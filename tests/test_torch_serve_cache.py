"""The port's paged KV-cache allocator (tpu_sandbox_torch/serve/cache.py), a
copy of JAX's: JAX's allocator tests (tests/test_serve.py:95-145) on the
port's copy, and the same random sequences of alloc, grow, commit, free and
flush on both packages' caches giving equal block tables, dest_indices,
prefix digests and stats at every step."""

import numpy as np
import pytest

from tpu_sandbox.serve import cache as jax_cache
from tpu_sandbox_torch.serve.cache import (CacheConfig, PagedKVCache,
                                           chain_digest)
from torch_threads import one_torch_thread  # noqa: F401

CCFG = CacheConfig(num_blocks=24, block_size=4, max_blocks_per_seq=8)


def test_cache_blocks_needed_and_admission():
    cache = PagedKVCache(CCFG)
    assert cache.blocks_needed([1] * 4, 0) == 1
    assert cache.blocks_needed([1] * 4, 1) == 2
    assert cache.blocks_needed([1] * 5, 11) == 4
    # 23 usable blocks (block 0 is the null block): a 24-block ask is out
    assert cache.alloc(list(range(5)), 0) is not None
    big = CacheConfig(num_blocks=4, block_size=4, max_blocks_per_seq=8)
    tight = PagedKVCache(big)
    assert tight.alloc([1] * 12, 0) is not None  # 3 blocks: exactly fits
    assert tight.alloc([2] * 4, 0) is None       # nothing left


def test_cache_free_list_reuse_and_grow():
    cfg = CacheConfig(num_blocks=6, block_size=4, max_blocks_per_seq=4)
    cache = PagedKVCache(cfg)
    a = cache.alloc([1, 2, 3, 4, 5], 0)          # 2 blocks
    b = cache.alloc([9, 8, 7], 0)                # 1 block
    assert len(a.block_ids) == 2 and len(b.block_ids) == 1
    assert cache.grow(a)                          # free 2 -> a takes one
    assert len(a.block_ids) == 3
    assert cache.grow(b)                          # b takes the last one
    cache.free(a, cache_prefix=False)
    c = cache.alloc([4] * 10, 0)                  # reuses a's freed blocks
    assert c is not None and len(c.block_ids) == 3
    cache.free(b, cache_prefix=False)
    cache.free(c, cache_prefix=False)
    assert cache.alloc([5] * 16, 0) is not None   # 4 blocks: pool healthy


def test_cache_prefix_sharing_refcounts_and_eviction():
    cfg = CacheConfig(num_blocks=6, block_size=4, max_blocks_per_seq=4)
    cache = PagedKVCache(cfg)                     # 5 usable blocks
    prompt = [7, 7, 7, 7, 5, 5, 5, 5, 9]          # two full blocks + tail
    a = cache.alloc(prompt, 0)
    assert a.n_shared == 0
    cache.commit_prefix(a)
    b = cache.alloc(prompt, 0)                    # full blocks shared
    assert b.n_shared == 2
    assert b.block_ids[:2] == a.block_ids[:2]
    assert cache.stats["prefix_hits"] == 1
    assert cache.stats["prefix_blocks_reused"] == 2
    cache.free(a)
    cache.free(b)
    # freed-with-prefix blocks stay cached (2) leaving 3 plainly free; a
    # 4-block ask only fits by evicting from the prefix cache
    c = cache.alloc([1] * 16, 0)
    assert c is not None
    assert cache.stats["evicted_cache_blocks"] >= 1


def _view(cache, allocs, bucket=16):
    """Everything the engine reads off a cache, as plain data."""
    return {
        "tables": [cache.block_table(a).tolist() for a in allocs],
        "dest": [cache.dest_indices(a, bucket).tolist() for a in allocs],
        "shared": [a.n_shared for a in allocs],
        "free": cache.free_blocks,
        "digest": cache.resident_prefix_digest(),
        "stats": dict(cache.stats),
    }


@pytest.mark.parametrize("seed", range(6))
def test_random_operations_match_the_jax_allocator(seed):
    """One random sequence of alloc (prompts drawn from a few shared
    prefixes, so blocks are shared), grow, commit_prefix, free (with and
    without caching the prefix) and flush_prefix_cache on both allocators:
    equal results and equal views after every operation."""
    cfg = dict(num_blocks=20, block_size=4, max_blocks_per_seq=6)
    ours = PagedKVCache(CacheConfig(**cfg))
    theirs = jax_cache.PagedKVCache(jax_cache.CacheConfig(**cfg))
    rng = np.random.default_rng(seed)
    heads = [rng.integers(1, 50, size=8).tolist() for _ in range(3)]
    live: list[tuple] = []
    for _ in range(200):
        op = rng.choice(["alloc", "alloc", "grow", "commit", "free",
                         "flush"], p=[0.3, 0.1, 0.25, 0.15, 0.18, 0.02])
        if op == "alloc" or not live:
            head = heads[int(rng.integers(len(heads)))]
            prompt = (head[:int(rng.integers(0, 9))]
                      + rng.integers(1, 50, size=int(rng.integers(1, 9)))
                      .tolist())
            new = int(rng.integers(0, 6))
            if ours.blocks_needed(prompt, new) > cfg["max_blocks_per_seq"]:
                with pytest.raises(ValueError):
                    ours.alloc(prompt, new)
                with pytest.raises(ValueError):
                    theirs.alloc(prompt, new)
                continue
            assert ours.can_admit(prompt, new) == theirs.can_admit(prompt, new)
            a, b = ours.alloc(prompt, new), theirs.alloc(prompt, new)
            assert (a is None) == (b is None)
            assert chain_digest(prompt, 4) == jax_cache.chain_digest(prompt, 4)
            if a is not None:
                assert a.prompt_hashes == b.prompt_hashes
                a.length = b.length = len(prompt)
                live.append((a, b))
        else:
            i = int(rng.integers(len(live)))
            a, b = live[i]
            if op == "grow":
                assert ours.grow(a) == theirs.grow(b)
            elif op == "commit":
                ours.commit_prefix(a)
                theirs.commit_prefix(b)
            elif op == "free":
                keep = bool(rng.integers(2))
                ours.free(a, cache_prefix=keep)
                theirs.free(b, cache_prefix=keep)
                live.pop(i)
            else:
                assert ours.flush_prefix_cache() == \
                    theirs.flush_prefix_cache()
        assert _view(ours, [a for a, _ in live]) == \
            _view(theirs, [b for _, b in live])
