"""Paged KV-cache allocator: blocks, block tables, free lists, prefix reuse.

The port's copy of ``tpu_sandbox/serve/cache.py``, line for line (numpy
only), so either package's allocator makes the same block tables.

The device side is two flat page arrays per model —

    k_pages, v_pages : [n_layers, num_blocks, block_size, n_heads, head_dim]

— owned by the engine and written in place by the prefill/decode steps
(see ``serve/decode.py``). Everything in this module is *host* bookkeeping:
which blocks belong to which sequence, which are free, and which hold a
shared prompt prefix.

Design points:

- **Block 0 is the null block.** It is never allocated. Bucket-padding
  positions in prefill and empty decode slots scatter their K/V there, and
  block-table padding gathers from it; reads are masked by sequence length
  so its garbage never reaches the softmax.
- **Prefix sharing.** Every *full* block of a prompt is keyed by a chain
  hash (hash of all tokens up to and including the block). A new sequence
  whose prompt starts with an already-cached chain reuses those blocks
  (refcount bump) and its prefill skips the stores for the shared span.
  Cached blocks carry one extra cache reference so they survive their
  owning sequence; under pressure the allocator drops unreferenced cache
  entries (free-list reuse on eviction).
- **Recompute on eviction.** When a sequence is preempted its blocks are
  freed and the request is requeued with its original prompt; decoding is
  greedy and the step functions are bitwise deterministic, so the replay
  regenerates the identical continuation.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import Sequence

import numpy as np


@dataclass(frozen=True)
class CacheConfig:
    num_blocks: int = 64          # includes the reserved null block 0
    block_size: int = 8           # positions per block
    max_blocks_per_seq: int = 8   # block-table width == max context / block_size

    @property
    def max_context(self) -> int:
        return self.max_blocks_per_seq * self.block_size


def _chain_hashes(tokens: Sequence[int], block_size: int) -> list[bytes]:
    """One digest per *full* block, each covering the prompt up to and
    including that block (so a hit implies the whole prefix matches)."""
    out = []
    h = hashlib.sha256()
    for start in range(0, len(tokens) - len(tokens) % block_size, block_size):
        h.update(np.asarray(tokens[start:start + block_size], np.int32).tobytes())
        out.append(h.digest())
    return out


#: bytes of each chain hash that travel in load-report digests — enough that
#: an accidental collision is a mis-routed request (a hint gone wrong, never
#: a correctness problem: the replica's allocator rehashes the full prompt)
DIGEST_BYTES = 8


def chain_digest(tokens: Sequence[int], block_size: int) -> list[str]:
    """Truncated-hex chain hashes of ``tokens``' full blocks — the compact
    form both sides of prefix-cache-aware routing speak: replicas advertise
    their resident set in this form (``PagedKVCache.resident_prefix_digest``)
    and the gateway computes a request's chain in it."""
    return [h[:DIGEST_BYTES].hex()
            for h in _chain_hashes(tokens, block_size)]


@dataclass
class SeqAlloc:
    """Host-side allocation record for one live sequence."""

    seq_id: int
    block_ids: list[int]           # owned/shared blocks, in position order
    n_shared: int                  # leading block_ids reused from the prefix cache
    prompt_hashes: list[bytes]     # chain hashes of the prompt's full blocks
    length: int = 0                # tokens currently stored


class PagedKVCache:
    """Block allocator + prefix cache. Pure host state (numpy ints only)."""

    def __init__(self, config: CacheConfig):
        if config.num_blocks < 2:
            raise ValueError("need at least one allocatable block beyond null")
        self.config = config
        self._free: list[int] = list(range(config.num_blocks - 1, 0, -1))
        self._refs: dict[int, int] = {}
        # chain hash -> block id, insertion-ordered for FIFO cache eviction
        self._prefix: dict[bytes, int] = {}
        self._seqs: dict[int, SeqAlloc] = {}
        self._next_seq = 0
        self.stats = {"prefix_hits": 0, "prefix_blocks_reused": 0,
                      "evicted_cache_blocks": 0}

    # -- introspection -------------------------------------------------------

    @property
    def free_blocks(self) -> int:
        return len(self._free)

    def resident_prefix_digest(self, top_k: int = 24) -> list[str]:
        """Truncated-hex digest of the resident prefix-cache entries, newest
        last — what a replica advertises in its load report so the gateway
        can route by prefix affinity without extra KV round trips.

        Bounded: at most ``top_k`` entries of ``2 * DIGEST_BYTES`` hex chars
        each. ``_prefix`` is insertion-ordered and eviction is FIFO, so the
        *newest* ``top_k`` entries are exactly the ones that will survive
        block pressure longest — evicted entries drop out of the digest the
        moment they drop out of the cache (no stale advertisements).
        """
        entries = list(self._prefix)[-top_k:]
        return [h[:DIGEST_BYTES].hex() for h in entries]

    def blocks_needed(self, prompt: Sequence[int], max_new: int) -> int:
        total = len(prompt) + max_new
        return -(-total // self.config.block_size)

    def can_admit(self, prompt: Sequence[int], max_new: int) -> bool:
        need = self.blocks_needed(prompt, max_new)
        shared = self._count_shared(prompt)
        return need - shared <= len(self._free) + self._reclaimable()

    # -- allocation ----------------------------------------------------------

    def alloc(self, prompt: Sequence[int], max_new: int, *,
              share: bool = True) -> SeqAlloc | None:
        """Reserve blocks for prompt + max_new tokens. Returns None when the
        free list (plus droppable cache blocks) can't cover it. With
        ``share`` False the prompt takes no cached block (its K/V would
        come from other weights than the caller's)."""
        cfg = self.config
        need = self.blocks_needed(prompt, max_new)
        if need > cfg.max_blocks_per_seq:
            raise ValueError(
                f"sequence needs {need} blocks > max_blocks_per_seq "
                f"{cfg.max_blocks_per_seq}")
        hashes = _chain_hashes(prompt, cfg.block_size)
        shared: list[int] = []
        for hh in hashes if share else ():
            bid = self._prefix.get(hh)
            if bid is None:
                break
            shared.append(bid)
        # blocks we are about to pin as shared are not reclaimable fuel
        if need - len(shared) > len(self._free) + self._reclaimable(
                exclude=set(shared)):
            return None
        for bid in shared:
            self._refs[bid] += 1
        fresh = [self._take_free() for _ in range(need - len(shared))]
        if shared:
            self.stats["prefix_hits"] += 1
            self.stats["prefix_blocks_reused"] += len(shared)
        alloc = SeqAlloc(
            seq_id=self._next_seq,
            block_ids=shared + fresh,
            n_shared=len(shared),
            prompt_hashes=hashes,
            length=0,
        )
        self._next_seq += 1
        self._seqs[alloc.seq_id] = alloc
        return alloc

    def commit_prefix(self, alloc: SeqAlloc) -> None:
        """Publish the sequence's full prompt blocks into the prefix cache.
        Call *after* prefill has stored their K/V; idempotent."""
        self._register_prefix(alloc)

    def free(self, alloc: SeqAlloc, *, cache_prefix: bool = True) -> None:
        """Release a sequence. Its full prompt blocks stay in the prefix
        cache (one cache ref keeps them off the free list) unless
        ``cache_prefix`` is False or they were never registered."""
        if self._seqs.pop(alloc.seq_id, None) is None:
            return
        if cache_prefix:
            self._register_prefix(alloc)
        for bid in alloc.block_ids:
            self._decref(bid)

    def grow(self, alloc: SeqAlloc) -> bool:
        """Append one block when decode crosses a block boundary. True on
        success; False means block pressure (caller preempts-to-requeue)."""
        if len(alloc.block_ids) >= self.config.max_blocks_per_seq:
            return False
        try:
            alloc.block_ids.append(self._take_free())
        except MemoryError:
            return False
        return True

    def flush_prefix_cache(self) -> int:
        """Drop every prefix-cache entry (the cache's own reference); blocks
        still pinned by live sequences survive via their remaining refs.
        Called on a weight swap: cached K/V was computed under the old
        weights and must never serve a request pinned to the new version.
        Returns the number of entries flushed."""
        n = 0
        for hh, bid in list(self._prefix.items()):
            del self._prefix[hh]
            self._decref(bid)
            n += 1
        return n

    # -- device-facing views -------------------------------------------------

    def block_table(self, alloc: SeqAlloc) -> np.ndarray:
        """Fixed-width [max_blocks_per_seq] int32 row, null-block padded."""
        cfg = self.config
        row = np.zeros(cfg.max_blocks_per_seq, np.int32)
        row[: len(alloc.block_ids)] = alloc.block_ids
        return row

    def dest_indices(self, alloc: SeqAlloc, bucket_len: int) -> np.ndarray:
        """Flat page indices [bucket_len] for storing prefill K/V.

        Position p of the prompt lands at flat slot
        ``block_ids[p // bs] * bs + p % bs``. Positions inside *shared*
        prefix blocks and bucket padding are redirected to the null block
        (flat slots [0, bs)) so prefill never rewrites shared content.
        """
        cfg = self.config
        bs = cfg.block_size
        idx = np.zeros(bucket_len, np.int64)
        for p in range(min(bucket_len, len(alloc.block_ids) * bs)):
            b = p // bs
            if b < alloc.n_shared:
                continue  # shared prefix: leave pointed at null block
            idx[p] = alloc.block_ids[b] * bs + p % bs
        return idx

    # -- internals -----------------------------------------------------------

    def _count_shared(self, prompt: Sequence[int]) -> int:
        n = 0
        for hh in _chain_hashes(prompt, self.config.block_size):
            if hh not in self._prefix:
                break
            n += 1
        return n

    def _reclaimable(self, exclude: set[int] | None = None) -> int:
        exclude = exclude or set()
        return sum(1 for bid in self._prefix.values()
                   if self._refs[bid] == 1 and bid not in exclude)

    def _take_free(self) -> int:
        if not self._free:
            self._evict_cache_block()
        if not self._free:
            raise MemoryError("paged KV cache exhausted")
        bid = self._free.pop()
        self._refs[bid] = 1
        return bid

    def _evict_cache_block(self) -> None:
        # FIFO over cache entries; only entries nobody else references can
        # be dropped. Longest chains first would be smarter; FIFO is enough.
        for hh, bid in list(self._prefix.items()):
            if self._refs[bid] == 1:
                del self._prefix[hh]
                self._decref(bid)
                self.stats["evicted_cache_blocks"] += 1
                return

    def _register_prefix(self, alloc: SeqAlloc) -> None:
        n_full = len(alloc.prompt_hashes)
        for i in range(n_full):
            hh = alloc.prompt_hashes[i]
            if hh in self._prefix:
                continue
            if i > 0 and alloc.prompt_hashes[i - 1] not in self._prefix:
                break  # never cache a chain with a missing link
            bid = alloc.block_ids[i]
            self._prefix[hh] = bid
            self._refs[bid] += 1  # the cache's own reference

    def _decref(self, bid: int) -> None:
        self._refs[bid] -= 1
        if self._refs[bid] == 0:
            del self._refs[bid]
            self._free.append(bid)
