"""The port's prefill and paged decode steps (tpu_sandbox_torch/serve/
decode.py) and the LM's serving hooks (models/transformer.py: ``kv_taps``,
per-call ``attention_fn``) against JAX's ``build_decode_step`` from bridged
weights, at the JAX serve tests' geometry (vocab 64, d 32, 4 heads, 2
layers, d_ff 64; CacheConfig(24, 4, 8), max_batch 3, buckets (8, 16)).

Tolerances, all fp32 on the CPU:

- across frameworks, 1e-5 absolute on logits and pages (the same f32 math
  in other summation orders; measured 1.3e-6);
- the port's decode against its own one-shot forward at max_context, 1e-5
  absolute: JAX claims bits there only through XLA:CPU's gemm for q >= 2
  (its q=2 pad), a property of XLA:CPU the port does not copy;
- a bf16 cache against the fp32 forward, JAX's own bound (rtol and atol
  0.05, tests/test_serve.py:181);
- prefix pages computed under another bucket, 1e-5 absolute (a matmul's
  row count may change its rounding).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_sandbox.models.transformer import TransformerConfig as JaxConfig
from tpu_sandbox.models.transformer import TransformerLM as JaxLM
from tpu_sandbox.serve.cache import CacheConfig as JaxCacheConfig
from tpu_sandbox.serve.decode import build_decode_step as jax_build
from tpu_sandbox.serve.decode import init_pages as jax_init_pages
from tpu_sandbox_torch.models.transformer import (TransformerConfig,
                                                  TransformerLM)
from tpu_sandbox_torch.serve.cache import CacheConfig, PagedKVCache
from tpu_sandbox_torch.serve.decode import (build_decode_step, gumbel_noise,
                                            init_pages, page_shapes,
                                            sample_token)
from tpu_sandbox_torch.utils.bridge import params_from_flax
from torch_threads import one_torch_thread  # noqa: F401

WIDTH = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             max_len=128)
MCFG = TransformerConfig(**WIDTH)
CCFG = CacheConfig(num_blocks=24, block_size=4, max_blocks_per_seq=8)
MAX_CTX = CCFG.max_context  # 32
TOL = 1e-5


@pytest.fixture(scope="module")
def jax_params():
    return JaxLM(JaxConfig(**WIDTH, dtype=jnp.float32)).init(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]


@pytest.fixture(scope="module")
def params(jax_params):
    return params_from_flax({"params": jax.tree.map(np.asarray, jax_params)})


@pytest.fixture(scope="module")
def step():
    return build_decode_step(MCFG, CCFG, max_batch=3, buckets=(8, 16))


@pytest.fixture(scope="module")
def model(params):
    m = TransformerLM(MCFG)
    m.load_state_dict(params)
    return m


def _long(a):
    return torch.as_tensor(np.asarray(a, np.int64))


def _padded_forward(model, seq, length=MAX_CTX):
    toks = torch.zeros((1, length), dtype=torch.long)
    toks[0, :len(seq)] = torch.tensor(seq)
    with torch.no_grad():
        return model(toks)[0, len(seq) - 1].numpy()


class _Run:
    """Prefill then greedy decode of one sequence in slot 0 of a step."""

    def __init__(self, prefill, decode, kp, vp, prompt, bucket=8):
        self.decode, self.kp, self.vp = decode, kp, vp
        self.cache = PagedKVCache(CCFG)
        self.alloc = self.cache.alloc(prompt, 0)
        toks = np.zeros((1, bucket), np.int64)
        toks[0, :len(prompt)] = prompt
        self.dest = self.cache.dest_indices(self.alloc, bucket)
        self.logits, self.kp, self.vp = prefill(
            self.kp, self.vp, toks, self.dest, len(prompt) - 1)
        self.alloc.length = len(prompt)
        self.seq = list(prompt)

    def next(self, token):
        self.seq.append(token)
        a = self.alloc
        if a.length % CCFG.block_size == 0 \
                and a.length // CCFG.block_size >= len(a.block_ids):
            assert self.cache.grow(a)
        tokens = np.zeros((3, 1), np.int64)
        lengths = np.zeros((3,), np.int64)
        tables = np.zeros((3, CCFG.max_blocks_per_seq), np.int64)
        tokens[0, 0] = token
        lengths[0] = len(self.seq)
        tables[0] = self.cache.block_table(a)
        self.logits, self.kp, self.vp = self.decode(
            self.kp, self.vp, tokens, lengths, tables)
        a.length = len(self.seq)
        return self.logits


def _ours(step, params, cache_dtype=torch.float32):
    kp, vp = init_pages(MCFG, CCFG, cache_dtype, device="cpu")

    def prefill(kp, vp, toks, dest, last):
        out, kp, vp = step.prefill[toks.shape[1]](
            params, kp, vp, _long(toks), _long(dest), last)
        return out.numpy(), kp, vp

    def decode(kp, vp, tokens, lengths, tables):
        out, kp, vp = step.decode(params, kp, vp, _long(tokens),
                                  _long(lengths), _long(tables))
        return out[0].numpy(), kp, vp

    return prefill, decode, kp, vp


def _theirs(jstep, jax_params):
    kp, vp = jax_init_pages(jstep.model_cfg, jstep.cache_cfg)

    def prefill(kp, vp, toks, dest, last):
        out, kp, vp = jstep.prefill[toks.shape[1]](
            jax_params, kp, vp, jnp.asarray(toks, jnp.int32),
            jnp.asarray(dest, jnp.int32), jnp.asarray(last, jnp.int32))
        return np.asarray(out), kp, vp

    def decode(kp, vp, tokens, lengths, tables):
        out, kp, vp = jstep.decode(
            jax_params, kp, vp, jnp.asarray(tokens, jnp.int32),
            jnp.asarray(lengths, jnp.int32), jnp.asarray(tables, jnp.int32))
        return np.asarray(out)[0], kp, vp

    return prefill, decode, kp, vp


def test_prefill_and_24_decode_steps_match_jax(params, step, jax_params):
    """Prefill, then 24 greedy decode steps on both packages' steps from
    one bridged tree: each step's logits and the whole page buffers within
    TOL, and the same greedy tokens."""
    jstep = jax_build(JaxConfig(**WIDTH, dtype=jnp.float32),
                      JaxCacheConfig(24, 4, 8), max_batch=3, buckets=(8, 16))
    prompt = [5, 17, 3, 42, 9]
    ours = _Run(*_ours(step, params), prompt)
    theirs = _Run(*_theirs(jstep, jax_params), prompt)
    for i in range(25):
        assert np.abs(ours.logits - theirs.logits).max() <= TOL, i
        for mine, jax_pages in ((ours.kp, theirs.kp), (ours.vp, theirs.vp)):
            assert np.abs(mine.numpy() - np.asarray(jax_pages)).max() <= TOL
        if i == 24:
            break
        token = int(theirs.logits.argmax())
        assert int(ours.logits.argmax()) == token, i
        ours.next(token)
        theirs.next(token)


def test_decode_matches_the_padded_forward_within_tolerance(params, step,
                                                            model):
    """Prefill plus 24 decode steps against the port's one-shot forward at
    max_context padding (and, at context 12, the exact-length forward)."""
    run = _Run(*_ours(step, params), [5, 17, 3, 42, 9])
    assert np.abs(run.logits - _padded_forward(model, run.seq)).max() <= TOL
    for _ in range(24):
        logits = run.next(int(run.logits.argmax()))
        assert np.abs(logits - _padded_forward(model, run.seq)).max() <= TOL
        if len(run.seq) == 12:
            exact = _padded_forward(model, run.seq, len(run.seq))
            assert np.abs(logits - exact).max() <= TOL


def test_decode_bf16_cache_stays_close(params, model):
    """A bf16 cache under fp32 weights and compute, within JAX's bound of
    the fp32 forward."""
    step16 = build_decode_step(MCFG, CCFG, max_batch=3, buckets=(8,),
                               cache_dtype=torch.bfloat16)
    run = _Run(*_ours(step16, params, torch.bfloat16), [11, 2, 33, 4])
    assert run.kp.dtype == torch.bfloat16
    for _ in range(12):
        logits = run.next(int(run.logits.argmax()))
        np.testing.assert_allclose(logits, _padded_forward(model, run.seq),
                                   rtol=0.05, atol=0.05)


def test_prefix_pages_from_another_bucket_within_tolerance(params, step):
    """K/V of a shared 8-token prefix written by a bucket-16 prefill serve a
    bucket-8 request (the prefix alone, both its blocks shared): its decode
    logits stay within TOL of the same request prefilled alone."""
    prefix = [3, 1, 4, 1, 5, 9, 2, 6]
    long_prompt, short_prompt = prefix + [5, 3, 5, 8, 9, 7, 9], prefix
    kp, vp = init_pages(MCFG, CCFG, device="cpu")
    cache = PagedKVCache(CCFG)
    a = cache.alloc(long_prompt, 0)
    toks = np.zeros((1, 16), np.int64)
    toks[0, :len(long_prompt)] = long_prompt
    step.prefill[16](params, kp, vp, _long(toks),
                     _long(cache.dest_indices(a, 16)), len(long_prompt) - 1)
    cache.commit_prefix(a)
    b = cache.alloc(short_prompt, 0)
    assert b.n_shared == 2
    toks = np.zeros((1, 8), np.int64)
    toks[0, :len(short_prompt)] = short_prompt
    first, kp, vp = step.prefill[8](
        params, kp, vp, _long(toks), _long(cache.dest_indices(b, 8)),
        len(short_prompt) - 1)
    b.length = len(short_prompt)
    assert cache.grow(b)                 # position 8 opens a third block
    shared = _Run(*_ours(step, params), short_prompt)  # its own prefix pages
    assert torch.equal(first.float(), torch.as_tensor(shared.logits))
    token = int(first.argmax())
    tables = np.zeros((3, CCFG.max_blocks_per_seq), np.int64)
    tables[0] = cache.block_table(b)
    tokens, lengths = np.zeros((3, 1), np.int64), np.zeros((3,), np.int64)
    tokens[0, 0], lengths[0] = token, len(short_prompt) + 1
    got, _, _ = step.decode(params, kp, vp, _long(tokens), _long(lengths),
                            _long(tables))
    want = shared.next(token)
    assert np.abs(got[0].numpy() - want).max() <= TOL


def test_kv_taps_and_attention_override_leave_the_forward_alone(params,
                                                                model,
                                                                jax_params):
    """The LM's serving hooks: a forward with ``kv_taps`` is bitwise the
    plain forward and taps each layer's k and v, which match JAX's sown
    ``kv_cache``; an ``attention_fn`` passed per call runs once a layer in
    layer order, and passing the plain attention changes nothing."""
    from tpu_sandbox_torch.ops.attention import causal_attention

    toks = np.random.default_rng(0).integers(0, 64, size=(2, 16))
    t = torch.as_tensor(toks)
    with torch.no_grad():
        plain = model(t)
        taps: list = []
        tapped = model(t, kv_taps=taps)
        seen: list = []

        def attn(q, k, v):
            seen.append(q.shape)
            return causal_attention(q, k, v)

        overridden = model(t, attention_fn=attn)
    assert torch.equal(tapped, plain) and torch.equal(overridden, plain)
    assert len(taps) == MCFG.n_layers and len(seen) == MCFG.n_layers
    _, sown = JaxLM(JaxConfig(**WIDTH, dtype=jnp.float32)).apply(
        {"params": jax_params}, jnp.asarray(toks, jnp.int32),
        mutable=["kv_cache"])
    for i, (k, v) in enumerate(taps):
        jk, jv = sown["kv_cache"][f"block{i}"]["attn"]["kv"]
        assert k.shape == (2, 16, 4, 8)
        assert np.abs(k.numpy() - np.asarray(jk)).max() <= TOL
        assert np.abs(v.numpy() - np.asarray(jv)).max() <= TOL


def test_page_shapes_and_init_pages():
    shape = (2, 24, 4, 4, 8)
    assert page_shapes(MCFG, CCFG) == (shape, shape)
    kp, vp = init_pages(MCFG, CCFG, torch.bfloat16, device="cpu")
    assert kp.shape == shape and kp.dtype == torch.bfloat16
    assert not kp.any() and not vp.any()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            init_pages(MCFG, CCFG)


def test_prefill_takes_only_its_bucket(params, step):
    kp, vp = init_pages(MCFG, CCFG, device="cpu")
    with pytest.raises(ValueError, match="bucket 8"):
        step.prefill[8](params, kp, vp, torch.zeros((1, 16), dtype=torch.long),
                        torch.zeros(16, dtype=torch.long), 3)
    assert step.pick_bucket(8) == 8 and step.pick_bucket(9) == 16
    with pytest.raises(ValueError, match="exceeds largest"):
        step.pick_bucket(17)


def test_sample_token_is_deterministic_and_top_k_bounded():
    rng = np.random.default_rng(0)
    logits = rng.normal(size=64).astype(np.float32)
    draws = {sample_token(logits, seed=7, step_index=3, temperature=0.8,
                          top_k=5) for _ in range(4)}
    assert len(draws) == 1  # same (seed, step) -> same token, always
    top5 = set(np.argsort(logits)[-5:].tolist())
    for i in range(32):
        assert sample_token(logits, seed=7, step_index=i, temperature=5.0,
                            top_k=5) in top5
    # different step indices decorrelate the stream
    seq = [sample_token(logits, seed=7, step_index=i, temperature=0.8)
           for i in range(32)]
    assert len(set(seq)) > 1
    # top_k=1 degenerates to argmax regardless of temperature
    assert sample_token(logits, seed=7, step_index=0, temperature=5.0,
                        top_k=1) == int(logits.argmax())


def test_sample_noise_is_keyed_by_seed_and_step_alone():
    """The draw is a function of (seed, step_index): the same key gives the
    same noise whatever was drawn before or from the global RNGs; another
    seed or step gives other noise."""
    a = gumbel_noise(7, 3, 64)
    np.random.seed(123)
    np.random.random(10)
    gumbel_noise(9, 1, 64)
    assert np.array_equal(gumbel_noise(7, 3, 64), a)
    assert a.dtype == np.float32
    assert not np.array_equal(gumbel_noise(8, 3, 64), a)
    assert not np.array_equal(gumbel_noise(7, 4, 64), a)
    assert not np.array_equal(gumbel_noise(3, 7, 64), a)
