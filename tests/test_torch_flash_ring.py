"""The port's flash-ring attention (tpu_sandbox_torch/parallel/flash_ring.py)
and its per-hop backward ``make_flash_bwd_lse`` (ops/flash_attention.py)
== the JAX package's, the contract of tests/test_flash_ring.py.

In one process: the per-hop (dq, dk, dv) of ``make_flash_bwd_lse``'s
closure against JAX's (Pallas ``_flash_bwd`` in interpret mode; the port's
kernels' plain versions) for diagonal, wholly-past and wholly-future hops,
a key block shorter than the query block and causal off, taken against
the final lse of the whole sequence; and the offset-lse merge of two
partials against full attention. Over four gloo ranks, spawned once for
the module (tests/torch_dist_workers.py): ``make_flash_ring_attention``
against JAX's on a 4-device mesh of virtual CPU devices, output and the
gradients of sum(out * w). fp32 [B, S, H 2, D 16] from a numpy seed.
Tolerances: the per-hop gradients (f32 outputs) within 1e-5 of max|JAX|,
fp32 and bf16 inputs alike (both sides take the products of the same
bf16 values in f32, in other orders; 1e-7 measured); the merge and the
ring output within 2e-5, the ring gradients within 1e-4 (absolute, values
of order 1): JAX's own bars."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from test_torch_ring_attention import B, D, WORLD, arrays, block, run_ranks
from tpu_sandbox.ops.attention import causal_attention as jax_attention
from tpu_sandbox.ops.pallas_attention import flash_attention_lse as jax_flash_lse
from tpu_sandbox.ops.pallas_attention import make_flash_bwd_lse as jax_bwd_lse
from tpu_sandbox.parallel.flash_ring import make_flash_ring_attention as jax_fr
from tpu_sandbox.runtime.mesh import make_mesh as jax_make_mesh
from tpu_sandbox_torch.ops import flash_attention as fa
from tpu_sandbox_torch.parallel.flash_ring import merge
from torch_threads import one_torch_thread  # noqa: F401

HOP_TOL = 1e-5
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
#: the ring cases on four ranks: name -> (scheme, options, heads, seed)
CASES = {"flash_ring_causal": ("flash_ring", {"causal": True}, 2, 5),
         "flash_ring_noncausal": ("flash_ring", {"causal": False}, 2, 6)}
#: one hop: the query block [Q_OFF, Q_OFF + 32) of a 128-token sequence
#: against keys [kv_offset, kv_offset + sk): name -> (kv_offset, sk, causal)
Q_OFF, S_LOC, S_ALL = 64, 32, 128
HOPS = {"diagonal": (64, 32, True), "past": (0, 32, True),
        "future": (96, 32, True), "short_kv": (50, 20, True),
        "noncausal": (96, 32, False)}


def _hop_inputs(causal, dt):
    """q (the block at Q_OFF), the whole k, v, g, and out and lse of the
    block's attention over the whole sequence (JAX's forward: the merged
    lse a ring's backward takes)."""
    jd, _ = DTYPES[dt]
    rng = np.random.default_rng(21)
    q, k, v = (jnp.asarray(rng.standard_normal((2, S_ALL, 2, D)), jd)
               for _ in range(3))
    q = q[:, Q_OFF:Q_OFF + S_LOC]
    g = jnp.asarray(rng.standard_normal((2, S_LOC, 2, D)), jd)
    out, lse = jax_flash_lse(q, k, v, causal=causal, q_offset=Q_OFF,
                             interpret=True)
    return q, k, v, g, out.astype(jd), lse


def _torch(x, dt):
    return torch.from_numpy(np.array(jnp.asarray(x, jnp.float32))).to(
        DTYPES[dt][1])


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("hop", list(HOPS))
def test_per_hop_backward_matches_jax(hop, dt):
    kv_offset, sk, causal = HOPS[hop]
    q, k, v, g, out, lse = _hop_inputs(causal, dt)
    kb, vb = (x[:, kv_offset:kv_offset + sk] for x in (k, v))
    want = jax_bwd_lse(q, out, g, lse, causal=causal, q_offset=Q_OFF,
                       interpret=True)(kb, vb, kv_offset)
    got = fa.make_flash_bwd_lse(
        *(_torch(x, dt) for x in (q, out, g)), _torch(lse, "fp32"),
        causal=causal, q_offset=Q_OFF)(_torch(kb, dt), _torch(vb, dt),
                                       kv_offset)
    for name, t, w in zip(("dq", "dk", "dv"), got, want):
        w = np.asarray(w)
        assert t.dtype == torch.float32 and w.dtype == np.float32
        assert tuple(t.shape) == w.shape
        scale = float(np.abs(w).max()) or 1.0
        err = float(np.abs(t.numpy() - w).max())
        assert err <= HOP_TOL * scale, (name, err, scale)
        if hop == "future":                 # no visible pair: exact zeros
            assert not t.any() and not w.any()


def test_hop_kinds():
    """chip_smoke's names for a causal hop's visible pairs, which key its
    per-hop kernel entries."""
    assert chip_smoke.hop_kind(32, 32, 64, 64) == "diagonal"
    assert chip_smoke.hop_kind(32, 32, 64, 32) == "past"
    assert chip_smoke.hop_kind(32, 32, 64, 96) == "future"
    assert chip_smoke.hop_kind(32, 32, 64, 33) == "diagonal"
    assert chip_smoke.hop_kind(32, 32, 64, 95) == "diagonal"


def test_offset_lse_partials_merge_to_reference():
    """Two half-sequence partials of flash_attention_with_lse, merged by
    their logsumexps, equal full attention (JAX's reference): the identity
    the ring forward is built on; the first query's second partial is
    wholly in its future and weighs 0."""
    rng = np.random.default_rng(4)
    q, k, v = (rng.standard_normal((2, 64, 2, D)).astype(np.float32)
               for _ in range(3))
    ref = np.asarray(jax_attention(q, k, v, causal=True))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    o = torch.zeros(tq.shape)
    lse = torch.full(tq.shape[:3], fa.NEG)
    for blk in range(2):
        part = slice(blk * 32, (blk + 1) * 32)
        o_b, lse_b = fa.flash_attention_with_lse(
            tq, tk[:, part], tv[:, part], causal=True, q_offset=0,
            kv_offset=blk * 32)
        o, lse = merge(o, lse, o_b, lse_b)
    np.testing.assert_allclose(o.numpy(), ref, rtol=0, atol=2e-5)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(tmp_path_factory, CASES)


@pytest.fixture(scope="module")
def jax_mesh():
    return jax_make_mesh({"sp": WORLD}, devices=jax.devices()[:WORLD])


@pytest.mark.parametrize("name", list(CASES))
def test_flash_ring_matches_jax(ranks, jax_mesh, name):
    _, options, heads, seed = CASES[name]
    fn = jax_fr(jax_mesh, "sp", interpret=True, **options)
    q, k, v, w = (jnp.asarray(x) for x in arrays(heads, seed))
    out = np.asarray(fn(q, k, v))
    grads = jax.grad(lambda *x: jnp.sum(fn(*x) * w), argnums=(0, 1, 2))(
        q, k, v)
    for r, res in enumerate(ranks):
        got = res[name]
        np.testing.assert_allclose(got["out"].numpy(), block(out, r),
                                   rtol=0, atol=2e-5,
                                   err_msg=f"{name} out, rank {r}")
        for x, g, want in zip("qkv", got["grads"], grads):
            np.testing.assert_allclose(g.numpy(), block(np.asarray(want), r),
                                       rtol=0, atol=1e-4,
                                       err_msg=f"{name} d{x}, rank {r}")


def test_flash_ring_matches_the_reference(ranks):
    """The causal ring's output against JAX's single-device reference
    attention on the whole sequence (B 4, S 32)."""
    _, _, heads, seed = CASES["flash_ring_causal"]
    q, k, v, _ = arrays(heads, seed)
    assert q.shape[0] == B
    ref = np.asarray(jax_attention(q, k, v, causal=True))
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res["flash_ring_causal"]["out"].numpy(),
                                   block(ref, r), rtol=0, atol=2e-5)
