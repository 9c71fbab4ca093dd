"""The port's flash attention (tpu_sandbox_torch/ops/flash_attention.py)
== the JAX flash attention with its Pallas kernels in interpret mode: the
forward and the gradients through jax.vjp on [B, S, H, D] inputs, with S
off the block and D off every head width; the port's plain backward
against JAX's blockwise reference backward; the offset/lse forward
against flash_attention_lse. On the CPU the port runs its kernels' plain
versions; chip_smoke.py holds the kernels against them on the card."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_sandbox.ops.pallas_attention import _blockwise_bwd
from tpu_sandbox.ops.pallas_attention import flash_attention as jax_flash
from tpu_sandbox.ops.pallas_attention import flash_attention_lse as jax_flash_lse
from tpu_sandbox_torch.ops import flash_attention as fa

DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
# of max|ref|. fp32: the same f32 math in other summation orders (the
# Pallas kernels sum 128-key blocks online, the plain version all keys at
# once). bf16: the same bf16 inputs; p, the output and the gradients are
# rounded to bf16 once on each side, so they may differ by an ulp or two
# (2^-8) where the f32 values straddle a rounding boundary.
TOL = {"fp32": 1e-5, "bf16": 2e-2}


def _qkvg(b, s, h, d, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((b, s, h, d)).astype(np.float32)
            for _ in range(4)]


def _err(got, want):
    want = np.asarray(jnp.asarray(want, jnp.float32))
    got = got.detach().float().numpy()
    assert got.shape == want.shape
    scale = float(np.max(np.abs(want))) or 1.0
    return float(np.max(np.abs(got - want))) / scale


@pytest.mark.parametrize("b,s,d", [(1, 128, 32), (2, 200, 40), (1, 200, 32),
                                   (2, 128, 40)])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_forward_and_vjp_match_jax(dt, causal, b, s, d):
    jd, td = DTYPES[dt]
    q, k, v, g = _qkvg(b, s, 2, d, seed=s + d)
    out, vjp = jax.vjp(
        lambda q, k, v: jax_flash(q, k, v, causal=causal, interpret=True),
        *(jnp.asarray(x, jd) for x in (q, k, v)))
    jdq, jdk, jdv = vjp(jnp.asarray(g, jd))

    tq, tk, tv = (torch.from_numpy(x).to(td).requires_grad_()
                  for x in (q, k, v))
    tout = fa.flash_attention(tq, tk, tv, causal=causal)
    assert tout.dtype == td
    tout.backward(torch.from_numpy(g).to(td))
    for name, got, want in (("out", tout, out), ("dq", tq.grad, jdq),
                            ("dk", tk.grad, jdk), ("dv", tv.grad, jdv)):
        assert got.dtype == td, name
        err = _err(got, want)
        assert err <= TOL[dt], f"{name}: {err:.3g} of max|ref|"


@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_matches_blockwise_reference(causal):
    """The port's two backward plain versions against _blockwise_bwd on the
    kernels' [B, H, S, D] layout, with keys past kv_len masked."""
    b, h, s, d, kv_len = 2, 2, 192, 32, 180
    q, k, v, g = (x.transpose(0, 2, 1, 3) for x in _qkvg(b, s, h, d, 7))
    scale = 1.0 / math.sqrt(d)
    tq, tk, tv, tg = (torch.from_numpy(np.ascontiguousarray(x))
                      for x in (q, k, v, g))
    kw = dict(scale=scale, causal=causal, kv_len=kv_len)
    out, lse = fa.flash_fwd(tq, tk, tv, **kw)
    delta = (tg * out).sum(-1)
    dk, dv = fa.flash_bwd_dkv(tq, tk, tv, tg, lse, delta, **kw)
    dq = fa.flash_bwd_dq(tq, tk, tv, tg, lse, delta, **kw)
    jdq, jdk, jdv = _blockwise_bwd(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
        jnp.asarray(out.numpy()), jnp.asarray(lse.numpy()), jnp.asarray(g),
        scale, causal, 64, kv_len)
    for name, got, want in (("dq", dq, jdq), ("dk", dk, jdk), ("dv", dv, jdv)):
        err = _err(got, want)
        assert err <= 1e-5, f"{name}: {err:.3g} of max|ref|"


@pytest.mark.parametrize("causal,q_offset,kv_offset",
                         [(True, 96, 0), (True, 40, 24), (False, 7, 300)])
def test_offset_lse_forward_matches_flash_attention_lse(causal, q_offset,
                                                        kv_offset):
    """Queries and keys at global offsets, q and kv of different lengths
    (every query sees some key), out and lse against the JAX forward."""
    rng = np.random.default_rng(11)
    q = rng.standard_normal((2, 72, 2, 40)).astype(np.float32)
    k, v = (rng.standard_normal((2, 100, 2, 40)).astype(np.float32)
            for _ in range(2))
    out, lse = jax_flash_lse(*(jnp.asarray(x) for x in (q, k, v)),
                             causal=causal, q_offset=q_offset,
                             kv_offset=kv_offset, interpret=True)
    tout, tlse = fa.flash_attention_with_lse(
        *(torch.from_numpy(x) for x in (q, k, v)), causal=causal,
        q_offset=q_offset, kv_offset=kv_offset)
    assert tlse.dtype == torch.float32 and tuple(tlse.shape) == (2, 72, 2)
    assert _err(tout, out) <= 1e-5
    assert _err(tlse, lse) <= 1e-6


def test_padding_contract_does_not_change_the_result():
    """S is padded to lcm(block_q, block_k) with masked keys and D to the
    head width; the sliced result is the same whatever the blocks."""
    q, k, v, _ = (torch.from_numpy(x) for x in _qkvg(1, 50, 2, 24, 3))
    ref = fa.flash_attention(q, k, v)
    for bq, bk in ((64, 96), (16, 16), (128, 32)):
        got = fa.flash_attention(q, k, v, block_q=bq, block_k=bk)
        assert got.shape == (1, 50, 2, 24)
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-6)


def test_head_width():
    assert [fa.head_width(d) for d in (8, 32, 40, 64, 65, 128, 160)] == [
        32, 32, 64, 64, 128, 128, 160]


@pytest.mark.parametrize("which", ["fwd", "dkv", "dq"])
def test_non_cpu_tensor_never_takes_the_plain_path(which):
    q = torch.empty((1, 2, 64, 64), device="meta")
    lse = torch.empty((1, 2, 64), device="meta")
    kw = dict(scale=0.125, causal=True, kv_len=64)
    with pytest.raises(ValueError, match="CUDA"):
        if which == "fwd":
            fa.flash_fwd(q, q, q, **kw)
        elif which == "dkv":
            fa.flash_bwd_dkv(q, q, q, q, lse, lse, **kw)
        else:
            fa.flash_bwd_dq(q, q, q, q, lse, lse, **kw)
