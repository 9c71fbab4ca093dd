"""The port's flash attention (tpu_sandbox_torch/ops/flash_attention.py)
== the JAX flash attention with its Pallas kernels in interpret mode: the
forward and the gradients through jax.vjp on [B, S, H, D] inputs, with S
off the block and D off every head width; the port's plain backward
against JAX's blockwise reference backward and, with float32 outputs for
bfloat16 inputs, against JAX's _flash_bwd; the offset/lse forward
against flash_attention_lse, whose out is float32 for either input
dtype. On the CPU the port runs its kernels' plain
versions; chip_smoke.py holds the kernels against them on the card."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_sandbox.ops.pallas_attention import _blockwise_bwd, _flash_bwd
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


@pytest.mark.parametrize("s,kv_len", [(128, 128), (256, 200)])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_backward_f32_out_matches_jax_flash_bwd(causal, s, kv_len):
    """bf16 q, k, v, do with float32 gradients (``out_dtype``): the port's
    backward (its plain version here) against JAX's _flash_bwd(...,
    out_dtype=float32) with its Pallas kernels in interpret mode, on the
    same inputs, lse and delta, keys from kv_len on padding. Both compute
    in f32 from the same bf16 values, so they agree to f32 summation
    order."""
    b, h, d = 1, 2, 128
    rng = np.random.default_rng(s + kv_len)
    q, k, v, g = (rng.standard_normal((b, h, s, d)).astype(np.float32)
                  for _ in range(4))
    tq, tk, tv, tg = (torch.from_numpy(x).to(torch.bfloat16)
                      for x in (q, k, v, g))
    scale = 1.0 / math.sqrt(d)
    kw = dict(scale=scale, causal=causal, kv_len=kv_len)
    out, lse = fa.flash_fwd_plain(tq.float(), tk.float(), tv.float(), **kw)
    delta = (tg.float() * out).sum(-1)
    dk, dv = fa.flash_bwd_dkv(tq, tk, tv, tg, lse, delta, **kw,
                              out_dtype=torch.float32)
    dq = fa.flash_bwd_dq(tq, tk, tv, tg, lse, delta, **kw,
                         out_dtype=torch.float32)
    jq, jk, jv, jg = (jnp.asarray(x, jnp.bfloat16) for x in (q, k, v, g))
    jdq, jdk, jdv = _flash_bwd(jq, jk, jv, jnp.asarray(delta.numpy()),
                               jnp.asarray(lse.numpy()), jg, scale, causal,
                               128, 128, True, kv_len,
                               out_dtype=jnp.float32)
    for name, got, want in (("dq", dq, jdq), ("dk", dk, jdk), ("dv", dv, jdv)):
        assert got.dtype == torch.float32 and want.dtype == jnp.float32, name
        err = _err(got, want)
        assert err <= 1e-5, f"{name}: {err:.3g} of max|ref|"


def test_kernel_output_dtypes():
    """The kernels write the input dtype or, for bfloat16 inputs, float32
    (the default is the input dtype); anything else is refused."""
    bf, f32 = (torch.empty((1, 1, 64, 64), dtype=t)
               for t in (torch.bfloat16, torch.float32))
    assert fa._out_code("x", bf, None) == (torch.bfloat16, 1)
    assert fa._out_code("x", bf, torch.float32) == (torch.float32, 0)
    assert fa._out_code("x", f32, None) == (torch.float32, 0)
    with pytest.raises(ValueError, match="float32"):
        fa._out_code("x", f32, torch.bfloat16)
    with pytest.raises(ValueError):
        fa._out_code("x", bf, torch.float16)


# flash_attention_lse's out against JAX's, of max|ref|, bf16 inputs: both
# write float32 out, but p is rounded to bf16 on each side before p.v,
# and JAX's per-block online max and the plain version's global max can
# put a p across a rounding boundary (measured on the CPU: <= 3.3e-7 on
# the three offset cases below, 3.0e-4 at S 200 D 64 causal)
LSE_OUT_TOL = {"fp32": 1e-5, "bf16": 1e-3}


@pytest.mark.parametrize("causal,q_offset,kv_offset",
                         [(True, 96, 0), (True, 40, 24), (False, 7, 300)])
@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_offset_lse_forward_matches_flash_attention_lse(dt, causal, q_offset,
                                                        kv_offset):
    """Queries and keys at global offsets, q and kv of different lengths
    (every query sees some key), out and lse against the JAX forward; out
    is float32 for either input dtype, as JAX's partials are."""
    jd, td = DTYPES[dt]
    rng = np.random.default_rng(11)
    q = rng.standard_normal((2, 72, 2, 40)).astype(np.float32)
    k, v = (rng.standard_normal((2, 100, 2, 40)).astype(np.float32)
            for _ in range(2))
    out, lse = jax_flash_lse(*(jnp.asarray(x, jd) for x in (q, k, v)),
                             causal=causal, q_offset=q_offset,
                             kv_offset=kv_offset, interpret=True)
    assert out.dtype == jnp.float32
    tout, tlse = fa.flash_attention_with_lse(
        *(torch.from_numpy(x).to(td) for x in (q, k, v)), causal=causal,
        q_offset=q_offset, kv_offset=kv_offset)
    assert tout.dtype == torch.float32 and tuple(tout.shape) == (2, 72, 2, 40)
    assert tlse.dtype == torch.float32 and tuple(tlse.shape) == (2, 72, 2)
    assert _err(tout, out) <= LSE_OUT_TOL[dt]
    assert _err(tlse, lse) <= 1e-6


def test_forward_output_dtypes():
    """flash_fwd writes the input dtype or, for bfloat16 inputs, float32;
    every other out_dtype is refused, by the kernel wrapper and by the
    plain version alike."""
    kw = dict(scale=0.125, causal=True, kv_len=64)
    bf, f32 = (torch.zeros((1, 1, 64, 32), dtype=t)
               for t in (torch.bfloat16, torch.float32))
    assert fa.flash_fwd(bf, bf, bf, **kw)[0].dtype == torch.bfloat16
    assert fa.flash_fwd(bf, bf, bf, out_dtype=torch.float32,
                        **kw)[0].dtype == torch.float32
    assert fa.flash_fwd(f32, f32, f32, **kw)[0].dtype == torch.float32
    with pytest.raises(ValueError, match="float32"):
        fa.flash_fwd(f32, f32, f32, out_dtype=torch.bfloat16, **kw)
    with pytest.raises(ValueError):
        fa.flash_fwd_plain(bf, bf, bf, out_dtype=torch.float16, **kw)


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
