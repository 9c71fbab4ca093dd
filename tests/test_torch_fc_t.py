"""The port's fc head (tpu_sandbox_torch/ops/fc_t.py) == the JAX fc_t
with its Pallas input-grad kernel (interpret mode): the forward and all
three cotangents (dy, dkernel, db), in fp32 and bf16, and fc_dgrad_t
alone. On the CPU the port runs the plain version of its kernel; the
kernel is held against it on the card by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_sandbox.ops.pallas_fc_t import fc_dgrad_t as jax_fc_dgrad_t
from tpu_sandbox.ops.pallas_fc_t import fc_t as jax_fc_t
from tpu_sandbox_torch.ops import fc_t

DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
# fp32: the same f32 products summed in other orders. bf16: same bf16
# inputs, f32 accumulation, one rounding each side -> one bf16 ulp
# (2^-8 relative) at most, where the sums straddle a rounding boundary.
REL = {"fp32": 1e-5, "bf16": 1e-2}


def _case(dt, n=3, h=4, c=8, w=6, k=10, seed=0):
    rng = np.random.default_rng(seed)
    y = rng.standard_normal((n, h, c, w)).astype(np.float32)
    kernel = (0.05 * rng.standard_normal((h * c * w, k))).astype(np.float32)
    bias = rng.standard_normal(k).astype(np.float32)
    g = rng.standard_normal((n, k)).astype(np.float32)
    jd, td = DTYPES[dt]
    return ((jnp.asarray(y, jd), jnp.asarray(kernel), jnp.asarray(bias), g),
            (torch.from_numpy(y).to(td), torch.from_numpy(kernel),
             torch.from_numpy(bias), g))


def _close(got, want, rel, what=""):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(jnp.asarray(want, jnp.float32))
    scale = float(np.max(np.abs(want))) or 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                               err_msg=what)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_forward_and_grads_match_jax(dt):
    (jy, jk, jb, g), (ty, tk, tb, _) = _case(dt)
    jd, td = DTYPES[dt]
    out, vjp = jax.vjp(lambda y, k, b: jax_fc_t(y, k, b, jd), jy, jk, jb)
    jdy, jdk, jdb = jax.jit(vjp)(jnp.asarray(g, jd))
    for t in (ty, tk, tb):
        t.requires_grad_()
    tout = fc_t.fc_t(ty, tk, tb, td)
    assert tout.dtype == td and tuple(tout.shape) == tuple(out.shape)
    _close(tout, out, REL[dt], "logits")
    tout.backward(torch.from_numpy(g).to(td))
    assert ty.grad.dtype == td
    assert tk.grad.dtype == torch.float32 and tb.grad.dtype == torch.float32
    _close(ty.grad, jdy, REL[dt], "dy")
    # the weight gradient is an f32 product of the same rounded inputs
    # on both sides
    _close(tk.grad, jdk, 1e-5, "dkernel")
    _close(tb.grad, jdb, 1e-5, "db")


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_dgrad_alone_matches_jax(dt):
    rng = np.random.default_rng(2)
    jd, td = DTYPES[dt]
    g = rng.standard_normal((5, 10)).astype(np.float32)
    wt = rng.standard_normal((10, 6, 8, 16)).astype(np.float32)
    want = jax.jit(jax_fc_dgrad_t, static_argnums=2)(
        jnp.asarray(g), jnp.asarray(wt, jd), jd)
    got = fc_t.fc_dgrad_t(torch.from_numpy(g), torch.from_numpy(wt).to(td), td)
    assert got.dtype == td and tuple(got.shape) == tuple(want.shape)
    _close(got, want, REL[dt])


def test_stage_wt_is_the_k_major_view():
    k2 = torch.arange(4 * 3 * 5 * 2, dtype=torch.float32).reshape(60, 2)
    wt = fc_t.stage_wt(k2, (4, 3, 5), torch.bfloat16)
    assert wt.shape == (2, 4, 3, 5) and wt.is_contiguous()
    assert torch.equal(wt.float(), k2.t().reshape(2, 4, 3, 5))


def test_non_cpu_tensor_never_takes_the_plain_path():
    g = torch.empty((5, 10), device="meta")
    wt = torch.empty((10, 2, 8, 8), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        fc_t.fc_dgrad_t(g, wt, torch.float32)
