"""The port's fused conv1 + BN/ReLU/pool unit
(tpu_sandbox_torch/ops/conv1_tail_t.py) == the JAX Pallas conv1_tail_t
(interpret mode) at 32x32 and at a one-block 4x4 image (H4 = W4 = 1,
every tap a halo), f1 8, in fp32 and bf16: the pooled output, mu and var;
dk5, dgamma and dbeta through the fused backward; the conv bias gradient,
which is analytically zero under BN, as tiny on both sides. The same
against the port's own unfused composition (conv1_tail_t_reference), and
the data-only guard; the bf16 kernel's dy pass, mirrored, takes every
(window, column) of a unit once. On the CPU the fused wgrad runs its
plain PyTorch version (the tail's apply pass, then the sparse wgrad); the
kernel is held against it on the card by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_sandbox.models.convnet_s2d_t import space_to_depth_t
from tpu_sandbox.ops.pallas_conv1_tail_t import conv1_tail_t as jax_conv1_tail_t
from tpu_sandbox_torch.ops import bn_tail_t, conv1_tail_t, conv5_t
from torch_threads import one_torch_thread  # noqa: F401

F1, BLK = 8, 4
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
# out: fp32 the same f32 arithmetic in other orders -> 1e-5 of the scale;
# bf16: y1 and z round to bf16 on both sides and a sum in another order
# can move one rounding by one bf16 ulp (2^-8 relative)
REL = {"fp32": 1e-5, "bf16": 1e-2}
# gradients hold batch sums of products with t_hat: 1e-4 in fp32; in bf16
# dy is rounded once on each side and dk5 to bf16, 2e-2 as the JAX
# package's own bf16 test of this unit
GRAD_REL = {"fp32": 1e-4, "bf16": 2e-2}
# the conv bias gradient sum(dy) is analytically 0 under BN. fp32: both
# sides hold f32 summation noise around it, compared as tiny, not as
# close. bf16: dy is rounded before the sum, so the sum is the rounding
# residue, not near 0; both sides sum the same rounded values, so they
# agree to one bf16 rounding of the result.
DCBIAS_TINY = 1e-3


def _inputs(hw, seed=0, n=2):
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((n, hw, hw)).astype(np.float32)
    x = np.array(space_to_depth_t(jnp.asarray(img), 4))
    k5 = (0.3 * rng.standard_normal((5, 5, 1, F1))).astype(np.float32)
    cb = (0.1 * rng.standard_normal(F1)).astype(np.float32)
    gamma = (1.0 + 0.1 * rng.standard_normal(F1)).astype(np.float32)
    beta = (0.1 * rng.standard_normal(F1)).astype(np.float32)
    cot = rng.standard_normal((n, hw // 4, 4 * F1, hw // 4)).astype(np.float32)
    return x, k5, cb, gamma, beta, cot


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _close(got, want, rel, what=""):
    want = _np(want)
    scale = float(np.max(np.abs(want))) or 1.0
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=rel * scale,
                               err_msg=what)


def _jax_case(x, k5, cb, gamma, beta, cot):
    """JAX (out, mu, var) and the VJP in (k5, cb, gamma, beta) on the
    pooled cotangent, jitted, as numpy."""
    def run(x, k5, cb, gamma, beta, cot):
        (out, mu, var), vjp = jax.vjp(
            lambda *p: jax_conv1_tail_t(x, *p, F1, BLK), k5, cb, gamma, beta)
        grads = vjp((cot.astype(out.dtype), jnp.zeros_like(mu),
                     jnp.zeros_like(var)))
        return (out, mu, var), grads
    return jax.tree.map(np.asarray, jax.jit(run)(x, k5, cb, gamma, beta, cot))


def _torch_case(fn, x, k5, cb, gamma, beta, cot):
    params = [t.clone().requires_grad_() for t in (k5, cb, gamma, beta)]
    out, mu, var = fn(x, *params, F1, BLK)
    out.backward(cot.to(out.dtype))
    return (out, mu, var), tuple(p.grad for p in params)


@pytest.fixture(scope="module",
                params=[(hw, dt) for hw in (32, 4) for dt in DTYPES],
                ids=lambda p: f"hw{p[0]}-{p[1]}")
def case(request):
    hw, dt = request.param
    jd, td = DTYPES[dt]
    x, k5, cb, gamma, beta, cot = _inputs(hw)
    want = _jax_case(jnp.asarray(x, jd), jnp.asarray(k5, jd),
                     jnp.asarray(cb, jd), jnp.asarray(gamma),
                     jnp.asarray(beta), jnp.asarray(cot))
    tin = (torch.from_numpy(x).to(td), torch.from_numpy(k5).to(td),
           torch.from_numpy(cb).to(td), torch.from_numpy(gamma),
           torch.from_numpy(beta), torch.from_numpy(cot))
    return dict(dt=dt, td=td, want=want, tin=tin,
                got=_torch_case(conv1_tail_t.conv1_tail_t, *tin))


def _check(got, want, dt):
    (out, mu, var), (dk5, dcb, dgamma, dbeta) = got
    (jout, jmu, jvar), (jdk5, jdcb, jdgamma, jdbeta) = want
    assert tuple(out.shape) == jout.shape
    _close(out, jout, REL[dt], "out")
    _close(mu, jmu, 1e-5, "mu")              # f32 statistics on both sides
    _close(var, jvar, 1e-5, "var")
    assert tuple(dk5.shape) == jdk5.shape == (5, 5, 1, F1)
    for g, w, name in ((dk5, jdk5, "dk5"), (dgamma, jdgamma, "dgamma"),
                       (dbeta, jdbeta, "dbeta")):
        _close(g, w, GRAD_REL[dt], name)
    if dt == "bf16":
        _close(dcb, jdcb, REL[dt], "dcbias")
        return
    for v, src in ((dcb, "port"), (jdcb, "reference")):
        assert float(np.max(np.abs(_np(v)))) < DCBIAS_TINY, src


def test_forward_and_gradients_match_jax(case):
    assert case["got"][0][0].dtype == case["td"]
    _check(case["got"], case["want"], case["dt"])


def test_forward_and_gradients_match_the_unfused_reference(case):
    """Within the port: the fused unit against autograd through the
    unfused composition (conv1_s2d_t_stats, then the fused tail)."""
    ref = _torch_case(conv1_tail_t.conv1_tail_t_reference, *case["tin"])
    _check(case["got"], jax.tree.map(_np, ref), case["dt"])


def test_fused_wgrad_is_apply_then_wgrad():
    """The fused backward's plain version is the tail's apply pass, then
    the sparse wgrad on its rounded dy: bitwise, in bf16."""
    x, k5, cb, gamma, beta, cot = _inputs(32, seed=1)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    y1 = conv5_t.conv1_s2d_t_forward(
        tx, *conv5_t.prep(torch.from_numpy(k5), torch.from_numpy(cb),
                          torch.bfloat16))
    g = torch.from_numpy(cot).to(torch.bfloat16)
    _, mu, _, inv, a_col, b_col = bn_tail_t.tail_forward(
        y1, torch.from_numpy(gamma), torch.from_numpy(beta), F1, BLK, 1e-5)
    args = (y1, g, F1, BLK, a_col, b_col, mu, inv)
    s1, s2 = bn_tail_t.bwd_reduce(*args)
    cols = bn_tail_t.bwd_scales(s1, s2, torch.from_numpy(gamma), inv,
                                BLK * BLK, y1.numel() // F1)
    dw1, db = conv1_tail_t.fused_wgrad(tx, *args, *cols)
    want = conv5_t.conv1_s2d_t_wgrad(tx, bn_tail_t.bwd_apply(*args, *cols))
    assert torch.equal(dw1, want[0]) and torch.equal(db, want[1])


def test_differentiated_input_raises():
    x, k5, cb, gamma, beta, _ = _inputs(4)
    scale = torch.ones((), requires_grad=True)
    with pytest.raises(ValueError, match="ZERO input cotangent"):
        conv1_tail_t.conv1_tail_t(
            torch.from_numpy(x) * scale,
            *(torch.from_numpy(t) for t in (k5, cb, gamma, beta)), F1, BLK)


def test_non_cpu_tensor_never_takes_the_plain_path():
    x = torch.empty((1, 2, 16, 8), device="meta")
    y1 = torch.empty((1, 2, 128, 8), device="meta")
    g = torch.empty((1, 2, 32, 8), device="meta")
    col = torch.empty((128,), device="meta")
    v = torch.empty((F1,), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        conv1_tail_t.fused_wgrad(x, y1, g, F1, BLK, col, col, v, v, col, col,
                                 col)


def _dy_pass_map(cout: int, threads: int = 256, unit_w: int = 64):
    """The (window, column) pairs each thread of the bf16 fused wgrad's dy
    pass takes in one unit, in its order: thread i keeps window i % 64
    and takes the 16 columns from (i // 64)*16, starting at its lane's
    (i % 32) so that a warp's windows spread over the banks (TailDy::
    prepare in csrc/conv1_tail_t.cu)."""
    taken = []
    for i in range(threads):
        o, j0, lane = i % 64, i // 64 * 16, i % 32
        if o < cout:
            taken += [(o, j0 + (lane + s) % 16) for s in range(unit_w // 4)]
    return taken


@pytest.mark.parametrize("f1", [5, 8, 16])
def test_bf16_dy_pass_takes_every_window_and_column_once(f1):
    """At f1 5, 8 and 16 (C/4 = 20, 32, 64 windows) the dy pass computes
    each window's dy at each of the unit's 64 columns once: in place over
    its staged y1, so a pair taken twice or missed would corrupt dW1."""
    cout = 16 * f1 // 4
    taken = _dy_pass_map(cout)
    assert sorted(taken) == [(o, j) for o in range(cout) for j in range(64)]
