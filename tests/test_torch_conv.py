"""The port's NHWC 3x3 conv (tpu_sandbox_torch/ops/conv.py) == the JAX
Pallas conv3x3 and conv3x3_stats (interpret mode): the forward, the fused
BN statistics, the VJP (dx through the flipped-weight forward, dw, db)
and the fused wgrad alone, in fp32 and bf16, at C16->CO32 and C8->CO16,
W=12 and W=1 (every tap of a row a halo but the centre). On the CPU the
port runs the plain PyTorch versions of its kernels; the kernels are held
against those on the card by chip_smoke.py."""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_sandbox.ops.pallas_conv import conv3x3 as jax_conv3x3
from tpu_sandbox.ops.pallas_conv import conv3x3_reference as jax_reference
from tpu_sandbox.ops.pallas_conv import conv3x3_stats as jax_stats
from tpu_sandbox_torch.ops import conv
from torch_threads import one_torch_thread  # noqa: F401

# (N, H, W, C, CO)
SHAPES = [(2, 5, 12, 16, 32), (1, 4, 1, 8, 16)]
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
# fp32: both accumulate 9C products in f32 in other orders -> 1e-5 of the
# scale. bf16: the inputs are the same bf16 values and both accumulate in
# f32 and round once, so the outputs differ by at most one bf16 rounding
# (2^-8 relative) where the f32 sums straddle a rounding boundary; the
# weight gradients are cast to bf16 on both sides.
REL = {"fp32": 1e-5, "bf16": 1e-2}


def _case(shape, dt, seed=0):
    n, h, w, c, co = shape
    rng = np.random.default_rng(seed)
    jd, td = DTYPES[dt]
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    wt = (0.2 * rng.standard_normal((3, 3, c, co))).astype(np.float32)
    b = rng.standard_normal(co).astype(np.float32)
    g = rng.standard_normal((n, h, w, co)).astype(np.float32)
    jax_in = [jnp.asarray(a, jd) for a in (x, wt, b, g)]
    torch_in = [torch.from_numpy(a).to(td) for a in (x, wt, b, g)]
    return jax_in, torch_in


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _close(got, want, rel, what=""):
    want = _np(want)
    scale = float(np.max(np.abs(want))) or 1.0
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=rel * scale,
                               err_msg=what)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_forward_matches_jax(shape, dt):
    (x, w, b, _), (tx, tw, tb, _) = _case(shape, dt)
    want = jax_conv3x3(x, w, b)
    got = conv.conv3x3(tx, tw, tb)
    assert got.dtype == tx.dtype and got.shape == tuple(want.shape)
    _close(got, want, REL[dt])


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_vjp_matches_jax(shape, dt):
    (x, w, b, g), (tx, tw, tb, tg) = _case(shape, dt, seed=1)
    _, vjp = jax.vjp(jax_conv3x3, x, w, b)
    jdx, jdw, jdb = jax.jit(vjp)(g)
    for t in (tx, tw, tb):
        t.requires_grad_()
    conv.conv3x3(tx, tw, tb).backward(tg)
    for got, want, nm in ((tx.grad, jdx, "dx"), (tw.grad, jdw, "dw"),
                          (tb.grad, jdb, "db")):
        assert tuple(got.shape) == tuple(want.shape), nm
        assert got.dtype == DTYPES[dt][1], nm
        _close(got, want, REL[dt], nm)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_stats_match_jax(shape, dt):
    """y, and the f32 sum and sum of squares of the ROUNDED y per channel
    (sums over N*H*W values in other orders: 1e-5 of the scale; in bf16
    the summed values are the rounded outputs, which may differ by one
    rounding, so the bf16 y tolerance holds for the sums too)."""
    (x, w, b, _), (tx, tw, tb, _) = _case(shape, dt, seed=4)
    jy, js, jss = jax_stats(x, w, b)
    y, s, ss = conv.conv3x3_stats(tx, tw, tb)
    assert y.dtype == tx.dtype and s.dtype == ss.dtype == torch.float32
    assert tuple(s.shape) == tuple(js.shape) == (1, shape[-1])
    _close(y, jy, REL[dt], "y")
    rel = 1e-5 if dt == "fp32" else REL[dt]
    _close(s, js, rel, "sum")
    _close(ss, jss, rel, "sumsq")
    # the sums are of the rounded y the function returns
    yf = y.float()
    _close(s[0], yf.sum(dim=(0, 1, 2)), 1e-5, "sum of y")
    _close(ss[0], yf.square().sum(dim=(0, 1, 2)), 1e-5, "sumsq of y")


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_stats_vjp_matches_jax(shape, dt):
    """The stats variant's VJP is the conv's: the sums' cotangents are
    ignored on both sides (JAX gets nonzero ones here; the port's sums
    are not differentiable)."""
    (x, w, b, g), (tx, tw, tb, tg) = _case(shape, dt, seed=5)
    _, vjp = jax.vjp(jax_stats, x, w, b)
    ones = jnp.ones((1, w.shape[-1]), jnp.float32)
    jdx, jdw, jdb = jax.jit(vjp)((g, ones, ones))
    for t in (tx, tw, tb):
        t.requires_grad_()
    y, s, ss = conv.conv3x3_stats(tx, tw, tb)
    assert not s.requires_grad and not ss.requires_grad
    y.backward(tg)
    for got, want, nm in ((tx.grad, jdx, "dx"), (tw.grad, jdw, "dw"),
                          (tb.grad, jdb, "db")):
        assert tuple(got.shape) == tuple(want.shape), nm
        _close(got, want, REL[dt], nm)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_wgrad_alone_matches_jax_f32_gradient(shape, dt):
    """The fused wgrad's f32 (dw [9C, CO], db [1, CO]) against the f32 VJP
    of the JAX function on the same (bf16-valued) inputs: both f32 sums
    over N*H*W products, 1e-5 of the scale."""
    (x, w, b, g), (tx, _, _, tg) = _case(shape, dt, seed=2)
    f32 = lambda t: jnp.asarray(t, jnp.float32)  # noqa: E731
    _, vjp = jax.vjp(jax_conv3x3, f32(x), f32(w), f32(b))
    _, jdw, jdb = jax.jit(vjp)(f32(g))
    dw, db = conv.conv3x3_wgrad(tx, tg)
    c, co = shape[3], shape[4]
    assert dw.dtype == db.dtype == torch.float32
    assert tuple(dw.shape) == (9 * c, co) and tuple(db.shape) == (1, co)
    _close(dw, np.asarray(jdw).reshape(9 * c, co), 1e-5, "dw")
    _close(db, np.asarray(jdb)[None], 1e-5, "db")


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_reference_matches_jax_reference(dt):
    """The library conv of the unfused plan (``F.conv2d`` then the bias,
    each rounded to the dtype) against JAX's lax.conv reference."""
    (x, w, b, _), (tx, tw, tb, _) = _case(SHAPES[0], dt, seed=6)
    got = conv.conv3x3_reference(tx, tw, tb)
    assert got.dtype == tx.dtype
    _close(got, jax_reference(x, w, b), REL[dt])


def test_plain_forward_is_the_tap_sum():
    """The plain version against a direct loop over pixels and taps."""
    (_, _, _, _), (x, w, b, _) = _case((1, 3, 4, 2, 3), "fp32", seed=3)
    y = conv.conv3x3_plain(x, w, b)
    n, h, wd, c = x.shape
    want = np.zeros((n, h, wd, w.shape[-1]), np.float32)
    xn, wn, bn = x.numpy(), w.numpy(), b.numpy()
    for i in range(h):
        for j in range(wd):
            acc = bn.astype(np.float64).copy()
            for dy in range(3):
                for dx in range(3):
                    ii, jj = i + dy - 1, j + dx - 1
                    if 0 <= ii < h and 0 <= jj < wd:
                        acc += xn[0, ii, jj] @ wn[dy, dx]
            want[0, i, j] = acc
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-6, atol=1e-6)


def test_input_grad_skipped_when_not_needed():
    """conv1's input is not differentiated: the dgrad pass must not run."""
    (_, _, _, _), (x, w, b, g) = _case(SHAPES[0], "fp32")
    w.requires_grad_()
    b.requires_grad_()
    real = conv.conv3x3_forward
    kinds = []

    def spy(*args, kind="fwd"):
        kinds.append(kind)
        return real(*args, kind=kind)

    with mock.patch.object(conv, "conv3x3_forward", spy):
        conv.conv3x3(x, w, b).backward(g)
    assert kinds == ["fwd"]
    assert w.grad is not None and b.grad is not None


def test_non_cpu_tensor_never_takes_the_plain_path():
    """A tensor that is not on the CPU goes to the kernel wrapper, which
    raises for anything it cannot launch on (here a meta tensor)."""
    x = torch.empty((1, 4, 8, 16), device="meta")
    w = torch.empty((3, 3, 16, 16), device="meta")
    b = torch.empty((16,), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        conv.conv3x3_forward(x, w, b)
    with pytest.raises(ValueError, match="CUDA"):
        conv.conv3x3_stats_forward(x, w, b)
    with pytest.raises(ValueError, match="CUDA"):
        conv.conv3x3_wgrad(x, torch.empty((1, 4, 8, 16), device="meta"))


@pytest.mark.parametrize("c,co", [(144, 16), (24, 16), (16, 24)])
def test_bf16_forward_refuses_what_its_kernel_cannot_take(c, co):
    """The bf16 forward's kernel holds a [9C, CO] weight tile and a ring of
    input rows in one block's shared memory and works in 16-channel steps:
    C above MAX_BF16_FWD_C, or C or CO off a multiple of 16, is refused
    before any launch (the plain version on the CPU takes any shape)."""
    x = torch.empty((1, 4, 8, c), dtype=torch.bfloat16, device="meta")
    w = torch.empty((3, 3, c, co), dtype=torch.bfloat16, device="meta")
    b = torch.empty((co,), dtype=torch.bfloat16, device="meta")
    for fwd in (conv.conv3x3_forward, conv.conv3x3_stats_forward):
        with pytest.raises(ValueError, match="multiples of 16"):
            fwd(x, w, b)


@pytest.mark.parametrize("n,h,w,tiles", [
    (5, 750, 750, 2), (1, 3, 65, 2), (140, 1, 65, 2), (2, 67, 130, 2),
    (2, 5, 70, 1), (3, 7, 75, 3), (1, 4, 1, 1)])
def test_bf16_wgrad_runs_cover_every_unit_once_in_order(n, h, w, tiles):
    """The bf16 wgrad's persistent blocks: run b of each (channel chunk, co)
    tile takes units [b*per, (b+1)*per), which the kernel walks as column
    f // H (image, W tile of WGRAD_UNIT_W pixels) and row f % H. Over the
    runs every (n, W tile, h) unit comes once, in order, every run is
    non-empty, and the runs times the tiles fill at most the card's 132
    blocks where there are units enough."""
    slots = 132
    runs, per = conv.wgrad_units(n * h, w, tiles, slots)
    wtiles = -(-w // conv.WGRAD_UNIT_W)
    total = n * wtiles * h
    seen = [(f // h // wtiles, f // h % wtiles, f % h)
            for b in range(runs) for f in range(b * per, min(total,
                                                             (b + 1) * per))]
    assert seen == [(i, t, r) for i in range(n) for t in range(wtiles)
                    for r in range(h)]
    assert all(b * per < total for b in range(runs))
    assert runs <= max(1, slots // tiles)
