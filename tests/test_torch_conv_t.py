"""The port's transposed-layout 3x3 conv (tpu_sandbox_torch/ops/conv_t.py)
== the JAX Pallas conv3x3_t, conv3x3_t_stats and conv3x3_t_wgrad
(interpret mode): the forward, the fused BN statistics, the VJP (dx, dw,
db) and the fused wgrad alone, in fp32 and bf16,
at W not divisible by the CUDA kernel's 64-column tile. On the CPU the
port runs the plain PyTorch versions of its kernels; the kernels are held
against those on the card by chip_smoke.py."""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_sandbox.ops.pallas_conv_t import conv3x3_t as jax_conv3x3_t
from tpu_sandbox.ops.pallas_conv_t import conv3x3_t_stats as jax_stats
from tpu_sandbox.ops.pallas_conv_t import conv3x3_t_wgrad as jax_wgrad
from tpu_sandbox_torch.ops import conv_t
from torch_threads import one_torch_thread  # noqa: F401

# (N, H, C, W, CO): W=13 and W=70 are not multiples of the 64-wide tile
SHAPES = [(2, 6, 16, 13, 24), (1, 4, 16, 70, 32)]
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
# fp32: both accumulate 9C products in f32 in other orders -> 1e-5 of the
# scale. bf16: the inputs are the same bf16 values and both accumulate in
# f32 and round once, so the outputs differ by at most one bf16 rounding
# (2^-8 relative) where the f32 sums straddle a rounding boundary.
REL = {"fp32": 1e-5, "bf16": 1e-2}


def _case(shape, dt, seed=0):
    n, h, c, w, co = shape
    rng = np.random.default_rng(seed)
    jd, td = DTYPES[dt]
    x = rng.standard_normal((n, h, c, w)).astype(np.float32)
    wt = (0.2 * rng.standard_normal((3, 3, c, co))).astype(np.float32)
    b = rng.standard_normal(co).astype(np.float32)
    g = rng.standard_normal((n, h, co, w)).astype(np.float32)
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
    want = jax_conv3x3_t(x, w, b)
    got = conv_t.conv3x3_t(tx, tw, tb)
    assert got.dtype == tx.dtype and got.shape == tuple(want.shape)
    _close(got, want, REL[dt])


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES)
def test_vjp_matches_jax(shape, dt):
    (x, w, b, g), (tx, tw, tb, tg) = _case(shape, dt, seed=1)
    _, vjp = jax.vjp(jax_conv3x3_t, x, w, b)
    jdx, jdw, jdb = jax.jit(vjp)(g)
    for t in (tx, tw, tb):
        t.requires_grad_()
    conv_t.conv3x3_t(tx, tw, tb).backward(tg)
    for got, want, nm in ((tx.grad, jdx, "dx"), (tw.grad, jdw, "dw"),
                          (tb.grad, jdb, "db")):
        assert tuple(got.shape) == tuple(want.shape), nm
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
    y, s, ss = conv_t.conv3x3_t_stats(tx, tw, tb)
    assert y.dtype == tx.dtype and s.dtype == ss.dtype == torch.float32
    assert tuple(s.shape) == tuple(js.shape) == (shape[-1], 1)
    _close(y, jy, REL[dt], "y")
    rel = 1e-5 if dt == "fp32" else REL[dt]
    _close(s, js, rel, "sum")
    _close(ss, jss, rel, "sumsq")
    # the sums are of the rounded y the function returns
    yf = y.float()
    _close(s[:, 0], yf.sum(dim=(0, 1, 3)), 1e-5, "sum of y")
    _close(ss[:, 0], yf.square().sum(dim=(0, 1, 3)), 1e-5, "sumsq of y")


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_stats_vjp_matches_jax(dt):
    """The stats variant's VJP is the conv's: the sums' cotangents are
    ignored on both sides (JAX gets nonzero ones here; the port's sums
    are not differentiable)."""
    (x, w, b, g), (tx, tw, tb, tg) = _case(SHAPES[0], dt, seed=5)
    _, vjp = jax.vjp(jax_stats, x, w, b)
    co = w.shape[-1]
    ones = jnp.ones((co, 1), jnp.float32)
    jdx, jdw, jdb = jax.jit(vjp)((g, ones, ones))
    for t in (tx, tw, tb):
        t.requires_grad_()
    y, s, ss = conv_t.conv3x3_t_stats(tx, tw, tb)
    assert not s.requires_grad and not ss.requires_grad
    y.backward(tg)
    for got, want, nm in ((tx.grad, jdx, "dx"), (tw.grad, jdw, "dw"),
                          (tb.grad, jdb, "db")):
        assert tuple(got.shape) == tuple(want.shape), nm
        _close(got, want, REL[dt], nm)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_wgrad_alone_matches_jax(dt):
    (x, _, _, g), (tx, _, _, tg) = _case(SHAPES[0], dt, seed=2)
    jdw, jdb = jax.jit(jax_wgrad)(x, g)
    dwt, db = conv_t.conv3x3_t_wgrad(tx, tg)
    assert dwt.dtype == torch.float32 and db.dtype == torch.float32
    assert tuple(dwt.shape) == tuple(jdw.shape)
    assert tuple(db.shape) == tuple(jdb.shape)
    # both f32 sums over N*H*W products of the same inputs
    _close(dwt, jdw, 1e-5, "dwT")
    _close(db, jdb, 1e-5, "db")


def test_plain_forward_is_the_tap_sum():
    """The plain version against a direct loop over pixels and taps."""
    (_, _, _, _), (x, w, b, _) = _case((1, 3, 2, 4, 3), "fp32", seed=3)
    y = conv_t.conv3x3_t_plain(x, w, b)
    n, h, c, wd = x.shape
    want = np.zeros((n, h, w.shape[-1], wd), np.float32)
    xn, wn, bn = x.numpy(), w.numpy(), b.numpy()
    for i in range(h):
        for j in range(wd):
            acc = bn.astype(np.float64).copy()
            for dy in range(3):
                for dx in range(3):
                    ii, jj = i + dy - 1, j + dx - 1
                    if 0 <= ii < h and 0 <= jj < wd:
                        acc += xn[0, ii, :, jj] @ wn[dy, dx]
            want[0, i, :, j] = acc
    np.testing.assert_allclose(y.numpy(), want, rtol=1e-6, atol=1e-6)


def test_input_grad_skipped_when_not_needed():
    """conv1's input is not differentiated: the dgrad pass must not run."""
    (_, _, _, _), (x, w, b, g) = _case(SHAPES[0], "fp32")
    w.requires_grad_()
    b.requires_grad_()
    real = conv_t.conv3x3_t_forward
    kinds = []

    def spy(*args, kind="fwd"):
        kinds.append(kind)
        return real(*args, kind=kind)

    with mock.patch.object(conv_t, "conv3x3_t_forward", spy):
        conv_t.conv3x3_t(x, w, b).backward(g)
    assert kinds == ["fwd"]
    assert w.grad is not None and b.grad is not None


def test_non_cpu_tensor_never_takes_the_plain_path():
    """A tensor that is not on the CPU goes to the kernel wrapper, which
    raises for anything it cannot launch on (here a meta tensor)."""
    x = torch.empty((1, 4, 16, 8), device="meta")
    w = torch.empty((3, 3, 16, 8), device="meta")
    b = torch.empty((8,), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        conv_t.conv3x3_t_forward(x, w, b)
    with pytest.raises(ValueError, match="CUDA"):
        conv_t.conv3x3_t_wgrad(x, torch.empty((1, 4, 8, 8), device="meta"))


def test_stats_on_a_non_cpu_tensor_never_takes_the_plain_path():
    x = torch.empty((1, 4, 16, 8), device="meta")
    w = torch.empty((3, 3, 16, 8), device="meta")
    b = torch.empty((8,), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        conv_t.conv3x3_t_stats_forward(x, w, b)


@pytest.mark.parametrize("rows", [1, 7, 128, 129, 3750])
def test_wgrad_slabs_cover_every_row_once(rows):
    """Slab s takes rows [s*per, (s+1)*per): every row once, every slab
    non-empty, and the slabs times the (co, k) tiles within the blocks the
    card holds at once (or one slab where the tiles alone exceed them)."""
    for tiles, slots in ((1, 128), (2, 132), (1, 132), (18, 528), (200, 132)):
        slabs, per = conv_t.wgrad_slabs(rows, tiles, slots)
        covered = [r // per for r in range(rows)]
        assert sorted(set(covered)) == list(range(slabs))
        assert slabs * per >= rows > (slabs - 1) * per
        assert slabs * tiles <= max(slots, tiles)


@pytest.mark.parametrize("rows,wtiles,cotiles,slots", [
    (3750, 6, 1, 132), (3750, 3, 1, 132), (3750, 6, 2, 264), (10, 1, 1, 132),
    (1, 1, 1, 132), (15, 2, 3, 4), (7, 5, 1, 1)])
def test_fwd_units_cover_every_row_and_w_tile_once(rows, wtiles, cotiles,
                                                    slots):
    """The bf16 forward's blocks take contiguous runs of (row, W tile)
    units: every unit once, every block non-empty, at most one wave of
    the card per channel tile where there are units enough."""
    blocks, per = conv_t.fwd_units(rows, wtiles, cotiles, slots)
    seen = [(u // wtiles, u % wtiles) for b in range(blocks)
            for u in range(b * per, min(rows * wtiles, (b + 1) * per))]
    assert seen == [(r, t) for r in range(rows) for t in range(wtiles)]
    assert all(b * per < rows * wtiles for b in range(blocks))
    assert blocks <= max(1, slots // cotiles)
