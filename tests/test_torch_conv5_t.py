"""The port's sparse-tap conv1 (tpu_sandbox_torch/ops/conv5_t.py) == the
JAX Pallas conv1_s2d_t, conv1_s2d_t_stats and conv1_s2d_t_wgrad
(interpret mode) at 32x32 and at a one-block 4x4 image (H4 = W4 = 1,
every tap a halo), f1 8, in fp32 and bf16: the forward, the fused BN
statistics, the fused wgrad and the autograd dk5/dbias; scatter_k5 and
gather_dk5 against JAX's, equal and adjoint; the union tile's index map
against the full-resolution image; the plain sparse conv against the
port's scattered-3x3 path; the data-only guard; the bf16 kernels' split
of the rows into persistent blocks of (row, 64-column) units, the fp32
wgrad's slabs, and the tap pairs the bf16 forward reads as one word. On
the CPU the port runs its kernels' plain PyTorch versions; the kernels
are held against those on the card by chip_smoke.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_sandbox.models.convnet_s2d_t import space_to_depth_t
from tpu_sandbox.ops import pallas_conv5_t as jax_conv5
from tpu_sandbox_torch.ops import conv5_t
from torch_threads import one_torch_thread  # noqa: F401

F1 = 8
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
# y: fp32 sums the same 25 products in another order -> 1e-5 of the
# scale. bf16: the same bf16 operands, f32 accumulation and one rounding
# on both sides, so y may differ by one bf16 rounding (2^-8 relative)
# where the f32 sums straddle a rounding boundary.
REL = {"fp32": 1e-5, "bf16": 1e-2}
# f32 sums over N*H4*W4 values of the same products (bf16 products are
# exact in f32), in other orders: 1e-5 of the scale in both dtypes
SUM_REL = 1e-5


def _inputs(hw, seed=0, n=2):
    rng = np.random.default_rng(seed)
    img = rng.standard_normal((n, hw, hw)).astype(np.float32)
    x = np.array(space_to_depth_t(jnp.asarray(img), 4))
    k5 = (0.3 * rng.standard_normal((5, 5, 1, F1))).astype(np.float32)
    b = rng.standard_normal(F1).astype(np.float32)
    g = rng.standard_normal(
        (n, hw // 4, 16 * F1, hw // 4)).astype(np.float32)
    return img, x, k5, b, g


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _close(got, want, rel, what=""):
    want = _np(want)
    scale = float(np.max(np.abs(want))) or 1.0
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=rel * scale,
                               err_msg=what)


def _jax_case(x, k5, b, g):
    """JAX forward, stats, wgrad and the VJP of conv1_s2d_t in (k5, b) on
    the cotangent g, jitted, as numpy."""
    def run(x, k5, b, g):
        y = jax_conv5.conv1_s2d_t(x, k5, b)
        stats = jax_conv5.conv1_s2d_t_stats(x, k5, b)
        wgrad = jax_conv5.conv1_s2d_t_wgrad(x, g)
        _, vjp = jax.vjp(lambda k, c: jax_conv5.conv1_s2d_t(x, k, c), k5, b)
        return y, stats, wgrad, vjp(g)
    return jax.tree.map(np.asarray, jax.jit(run)(x, k5, b, g))


@pytest.fixture(scope="module",
                params=[(hw, dt) for hw in (32, 4) for dt in DTYPES],
                ids=lambda p: f"hw{p[0]}-{p[1]}")
def case(request):
    hw, dt = request.param
    jd, td = DTYPES[dt]
    _, x, k5, b, g = _inputs(hw)
    want = _jax_case(*(jnp.asarray(a, jd) for a in (x, k5, b, g)))
    tx, tk5, tb, tg = (torch.from_numpy(a).to(td) for a in (x, k5, b, g))
    return dict(dt=dt, td=td, want=want, x=tx, k5=tk5, b=tb, g=tg)


def test_scatter_k5_matches_jax():
    _, _, k5, _, _ = _inputs(4, seed=3)
    want = np.asarray(jax_conv5.scatter_k5(jnp.asarray(k5)))
    got = conv5_t.scatter_k5(torch.from_numpy(k5)).numpy()
    assert got.shape == want.shape == (16 * F1, conv5_t.NT)
    np.testing.assert_array_equal(got, want)


def test_gather_dk5_matches_jax_and_is_the_adjoint():
    rng = np.random.default_rng(4)
    k5 = rng.standard_normal((5, 5, 1, F1)).astype(np.float32)
    w1 = rng.standard_normal((16 * F1, conv5_t.NT)).astype(np.float32)
    want = np.asarray(jax_conv5.gather_dk5(jnp.asarray(w1), F1))
    got = conv5_t.gather_dk5(torch.from_numpy(w1), F1)
    assert tuple(got.shape) == want.shape == (5, 5, 1, F1)
    # sums of the same 16 values per tap, in another order
    _close(got, want, 1e-6, "dk5")
    # <scatter(k), W> == <k, gather(W)>: the identity the VJP relies on
    lhs = float((conv5_t.scatter_k5(torch.from_numpy(k5)).double()
                 * torch.from_numpy(w1).double()).sum())
    rhs = float((torch.from_numpy(k5).double() * got.double()).sum())
    np.testing.assert_allclose(lhs, rhs, rtol=1e-6)


def test_forward_matches_jax(case):
    y = conv5_t.conv1_s2d_t(case["x"], case["k5"], case["b"])
    assert y.dtype == case["td"] and tuple(y.shape) == case["want"][0].shape
    _close(y, case["want"][0], REL[case["dt"]], "y")


def test_stats_match_jax(case):
    y, s, ss = conv5_t.conv1_s2d_t_stats(case["x"], case["k5"], case["b"])
    jy, js, jss = case["want"][1]
    assert s.dtype == ss.dtype == torch.float32
    assert tuple(s.shape) == js.shape == (16 * F1, 1)
    _close(y, jy, REL[case["dt"]], "y")
    # sums of the rounded y: in bf16 the summed values may differ by one
    # rounding, so the bf16 y tolerance holds for the sums too
    rel = SUM_REL if case["dt"] == "fp32" else REL["bf16"]
    _close(s, js, rel, "sum")
    _close(ss, jss, rel, "sumsq")
    # the sums are of the rounded y the function returns
    yf = y.float()
    _close(s[:, 0], yf.sum(dim=(0, 1, 3)), 1e-5, "sum of y")
    _close(ss[:, 0], yf.square().sum(dim=(0, 1, 3)), 1e-5, "sumsq of y")


def test_wgrad_matches_jax(case):
    dw1, db = conv5_t.conv1_s2d_t_wgrad(case["x"], case["g"])
    jdw1, jdb = case["want"][2]
    assert dw1.dtype == db.dtype == torch.float32
    assert tuple(dw1.shape) == jdw1.shape == (16 * F1, conv5_t.NT)
    assert tuple(db.shape) == jdb.shape == (16 * F1, 1)
    _close(dw1, jdw1, SUM_REL, "dW1")
    _close(db, jdb, SUM_REL, "db")


def test_autograd_dk5_dbias_match_jax(case):
    k5 = case["k5"].clone().requires_grad_()
    b = case["b"].clone().requires_grad_()
    conv5_t.conv1_s2d_t(case["x"], k5, b).backward(case["g"])
    jdk5, jdb = case["want"][3]
    assert k5.grad.dtype == case["td"] and tuple(k5.grad.shape) == jdk5.shape
    assert tuple(b.grad.shape) == jdb.shape
    # f32 sums on both sides, rounded once to the parameter dtype
    rel = SUM_REL if case["dt"] == "fp32" else REL["bf16"]
    _close(k5.grad, jdk5, rel, "dk5")
    _close(b.grad, jdb, rel, "dbias")


@pytest.mark.parametrize("hw", [32, 4])
def test_union_tile_is_the_zero_padded_image(hw):
    """Tile row (m'+2)*8 + (j+2) at block (h4, w4) is the full-resolution
    pixel (4*h4 + m', 4*w4 + j), zero outside the image."""
    img, x, *_ = _inputs(hw, seed=5, n=1)
    tile = conv5_t.union_tile_plain(torch.from_numpy(x)).numpy()
    pad = np.pad(img[0], 2)
    for mp in range(-2, 6):
        for j in range(-2, 6):
            t = (mp + 2) * 8 + (j + 2)
            for h4 in range(hw // 4):
                want = pad[4 * h4 + mp + 2, 4 * np.arange(hw // 4) + j + 2]
                np.testing.assert_array_equal(tile[0, h4, t], want)


@pytest.mark.parametrize("hw", [32, 4])
def test_sparse_conv_equals_the_scattered_3x3_path(hw):
    """Within the port, fp32: the sparse conv and the scattered-3x3 conv
    on the same operands, forward and the gradients in k5 and bias."""
    _, x, k5, b, g = _inputs(hw, seed=6)
    tx, tg = torch.from_numpy(x), torch.from_numpy(g)
    out = []
    for fn in (conv5_t.conv1_s2d_t, conv5_t.conv1_s2d_t_reference):
        tk5 = torch.from_numpy(k5).requires_grad_()
        tb = torch.from_numpy(b).requires_grad_()
        y = fn(tx, tk5, tb)
        y.backward(tg)
        out.append((y, tk5.grad, tb.grad))
    # 25 taps here, 144 (mostly zero) there, summed in other orders
    for got, want, name in zip(out[0], out[1], ("y", "dk5", "dbias")):
        _close(got, want, 1e-5, name)


def test_differentiated_input_raises():
    """The x cotangent is never computed, so an x that requires grad
    raises instead of getting a silent zero; data x still differentiates
    in the weights, and a forward under no_grad is allowed."""
    _, x, k5, b, _ = _inputs(4)
    x = torch.from_numpy(x)
    k5 = torch.from_numpy(k5).requires_grad_()
    b = torch.from_numpy(b)
    scale = torch.ones((), requires_grad=True)
    with pytest.raises(ValueError, match="ZERO input cotangent"):
        conv5_t.conv1_s2d_t(x * scale, k5, b)
    with pytest.raises(ValueError, match="ZERO input cotangent"):
        conv5_t.conv1_s2d_t_stats(x * scale, k5, b)
    conv5_t.conv1_s2d_t(x, k5, b).sum().backward()
    assert k5.grad is not None and k5.grad.shape == k5.shape
    with torch.no_grad():
        conv5_t.conv1_s2d_t(x * scale, k5, b)


def test_non_cpu_tensor_never_takes_the_plain_path():
    """A tensor that is not on the CPU goes to the kernel wrapper, which
    raises for anything it cannot launch on (here a meta tensor)."""
    x = torch.empty((1, 2, 16, 8), device="meta")
    w1 = torch.empty((128, 64), device="meta")
    b = torch.empty((128,), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        conv5_t.conv1_s2d_t_forward(x, w1, b)
    with pytest.raises(ValueError, match="CUDA"):
        conv5_t.conv1_s2d_t_stats_forward(x, w1, b)
    with pytest.raises(ValueError, match="CUDA"):
        conv5_t.conv1_s2d_t_wgrad(x, torch.empty((1, 2, 128, 8),
                                                 device="meta"))


def test_input_that_is_not_the_s2d_image_raises():
    with pytest.raises(ValueError, match="1-channel-input"):
        conv5_t.conv1_s2d_t_plain(torch.zeros((1, 2, 4, 3)),
                                  torch.zeros((128, 64)), torch.zeros(128))


@pytest.mark.parametrize("rows", [1, 3, 10, 21, 3750])
def test_bf16_units_cover_every_row_and_column_tile_once(rows):
    """The bf16 forward's and wgrad's persistent blocks take contiguous
    runs of (row, UNIT_W-column) units: every unit once, every block
    non-empty, at most ``slots`` blocks, at odd W, at W one past a unit
    and at the main path's W 750."""
    for w in (1, 64, 65, 75, 750):
        tiles = -(-w // conv5_t.UNIT_W)
        for slots in (132, 7, 1):
            blocks, per = conv5_t.units_plan(rows, w, slots)
            seen = [(u // tiles, u % tiles) for b in range(blocks)
                    for u in range(b * per, min(rows * tiles, (b + 1) * per))]
            assert seen == [(r, t) for r in range(rows) for t in range(tiles)]
            assert all(b * per < rows * tiles for b in range(blocks))
            assert blocks <= slots


@pytest.mark.parametrize("rows", [1, 3, 10, 21, 3750])
def test_wgrad_splits_cover_every_row_once(rows):
    """The fp32 wgrad's slabs and the bf16 wgrad's blocks of units each
    take every row once: a row's units are all in one block or in
    consecutive ones."""
    slabs, per = conv5_t.wgrad_slabs(rows)
    assert [r // per for r in range(rows)] == sorted(
        r // per for r in range(rows))
    assert sorted({r // per for r in range(rows)}) == list(range(slabs))
    tiles = -(-750 // conv5_t.UNIT_W)
    blocks, per = conv5_t.units_plan(rows, 750, 132)
    rows_of = [sorted({u // tiles for u in range(b * per,
                                                  min(rows * tiles,
                                                      (b + 1) * per))})
               for b in range(blocks)]
    assert sorted({r for rs in rows_of for r in rs}) == list(range(rows))
    assert sum(len(rs) for rs in rows_of) <= rows + blocks - 1


def test_tap_pairs_are_adjacent_channels_of_one_strip_row():
    """The bf16 forward reads taps 2p and 2p+1 as one 32-bit word of its
    [block row][column][16 channels] copy of x: the two share their block
    row and column offset and are channels 2q and 2q+1. So the kernels
    keep the union tile's tap order (that of scatter_k5 and gather_dk5),
    and the tile rows 2p, 2p+1 are those two channels of x, shifted."""
    _, x, *_ = _inputs(32, seed=7, n=1)
    tile = conv5_t.union_tile_plain(torch.from_numpy(x)).numpy()
    xp = np.pad(x, ((0, 0), (1, 1), (0, 0), (1, 1)))
    h4, w4 = x.shape[1], x.shape[3]
    for p in range(conv5_t.NT // 2):
        rr0, ch0, dc0 = conv5_t._tap(2 * p)
        rr1, ch1, dc1 = conv5_t._tap(2 * p + 1)
        assert (rr0, dc0) == (rr1, dc1) and ch0 % 2 == 0 and ch1 == ch0 + 1
        for k, ch in ((0, ch0), (1, ch1)):
            np.testing.assert_array_equal(
                tile[0, :, 2 * p + k], xp[0, rr0:rr0 + h4, ch, dc0:dc0 + w4])
