"""The port's NHWC fused BN/ReLU/pool tail (tpu_sandbox_torch/ops/bn_tail.py)
== the JAX Pallas fused_bn_relu_pool (interpret mode) at the geometries
of tests/test_pallas_bn_tail.py, (blk, co) = (4, 4), (2, 16) and (4, 16),
plus the main path's bn2 (2, 32) and (2, 4), whose co the kernels' 16-byte
path cannot take, in fp32 and bf16: the pooled output, mu and var; dy,
dgamma and dbeta (the reduce pass's s2 and s1); the bf16 tie case; the
ysums path; and unfused_reference. On the CPU the port runs its kernels'
plain PyTorch versions; the kernels are held against those on the card
by chip_smoke.py. Here too: a Python mirror of the passes' walk in
csrc/bn_tail.cu (which thread takes which pixel and channels, and where
its accesses fall) and of the reduce's fixed-order combine of its sums,
the host's slab plan, and the ctypes signatures against the C ones."""

import ctypes
import re
from collections import Counter
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_sandbox.ops import pallas_bn_tail as jax_tail
from tpu_sandbox_torch.ops import bn_tail
from torch_threads import one_torch_thread  # noqa: F401

GEOMS = [(4, 4, 12), (2, 16, 8), (4, 16, 8), (2, 32, 6), (2, 4, 6)]  # (blk, co, hw)
DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
# fp32: the same f32 arithmetic in other orders (means, sums over the
# batch; XLA may contract y*a + b into an FMA): 1e-5 of the scale.
# bf16: z is rounded to bf16 on both sides, and an FMA or another
# summation order of mu can move one rounding by one bf16 ulp (2^-8
# relative); dy is rounded to bf16 once on each side.
REL = {"fp32": 1e-5, "bf16": 1e-2}
# gradients hold sums over the batch of products with t_hat: 1e-4 in fp32
GRAD_REL = {"fp32": 1e-4, "bf16": 1e-2}


def _inputs(blk, co, hw, seed=0, n=2):
    rng = np.random.default_rng(seed)
    c = blk * blk * co
    y = rng.standard_normal((n, hw, hw, c)).astype(np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(co)).astype(np.float32)
    beta = rng.standard_normal(co).astype(np.float32)
    cot = rng.standard_normal((n, hw, hw, c // 4)).astype(np.float32)
    return y, gamma, beta, cot


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t, jnp.float32))


def _close(got, want, rel, what=""):
    want = _np(want)
    scale = float(np.max(np.abs(want))) or 1.0
    np.testing.assert_allclose(_np(got), want, rtol=0, atol=rel * scale,
                               err_msg=what)


def _ysums(y):
    """Per-channel [1,C] sums of y and y*y, in f32."""
    yf = y.astype(np.float32)
    return (yf.sum(axis=(0, 1, 2))[None],
            np.square(yf).sum(axis=(0, 1, 2))[None])


def _jax_case(y, gamma, beta, cot, co, blk, ysums=None):
    """JAX forward (out, mu, var) and its VJP (dy, dgamma, dbeta) on the
    pooled cotangent, jitted, as numpy."""
    def run(y, gamma, beta, cot):
        (out, mu, var), vjp = jax.vjp(
            lambda y, g, b: jax_tail.fused_bn_relu_pool(
                y, g, b, co, blk, 1e-5, None, ysums), y, gamma, beta)
        dy, dg, db = vjp((cot.astype(out.dtype), jnp.zeros_like(mu),
                          jnp.zeros_like(var)))
        return out, mu, var, dy, dg, db
    return [np.asarray(jnp.asarray(t, jnp.float32))
            for t in jax.jit(run)(y, gamma, beta, cot)]


def _torch_case(y, gamma, beta, cot, co, blk, ysums=None):
    ty, tg, tb = (t.clone().requires_grad_() for t in (y, gamma, beta))
    out, mu, var = bn_tail.fused_bn_relu_pool(ty, tg, tb, co, blk,
                                              ysums=ysums)
    out.backward(cot.to(out.dtype))
    return out, mu, var, ty.grad, tg.grad, tb.grad


@pytest.fixture(scope="module", params=[(g, d) for g in GEOMS for d in DTYPES],
                ids=lambda p: f"blk{p[0][0]}-co{p[0][1]}-hw{p[0][2]}-{p[1]}")
def case(request):
    (blk, co, hw), dt = request.param
    jd, td = DTYPES[dt]
    y, gamma, beta, cot = _inputs(blk, co, hw)
    want = _jax_case(jnp.asarray(y, jd), jnp.asarray(gamma),
                     jnp.asarray(beta), jnp.asarray(cot), co, blk)
    got = _torch_case(torch.from_numpy(y).to(td), torch.from_numpy(gamma),
                      torch.from_numpy(beta), torch.from_numpy(cot), co, blk)
    return dict(dt=dt, want=want, got=got)


def test_forward_matches_jax(case):
    got, want, dt = case["got"], case["want"], case["dt"]
    assert got[0].dtype == DTYPES[dt][1]
    assert tuple(got[0].shape) == want[0].shape
    _close(got[0], want[0], REL[dt], "out")
    _close(got[1], want[1], 1e-5, "mu")     # f32 statistics on both sides
    _close(got[2], want[2], 1e-5, "var")


def test_gradients_match_jax(case):
    """dy, and dgamma = s2 and dbeta = s1 of the reduce pass, folded over
    the groups."""
    got, want, dt = case["got"], case["want"], case["dt"]
    for i, name in ((3, "dy"), (4, "dgamma"), (5, "dbeta")):
        assert tuple(got[i].shape) == want[i].shape, name
        _close(got[i], want[i], GRAD_REL[dt], name)


def test_bf16_tie_routing_is_exact_and_dy_within_one_ulp():
    """Inputs quantised to quarters with gamma 1 and beta 0, so that the
    bf16-rounded z has exact ties in pool windows: the port's routing
    equals JAX's _route on the same rounded z, and dy through the whole
    backward is within one bf16 ulp of max|dy|."""
    rng = np.random.default_rng(7)
    co, blk = 8, 2
    y = (np.round(rng.standard_normal((2, 4, 4, blk * blk * co)) * 4)
         / 4).astype(np.float32)
    cot = rng.standard_normal((2, 4, 4, co)).astype(np.float32)
    gamma, beta = np.ones(co, np.float32), np.zeros(co, np.float32)
    ty = torch.from_numpy(y).to(torch.bfloat16)
    tcot = torch.from_numpy(cot).to(torch.bfloat16)
    mu, var = bn_tail.stats(ty, co)
    inv = torch.rsqrt(var + 1e-5)
    a = bn_tail.col_expand(inv, blk * blk)
    b = bn_tail.col_expand(-mu * inv, blk * blk)
    got_dz = bn_tail._dz(ty, tcot, co, blk, a, b).numpy()
    z = bn_tail._rounded_relu(ty, a, b).numpy()
    g_exp = jnp.asarray(_np(tcot)) @ jnp.asarray(
        jax_tail.selection_matrix(blk, co).T)
    want_dz = np.asarray(jax_tail._route(jnp.asarray(z), g_exp, co, blk)
                         * (z > 0))
    zw = bn_tail._windows(torch.from_numpy(z), blk, co)
    pair = zw[..., :, 0, :, 0, :]
    assert ((pair == zw[..., :, 0, :, 1, :]) & (pair > 0)).any(), "no tie"
    np.testing.assert_array_equal(got_dz + 0.0, want_dz + 0.0)
    want = _jax_case(jnp.asarray(y, jnp.bfloat16), jnp.asarray(gamma),
                     jnp.asarray(beta), jnp.asarray(cot), co, blk)
    got = _torch_case(ty, torch.from_numpy(gamma), torch.from_numpy(beta),
                      torch.from_numpy(cot), co, blk)
    _close(got[0], want[0], 0.0, "out")
    _close(got[3], want[3], 2.0 ** -8, "dy")


@pytest.mark.parametrize("blk,co,hw", [(2, 16, 8), (4, 4, 12)])
def test_ysums_path_matches_jax_and_sums_get_zero_cotangents(blk, co, hw):
    """The statistics from per-lane [1, C] sums (count = y.size // co),
    as conv3x3_stats gives them, against JAX's ysums path; the sums get
    zero cotangents, and the result equals the tail's own statistics."""
    y, gamma, beta, cot = _inputs(blk, co, hw, seed=4)
    s, ss = _ysums(y)
    want = _jax_case(jnp.asarray(y), jnp.asarray(gamma), jnp.asarray(beta),
                     jnp.asarray(cot), co, blk,
                     ysums=(jnp.asarray(s), jnp.asarray(ss)))
    ts = torch.from_numpy(s).requires_grad_()
    tss = torch.from_numpy(ss).requires_grad_()
    got = _torch_case(torch.from_numpy(y), torch.from_numpy(gamma),
                      torch.from_numpy(beta), torch.from_numpy(cot), co, blk,
                      ysums=(ts, tss))
    for g, w, name in zip(got, want, ("out", "mu", "var", "dy", "dgamma",
                                      "dbeta")):
        _close(g, w, 1e-4 if name.startswith("d") else 1e-5, name)
    assert torch.count_nonzero(ts.grad) == 0
    assert torch.count_nonzero(tss.grad) == 0
    own = _torch_case(torch.from_numpy(y), torch.from_numpy(gamma),
                      torch.from_numpy(beta), torch.from_numpy(cot), co, blk)
    for g, o, name in zip(got, own, ("out", "mu", "var", "dy")):
        _close(g, o, 1e-5, name)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_unfused_reference_and_stats_match_jax(dt):
    blk, co, hw = 4, 4, 12
    jd, td = DTYPES[dt]
    y, gamma, beta, _ = _inputs(blk, co, hw, seed=3)
    want = jax.jit(lambda *a: jax_tail.unfused_reference(*a, co, blk))(
        jnp.asarray(y, jd), jnp.asarray(gamma), jnp.asarray(beta))
    ty = torch.from_numpy(y).to(td)
    got = bn_tail.unfused_reference(ty, torch.from_numpy(gamma),
                                    torch.from_numpy(beta), co, blk)
    for g, w, name in zip(got, want, ("out", "mu", "var")):
        _close(g, w, REL[dt] if name == "out" else 1e-5, name)
    jmu, jvar = jax_tail._stats(jnp.asarray(y, jd), co)
    mu, var = bn_tail.stats(ty, co)
    _close(mu, jmu, 1e-5, "_stats mu")
    _close(var, jvar, 1e-5, "_stats var")


@pytest.mark.parametrize("blk,co,hw", GEOMS)
def test_fused_equals_the_unfused_chain(blk, co, hw):
    """Within the port: the fused function's forward and gradients equal
    autograd through the unfused chain (fp32)."""
    y, gamma, beta, cot = _inputs(blk, co, hw, seed=5)
    got = _torch_case(torch.from_numpy(y), torch.from_numpy(gamma),
                      torch.from_numpy(beta), torch.from_numpy(cot), co, blk)
    ty, tg, tb = (torch.from_numpy(t).requires_grad_()
                  for t in (y, gamma, beta))
    out, mu, var = bn_tail.unfused_reference(ty, tg, tb, co, blk)
    out.backward(torch.from_numpy(cot))
    for g, w, name in zip(got, (out, mu, var, ty.grad, tg.grad, tb.grad),
                          ("out", "mu", "var", "dy", "dgamma", "dbeta")):
        _close(g, w, 1e-4 if name.startswith("d") else 1e-5, name)


def test_non_cpu_tensor_never_takes_the_plain_path():
    """A tensor that is not on the CPU goes to the kernel wrapper, which
    raises for anything it cannot launch on (here a meta tensor)."""
    y = torch.empty((1, 2, 8, 16), device="meta")
    g = torch.empty((1, 2, 8, 4), device="meta")
    vec = torch.empty((16,), device="meta")
    v = torch.empty((4,), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        bn_tail.tail_fwd(y, vec, vec, 4, 2)
    with pytest.raises(ValueError, match="CUDA"):
        bn_tail.bwd_reduce(y, g, 4, 2, vec, vec, v, v)
    with pytest.raises(ValueError, match="CUDA"):
        bn_tail.bwd_apply(y, g, 4, 2, vec, vec, v, v, vec, vec, vec)


def test_bad_geometry_raises():
    with pytest.raises(ValueError, match="blocks"):
        bn_tail.tail_fwd(torch.zeros((1, 1, 4, 12)), torch.zeros(12),
                         torch.zeros(12), 4, 2)


@pytest.mark.parametrize("pixels,slots", [
    (2812500, 264), (2812500, 528), (2812500, 792), (2812500, 1056),
    (1575, 528), (700, 528), (3000, 4), (256, 528), (257, 2), (1, 528)])
def test_pixel_slabs_cover_every_pixel_once(pixels, slots):
    """Every pass's slab plan (``pixel_slabs``): slab s
    takes pixels [s*per, (s+1)*per), every pixel once, every slab
    non-empty, whole SLAB_QUANTUM runs a slab, and no more slabs than the
    blocks the library asks for (or one where there are fewer runs)."""
    slabs, per = bn_tail.pixel_slabs(pixels, slots)
    assert per % bn_tail.SLAB_QUANTUM == 0
    assert (slabs - 1) * per < pixels <= slabs * per
    assert slabs <= max(slots, 1)
    # about as many slabs as asked: at least half, where there are runs
    # enough
    runs = -(-pixels // bn_tail.SLAB_QUANTUM)
    assert slabs >= min(runs, slots) // 2


def _window(o, co, blk):
    """tail_math.cuh's window(): the four channels of pooled channel o."""
    k, ab, half = o % co, o // co, blk // 2
    r = (2 * (ab // half) * blk + 2 * (ab % half)) * co + k
    return [r, r + co, r + blk * co, r + blk * co + co]


def _vector_path(esize, co, *addrs):
    """csrc/bn_tail.cu's choice of the 16-byte path (V 8): bf16, co a
    multiple of 8 and every tensor 16-byte aligned (in_vectors)."""
    return esize == 2 and co % 8 == 0 and all(a % 16 == 0 for a in addrs)


def _walk(pixels, c, v, slabs, per):
    """(block, round, thread, pixel, group) of every item of a pass's walk
    (Groups<V> of csrc/bn_tail.cu), in order: block b
    takes pixels [b*per, b*per + n); thread t takes group t % G of the
    pixels q = t // G, q + PB, ... of them (G = C/4/V groups a pixel, PB =
    256 // G pixels a round); threads from PB*G on take none."""
    groups = c // 4 // v
    pb = 256 // groups
    for b in range(slabs):
        p0 = b * per
        n = min(per, pixels - p0)
        for t in range(pb * groups):
            grp, q = t % groups, t // groups
            for j in range(q, n, pb):
                yield b, (j - q) // pb, t, p0 + j, grp


@pytest.mark.parametrize("pixels,co,blk,esize,odd,slots", [
    # the main path's geometries (bn1, bn2) at a cut pixel count, with
    # several runs a slab and with one
    (3000, 16, 4, 2, False, 4), (3000, 32, 2, 2, False, 4),
    (1575, 16, 4, 2, False, 528), (1575, 32, 2, 2, False, 528),
    # chip_smoke.py's ragged shapes: co 8 (16 bytes, half a sector a
    # member), co 4 (the general path), fp32 (the general path), y and g
    # at an odd element (the general path)
    (700, 8, 2, 2, False, 528), (1575, 8, 4, 2, False, 528),
    (700, 4, 4, 2, False, 528), (1575, 4, 4, 4, False, 528),
    (700, 16, 4, 4, False, 528), (1575, 32, 2, 2, True, 528),
    (700, 16, 4, 2, True, 528)])
def test_walk_takes_every_window_once_in_aligned_accesses(
        pixels, co, blk, esize, odd, slots):
    """The forward's and the apply's walk takes each (pixel, pooled
    channel) once, on the 16-byte path where the C source takes it and on
    the general path otherwise. On the 16-byte path every y, g, out and dy
    access is 16 bytes on a 16-byte boundary, and where co is a multiple of
    16 each of a warp's stores (the pooled out, each member's dy) fills
    whole 32-byte sectors."""
    c = blk * blk * co
    cout = c // 4
    y0 = 4096 + (esize if odd else 0)       # y and g at an odd element
    g0 = (1 << 30) + (esize if odd else 0)
    out0 = 1 << 31                            # fresh outputs: aligned
    vec = _vector_path(esize, co, y0, g0, out0)
    assert vec == (esize == 2 and co % 8 == 0 and not odd)
    v = 8 if vec else 1
    slabs, per = bn_tail.pixel_slabs(pixels, slots)
    taken = Counter()
    stores = {}
    for b, rnd, t, p, grp in _walk(pixels, c, v, slabs, per):
        taken.update((p, o) for o in range(grp * v, grp * v + v))
        if not vec:
            continue
        starts = _window(grp * v, co, blk)
        # each member's run of 8 channels lies in one (a, b) block
        assert all(_window(grp * v + e, co, blk) == [s + e for s in starts]
                   for e in range(v))
        accesses = [y0 + (p * c + s) * esize for s in starts]
        accesses += [g0 + (p * cout + grp * v) * esize,
                     out0 + (p * cout + grp * v) * esize]
        assert all(at % 16 == 0 for at in accesses)
        warp = (b, rnd, t // 32)
        stores.setdefault((warp, "out"), []).append(accesses[-1])
        for i, s in enumerate(starts):
            stores.setdefault((warp, i), []).append(
                out0 + (p * c + s) * esize)
    assert taken == Counter((p, o) for p in range(pixels) for o in range(cout))
    if not vec or co % 16:
        return
    for spans in stores.values():
        covered = set()
        for at in spans:
            covered.update(range(at, at + 16))
        for sector in {at // 32 for at in covered}:
            assert set(range(32 * sector, 32 * sector + 32)) <= covered


_C_KINDS = {"int": ctypes.c_int, "long long": ctypes.c_longlong,
            "pointer": ctypes.c_void_p}


def test_ctypes_argtypes_match_the_c_signatures():
    """Every C entry point of csrc/bn_tail.cu has an ARGTYPES entry of its
    parameter count and kinds (a pointer or N*H*W passed as a c_int would
    be cut to 32 bits on the card, with nothing failing on the CPU), and
    every ARGTYPES entry names a C entry point."""
    src = (Path(bn_tail.build.CSRC) / "bn_tail.cu").read_text()
    sigs = {}
    for name, params in re.findall(
            r'extern "C"\s+[\w\s*]*?\b(\w+)\s*\(([^)]*)\)', src):
        sigs[name] = ["pointer" if "*" in p else p.rsplit(None, 1)[0]
                      for p in (q.strip() for q in params.split(",")) if p]
    # bound by build.load for every library
    sigs.pop("cuda_error_string")
    assert set(sigs) == set(bn_tail.ARGTYPES)
    for name, kinds in sigs.items():
        assert bn_tail.ARGTYPES[name] == [_C_KINDS[k] for k in kinds], name


def _reduce_vector_path(esize, co, c, *addrs):
    """csrc/bn_tail.cu's choice of the reduce's 16-byte path (V 8): the
    forward's and the apply's, and G = C/32 groups a pixel a power of two,
    so that a group's threads in a warp are the lanes of a butterfly."""
    return _vector_path(esize, co, *addrs) and 32 % (c // 32) == 0


def _reduce_row(x, p0, n, c, co, blk, v):
    """The partial row of the slab [p0, p0 + n) as tail_bwd_reduce_kernel
    adds it, f32 [C, 2] from the per-(pixel, channel) terms x [pixels, C,
    2] (dz and dz*t_hat): each thread's pixels in walk order; with V 8 the
    lane butterfly of a group's threads, then the warps in order; with V 1
    the PB threads of a window in order. Also asserts that the butterfly
    leaves every lane of a group the same bits."""
    groups = c // 4 // v
    pb = 256 // groups
    threads = np.arange(pb * groups)
    chans = np.array([[s + e for s in _window(grp * v, co, blk)
                       for e in range(v)] for grp in range(groups)])
    assert sorted(chans.ravel()) == list(range(c))
    ch_t = chans[threads % groups]
    q = threads // groups
    acc = np.zeros((len(threads), 4 * v, 2), np.float32)
    for rnd in range(-(-n // pb)):
        j = q + rnd * pb
        live = j < n
        acc[live] = acc[live] + x[p0 + j[live][:, None], ch_t[live]]
    row = np.zeros((c, 2), np.float32)
    if v > 1:
        acc = acc.reshape(8, 32, 4 * v, 2)
        lanes = np.arange(32)
        m = groups
        while m < 32:
            acc = acc + acc[:, lanes ^ m]
            m *= 2
        assert np.array_equal(acc, acc[:, lanes % groups])
        for w in range(8):
            for lane in range(groups):
                row[chans[lane]] = (acc[w, lane] if w == 0
                                    else row[chans[lane]] + acc[w, lane])
    else:
        s = np.zeros((groups, 4, 2), np.float32)
        for r in range(pb):
            s = s + acc[r * groups:(r + 1) * groups]
        row[chans] = s
    return row


def _reduce_partials(part):
    """reduce.cuh's reduce_partials: 32 runs of rows, each added in order,
    then the 32 run sums in order."""
    rows = part.shape[0]
    per = -(-rows // 32)
    runs = []
    for r in range(32):
        s = np.zeros(part.shape[1:], np.float32)
        for k in range(r * per, min(rows, r * per + per)):
            s = s + part[k]
        runs.append(s)
    out = np.zeros(part.shape[1:], np.float32)
    for s in runs:
        out = out + s
    return out


@pytest.mark.parametrize("pixels,co,blk,esize,odd,slots", [
    # the main path's kinds (bn1 G 8, bn2 G 4) with several 256-pixel runs
    # a slab and a last round partly filled, and at chip_smoke.py's ragged
    # pixel counts
    (3000, 16, 4, 2, False, 4), (3000, 32, 2, 2, False, 4),
    (1575, 16, 4, 2, False, 264), (700, 32, 2, 2, False, 264),
    # G 1 (the butterfly over all five lane bits), G 32 (none: C 1024),
    # G 3 (not a power of two: the general path), co 4, fp32 and y and g at
    # an odd element (the general path)
    (700, 8, 2, 2, False, 264), (300, 64, 4, 2, False, 264),
    (700, 24, 2, 2, False, 264), (700, 4, 4, 2, False, 264),
    (700, 16, 4, 4, False, 264), (1575, 32, 2, 2, True, 264)])
def test_reduce_walk_takes_every_window_once_and_combines_in_a_fixed_order(
        pixels, co, blk, esize, odd, slots):
    """The reduce's slab plan and walk (Groups<V>, the same as the
    forward's) take each (pixel, pooled channel) once; on the 16-byte path
    every y and g load is 16 bytes on a 16-byte boundary. Its sums: a
    block's partial row depends on its own slab's pixels only, and the
    order of every addition is fixed by the lane, warp and slab indices,
    so two runs with the blocks in other orders give the same bits, within
    1e-5 of the exact sums."""
    c = blk * blk * co
    cout = c // 4
    y0 = 4096 + (esize if odd else 0)
    g0 = (1 << 30) + (esize if odd else 0)
    vec = _reduce_vector_path(esize, co, c, y0, g0)
    assert vec == (esize == 2 and co % 8 == 0 and not odd and co != 24)
    v = 8 if vec else 1
    slabs, per = bn_tail.pixel_slabs(pixels, slots)
    taken = Counter()
    for _, _, _, p, grp in _walk(pixels, c, v, slabs, per):
        taken.update((p, o) for o in range(grp * v, grp * v + v))
        if vec:
            starts = _window(grp * v, co, blk)
            assert all((y0 + (p * c + s) * esize) % 16 == 0 for s in starts)
            assert (g0 + (p * cout + grp * v) * esize) % 16 == 0
    assert taken == Counter((p, o) for p in range(pixels) for o in range(cout))
    x = np.random.default_rng(11).standard_normal(
        (pixels, c, 2)).astype(np.float32)
    sums = []
    for order in (range(slabs), reversed(range(slabs))):
        part = np.full((slabs, c, 2), np.nan, np.float32)
        for s in order:
            part[s] = _reduce_row(x, s * per, min(per, pixels - s * per), c,
                                  co, blk, v)
        sums.append(_reduce_partials(part))
    assert np.array_equal(sums[0], sums[1])
    want = x.astype(np.float64).sum(axis=0)
    np.testing.assert_allclose(sums[0], want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
