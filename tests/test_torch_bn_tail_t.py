"""The port's fused BN/ReLU/pool tail (tpu_sandbox_torch/ops/bn_tail_t.py)
== the JAX Pallas fused_bn_relu_pool_t (interpret mode) at the
geometries of tests/test_pallas_bn_tail_t.py, in fp32 and bf16: the
pooled output, mu and var; dy, dgamma and dbeta; the bf16 tie case; the
ysums path; bwd_reduce's s1/s2; and unfused_reference_t. On the CPU the
port runs its kernels' plain PyTorch versions; the kernels are held
against those on the card by chip_smoke.py."""

import ctypes
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_sandbox.ops import pallas_bn_tail_t as jax_tail
from tpu_sandbox.ops.pallas_bn_tail import selection_matrix
from tpu_sandbox_torch.ops import bn_tail_t
from tpu_sandbox_torch.ops.conv_t import wgrad_slabs
from torch_threads import one_torch_thread  # noqa: F401

GEOMS = [(4, 4, 12), (2, 16, 8), (4, 16, 8)]      # (blk, co, hw)
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
    y = rng.standard_normal((n, hw, c, hw)).astype(np.float32)
    gamma = (1 + 0.1 * rng.standard_normal(co)).astype(np.float32)
    beta = rng.standard_normal(co).astype(np.float32)
    cot = rng.standard_normal((n, hw, c // 4, hw)).astype(np.float32)
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
    """Per-channel [C,1] sums of y and y*y, in f32."""
    yf = y.astype(np.float32)
    return (yf.sum(axis=(0, 1, 3))[:, None],
            np.square(yf).sum(axis=(0, 1, 3))[:, None])


def _jax_case(y, gamma, beta, cot, co, blk, ysums=None):
    """JAX forward (out, mu, var) and its VJP (dy, dgamma, dbeta) on the
    pooled cotangent, jitted, as numpy."""
    def run(y, gamma, beta, cot):
        (out, mu, var), vjp = jax.vjp(
            lambda y, g, b: jax_tail.fused_bn_relu_pool_t(
                y, g, b, co, blk, 1e-5, None, ysums), y, gamma, beta)
        dy, dg, db = vjp((cot.astype(out.dtype), jnp.zeros_like(mu),
                          jnp.zeros_like(var)))
        return out, mu, var, dy, dg, db
    return [np.asarray(jnp.asarray(t, jnp.float32))
            for t in jax.jit(run)(y, gamma, beta, cot)]


def _torch_case(y, gamma, beta, cot, co, blk, ysums=None):
    ty, tg, tb = (t.clone().requires_grad_() for t in (y, gamma, beta))
    out, mu, var = bn_tail_t.fused_bn_relu_pool_t(ty, tg, tb, co, blk,
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
    got, want, dt = case["got"], case["want"], case["dt"]
    for i, name in ((3, "dy"), (4, "dgamma"), (5, "dbeta")):
        assert tuple(got[i].shape) == want[i].shape, name
        _close(got[i], want[i], GRAD_REL[dt], name)


def _tie_inputs():
    """Inputs quantised to quarters with gamma 1 and beta 0, so that the
    bf16-rounded z has exact ties in every pool window."""
    rng = np.random.default_rng(7)
    co, blk = 8, 2
    y = (np.round(rng.standard_normal((2, 4, blk * blk * co, 4)) * 4)
         / 4).astype(np.float32)
    cot = rng.standard_normal((2, 4, co, 4)).astype(np.float32)
    return y, np.ones(co, np.float32), np.zeros(co, np.float32), cot, co, blk


def test_bf16_tie_routing_is_exact_and_dy_within_one_ulp():
    y, gamma, beta, cot, co, blk = _tie_inputs()
    ty = torch.from_numpy(y).to(torch.bfloat16)
    tcot = torch.from_numpy(cot).to(torch.bfloat16)
    # the routing: the port's dz == JAX's _route on the same rounded z
    mu, var = bn_tail_t.stats_t(ty, co)
    inv = torch.rsqrt(var + 1e-5)
    a_col = bn_tail_t.col_expand(inv, blk * blk)
    b_col = bn_tail_t.col_expand(-mu * inv, blk * blk)
    got_dz = bn_tail_t._dz(ty, tcot, co, blk, a_col, b_col).numpy()
    z = bn_tail_t._rounded_relu(ty, a_col, b_col).numpy()
    n, h, c, w = y.shape
    rows = lambda t: jnp.asarray(t.transpose(2, 0, 1, 3).reshape(t.shape[2], -1))  # noqa: E731
    g_exp = jnp.asarray(selection_matrix(blk, co)) @ rows(_np(tcot))
    want_dz = jax_tail._route(rows(z), g_exp, co, blk) * (rows(z) > 0)
    want_dz = np.asarray(want_dz).reshape(c, n, h, w).transpose(1, 2, 0, 3)
    zw = bn_tail_t._windows(torch.from_numpy(z), blk, co)
    pair = zw[:, :, :, 0, :, 0]
    assert ((pair == zw[:, :, :, 0, :, 1]) & (pair > 0)).any(), "no tie"
    np.testing.assert_array_equal(got_dz + 0.0, want_dz + 0.0)
    # dy through the whole backward, against JAX within one bf16 ulp of
    # max|dy|
    want = _jax_case(jnp.asarray(y, jnp.bfloat16), jnp.asarray(gamma),
                     jnp.asarray(beta), jnp.asarray(cot), co, blk)
    got = _torch_case(ty, torch.from_numpy(gamma), torch.from_numpy(beta),
                      torch.from_numpy(cot), co, blk)
    _close(got[0], want[0], 0.0, "out")
    _close(got[3], want[3], 2.0 ** -8, "dy")


def test_ysums_path_matches_jax_and_sums_get_zero_cotangents():
    blk, co, hw = 2, 16, 8
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
    # the same statistics as the tail's own pass over y
    own = _torch_case(torch.from_numpy(y), torch.from_numpy(gamma),
                      torch.from_numpy(beta), torch.from_numpy(cot), co, blk)
    for g, o, name in zip(got, own, ("out", "mu", "var", "dy")):
        _close(g, o, 1e-5, name)


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_bwd_reduce_matches_jax(dt):
    blk, co, hw = 4, 4, 12
    jd, td = DTYPES[dt]
    y, gamma, beta, cot = _inputs(blk, co, hw, seed=2)
    jy, jg = jnp.asarray(y, jd), jnp.asarray(cot, jd)
    mu, var = jax_tail._stats_t(jy, co)
    inv = jax.lax.rsqrt(var + 1e-5)
    a_co = inv * jnp.asarray(gamma)
    a_col = jax_tail._col_expand(a_co, blk * blk)
    b_col = jax_tail._col_expand(jnp.asarray(beta) - mu * a_co, blk * blk)
    s1, s2, *_ = jax.jit(
        lambda *a: jax_tail.bwd_reduce(*a[:2], co, blk, *a[2:], None))(
        jy, jg, a_col, b_col, mu, inv)
    got1, got2 = bn_tail_t.bwd_reduce(
        torch.from_numpy(y).to(td), torch.from_numpy(cot).to(td), co, blk,
        *(torch.from_numpy(np.array(t).reshape(-1))
          for t in (a_col, b_col, mu, inv)))
    assert got1.shape == (co,) and got2.shape == (co,)
    # f32 sums over the batch of the same routed values, in other orders
    _close(got1, s1, 1e-5, "s1")
    _close(got2, s2, 1e-5, "s2")


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_unfused_reference_matches_jax(dt):
    blk, co, hw = 4, 4, 12
    jd, td = DTYPES[dt]
    y, gamma, beta, _ = _inputs(blk, co, hw, seed=3)
    want = jax.jit(lambda *a: jax_tail.unfused_reference_t(*a, co, blk))(
        jnp.asarray(y, jd), jnp.asarray(gamma), jnp.asarray(beta))
    got = bn_tail_t.unfused_reference_t(
        torch.from_numpy(y).to(td), torch.from_numpy(gamma),
        torch.from_numpy(beta), co, blk)
    for g, w, name in zip(got, want, ("out", "mu", "var")):
        _close(g, w, REL[dt] if name == "out" else 1e-5, name)


@pytest.mark.parametrize("blk,co,hw", GEOMS)
def test_fused_equals_the_unfused_chain(blk, co, hw):
    """Within the port: the fused function's forward and gradients equal
    autograd through the unfused chain (fp32)."""
    y, gamma, beta, cot = _inputs(blk, co, hw, seed=5)
    got = _torch_case(torch.from_numpy(y), torch.from_numpy(gamma),
                      torch.from_numpy(beta), torch.from_numpy(cot), co, blk)
    ty, tg, tb = (torch.from_numpy(t).requires_grad_()
                  for t in (y, gamma, beta))
    out, mu, var = bn_tail_t.unfused_reference_t(ty, tg, tb, co, blk)
    out.backward(torch.from_numpy(cot))
    for g, w, name in zip(got, (out, mu, var, ty.grad, tg.grad, tb.grad),
                          ("out", "mu", "var", "dy", "dgamma", "dbeta")):
        _close(g, w, 1e-4 if name.startswith("d") else 1e-5, name)


def test_non_cpu_tensor_never_takes_the_plain_path():
    """A tensor that is not on the CPU goes to the kernel wrapper, which
    raises for anything it cannot launch on (here a meta tensor)."""
    y = torch.empty((1, 2, 16, 8), device="meta")
    g = torch.empty((1, 2, 4, 8), device="meta")
    col = torch.empty((16,), device="meta")
    v = torch.empty((4,), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        bn_tail_t.tail_fwd(y, col, col, 4, 2)
    with pytest.raises(ValueError, match="CUDA"):
        bn_tail_t.bwd_reduce(y, g, 4, 2, col, col, v, v)
    with pytest.raises(ValueError, match="CUDA"):
        bn_tail_t.bwd_apply(y, g, 4, 2, col, col, v, v, col, col, col)


def test_bad_geometry_raises():
    with pytest.raises(ValueError, match="blocks"):
        bn_tail_t.tail_fwd(torch.zeros((1, 1, 12, 4)), torch.zeros(12),
                           torch.zeros(12), 4, 2)


@pytest.mark.parametrize("rows,windows,slots", [
    (3750, 64, 1056), (3750, 32, 1056), (21, 64, 1056), (21, 1, 1056),
    (10, 4, 1056), (1, 4, 1056), (3750, 64, 40), (7, 3, 5),
    # the forward's and the apply's own slots (2 waves of 2 to 8 blocks of
    # 256 threads on 132 SMs), at both tails and the ragged shapes
    (3750, 64, 2112), (3750, 32, 2112), (3750, 64, 792), (3750, 32, 792),
    (3750, 64, 528), (21, 8, 792), (10, 4, 2112), (21, 16, 528)])
def test_reduce_slabs_cover_every_row_once_in_order(rows, windows, slots):
    """The passes' slabs of whole rows (``tail_fwd``, ``bwd_reduce`` and
    ``bwd_apply`` split the N*H rows with ``wgrad_slabs``, the C/4 windows
    as its tiles): slab s takes rows [s*per, (s+1)*per); every row once,
    in order, every slab non-empty, and the slabs times the windows (one
    block each, and one partial row of the reduce) within the blocks the
    library asks for, or one slab a window where the windows alone exceed
    them."""
    slabs, per = wgrad_slabs(rows, windows, slots)
    seen = [r for s in range(slabs) for r in range(s * per,
                                                   min(rows, (s + 1) * per))]
    assert seen == list(range(rows))
    assert all(s * per < rows for s in range(slabs))
    assert slabs * windows <= max(slots, windows)


_C_KINDS = {"int": ctypes.c_int, "pointer": ctypes.c_void_p}


def _c_signatures(src: str) -> dict[str, list[str]]:
    """{name: [parameter kinds]} of every ``extern "C"`` function of a CUDA
    source: "pointer" for a parameter whose type holds ``*``, else its
    type (``int`` for the sizes)."""
    sigs = {}
    for name, params in re.findall(
            r'extern "C"\s+[\w\s*]*?\b(\w+)\s*\(([^)]*)\)', src):
        kinds = []
        for param in filter(None, (p.strip() for p in params.split(","))):
            if param == "void":
                continue
            kinds.append("pointer" if "*" in param
                         else param.rsplit(None, 1)[0].strip())
        sigs[name] = kinds
    return sigs


def test_ctypes_argtypes_match_the_c_signatures():
    """Every C entry point of csrc/bn_tail_t.cu that the wrapper binds has
    an ARGTYPES entry of its parameter count and kinds (a pointer passed
    as a c_int would be cut to 32 bits on the card, with nothing failing
    on the CPU), and every ARGTYPES entry names a C entry point."""
    src = (Path(bn_tail_t.build.CSRC) / "bn_tail_t.cu").read_text()
    sigs = _c_signatures(src)
    # bound by build.load for every library
    sigs.pop("cuda_error_string")
    assert set(sigs) == set(bn_tail_t.ARGTYPES)
    for name, kinds in sigs.items():
        want = [_C_KINDS[k] for k in kinds]
        assert bn_tail_t.ARGTYPES[name] == want, name


def _fast_div(d: int):
    """FastDiv of csrc/bn_tail_t.cu: n // d by a multiply and a shift."""
    l = (d - 1).bit_length() if d > 1 else 0
    m = ((1 << 32) * ((1 << l) - d)) // d + 1
    assert m < 1 << 32
    return lambda n: (((m * n) >> 32) + n) >> l


def _slot_map(rows, w, v, esize, pitch, base, words=1, align_bytes=64):
    """The (row, first w, words) each slot of a forward or apply block's
    walk takes, in order (None: an empty slot), as Slab<T, V, Q, true> of
    csrc/bn_tail_t.cu lays them out: P slots of ``words`` words (v
    elements each) a row, P*words a whole number of ``align_bytes`` runs;
    slot j of row r starts at word j*words - lead, lead the word of the
    stored row's first element within its run (the row starts ``base`` +
    r*pitch*esize bytes in). Words outside the row are dropped."""
    word = esize * v
    run = align_bytes // word
    per_row = w // v
    p = (per_row + 2 * run - 2) // run * run // words
    div = _fast_div(p)
    lead0, step = base // word, pitch // v
    out = []
    for it in range(rows * p):
        r = div(it)
        w0 = (it - r * p) * words - (lead0 + r * step) % (1 << 32) % run
        got = [q for q in range(w0, w0 + words) if 0 <= q < per_row]
        out.append((r, got[0] * v, len(got)) if got else None)
    return out


@pytest.mark.parametrize("d", [1, 2, 3, 7, 35, 47, 375, 384, 392, 12345,
                               2**20, 2**31 - 1])
def test_fast_div_is_floor_division(d):
    rng = np.random.default_rng(d)
    ns = [0, 1, d - 1, d, d + 1, 2**31 - 2, 2**31 - 1,
          *rng.integers(0, 2**31, 500).tolist()]
    div = _fast_div(d)
    assert [div(n) for n in ns if n >= 0] == [n // d for n in ns if n >= 0]


@pytest.mark.parametrize("w,v,esize,c,words", [
    (750, 2, 2, 256, 4), (750, 2, 2, 128, 4), (70, 2, 2, 32, 4),
    (70, 2, 4, 64, 2), (75, 1, 2, 16, 1), (75, 1, 4, 16, 1), (1, 1, 2, 16, 1),
    (2, 2, 2, 16, 4)])
def test_aligned_slots_take_every_element_once_and_store_whole_sectors(
        w, v, esize, c, words):
    """The forward's and the apply's walk (Slab with AL in
    csrc/bn_tail_t.cu) takes each (row, w) of its slab once, at any
    alignment of the stored row; a slot that holds all its words starts on
    a 16-byte boundary (its single access); and a warp's 32 slots store
    whole 32-byte sectors of a row, but at the row's two ends."""
    rows = 21
    for base in (4096, 4096 + 750 * esize, 4096 + 2 * 7 * esize,
                 4096 + 16 * 750 * esize):
        taken = _slot_map(rows, w, v, esize, c * w, base, words)
        elems = sorted((r, e0 + k * v) for r, e0, n in filter(None, taken)
                       for k in range(n))
        assert elems == [(r, e) for r in range(rows) for e in range(0, w, v)]
        for r, e0, n in filter(None, taken):
            if n == words:
                at = base + (r * c * w + e0) * esize
                assert at % (words * v * esize) == 0
        for warp in range(0, len(taken), 32):
            by_row = {}
            for r, e0, n in filter(None, taken[warp:warp + 32]):
                by_row.setdefault(r, []).append((e0, e0 + n * v))
            for r, spans in by_row.items():
                lo = min(a for a, _ in spans)
                hi = max(b for _, b in spans)
                assert (base + (r * c * w + lo) * esize) % 32 == 0 or lo == 0
                assert (base + (r * c * w + hi) * esize) % 32 == 0 or hi == w
