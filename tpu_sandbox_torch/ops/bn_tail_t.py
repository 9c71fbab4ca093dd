"""Fused train-mode BN-apply + ReLU + 2x2 block max-pool in the transposed
layout [N, H, C, W], whose three passes are CUDA kernels.

Counterpart of ``tpu_sandbox/ops/pallas_bn_tail_t.py``:
``fused_bn_relu_pool_t`` (:179) with ``_forward`` (:199-230, the ``ysums``
fold :204-209), ``bwd_reduce`` (:240-285), ``bwd_scales`` (:288-297),
``_vjp_bwd`` (:300-333), ``unfused_reference_t`` (:150) and ``_stats_t``
(:168). The same math and exactness contract: z = relu(round(y*a + b))
with a = gamma*rsqrt(var+eps), b = beta - mu*a per channel, rounded to
y's dtype before the ReLU; the 2x2 pool inside the channel dim (channel
(a*blk+b)*co+k, partners at offsets co and blk*co); the train-mode BN
backward through the batch statistics; the pool VJP splitting an exact
tie on rounded values 0.5/0.5. Per-channel vectors are f32 columns of C
(a per-co vector tiled blk*blk times), as the Pallas kernels take them.

Each pass dispatches on the device of its tensors: on the CPU it runs the
plain PyTorch version below (the tests hold it against the JAX function);
on a CUDA tensor it launches the kernel of ``csrc/bn_tail_t.cu`` or
raises. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter

import torch

from tpu_sandbox_torch.ops import build
from tpu_sandbox_torch.ops.conv_t import wgrad_slabs

#: launches of the CUDA kernels, by pass and shape ("bn_tail_t fwd C256
#: CO16", "bn_tail_t bwd_reduce C128 CO32", "bn_tail_t bwd_apply C256
#: CO16"); only a kernel launch adds to it
LAUNCHES: Counter = Counter()

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int

#: the ctypes argument kinds of the library's C entry points (each returns
#: an int), in the order of csrc/bn_tail_t.cu's signatures: the dtype, the
#: tensors' pointers, N*H, C, co, blk, W and the slab plan, the stream
ARGTYPES = {
    "bn_tail_t_slots": [_I],
    "bn_tail_t_fwd": [_I] + [_P] * 4 + [_I] * 7 + [_P],
    "bn_tail_t_bwd_reduce": [_I] + [_P] * 8 + [_I] * 7 + [_P],
    "bn_tail_t_bwd_apply": [_I] + [_P] * 10 + [_I] * 7 + [_P],
}
#: each pass's index in ``bn_tail_t_slots``
_PASSES = {"fwd": 0, "bwd_reduce": 1, "bwd_apply": 2}


def _lib() -> ctypes.CDLL:
    lib = build.load("bn_tail_t")
    if not getattr(lib, "_bound", False):
        for name, argtypes in ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _I
        lib._bound = True
    return lib


def _check_geometry(y: torch.Tensor, co: int, blk: int) -> None:
    if y.dim() != 4:
        raise ValueError(f"expected y [N,H,C,W], got {tuple(y.shape)}")
    if blk < 2 or blk % 2 or y.shape[2] != blk * blk * co:
        raise ValueError(f"{y.shape[2]} channels are not {blk}x{blk} blocks "
                         f"of {co} (blk even)")


def col_expand(v_co: torch.Tensor, reps: int) -> torch.Tensor:
    """Per-co vector -> f32 column of reps*co channels (co minor)."""
    return v_co.float().repeat(reps)


# -- plain PyTorch versions ----------------------------------------------


def _windows(t: torch.Tensor, blk: int, co: int) -> torch.Tensor:
    """[N,H,C,W] -> [N,H,blk/2,2,blk/2,2,co,W]: dims 3 and 5 are the low
    bits of (a, b); index 0 on both is a window's representative."""
    n, h, _, w = t.shape
    return t.reshape(n, h, blk // 2, 2, blk // 2, 2, co, w)


def _rounded_relu(y: torch.Tensor, a_col: torch.Tensor,
                  b_col: torch.Tensor) -> torch.Tensor:
    """z in y's dtype, held in f32: rounded before the ReLU."""
    zpre = y.float() * a_col[:, None] + b_col[:, None]
    return torch.clamp_min(zpre.to(y.dtype), 0).float()


def _tie_weight(x: torch.Tensor, xb: torch.Tensor) -> torch.Tensor:
    return 0.5 * ((x > xb).float() + (x >= xb).float())


def _dz(y, g, co, blk, a_col, b_col) -> torch.Tensor:
    """The pooled cotangent g routed back through the pool (the pair at
    offset blk*co first, then inside each pair at offset co; exact ties
    split 0.5/0.5) and masked by the ReLU: f32 [N,H,C,W]."""
    z = _rounded_relu(y, a_col, b_col)
    zw = _windows(z, blk, co)
    n, h, _, w = g.shape
    gw = g.float().reshape(n, h, blk // 2, blk // 2, co, w)
    z00, z01 = zw[:, :, :, 0, :, 0], zw[:, :, :, 0, :, 1]
    z10, z11 = zw[:, :, :, 1, :, 0], zw[:, :, :, 1, :, 1]
    w2 = _tie_weight(torch.maximum(z00, z01), torch.maximum(z10, z11))
    da, db = gw * w2, gw * (1.0 - w2)
    w1a, w1b = _tie_weight(z00, z01), _tie_weight(z10, z11)
    pair_a = torch.stack([da * w1a, da * (1.0 - w1a)], dim=4)
    pair_b = torch.stack([db * w1b, db * (1.0 - w1b)], dim=4)
    dz = torch.stack([pair_a, pair_b], dim=3).reshape(z.shape)
    return torch.where(z > 0, dz, torch.zeros_like(dz))


def _t_hat(y, mu, inv, reps: int) -> torch.Tensor:
    return ((y.float() - col_expand(mu, reps)[:, None])
            * col_expand(inv, reps)[:, None])


def _fold(v_c: torch.Tensor, co: int) -> torch.Tensor:
    """Per-channel [C] -> per-co [co]: the sum over the blk*blk groups."""
    return v_c.reshape(-1, co).sum(0)


def tail_fwd_plain(y, a_col, b_col, co: int, blk: int) -> torch.Tensor:
    """out = pool2x2(relu(round(y*a + b))) in y's dtype."""
    zw = _windows(_rounded_relu(y, a_col, b_col), blk, co)
    m = torch.maximum(
        torch.maximum(zw[:, :, :, 0, :, 0], zw[:, :, :, 0, :, 1]),
        torch.maximum(zw[:, :, :, 1, :, 0], zw[:, :, :, 1, :, 1]))
    n, h, _, w = y.shape
    return m.reshape(n, h, -1, w).to(y.dtype)


def bwd_reduce_plain(y, g, co: int, blk: int, a_col, b_col, mu, inv):
    """(s1_co, s2_co): s1 = sum dz and s2 = sum dz*t_hat over (n, h, w),
    folded over the groups."""
    dz = _dz(y, g, co, blk, a_col, b_col)
    t_hat = _t_hat(y, mu, inv, blk * blk)
    s1 = dz.sum(dim=(0, 1, 3))
    s2 = (dz * t_hat).sum(dim=(0, 1, 3))
    return _fold(s1, co), _fold(s2, co)


def bwd_apply_plain(y, g, co: int, blk: int, a_col, b_col, mu, inv, gi_col,
                    c1_col, c2_col) -> torch.Tensor:
    """dy = gi*((dz - c1) - t_hat*c2), rounded once to y's dtype."""
    dz = _dz(y, g, co, blk, a_col, b_col)
    t_hat = _t_hat(y, mu, inv, blk * blk)
    dy = gi_col[:, None] * ((dz - c1_col[:, None]) - t_hat * c2_col[:, None])
    return dy.to(y.dtype)


# -- kernel wrappers -------------------------------------------------------


def _cuda_operands(what: str, y: torch.Tensor, g: torch.Tensor | None,
                   cols) -> None:
    if y.device.type != "cuda":
        raise ValueError(f"{what} kernel takes CUDA tensors, got {y.device}")
    if y.dtype not in _DTYPES:
        raise ValueError(f"{what} kernel takes float32 or bfloat16, got "
                         f"{y.dtype}")
    n, h, c, w = y.shape
    if n * h > 65535:
        raise ValueError(f"{what} kernel takes N*H <= 65535 rows, got {n * h}")
    if not y.is_contiguous():
        raise ValueError("y must be contiguous")
    if g is not None and (g.device != y.device or g.dtype != y.dtype
                          or tuple(g.shape) != (n, h, c // 4, w)
                          or not g.is_contiguous()):
        raise ValueError(f"g must be a contiguous {y.dtype} tensor of shape "
                         f"{(n, h, c // 4, w)} on {y.device}, got {g.dtype} "
                         f"{tuple(g.shape)} on {g.device}")
    for col in cols:
        if (col.device != y.device or col.dtype != torch.float32
                or tuple(col.shape) != (c,) or not col.is_contiguous()):
            raise ValueError(f"per-channel columns must be contiguous f32 "
                             f"[{c}] on {y.device}")


@functools.lru_cache(maxsize=None)
def _slots(device_index: int, what: str) -> int:
    """The blocks the library asks for the pass on a card: a property of
    the card and the kernel, asked once, off the launch's path."""
    with torch.cuda.device(device_index):
        slots = _lib().bn_tail_t_slots(_PASSES[what])
    if slots <= 0:
        raise RuntimeError(f"bn_tail_t {what}: the card's block count could "
                           "not be asked")
    return slots


def _slab_plan(what: str, y: torch.Tensor) -> tuple[int, int]:
    """(slabs, rows_per_slab): one block a (slab of whole rows, window),
    about as many blocks as the library asks for the pass."""
    n, h, c, _ = y.shape
    return wgrad_slabs(n * h, c // 4, _slots(y.device.index, what))


def _launch(what: str, y: torch.Tensor, *ptrs, co: int, blk: int,
            plan: tuple[int, int]) -> None:
    lib = _lib()
    fn_name = f"bn_tail_t_{what}"
    n, h, c, w = y.shape
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = getattr(lib, fn_name)(_DTYPES[y.dtype], y.data_ptr(),
                                    *[p.data_ptr() for p in ptrs], n * h, c,
                                    co, blk, w, *plan, stream)
    build.check(lib, err, fn_name)


def tail_fwd(y: torch.Tensor, a_col: torch.Tensor, b_col: torch.Tensor,
             co: int, blk: int) -> torch.Tensor:
    """The forward pass: y [N,H,blk*blk*co,W] -> pool2x2(relu(round(y*a +
    b))) [N,H,(blk//2)**2*co,W] in y's dtype."""
    _check_geometry(y, co, blk)
    if y.device.type == "cpu":
        return tail_fwd_plain(y, a_col, b_col, co, blk)
    _cuda_operands("bn_tail_t fwd", y, None, (a_col, b_col))
    n, h, c, w = y.shape
    out = torch.empty((n, h, c // 4, w), dtype=y.dtype, device=y.device)
    _launch("fwd", y, a_col, b_col, out, co=co, blk=blk,
            plan=_slab_plan("fwd", y))
    LAUNCHES[f"bn_tail_t fwd C{c} CO{co}"] += 1
    return out


def bwd_reduce(y: torch.Tensor, g: torch.Tensor, co: int, blk: int,
               a_col: torch.Tensor, b_col: torch.Tensor, mu: torch.Tensor,
               inv: torch.Tensor):
    """The backward's first pass: (s1_co [co], s2_co [co]) f32, s1 = sum
    dz and s2 = sum dz*t_hat over the whole batch, t_hat = (y - mu)*inv.
    Public, as in JAX, so that a fused conv1+tail backward can run the
    same reduction before its own apply pass."""
    _check_geometry(y, co, blk)
    if y.device.type == "cpu":
        return bwd_reduce_plain(y, g, co, blk, a_col, b_col, mu, inv)
    reps = blk * blk
    mu_col, inv_col = col_expand(mu, reps), col_expand(inv, reps)
    _cuda_operands("bn_tail_t bwd_reduce", y, g,
                   (a_col, b_col, mu_col, inv_col))
    c = y.shape[2]
    # one partial a slab
    plan = _slab_plan("bwd_reduce", y)
    part = torch.empty((plan[0], 2 * c), dtype=torch.float32,
                       device=y.device)
    sums = torch.empty((2 * c,), dtype=torch.float32, device=y.device)
    _launch("bwd_reduce", y, g, a_col, b_col, mu_col, inv_col, part, sums,
            co=co, blk=blk, plan=plan)
    LAUNCHES[f"bn_tail_t bwd_reduce C{c} CO{co}"] += 1
    # the fold over the groups stays outside the kernel, as in JAX
    return _fold(sums[:c], co), _fold(sums[c:], co)


def global_scales(s1_co, s2_co, gamma, inv, groups: int, m_count: int,
                  group=None):
    """``bwd_scales`` on the whole batch's sums and count, summed over the
    ranks of ``group`` (a ``StatsGroup``; None: this rank's)."""
    if group is not None:
        (s1_co, s2_co), m_count = group.totals((s1_co, s2_co), m_count)
    return bwd_scales(s1_co, s2_co, gamma, inv, groups, m_count)


def bwd_scales(s1_co, s2_co, gamma, inv, groups: int, m_count):
    """The BN backward's per-channel columns (gi, c1, c2) of
    dy = gi*(dz - c1 - t_hat*c2): one function shared by every apply
    pass, as in JAX."""
    gi_col = col_expand(gamma.float() * inv, groups)
    c1_col = col_expand(s1_co / m_count, groups)
    c2_col = col_expand(s2_co / m_count, groups)
    return gi_col, c1_col, c2_col


def bwd_apply(y, g, co: int, blk: int, a_col, b_col, mu, inv, gi_col,
              c1_col, c2_col) -> torch.Tensor:
    """The backward's second pass: dy [N,H,C,W] in y's dtype."""
    _check_geometry(y, co, blk)
    if y.device.type == "cpu":
        return bwd_apply_plain(y, g, co, blk, a_col, b_col, mu, inv, gi_col,
                               c1_col, c2_col)
    reps = blk * blk
    mu_col, inv_col = col_expand(mu, reps), col_expand(inv, reps)
    _cuda_operands("bn_tail_t bwd_apply", y, g,
                   (a_col, b_col, mu_col, inv_col, gi_col, c1_col, c2_col))
    dy = torch.empty_like(y)
    _launch("bwd_apply", y, g, a_col, b_col, mu_col, inv_col, gi_col, c1_col,
            c2_col, dy, co=co, blk=blk, plan=_slab_plan("bwd_apply", y))
    LAUNCHES[f"bn_tail_t bwd_apply C{y.shape[2]} CO{co}"] += 1
    return dy


# -- the fused function ----------------------------------------------------


def stats_t(y: torch.Tensor, co: int):
    """(mu [co], biased var [co]) in f32 over (n, h, groups, w)."""
    n, h, c, w = y.shape
    yg = y.float().reshape(n, h, c // co, co, w)
    mu = yg.mean(dim=(0, 1, 2, 4))
    var = torch.clamp_min(yg.square().mean(dim=(0, 1, 2, 4)) - mu.square(),
                          0.0)
    return mu, var


def _stats_from_sums(s: torch.Tensor, ss: torch.Tensor, co: int, count: int):
    """(mu, biased var) per co from per-channel [C,1] sums of y and y*y,
    ``count`` = y.numel() // co values per co."""
    s_co = _fold(s[:, 0].float(), co)
    ss_co = _fold(ss[:, 0].float(), co)
    mu = s_co / count
    return mu, torch.clamp_min(ss_co / count - mu.square(), 0.0)


def unfused_reference_t(y, gamma, beta, co: int, blk: int,
                        eps: float = 1e-5):
    """The unfused transposed tail as ConvNetS2DT computes it in train
    mode: (pooled, mu, var). The contract the fused function must equal."""
    from tpu_sandbox_torch.models.convnet_s2d_t import block_max_pool_t

    *lead, c, w = y.shape
    yf = y.float().reshape(*lead, c // co, co, w)
    red = tuple(i for i in range(yf.dim()) if i != yf.dim() - 2)
    mu = yf.mean(dim=red)
    var = torch.clamp_min(yf.square().mean(dim=red) - mu.square(), 0.0)
    z = (yf - mu[:, None]) * (torch.rsqrt(var + eps)
                              * gamma.float())[:, None] \
        + beta.float()[:, None]
    z = torch.relu(z.reshape(*lead, c, w).to(y.dtype))
    return block_max_pool_t(z, blk, co), mu, var


def tail_forward(y, gamma, beta, co: int, blk: int, eps: float, s=None,
                 ss=None, group=None):
    """The fused forward, as JAX's ``_forward``: the statistics from the
    per-channel sums (s, ss) when given, else a pass over y; the f32
    columns; the forward kernel. Returns (out, mu, var, inv, a_col,
    b_col). Under ``group`` (a ``StatsGroup``) the sums (taken from y
    when not given) and the element count are summed over its ranks
    first: the whole batch's statistics."""
    if group is not None:
        if s is None:
            yf = y.float()
            s, ss = yf.sum(dim=(0, 1, 3))[:, None], \
                yf.square().sum(dim=(0, 1, 3))[:, None]
        (s, ss), count = group.totals((s, ss), y.numel() // co)
        mu, var = _stats_from_sums(s, ss, co, count)
    elif s is None:
        mu, var = stats_t(y, co)
    else:
        mu, var = _stats_from_sums(s, ss, co, y.numel() // co)
    inv = torch.rsqrt(var + eps)
    a_co = inv * gamma.float()
    reps = blk * blk
    a_col = col_expand(a_co, reps)
    b_col = col_expand(beta.float() - mu * a_co, reps)
    return tail_fwd(y, a_col, b_col, co, blk), mu, var, inv, a_col, b_col


class _FusedBnReluPoolT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, gamma, beta, s, ss, co, blk, eps, group):
        out, mu, var, inv, a_col, b_col = tail_forward(y, gamma, beta, co, blk,
                                                       eps, s, ss, group)
        ctx.save_for_backward(y, gamma, mu, inv, a_col, b_col)
        ctx.co, ctx.blk, ctx.group = co, blk, group
        ctx.mark_non_differentiable(mu, var)
        return out, mu, var

    @staticmethod
    def backward(ctx, g, _dmu, _dvar):
        # the mu/var cotangents are ignored, as in JAX: the running-stats
        # update is not differentiated
        y, gamma, mu, inv, a_col, b_col = ctx.saved_tensors
        co, blk = ctx.co, ctx.blk
        g = g.contiguous()
        s1_co, s2_co = bwd_reduce(y, g, co, blk, a_col, b_col, mu, inv)
        n, h, _, w = y.shape
        groups = blk * blk
        # the columns take the whole batch's sums; dgamma and dbeta stay
        # this rank's share, which the engine's gradient sync adds up
        gi_col, c1_col, c2_col = global_scales(
            s1_co, s2_co, gamma, inv, groups, n * h * w * groups, ctx.group)
        dy = bwd_apply(y, g, co, blk, a_col, b_col, mu, inv, gi_col, c1_col,
                       c2_col)
        # the sums' cotangents are zero by contract: dy already carries the
        # statistics' dependence on y
        ds = (torch.zeros((y.shape[2], 1), device=y.device)
              if ctx.needs_input_grad[3] else None)
        dss = (torch.zeros((y.shape[2], 1), device=y.device)
               if ctx.needs_input_grad[4] else None)
        return (dy, s2_co.to(gamma.dtype), s1_co.to(gamma.dtype), ds, dss,
                None, None, None, None)


def fused_bn_relu_pool_t(y: torch.Tensor, gamma: torch.Tensor,
                         beta: torch.Tensor, co: int, blk: int,
                         eps: float = 1e-5, ysums=None, group=None):
    """[N,H,blk*blk*co,W] conv output -> ([N,H,(blk//2)**2*co,W] pooled,
    mu [co], var [co]) with train-mode batch statistics: the transposed
    grouped BN + relu + block_max_pool_t chain in one pass forward and
    two backward. ``ysums=(sum [C,1], sumsq [C,1])`` f32 per-channel sums
    of y (from ``conv3x3_t_stats``) replace the statistics pass over y.
    ``group`` (a ``StatsGroup``) makes the statistics the whole batch's:
    the forward's sums and the backward's reduce sums are summed over its
    ranks before the kernels that use them. mu and var are not
    differentiable."""
    s, ss = (None, None) if ysums is None else ysums
    return _FusedBnReluPoolT.apply(y.contiguous(), gamma, beta, s, ss, co,
                                   blk, eps, group)
