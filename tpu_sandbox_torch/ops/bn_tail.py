"""Fused train-mode BN-apply + ReLU + 2x2 block max-pool in the NHWC layout
[N, H, W, C], whose three passes are CUDA kernels.

Counterpart of ``tpu_sandbox/ops/pallas_bn_tail.py``:
``fused_bn_relu_pool`` (:218) with ``_forward`` (:238, the ``ysums`` fold
:243-248), ``_vjp_bwd`` (:279-344, the reduce and apply passes),
``unfused_reference`` (:191) and ``_stats`` (:208). The same math and
exactness contract as the transposed tail (``ops/bn_tail_t.py``), with the
channels last: z = relu(round(y*a + b)) with a = gamma*rsqrt(var+eps),
b = beta - mu*a per channel, rounded to y's dtype before the ReLU; the 2x2
pool inside the channel dim (channel (a*blk+b)*co+k, partners at offsets
co and blk*co); the train-mode BN backward through the batch statistics,
m_count = n*h*w*blk*blk, dgamma = sum dz*t_hat and dbeta = sum dz per co;
the pool VJP splitting an exact tie on rounded values 0.5/0.5.
Per-channel vectors are f32 vectors of C (a per-co vector tiled blk*blk
times), as the Pallas kernels take them.

Each pass dispatches on the device of its tensors: on the CPU it runs the
plain PyTorch version below (the tests hold it against the JAX function);
on a CUDA tensor it launches the kernel of ``csrc/bn_tail.cu`` or raises.
There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter

import torch

from tpu_sandbox_torch.ops import build
from tpu_sandbox_torch.ops.bn_tail_t import (
    _fold,
    _tie_weight,
    bwd_scales,
    global_scales,
    col_expand,
)
from tpu_sandbox_torch.ops.conv_t import wgrad_slabs

#: launches of the CUDA kernels, by pass and shape ("bn_tail fwd C256
#: CO16", "bn_tail bwd_reduce C128 CO32", "bn_tail bwd_apply C256 CO16");
#: only a kernel launch adds to it
LAUNCHES: Counter = Counter()

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong

#: the ctypes argument kinds of the library's C entry points (each returns
#: an int), in the order of csrc/bn_tail.cu's signatures: the dtype, the
#: tensors' pointers, N*H*W, C, co, blk, the pass's slab plan, the stream
ARGTYPES = {
    "bn_tail_slots": [_I, _I],
    "bn_tail_fwd": [_I] + [_P] * 4 + [_L] + [_I] * 5 + [_P],
    "bn_tail_bwd_reduce": [_I] + [_P] * 8 + [_L] + [_I] * 5 + [_P],
    "bn_tail_bwd_apply": [_I] + [_P] * 10 + [_L] + [_I] * 5 + [_P],
}
#: each pass's index in ``bn_tail_slots``
_PASSES = {"fwd": 0, "bwd_apply": 1, "bwd_reduce": 2}
#: a slab of any pass is a whole number of runs of this many pixels:
#: a block's rounds of 256 // G pixels (G groups of channels a pixel) then
#: all fill but the slab's last wherever G is a power of two (8 and 4 on
#: the main path)
SLAB_QUANTUM = 256


def _lib() -> ctypes.CDLL:
    lib = build.load("bn_tail")
    if not getattr(lib, "_bound", False):
        for name, argtypes in ARGTYPES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = _I
        lib._bound = True
    return lib


def _check_geometry(y: torch.Tensor, co: int, blk: int) -> None:
    if y.dim() != 4:
        raise ValueError(f"expected y [N,H,W,C], got {tuple(y.shape)}")
    if blk < 2 or blk % 2 or y.shape[3] != blk * blk * co:
        raise ValueError(f"{y.shape[3]} channels are not {blk}x{blk} blocks "
                         f"of {co} (blk even)")


# -- plain PyTorch versions ----------------------------------------------


def _windows(t: torch.Tensor, blk: int, co: int) -> torch.Tensor:
    """[N,H,W,C] -> [N,H,W,blk/2,2,blk/2,2,co]: dims 4 and 6 are the low
    bits of (a, b); index 0 on both is a window's representative."""
    n, h, w, _ = t.shape
    return t.reshape(n, h, w, blk // 2, 2, blk // 2, 2, co)


def _rounded_relu(y: torch.Tensor, a: torch.Tensor,
                  b: torch.Tensor) -> torch.Tensor:
    """z in y's dtype, held in f32: rounded before the ReLU."""
    return torch.clamp_min((y.float() * a + b).to(y.dtype), 0).float()


def _dz(y, g, co, blk, a, b) -> torch.Tensor:
    """The pooled cotangent g routed back through the pool (the pair at
    offset blk*co first, then inside each pair at offset co; exact ties
    split 0.5/0.5) and masked by the ReLU: f32 [N,H,W,C]."""
    z = _rounded_relu(y, a, b)
    zw = _windows(z, blk, co)
    n, h, w, _ = g.shape
    gw = g.float().reshape(n, h, w, blk // 2, blk // 2, co)
    z00, z01 = zw[..., :, 0, :, 0, :], zw[..., :, 0, :, 1, :]
    z10, z11 = zw[..., :, 1, :, 0, :], zw[..., :, 1, :, 1, :]
    w2 = _tie_weight(torch.maximum(z00, z01), torch.maximum(z10, z11))
    da, db = gw * w2, gw * (1.0 - w2)
    w1a, w1b = _tie_weight(z00, z01), _tie_weight(z10, z11)
    pair_a = torch.stack([da * w1a, da * (1.0 - w1a)], dim=5)
    pair_b = torch.stack([db * w1b, db * (1.0 - w1b)], dim=5)
    dz = torch.stack([pair_a, pair_b], dim=4).reshape(z.shape)
    return torch.where(z > 0, dz, torch.zeros_like(dz))


def _t_hat(y, mu, inv, reps: int) -> torch.Tensor:
    return (y.float() - col_expand(mu, reps)) * col_expand(inv, reps)


def tail_fwd_plain(y, a, b, co: int, blk: int) -> torch.Tensor:
    """out = pool2x2(relu(round(y*a + b))) in y's dtype."""
    zw = _windows(_rounded_relu(y, a, b), blk, co)
    m = torch.maximum(
        torch.maximum(zw[..., :, 0, :, 0, :], zw[..., :, 0, :, 1, :]),
        torch.maximum(zw[..., :, 1, :, 0, :], zw[..., :, 1, :, 1, :]))
    n, h, w, _ = y.shape
    return m.reshape(n, h, w, -1).to(y.dtype)


def bwd_reduce_plain(y, g, co: int, blk: int, a, b, mu, inv):
    """(s1_co, s2_co): s1 = sum dz and s2 = sum dz*t_hat over (n, h, w),
    folded over the groups."""
    dz = _dz(y, g, co, blk, a, b)
    t_hat = _t_hat(y, mu, inv, blk * blk)
    s1 = dz.sum(dim=(0, 1, 2))
    s2 = (dz * t_hat).sum(dim=(0, 1, 2))
    return _fold(s1, co), _fold(s2, co)


def bwd_apply_plain(y, g, co: int, blk: int, a, b, mu, inv, gi, c1,
                    c2) -> torch.Tensor:
    """dy = gi*((dz - c1) - t_hat*c2), rounded once to y's dtype."""
    dz = _dz(y, g, co, blk, a, b)
    t_hat = _t_hat(y, mu, inv, blk * blk)
    return (gi * ((dz - c1) - t_hat * c2)).to(y.dtype)


# -- kernel wrappers -------------------------------------------------------


def _cuda_operands(what: str, y: torch.Tensor, g: torch.Tensor | None,
                   vecs, co_vecs=(), co: int = 0) -> None:
    if y.device.type != "cuda":
        raise ValueError(f"{what} kernel takes CUDA tensors, got {y.device}")
    if y.dtype not in _DTYPES:
        raise ValueError(f"{what} kernel takes float32 or bfloat16, got "
                         f"{y.dtype}")
    n, h, w, c = y.shape
    if c // 4 > 256:
        raise ValueError(f"{what} kernel takes C <= 1024, got {c}")
    if not y.is_contiguous():
        raise ValueError("y must be contiguous")
    if g is not None and (g.device != y.device or g.dtype != y.dtype
                          or tuple(g.shape) != (n, h, w, c // 4)
                          or not g.is_contiguous()):
        raise ValueError(f"g must be a contiguous {y.dtype} tensor of shape "
                         f"{(n, h, w, c // 4)} on {y.device}, got {g.dtype} "
                         f"{tuple(g.shape)} on {g.device}")
    for vs, n in ((vecs, c), (co_vecs, co)):
        for v in vs:
            if (v.device != y.device or v.dtype != torch.float32
                    or tuple(v.shape) != (n,) or not v.is_contiguous()):
                raise ValueError(f"per-channel vectors must be contiguous "
                                 f"f32 [{n}] on {y.device}")


def pixel_slabs(pixels: int, slots: int) -> tuple[int, int]:
    """(slabs, pixels_per_slab) of a pass: one block a slab of whole
    SLAB_QUANTUM-pixel runs, about ``slots`` slabs (the blocks the library
    asks for), every pixel in one slab and every slab non-empty."""
    runs = max(1, -(-pixels // SLAB_QUANTUM))
    _, per = wgrad_slabs(runs, 1, slots)
    per *= SLAB_QUANTUM
    return max(1, -(-pixels // per)), per


@functools.lru_cache(maxsize=None)
def _slots(device_index: int, what: str, c: int) -> int:
    """The blocks the library asks for the pass at C channels on a card: a
    property of the card and the kernel, asked once, off the launch's
    path."""
    with torch.cuda.device(device_index):
        slots = _lib().bn_tail_slots(_PASSES[what], c)
    if slots <= 0:
        raise RuntimeError(f"bn_tail {what}: the card's block count could "
                           "not be asked")
    return slots


def _slab_plan(what: str, y: torch.Tensor) -> tuple[int, int]:
    n, h, w, c = y.shape
    return pixel_slabs(n * h * w, _slots(y.device.index, what, c))


def _launch(fn_name: str, y: torch.Tensor, *ptrs, co: int, blk: int,
            plan: tuple[int, ...] = ()) -> None:
    lib = _lib()
    n, h, w, c = y.shape
    with torch.cuda.device(y.device):
        stream = torch.cuda.current_stream(y.device).cuda_stream
        err = getattr(lib, fn_name)(_DTYPES[y.dtype], y.data_ptr(),
                                    *[p.data_ptr() for p in ptrs], n * h * w,
                                    c, co, blk, *plan, stream)
    build.check(lib, err, fn_name)


def tail_fwd(y: torch.Tensor, a: torch.Tensor, b: torch.Tensor, co: int,
             blk: int) -> torch.Tensor:
    """The forward pass: y [N,H,W,blk*blk*co] -> pool2x2(relu(round(y*a +
    b))) [N,H,W,(blk//2)**2*co] in y's dtype."""
    _check_geometry(y, co, blk)
    if y.device.type == "cpu":
        return tail_fwd_plain(y, a, b, co, blk)
    _cuda_operands("bn_tail fwd", y, None, (a, b))
    n, h, w, c = y.shape
    out = torch.empty((n, h, w, c // 4), dtype=y.dtype, device=y.device)
    _launch("bn_tail_fwd", y, a, b, out, co=co, blk=blk,
            plan=_slab_plan("fwd", y))
    LAUNCHES[f"bn_tail fwd C{c} CO{co}"] += 1
    return out


def bwd_reduce(y: torch.Tensor, g: torch.Tensor, co: int, blk: int,
               a: torch.Tensor, b: torch.Tensor, mu: torch.Tensor,
               inv: torch.Tensor):
    """The backward's first pass: (s1_co [co], s2_co [co]) f32, s1 = sum
    dz and s2 = sum dz*t_hat over the whole batch, t_hat = (y - mu)*inv."""
    _check_geometry(y, co, blk)
    if y.device.type == "cpu":
        return bwd_reduce_plain(y, g, co, blk, a, b, mu, inv)
    # mu and inv go in per co: the kernel reads channel c's at c % co
    mu, inv = mu.float(), inv.float()
    _cuda_operands("bn_tail bwd_reduce", y, g, (a, b), (mu, inv), co)
    c = y.shape[3]
    plan = _slab_plan("bwd_reduce", y)
    # one partial row a slab, then their sum, which the library adds in a
    # fixed order
    part = torch.empty((plan[0] + 1, 2 * c), dtype=torch.float32,
                       device=y.device)
    sums = part[plan[0]]
    _launch("bn_tail_bwd_reduce", y, g, a, b, mu, inv, part, sums, co=co,
            blk=blk, plan=plan)
    LAUNCHES[f"bn_tail bwd_reduce C{c} CO{co}"] += 1
    # the fold over the groups stays outside the kernel, as in JAX
    return _fold(sums[:c], co), _fold(sums[c:], co)


def bwd_apply(y, g, co: int, blk: int, a, b, mu, inv, gi, c1,
              c2) -> torch.Tensor:
    """The backward's second pass: dy [N,H,W,C] in y's dtype."""
    _check_geometry(y, co, blk)
    if y.device.type == "cpu":
        return bwd_apply_plain(y, g, co, blk, a, b, mu, inv, gi, c1, c2)
    reps = blk * blk
    mu_v, inv_v = col_expand(mu, reps), col_expand(inv, reps)
    _cuda_operands("bn_tail bwd_apply", y, g, (a, b, mu_v, inv_v, gi, c1, c2))
    c = y.shape[3]
    dy = torch.empty_like(y)
    _launch("bn_tail_bwd_apply", y, g, a, b, mu_v, inv_v, gi, c1, c2, dy,
            co=co, blk=blk, plan=_slab_plan("bwd_apply", y))
    LAUNCHES[f"bn_tail bwd_apply C{c} CO{co}"] += 1
    return dy


# -- the fused function ----------------------------------------------------


def stats(y: torch.Tensor, co: int):
    """(mu [co], biased var [co]) in f32 over every dim but co."""
    yf = y.float().reshape(-1, y.shape[-1] // co, co)
    mu = yf.mean(dim=(0, 1))
    var = torch.clamp_min(yf.square().mean(dim=(0, 1)) - mu.square(), 0.0)
    return mu, var


def unfused_reference(y, gamma, beta, co: int, blk: int, eps: float = 1e-5):
    """The unfused NHWC tail as ConvNetS2D computes it in train mode:
    (pooled, mu, var). The contract the fused function must equal."""
    from tpu_sandbox_torch.models.convnet_s2d import block_max_pool

    *lead, c = y.shape
    yf = y.float().reshape(*lead, c // co, co)
    red = tuple(range(yf.dim() - 1))
    mu = yf.mean(dim=red)
    var = torch.clamp_min(yf.square().mean(dim=red) - mu.square(), 0.0)
    z = (yf - mu) * (torch.rsqrt(var + eps) * gamma.float()) + beta.float()
    z = torch.relu(z.reshape(*lead, c).to(y.dtype))
    return block_max_pool(z, blk, co), mu, var


def tail_forward(y, gamma, beta, co: int, blk: int, eps: float, s=None,
                 ss=None, group=None):
    """The fused forward, as JAX's ``_forward``: the statistics from the
    per-channel sums (s, ss) [1, C] when given, else a pass over y; the
    f32 vectors; the forward kernel. Returns (out, mu, var, inv, a, b).
    Under ``group`` (a ``StatsGroup``) the sums (taken from y when not
    given) and the element count are summed over its ranks first: the
    whole batch's statistics."""
    count = y.numel() // co
    if group is not None:
        if s is None:
            yf = y.float().reshape(-1, y.shape[-1])
            s, ss = yf.sum(dim=0)[None], yf.square().sum(dim=0)[None]
        (s, ss), count = group.totals((s, ss), count)
    if s is None:
        mu, var = stats(y, co)
    else:
        mu = _fold(s[0].float(), co) / count
        var = torch.clamp_min(_fold(ss[0].float(), co) / count - mu.square(),
                              0.0)
    inv = torch.rsqrt(var + eps)
    a_co = inv * gamma.float()
    reps = blk * blk
    a = col_expand(a_co, reps)
    b = col_expand(beta.float() - mu * a_co, reps)
    return tail_fwd(y, a, b, co, blk), mu, var, inv, a, b


class _FusedBnReluPool(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, gamma, beta, s, ss, co, blk, eps, group):
        out, mu, var, inv, a, b = tail_forward(y, gamma, beta, co, blk, eps,
                                               s, ss, group)
        ctx.save_for_backward(y, gamma, mu, inv, a, b)
        ctx.co, ctx.blk, ctx.group = co, blk, group
        ctx.mark_non_differentiable(mu, var)
        return out, mu, var

    @staticmethod
    def backward(ctx, g, _dmu, _dvar):
        # the mu/var cotangents are ignored, as in JAX: the running-stats
        # update is not differentiated
        y, gamma, mu, inv, a, b = ctx.saved_tensors
        co, blk = ctx.co, ctx.blk
        g = g.contiguous()
        s1_co, s2_co = bwd_reduce(y, g, co, blk, a, b, mu, inv)
        groups = blk * blk
        # the columns take the whole batch's sums; dgamma and dbeta stay
        # this rank's share, which the engine's gradient sync adds up
        gi, c1, c2 = global_scales(s1_co, s2_co, gamma, inv, groups,
                                   y.numel() // y.shape[3] * groups,
                                   ctx.group)
        dy = bwd_apply(y, g, co, blk, a, b, mu, inv, gi, c1, c2)
        # the sums' cotangents are zero by contract: dy already carries the
        # statistics' dependence on y
        ds = (torch.zeros((1, y.shape[3]), device=y.device)
              if ctx.needs_input_grad[3] else None)
        dss = (torch.zeros((1, y.shape[3]), device=y.device)
               if ctx.needs_input_grad[4] else None)
        return (dy, s2_co.to(gamma.dtype), s1_co.to(gamma.dtype), ds, dss,
                None, None, None, None)


def fused_bn_relu_pool(y: torch.Tensor, gamma: torch.Tensor,
                       beta: torch.Tensor, co: int, blk: int,
                       eps: float = 1e-5, ysums=None, group=None):
    """[N,H,W,blk*blk*co] conv output -> ([N,H,W,(blk//2)**2*co] pooled,
    mu [co], var [co]) with train-mode batch statistics: the grouped BN +
    relu + block_max_pool chain in one pass forward and two backward.
    ``ysums=(sum [1,C], sumsq [1,C])`` f32 per-channel sums of y (from
    ``conv3x3_stats``) replace the statistics pass over y. ``group`` (a
    ``StatsGroup``) makes the statistics the whole batch's: the forward's
    sums and the backward's reduce sums are summed over its ranks before
    the kernels that use them. mu and var are not differentiable."""
    s, ss = (None, None) if ysums is None else ysums
    return _FusedBnReluPool.apply(y.contiguous(), gamma, beta, s, ss, co,
                                  blk, eps, group)
