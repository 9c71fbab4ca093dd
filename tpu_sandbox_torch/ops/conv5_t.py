"""Sparse-tap conv1 of the transposed space-to-depth plan: the 5x5 conv of
the one-channel image on its 4x4-blocked form x [N, H4, 16, W4], as one
[CO, 64] x [64, W] product per output row against the union tap tile.

Counterpart of ``tpu_sandbox/ops/pallas_conv5_t.py``: the constants,
``_scatter_indices`` (:65-76), ``scatter_k5`` (:79), ``gather_dk5`` (:87),
``_prep`` (:248), the data-only guard ``_data_only`` (:255-291),
``conv1_s2d_t`` (:300) and ``conv1_s2d_t_stats`` (:366) with their custom
VJPs (:344-383), ``conv1_s2d_t_wgrad`` (:309) and
``conv1_s2d_t_reference`` (:386). Same interface: x [N,H4,16,W4], the
canonical k5 [5,5,1,f1] and bias [f1] -> y [N,H4,16*f1,W4] in x.dtype with
f32 accumulation and one rounding; the stats variant also returns the f32
per-channel (sum [CO,1], sumsq [CO,1]) of the ROUNDED y, whose cotangents
are ignored; the weight and bias gradients are one fused pass returning
(dW1 [CO, 64] f32, db [CO, 1] f32), gathered back onto k5 and the bias.

The union tile: row t = (m'+2)*8 + (j+2), for m' and j in -2..5, is
x[n, h4 + m'//4, (m' % 4)*4 + j % 4, w4 + j//4] (Python's floor and mod),
zero outside the image. W1 [16*f1, 64] is k5 scattered onto it: output
channel (a'*4 + b')*f1 + co takes tap (ty, tx) at t = (a'+ty)*8 + (b'+tx).

conv1's input is the image, which is data: the x cotangent is never
computed, and a forward whose x requires grad raises rather than return a
silent zero for a trained input.

Each kernel dispatches on the device of its tensors: on the CPU it runs
the plain PyTorch version below (the tests hold it against the JAX
function); on a CUDA tensor it launches the hand-written kernel of
``csrc/conv5_t.cu`` or raises. There is no fallback between the two.
The TPU-only ``restage`` switch of the wgrad has no counterpart here.
"""

from __future__ import annotations

import ctypes
import functools
from collections import Counter

import numpy as np
import torch
import torch.nn.functional as F

from tpu_sandbox_torch.ops import build
from tpu_sandbox_torch.ops.conv_t import (_check_cuda, conv3x3_t, fwd_units,
                                          wgrad_slabs)

R = 4          # s2d factor of conv1
K5 = 5         # original kernel size
NT = 8 * 8     # union tap tile rows: (m', j) in (-2..5)^2
#: columns of a unit of work of the bf16 kernels (forward and wgrad, here
#: and in ops/conv1_tail_t.py): one (row, UNIT_W-column) piece of the output
UNIT_W = 64

#: launches of the CUDA kernels, by kind and output channels
#: ("conv1_s2d_t fwd CO256", "conv1_s2d_t_stats CO256",
#: "conv1_s2d_t_wgrad CO256"); only a kernel launch adds to it
LAUNCHES: Counter = Counter()

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = build.load("conv5_t")
    if not getattr(lib, "_bound", False):
        lib.conv1_s2d_t_fwd.argtypes = [
            _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
        lib.conv1_s2d_t_fwd.restype = _I
        lib.conv1_s2d_t_fwd_stats.argtypes = [
            _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
        lib.conv1_s2d_t_fwd_stats.restype = _I
        for plan in (lib.conv1_s2d_t_fwd_plan, lib.conv1_s2d_t_wgrad_plan):
            plan.argtypes = [_I]
            plan.restype = _I
        lib.conv1_s2d_t_stats_rows.argtypes = []
        lib.conv1_s2d_t_stats_rows.restype = _I
        lib.conv1_s2d_t_stats_wtiles.argtypes = [_I]
        lib.conv1_s2d_t_stats_wtiles.restype = _I
        lib.conv1_s2d_t_wgrad.argtypes = [
            _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P]
        lib.conv1_s2d_t_wgrad.restype = _I
        lib._bound = True
    return lib


# -- the weight scatter and its transpose --------------------------------


@functools.lru_cache(maxsize=2)
def _scatter_indices(f1: int):
    """Static index arrays mapping k5[ty, tx, 0, co] into W1[c_out, t]:
    c_out = (a'*4 + b')*f1 + co, t = (a'+ty)*8 + (b'+tx)."""
    a, b, ty, tx, co = np.meshgrid(
        np.arange(R), np.arange(R), np.arange(K5), np.arange(K5),
        np.arange(f1), indexing="ij",
    )
    rows = (a * R + b) * f1 + co
    cols = (a + ty) * 8 + (b + tx)
    return tuple(torch.from_numpy(v.reshape(-1))
                 for v in (rows, cols, ty, tx, co))


def scatter_k5(k5: torch.Tensor) -> torch.Tensor:
    """k5 [5,5,1,f1] -> W1 [16*f1, 64] (the union-tile weight). Every
    (row, col) is written once, so the assignment is exact."""
    f1 = k5.shape[-1]
    rows, cols, ty, tx, co = (i.to(k5.device) for i in _scatter_indices(f1))
    w1 = torch.zeros((R * R * f1, NT), dtype=k5.dtype, device=k5.device)
    w1[rows, cols] = k5[ty, tx, 0, co]
    return w1


def gather_dk5(dw1: torch.Tensor, f1: int) -> torch.Tensor:
    """Transpose of ``scatter_k5``: dW1 [16*f1, 64] -> dk5 [5,5,1,f1], each
    k5 tap summing its 16 (a', b') occurrences (a plain sum over two axes:
    the same order on every run, unlike an accumulating index_put_)."""
    rows, cols, *_ = (i.to(dw1.device) for i in _scatter_indices(f1))
    dk5 = dw1[rows, cols].reshape(R, R, K5, K5, f1).sum((0, 1))
    return dk5.reshape(K5, K5, 1, f1)


def prep(k5: torch.Tensor, bias: torch.Tensor, dtype: torch.dtype):
    """(W1 [16*f1, 64], bias [16*f1]) in ``dtype``: the weight rounds to
    the compute dtype BEFORE the scatter, the bias is tiled 16 times."""
    return scatter_k5(k5.to(dtype)), bias.to(dtype).repeat(R * R)


def fold_param_grads(dw1: torch.Tensor, db: torch.Tensor, f1: int,
                     k5_dtype: torch.dtype, bias_dtype: torch.dtype):
    """(dk5 [5,5,1,f1], dbias [f1]) from the wgrad's (dW1, db [CO,1])."""
    dk5 = gather_dk5(dw1, f1).to(k5_dtype)
    return dk5, db[:, 0].reshape(R * R, f1).sum(0).to(bias_dtype)


# -- plain PyTorch versions ----------------------------------------------


def _tap(t: int) -> tuple[int, int, int]:
    """Tile row t -> (block row offset + 1, channel, column offset + 1):
    the row, channel and column of x padded by one block on each side."""
    mp, j = t // 8 - 2, t % 8 - 2
    return mp // R + 1, (mp % R) * R + j % R, j // R + 1


def _check_x(x: torch.Tensor) -> None:
    if x.dim() != 4 or x.shape[2] != R * R:
        raise ValueError(f"conv1_s2d_t is the r=4, 1-channel-input conv: x "
                         f"must be [N,H4,16,W4], got {tuple(x.shape)}")


def union_tile_plain(x: torch.Tensor) -> torch.Tensor:
    """x [N,H4,16,W4] -> the union tap tile [N,H4,64,W4] in f32, from x
    zero-padded by one block row and one block column."""
    _check_x(x)
    n, h, _, w = x.shape
    xp = F.pad(x.float(), (1, 1, 0, 0, 1, 1))
    rows = []
    for t in range(NT):
        rr, ch, dc = _tap(t)
        rows.append(xp[:, rr:rr + h, ch, dc:dc + w])
    return torch.stack(rows, dim=2)


def conv1_s2d_t_plain(x: torch.Tensor, w1: torch.Tensor,
                      bias_g: torch.Tensor) -> torch.Tensor:
    """The forward as one f32 product with the union tile plus the bias,
    one rounding to x.dtype at the end: the kernel's math, written
    plainly."""
    y = torch.einsum("nhtw,ct->nhcw", union_tile_plain(x), w1.float())
    return (y + bias_g.float()[:, None]).to(x.dtype)


def conv1_s2d_t_stats_plain(x: torch.Tensor, w1: torch.Tensor,
                            bias_g: torch.Tensor):
    """(y, sum [CO,1], sumsq [CO,1]): the plain forward, then f32 sums of
    the rounded y and of its squares over (n, h, w)."""
    y = conv1_s2d_t_plain(x, w1, bias_g)
    yf = y.float()
    return (y, yf.sum(dim=(0, 1, 3))[:, None],
            yf.square().sum(dim=(0, 1, 3))[:, None])


def conv1_s2d_t_wgrad_plain(x: torch.Tensor, g: torch.Tensor):
    """(dW1 [CO, 64] f32, db [CO, 1] f32): the f32 product of g with the
    union tile summed over (n, h, w); db sums g."""
    gf = g.float()
    dw1 = torch.einsum("nhcw,nhtw->ct", gf, union_tile_plain(x))
    return dw1, gf.sum(dim=(0, 1, 3))[:, None]


# -- kernel wrappers -------------------------------------------------------


def units_plan(rows: int, w: int, slots: int) -> tuple[int, int]:
    """(blocks, units_per_block) of a bf16 kernel's persistent blocks: the
    ``rows`` * ceil(w / UNIT_W) (row, column) units in contiguous runs over
    at most ``slots`` blocks (``fwd_units`` with one channel tile: a block
    covers all of CO)."""
    return fwd_units(rows, -(-w // UNIT_W), 1, slots)


def bf16_units(plan, x: torch.Tensor, co: int, what: str) -> tuple[int, int]:
    """(blocks, per) of a bf16 launch over x [N,H,16,W] with ``co`` output
    channels. ``plan(i)`` is the library's plan entry: 0 its unit width, 1
    its blocks resident on the card at once, 2 the most channels it
    takes."""
    with torch.cuda.device(x.device):
        unit_w, slots, max_co = plan(0), plan(1), plan(2)
    if unit_w != UNIT_W or slots <= 0:
        raise RuntimeError(f"{what}: no plan (unit {unit_w}, slots {slots})")
    if co > max_co:
        raise ValueError(f"{what} bf16 kernel takes at most {max_co} output "
                         f"channels, got {co}")
    n, h, _, wd = x.shape
    return units_plan(n * h, wd, slots)


def _fwd_operands(x: torch.Tensor, w1: torch.Tensor,
                  bias_g: torch.Tensor) -> None:
    n, h, c, wd = x.shape
    co = w1.shape[0]
    if x.dtype not in _DTYPES:
        raise ValueError(f"conv1_s2d_t kernel takes float32 or bfloat16, got "
                         f"{x.dtype}")
    _check_cuda("x", x, x.dtype, (n, h, c, wd))
    _check_cuda("w1", w1, x.dtype, (co, NT))
    _check_cuda("bias", bias_g, x.dtype, (co,))


def _fwd_plan(lib, x: torch.Tensor, co: int) -> tuple[int, int, int]:
    """(blocks, units_per_block, stats partials) of a forward launch."""
    n, h, _, wd = x.shape
    if x.dtype == torch.float32:
        return 0, 0, (-(-(n * h) // lib.conv1_s2d_t_stats_rows())
                      * lib.conv1_s2d_t_stats_wtiles(wd))
    blocks, per = bf16_units(lib.conv1_s2d_t_fwd_plan, x, co,
                               "conv1_s2d_t")
    return blocks, per, blocks


def conv1_s2d_t_forward(x: torch.Tensor, w1: torch.Tensor,
                        bias_g: torch.Tensor) -> torch.Tensor:
    """Non-differentiable forward: x [N,H4,16,W4], W1 [CO, 64], bias [CO]
    -> y [N,H4,CO,W4] in x.dtype."""
    _check_x(x)
    if x.device.type == "cpu":
        return conv1_s2d_t_plain(x, w1, bias_g)
    _fwd_operands(x, w1, bias_g)
    n, h, _, wd = x.shape
    co = w1.shape[0]
    lib = _lib()
    blocks, per, _ = _fwd_plan(lib, x, co)
    y = torch.empty((n, h, co, wd), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.conv1_s2d_t_fwd(_DTYPES[x.dtype], x.data_ptr(),
                                  w1.data_ptr(), bias_g.data_ptr(),
                                  y.data_ptr(), n, h, co, wd, blocks, per,
                                  stream)
    build.check(lib, err, "conv1_s2d_t_fwd")
    LAUNCHES[f"conv1_s2d_t fwd CO{co}"] += 1
    return y


def conv1_s2d_t_stats_forward(x: torch.Tensor, w1: torch.Tensor,
                              bias_g: torch.Tensor):
    """Non-differentiable forward with fused BN statistics: (y, sum
    [CO,1] f32, sumsq [CO,1] f32) of the rounded y."""
    _check_x(x)
    if x.device.type == "cpu":
        return conv1_s2d_t_stats_plain(x, w1, bias_g)
    _fwd_operands(x, w1, bias_g)
    n, h, _, wd = x.shape
    co = w1.shape[0]
    lib = _lib()
    blocks, per, parts = _fwd_plan(lib, x, co)
    y = torch.empty((n, h, co, wd), dtype=x.dtype, device=x.device)
    part = torch.empty((parts, 2 * co), dtype=torch.float32, device=x.device)
    sums = torch.empty((2 * co,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.conv1_s2d_t_fwd_stats(_DTYPES[x.dtype], x.data_ptr(),
                                        w1.data_ptr(), bias_g.data_ptr(),
                                        y.data_ptr(), part.data_ptr(),
                                        sums.data_ptr(), n, h, co, wd, blocks,
                                        per, stream)
    build.check(lib, err, "conv1_s2d_t_fwd_stats")
    LAUNCHES[f"conv1_s2d_t_stats CO{co}"] += 1
    return y, sums[:co, None], sums[co:, None]


def conv1_s2d_t_wgrad(x: torch.Tensor, g: torch.Tensor):
    """Fused weight+bias gradient: x [N,H4,16,W4], g [N,H4,CO,W4] ->
    (dW1 [CO, 64] f32, db [CO, 1] f32)."""
    _check_x(x)
    if x.device.type == "cpu":
        return conv1_s2d_t_wgrad_plain(x, g)
    n, h, c, wd = x.shape
    co = g.shape[2]
    if x.dtype not in _DTYPES:
        raise ValueError(f"conv1_s2d_t_wgrad kernel takes float32 or "
                         f"bfloat16, got {x.dtype}")
    _check_cuda("x", x, x.dtype, (n, h, c, wd))
    _check_cuda("g", g, x.dtype, (n, h, co, wd))
    lib = _lib()
    if x.dtype == torch.float32:
        parts, per = wgrad_slabs(n * h)
    else:
        parts, per = bf16_units(lib.conv1_s2d_t_wgrad_plan, x, co,
                                "conv1_s2d_t_wgrad")
    m = co * NT + co
    part = torch.empty((parts, m), dtype=torch.float32, device=x.device)
    out = torch.empty((m,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.conv1_s2d_t_wgrad(_DTYPES[x.dtype], x.data_ptr(),
                                    g.data_ptr(), part.data_ptr(),
                                    out.data_ptr(), n, h, co, wd, parts, per,
                                    stream)
    build.check(lib, err, "conv1_s2d_t_wgrad")
    LAUNCHES[f"conv1_s2d_t_wgrad CO{co}"] += 1
    return out[: co * NT].view(co, NT), out[co * NT:].view(co, 1)


# -- the differentiable functions ----------------------------------------


def require_data_input(x: torch.Tensor, what: str) -> None:
    """Refuse to differentiate through x: the sparse conv1 returns no x
    cotangent by contract, which is right for the model's conv1, whose
    input is the image through the fixed input stage, and silently wrong
    after any trainable preprocessing."""
    if torch.is_grad_enabled() and x.requires_grad:
        raise ValueError(
            f"{what}'s input is being differentiated. This kernel returns "
            "a ZERO input cotangent by contract: its input must be data "
            "(the fused input stage output), never a function of trainable "
            "parameters; composing it after trainable preprocessing would "
            "produce silently wrong gradients. Use the scattered-3x3 conv1 "
            "instead (ConvNetS2DT(sparse_conv1=False) or "
            "ops.conv_t.conv3x3_t, which propagates a real input "
            "cotangent).")


def _conv1_backward(ctx, g):
    """(None, dk5, dbias) of both Functions from the y cotangent."""
    (x,) = ctx.saved_tensors
    dw1, db = conv1_s2d_t_wgrad(x, g.contiguous())
    return (None, *fold_param_grads(dw1, db, ctx.f1, *ctx.dtypes))


class _Conv1S2DT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k5, bias):
        ctx.save_for_backward(x)
        ctx.f1, ctx.dtypes = k5.shape[-1], (k5.dtype, bias.dtype)
        return conv1_s2d_t_forward(x, *prep(k5, bias, x.dtype))

    @staticmethod
    def backward(ctx, g):
        return _conv1_backward(ctx, g)


class _Conv1S2DTStats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k5, bias):
        ctx.save_for_backward(x)
        ctx.f1, ctx.dtypes = k5.shape[-1], (k5.dtype, bias.dtype)
        y, s, ss = conv1_s2d_t_stats_forward(x, *prep(k5, bias, x.dtype))
        # the consumer of the sums accounts for their dependence on y in
        # its own backward (the JAX VJP ignores their cotangents too)
        ctx.mark_non_differentiable(s, ss)
        return y, s, ss

    @staticmethod
    def backward(ctx, g, _ds, _dss):
        return _conv1_backward(ctx, g)


def conv1_s2d_t(x: torch.Tensor, k5: torch.Tensor,
                bias: torch.Tensor) -> torch.Tensor:
    """Sparse-tap conv1: x [N,H4,16,W4] (the s2d-transposed image, data
    only), k5 [5,5,1,f1] canonical 5x5 weights, bias [f1] -> y
    [N,H4,16*f1,W4] in x.dtype, f32 accumulation. Differentiable in k5
    and bias; an x that requires grad raises."""
    require_data_input(x, "conv1_s2d_t")
    return _Conv1S2DT.apply(x.contiguous(), k5, bias)


def conv1_s2d_t_stats(x: torch.Tensor, k5: torch.Tensor, bias: torch.Tensor):
    """``conv1_s2d_t`` that also returns (sum [CO,1], sumsq [CO,1]) of the
    rounded output in f32, as ``conv3x3_t_stats`` does; the sums are not
    differentiable. The same data-only guard on x."""
    require_data_input(x, "conv1_s2d_t_stats")
    return _Conv1S2DTStats.apply(x.contiguous(), k5, bias)


def conv1_s2d_t_reference(x: torch.Tensor, k5: torch.Tensor,
                          bias: torch.Tensor) -> torch.Tensor:
    """Equality contract: the port's scattered-3x3 conv1 (as ConvT runs it
    with ``sparse=False``) on the same operands."""
    from tpu_sandbox_torch.models.convnet_s2d import scatter_kernel

    wg = scatter_kernel(k5.to(x.dtype), R)
    reps = wg.shape[-1] // k5.shape[-1]
    return conv3x3_t(x.contiguous(), wg, bias.to(x.dtype).repeat(reps))
