"""3x3 stride-1 SAME conv + bias in the NHWC layout [N, H, W, C].

Counterpart of ``tpu_sandbox/ops/pallas_conv.py``: ``conv3x3`` (:241)
with its custom VJP (:249-286), ``conv3x3_stats`` (:290) with its VJP
(:302-310), ``_flip_transpose`` (:234) and ``conv3x3_reference`` (:313).
Same interface: x [N,H,W,C], scattered w [3,3,C,CO], bias [CO] -> y
[N,H,W,CO] in x.dtype with f32 accumulation and one rounding; the stats
variant also returns the f32 per-channel (sum [1,CO], sumsq [1,CO]) of the
ROUNDED y, whose cotangents are ignored; the input gradient is the forward
kernel on flipped weights with zero bias, skipped when x needs no
gradient; the weight and bias gradients are one fused pass returning
(dw [9C, CO] f32 in (dy, dx, C) row order, db [1, CO] f32), cast to w's
dtype in the backward as the JAX VJP does.

Each function dispatches on the device of its tensors: on the CPU it runs
the plain PyTorch version below (the tests hold it against the JAX
function); on a CUDA tensor it launches the hand-written kernel of
``csrc/conv.cu`` or raises. There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch
import torch.nn.functional as F

from tpu_sandbox_torch.ops import build
from tpu_sandbox_torch.ops.conv_t import (_check_cuda, flip_transpose,
                                          fwd_units, wgrad_slabs)

#: launches of the CUDA kernels, by kernel, kind and channel counts
#: ("conv3x3 fwd C16 CO256", "conv3x3 dgrad C128 CO64",
#: "conv3x3_stats C64 CO128", "conv3x3_wgrad C16 CO256"); only a kernel
#: launch adds to it
LAUNCHES: Counter = Counter()

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: the most input channels of the bf16 forward (its weight tile and input
#: ring live in one block's shared memory)
MAX_BF16_FWD_C = 128
_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = build.load("conv")
    if not getattr(lib, "_bound", False):
        lib.conv3x3_fwd.argtypes = [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
        lib.conv3x3_fwd.restype = _I
        lib.conv3x3_fwd_stats.argtypes = [
            _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
        lib.conv3x3_fwd_stats.restype = _I
        lib.conv3x3_stats_parts.argtypes = [_I, _I, _I, _I, _I]
        lib.conv3x3_stats_parts.restype = _I
        lib.conv3x3_wgrad.argtypes = [
            _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
        lib.conv3x3_wgrad.restype = _I
        lib.conv3x3_wgrad_plan.argtypes = [_I, _I, _I]
        lib.conv3x3_wgrad_plan.restype = _I
        lib._bound = True
    return lib


def _check_layout(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:2]) != (3, 3):
        raise ValueError(f"expected x [N,H,W,C] and w [3,3,C,CO]; got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    if w.shape[2] != x.shape[3]:
        raise ValueError(f"w has {w.shape[2]} input channels, x has "
                         f"{x.shape[3]}")


# -- plain PyTorch versions ----------------------------------------------


def conv3x3_plain(x: torch.Tensor, w: torch.Tensor,
                  bias: torch.Tensor) -> torch.Tensor:
    """The forward as nine shifted-tap f32 products plus the bias, one
    rounding to x.dtype at the end: the kernel's math, written plainly."""
    _check_layout(x, w)
    n, h, wd, _ = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    wf = w.float()
    y = bias.float().expand(n, h, wd, -1).clone()
    for dy in range(3):
        for dx in range(3):
            tap = xp[:, dy:dy + h, dx:dx + wd, :]
            y += torch.einsum("nhwc,cd->nhwd", tap, wf[dy, dx])
    return y.to(x.dtype)


def conv3x3_stats_plain(x: torch.Tensor, w: torch.Tensor,
                        bias: torch.Tensor):
    """(y, sum [1,CO], sumsq [1,CO]): the plain forward, then f32 sums of
    the rounded y and of its squares over (n, h, w)."""
    y = conv3x3_plain(x, w, bias)
    yf = y.float()
    return (y, yf.sum(dim=(0, 1, 2))[None],
            yf.square().sum(dim=(0, 1, 2))[None])


def conv3x3_wgrad_plain(x: torch.Tensor, g: torch.Tensor):
    """(dw [9C, CO] f32, db [1, CO] f32): per tap, the f32 product of the
    shifted x with g summed over (n, h, w), rows in (dy, dx, C) order; db
    sums g."""
    n, h, wd, _ = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    gf = g.float()
    taps = [torch.einsum("nhwc,nhwd->cd", xp[:, dy:dy + h, dx:dx + wd, :], gf)
            for dy in range(3) for dx in range(3)]
    return torch.cat(taps, dim=0), gf.sum(dim=(0, 1, 2))[None]


def conv3x3_reference(x: torch.Tensor, w: torch.Tensor,
                      bias: torch.Tensor) -> torch.Tensor:
    """The library conv this kernel replaces (``ConvNetS2D``'s unfused
    conv, JAX's ``lax.conv`` there): ``F.conv2d`` on the NHWC tensor in
    x's dtype, then the bias added in that dtype."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1), padding=1)
    return y.permute(0, 2, 3, 1) + bias


# -- kernel wrappers -------------------------------------------------------


def _fwd_operands(what: str, x: torch.Tensor, w: torch.Tensor,
                  bias: torch.Tensor) -> torch.Tensor:
    """Checks a forward launch's operands; returns w as [9C, CO]."""
    n, h, wd, c = x.shape
    co = w.shape[-1]
    if x.dtype not in _DTYPES:
        raise ValueError(f"{what} kernel takes float32 or bfloat16, got "
                         f"{x.dtype}")
    if x.dtype == torch.bfloat16 and (c % 16 or co % 16
                                      or c > MAX_BF16_FWD_C):
        raise ValueError(f"{what} bf16 kernel takes C and CO multiples of "
                         f"16, C up to {MAX_BF16_FWD_C}, got {c} and {co}")
    if n * h > 65535:
        raise ValueError(f"{what} kernel takes N*H <= 65535 rows, got "
                         f"{n * h}")
    wm = w.reshape(9 * c, co).contiguous()
    _check_cuda("x", x, x.dtype, (n, h, wd, c))
    _check_cuda("w", wm, x.dtype, (9 * c, co))
    _check_cuda("bias", bias, x.dtype, (co,))
    for name, t in (("x", x), ("w", wm)):
        if t.data_ptr() % 32:
            raise ValueError(f"{name} must be 32-byte aligned")
    return wm


def conv3x3_forward(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                    *, kind: str = "fwd") -> torch.Tensor:
    """Non-differentiable forward. ``kind`` names the launch for the
    counter ("fwd" or "dgrad"); it does not change the math."""
    _check_layout(x, w)
    if x.device.type == "cpu":
        return conv3x3_plain(x, w, bias)
    wm = _fwd_operands("conv3x3", x, w, bias)
    n, h, wd, c = x.shape
    co = w.shape[-1]
    y = torch.empty((n, h, wd, co), dtype=x.dtype, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.conv3x3_fwd(_DTYPES[x.dtype], x.data_ptr(), wm.data_ptr(),
                              bias.data_ptr(), y.data_ptr(), n, h, wd, c, co,
                              stream)
    build.check(lib, err, "conv3x3_fwd")
    LAUNCHES[f"conv3x3 {kind} C{c} CO{co}"] += 1
    return y


def conv3x3_stats_forward(x: torch.Tensor, w: torch.Tensor,
                          bias: torch.Tensor):
    """Non-differentiable forward with fused BN statistics: (y, sum
    [1,CO] f32, sumsq [1,CO] f32) of the rounded y."""
    _check_layout(x, w)
    if x.device.type == "cpu":
        return conv3x3_stats_plain(x, w, bias)
    wm = _fwd_operands("conv3x3_stats", x, w, bias)
    n, h, wd, c = x.shape
    co = w.shape[-1]
    dt = _DTYPES[x.dtype]
    lib = _lib()
    parts = lib.conv3x3_stats_parts(dt, n, h, wd, co)
    y = torch.empty((n, h, wd, co), dtype=x.dtype, device=x.device)
    part = torch.empty((parts, 2 * co), dtype=torch.float32, device=x.device)
    sums = torch.empty((2 * co,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.conv3x3_fwd_stats(dt, x.data_ptr(), wm.data_ptr(),
                                    bias.data_ptr(), y.data_ptr(),
                                    part.data_ptr(), sums.data_ptr(), n, h, wd,
                                    c, co, stream)
    build.check(lib, err, "conv3x3_fwd_stats")
    LAUNCHES[f"conv3x3_stats C{c} CO{co}"] += 1
    return y, sums[None, :co], sums[None, co:]


#: pixels of a bf16 wgrad unit: one (image, W tile, h) row piece
WGRAD_UNIT_W = 128


def wgrad_units(rows: int, w: int, tiles: int,
                slots: int) -> tuple[int, int]:
    """(runs, units_per_run) of the bf16 wgrad: its ``rows`` (= N*H) *
    ceil(w / WGRAD_UNIT_W) units in contiguous runs, about ``slots //
    tiles`` a (channel chunk, co) tile, so the runs times the tiles fill
    the card once; every run non-empty. The kernel walks unit f of a run
    as column f // H (image, W tile) and row f % H."""
    return fwd_units(rows, -(-w // WGRAD_UNIT_W), tiles, slots)


def _wgrad_plan(lib, x: torch.Tensor, co: int) -> tuple[int, int]:
    """(slabs or runs, rows or units each) of a wgrad launch over x."""
    n, h, wd, c = x.shape
    if x.dtype == torch.float32:
        return wgrad_slabs(n * h)
    with torch.cuda.device(x.device):
        unit_w, tiles, slots = (lib.conv3x3_wgrad_plan(c, co, i)
                                for i in range(3))
    if unit_w != WGRAD_UNIT_W or min(tiles, slots) <= 0:
        raise RuntimeError(f"conv3x3_wgrad bf16: no plan for C {c}, CO {co}")
    if n * h * -(-wd // unit_w) >= 2 ** 31:
        raise ValueError(f"conv3x3_wgrad bf16 kernel takes fewer than 2^31 "
                         f"units, got {n * h} rows of {wd} pixels")
    return wgrad_units(n * h, wd, tiles, slots)


def conv3x3_wgrad(x: torch.Tensor, g: torch.Tensor):
    """Fused weight+bias gradient: x [N,H,W,C], g [N,H,W,CO] ->
    (dw [9C, CO] f32, db [1, CO] f32)."""
    if x.device.type == "cpu":
        return conv3x3_wgrad_plain(x, g)
    n, h, wd, c = x.shape
    co = g.shape[-1]
    if x.dtype not in _DTYPES:
        raise ValueError(f"conv3x3_wgrad kernel takes float32 or bfloat16, "
                         f"got {x.dtype}")
    if x.dtype == torch.bfloat16 and (c % 16 or co % 16):
        raise ValueError(f"conv3x3_wgrad bf16 kernel takes C and CO "
                         f"multiples of 16, got {c} and {co}")
    _check_cuda("x", x, x.dtype, (n, h, wd, c))
    _check_cuda("g", g, x.dtype, (n, h, wd, co))
    for name, t in (("x", x), ("g", g)):
        if t.data_ptr() % 32:
            raise ValueError(f"{name} must be 32-byte aligned")
    lib = _lib()
    slabs, per = _wgrad_plan(lib, x, co)
    m = 9 * c * co + co
    part = torch.empty((slabs, m), dtype=torch.float32, device=x.device)
    out = torch.empty((m,), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.conv3x3_wgrad(_DTYPES[x.dtype], x.data_ptr(), g.data_ptr(),
                                part.data_ptr(), out.data_ptr(), n, h, wd, c,
                                co, slabs, per, stream)
    build.check(lib, err, "conv3x3_wgrad")
    LAUNCHES[f"conv3x3_wgrad C{c} CO{co}"] += 1
    return out[: 9 * c * co].view(9 * c, co), out[9 * c * co:].view(1, co)


def _conv_backward(ctx, g):
    """(dx, dw, dbias) of both convs' Functions from the y cotangent."""
    x, w = ctx.saved_tensors
    g = g.contiguous()
    c, co = x.shape[3], w.shape[-1]
    dx = None
    # conv1's input is the image, which is not differentiated: JAX leaves
    # this pass to dead-code elimination, here it is skipped
    if ctx.needs_input_grad[0]:
        dx = conv3x3_forward(
            g, flip_transpose(w).contiguous(),
            torch.zeros((c,), dtype=g.dtype, device=g.device), kind="dgrad")
    dw, db = conv3x3_wgrad(x, g)
    return dx, dw.reshape(3, 3, c, co).to(w.dtype), db[0].to(w.dtype)


class _Conv3x3(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bias):
        ctx.save_for_backward(x, w)
        return conv3x3_forward(x, w, bias)

    @staticmethod
    def backward(ctx, g):
        return _conv_backward(ctx, g)


class _Conv3x3Stats(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bias):
        ctx.save_for_backward(x, w)
        y, s, ss = conv3x3_stats_forward(x, w, bias)
        # the consumer of the sums accounts for their dependence on y in
        # its own backward (the JAX VJP ignores their cotangents too)
        ctx.mark_non_differentiable(s, ss)
        return y, s, ss

    @staticmethod
    def backward(ctx, g, _ds, _dss):
        return _conv_backward(ctx, g)


def conv3x3(x: torch.Tensor, w: torch.Tensor,
            bias: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 SAME conv + bias: x [N,H,W,C], w [3,3,C,CO], bias
    [CO] -> y [N,H,W,CO] in x.dtype, f32 accumulation. Differentiable:
    the input gradient reuses the forward on flipped weights, the weight
    and bias gradients are the fused wgrad pass."""
    return _Conv3x3.apply(x.contiguous(), w.contiguous(), bias)


def conv3x3_stats(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor):
    """``conv3x3`` that also returns (sum [1,CO], sumsq [1,CO]) of the
    rounded output in f32: BN's batch statistics fused into the conv's
    output pass. Differentiable in x, w and bias through y only; the sums
    are not differentiable."""
    return _Conv3x3Stats.apply(x.contiguous(), w.contiguous(), bias)
