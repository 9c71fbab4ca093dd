"""3x3 stride-1 SAME conv + bias in the transposed layout [N, H, C, W].

Counterpart of ``tpu_sandbox/ops/pallas_conv_t.py``: ``conv3x3_t`` (:267)
with its custom VJP (:275-343) and ``conv3x3_t_wgrad`` (:293). Same
interface: x [N,H,C,W], scattered w [3,3,C,CO], bias [CO] -> y [N,H,CO,W]
in x.dtype with f32 accumulation and one rounding; the input gradient is
the forward kernel on flipped weights with zero bias; the weight and bias
gradients are one fused pass returning (dwT [CO, 9C] f32, db [CO, 1] f32).

Each function dispatches on the device of its tensors: on the CPU it runs
the plain PyTorch version below (the tests hold it against the JAX
function); on a CUDA tensor it launches the hand-written kernel of
``csrc/conv_t.cu`` or raises. There is no fallback between the two.
The TPU-only ``restage`` switch of the wgrad has no counterpart here.
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch

from tpu_sandbox_torch.ops import build

#: launches of the CUDA kernels, by kernel, kind and channel counts
#: ("conv3x3_t fwd C16 CO256", "conv3x3_t dgrad C128 CO64",
#: "conv3x3_t_wgrad C64 CO128"); only a kernel launch adds to it
LAUNCHES: Counter = Counter()

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
#: about this many wgrad slabs, so that the (co, k) tiles times the slabs
#: keep every SM busy
_WGRAD_SLABS = 128
_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = build.load("conv_t")
    if not getattr(lib, "_bound", False):
        lib.conv3x3_t_fwd.argtypes = [_I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]
        lib.conv3x3_t_fwd.restype = _I
        lib.conv3x3_t_wgrad.argtypes = [
            _I, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P]
        lib.conv3x3_t_wgrad.restype = _I
        lib._bound = True
    return lib


def _check_cuda(name: str, t: torch.Tensor, dtype, shape) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must have shape {tuple(shape)}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_layout(x: torch.Tensor, w: torch.Tensor) -> None:
    if x.dim() != 4 or w.dim() != 4 or tuple(w.shape[:2]) != (3, 3):
        raise ValueError(f"expected x [N,H,C,W] and w [3,3,C,CO]; got "
                         f"{tuple(x.shape)}, {tuple(w.shape)}")
    if w.shape[2] != x.shape[2]:
        raise ValueError(f"w has {w.shape[2]} input channels, x has "
                         f"{x.shape[2]}")


# -- plain PyTorch versions ----------------------------------------------


def conv3x3_t_plain(x: torch.Tensor, w: torch.Tensor,
                    bias: torch.Tensor) -> torch.Tensor:
    """The forward as nine shifted-tap f32 products plus the bias, one
    rounding to x.dtype at the end: the kernel's math, written plainly."""
    _check_layout(x, w)
    n, h, c, wd = x.shape
    xp = torch.nn.functional.pad(x.float(), (1, 1, 0, 0, 1, 1))
    wf = w.float()
    y = bias.float()[None, None, :, None].expand(n, h, -1, wd).clone()
    for dy in range(3):
        for dx in range(3):
            tap = xp[:, dy:dy + h, :, dx:dx + wd]
            y += torch.einsum("nhcw,cd->nhdw", tap, wf[dy, dx])
    return y.to(x.dtype)


def conv3x3_t_wgrad_plain(x: torch.Tensor, g: torch.Tensor):
    """(dwT [CO, 9C] f32, db [CO, 1] f32): per tap, the f32 product of g
    with the shifted x summed over (n, h, w); db sums g."""
    n, h, c, wd = x.shape
    xp = torch.nn.functional.pad(x.float(), (1, 1, 0, 0, 1, 1))
    gf = g.float()
    taps = [torch.einsum("nhdw,nhcw->dc", gf, xp[:, dy:dy + h, :, dx:dx + wd])
            for dy in range(3) for dx in range(3)]
    dwt = torch.cat(taps, dim=1)
    db = gf.sum(dim=(0, 1, 3))[:, None]
    return dwt, db


# -- kernel wrappers -------------------------------------------------------


def conv3x3_t_forward(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                      *, kind: str = "fwd") -> torch.Tensor:
    """Non-differentiable forward. ``kind`` names the launch for the
    counter ("fwd" or "dgrad"); it does not change the math."""
    _check_layout(x, w)
    if x.device.type == "cpu":
        return conv3x3_t_plain(x, w, bias)
    n, h, c, wd = x.shape
    co = w.shape[-1]
    if x.dtype not in _DTYPES:
        raise ValueError(f"conv3x3_t kernel takes float32 or bfloat16, got "
                         f"{x.dtype}")
    if x.dtype == torch.bfloat16 and c % 16:
        raise ValueError(f"conv3x3_t bf16 kernel takes C a multiple of 16, "
                         f"got {c}")
    if n * h > 65535:
        raise ValueError(f"conv3x3_t kernel takes N*H <= 65535 rows, got "
                         f"{n * h}")
    wt = w.reshape(9 * c, co).t().contiguous()
    _check_cuda("x", x, x.dtype, (n, h, c, wd))
    _check_cuda("wt", wt, x.dtype, (co, 9 * c))
    _check_cuda("bias", bias, x.dtype, (co,))
    y = torch.empty((n, h, co, wd), dtype=x.dtype, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.conv3x3_t_fwd(_DTYPES[x.dtype], x.data_ptr(), wt.data_ptr(),
                                bias.data_ptr(), y.data_ptr(), n, h, c, co, wd,
                                stream)
    build.check(lib, err, "conv3x3_t_fwd")
    LAUNCHES[f"conv3x3_t {kind} C{c} CO{co}"] += 1
    return y


def wgrad_slabs(rows: int) -> tuple[int, int]:
    """(slabs, rows_per_slab) for the wgrad's split of the N*H rows:
    at most ``_WGRAD_SLABS`` slabs, every one non-empty."""
    per = -(-rows // min(rows, _WGRAD_SLABS))
    return -(-rows // per), per


def conv3x3_t_wgrad(x: torch.Tensor, g: torch.Tensor):
    """Fused weight+bias gradient: x [N,H,C,W], g [N,H,CO,W] ->
    (dwT [CO, 9C] f32, db [CO, 1] f32)."""
    if x.device.type == "cpu":
        return conv3x3_t_wgrad_plain(x, g)
    n, h, c, wd = x.shape
    co = g.shape[2]
    if x.dtype not in _DTYPES:
        raise ValueError(f"conv3x3_t_wgrad kernel takes float32 or bfloat16, "
                         f"got {x.dtype}")
    _check_cuda("x", x, x.dtype, (n, h, c, wd))
    _check_cuda("g", g, x.dtype, (n, h, co, wd))
    slabs, per = wgrad_slabs(n * h)
    m = co * 9 * c + co
    part = torch.empty((slabs, m), dtype=torch.float32, device=x.device)
    out = torch.empty((m,), dtype=torch.float32, device=x.device)
    lib = _lib()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.conv3x3_t_wgrad(_DTYPES[x.dtype], x.data_ptr(), g.data_ptr(),
                                  part.data_ptr(), out.data_ptr(), n, h, c, co,
                                  wd, slabs, per, stream)
    build.check(lib, err, "conv3x3_t_wgrad")
    LAUNCHES[f"conv3x3_t_wgrad C{c} CO{co}"] += 1
    return out[: co * 9 * c].view(co, 9 * c), out[co * 9 * c:].view(co, 1)


def flip_transpose(w: torch.Tensor) -> torch.Tensor:
    """Forward weights -> input-gradient weights: spatial flip + ci/co
    transpose."""
    return w.flip(0, 1).transpose(2, 3)


class _Conv3x3T(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, w, bias):
        ctx.save_for_backward(x, w)
        return conv3x3_t_forward(x, w, bias)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g = g.contiguous()
        c, co = x.shape[2], w.shape[-1]
        dx = None
        # conv1's input is the image, which is not differentiated: JAX
        # leaves this pass to dead-code elimination, here it is skipped
        if ctx.needs_input_grad[0]:
            dx = conv3x3_t_forward(
                g, flip_transpose(w),
                torch.zeros((c,), dtype=g.dtype, device=g.device),
                kind="dgrad")
        dwt, db = conv3x3_t_wgrad(x, g)
        dw = dwt.t().reshape(3, 3, c, co).to(w.dtype)
        return dx, dw, db[:, 0].to(w.dtype)


def conv3x3_t(x: torch.Tensor, w: torch.Tensor,
              bias: torch.Tensor) -> torch.Tensor:
    """3x3 stride-1 SAME conv + bias in transposed layout: x [N,H,C,W],
    w [3,3,C,CO], bias [CO] -> y [N,H,CO,W] in x.dtype, f32 accumulation.
    Differentiable: the input gradient reuses the forward on flipped
    weights, the weight and bias gradients are the fused wgrad pass."""
    return _Conv3x3T.apply(x, w, bias)
