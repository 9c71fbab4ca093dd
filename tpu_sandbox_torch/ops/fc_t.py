"""The transposed plan's fc head, whose input gradient is a CUDA kernel.

Counterpart of ``tpu_sandbox/ops/pallas_fc_t.py``: ``fc_t`` (:97) with
``_fc_fwd_core`` (:116) and ``_fc_vjp_bwd`` (:129-141), and ``fc_dgrad_t``
(:71). The fc kernel parameter is f32 [H*C*W, K] in canonical (h, c, w)
row order; it is staged once per step as the k-major wT [K, H, C, W] in
the compute dtype. The forward and the weight gradient are plain matrix
products, as the JAX package leaves them to XLA; the input gradient
``dy[n,h,c,w] = sum_k g[n,k] * wT[k,h,c,w]`` is the kernel of
``csrc/fc_t.cu`` on a CUDA tensor and the plain version below on the CPU.
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch

from tpu_sandbox_torch.ops import build

#: launches of the CUDA kernel ("fc_dgrad_t"); only a kernel launch adds to it
LAUNCHES: Counter = Counter()

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib() -> ctypes.CDLL:
    lib = build.load("fc_t")
    if not getattr(lib, "_bound", False):
        lib.fc_dgrad_t.argtypes = [_I, _P, _P, _P, _I, _I, ctypes.c_longlong, _P]
        lib.fc_dgrad_t.restype = _I
        lib._bound = True
    return lib


def fc_dgrad_t_plain(g: torch.Tensor, wt: torch.Tensor,
                     out_dtype: torch.dtype) -> torch.Tensor:
    """g [N, K] f32, wT [K, H, C, W] -> dy [N, H, C, W] in ``out_dtype``:
    the k-sum in f32, rounded once."""
    k = wt.shape[0]
    dy = (g.float() @ wt.reshape(k, -1).float()).reshape(
        g.shape[0], *wt.shape[1:])
    return dy.to(out_dtype)


def fc_dgrad_t(g: torch.Tensor, wt: torch.Tensor,
               out_dtype: torch.dtype) -> torch.Tensor:
    """g [N, K] f32, wT [K, H, C, W] (k-major) -> dy [N, H, C, W] in
    ``out_dtype``, f32 accumulation."""
    n, k = g.shape
    if wt.shape[0] != k:
        raise ValueError(f"g has {k} classes, wT has {wt.shape[0]}")
    if g.device.type == "cpu":
        return fc_dgrad_t_plain(g, wt, out_dtype)
    if g.device.type != "cuda" or wt.device != g.device:
        raise ValueError(f"fc_dgrad_t kernel takes g and wT on one CUDA "
                         f"device, got {g.device} and {wt.device}")
    if g.dtype != torch.float32:
        raise ValueError(f"g must be float32, got {g.dtype}")
    if wt.dtype not in _DTYPES or out_dtype != wt.dtype:
        raise ValueError(f"fc_dgrad_t kernel takes wT and dy both float32 or "
                         f"both bfloat16, got {wt.dtype} -> {out_dtype}")
    if not (g.is_contiguous() and wt.is_contiguous()):
        raise ValueError("g and wT must be contiguous")
    f = wt.numel() // k
    if (f * wt.element_size()) % 16 or wt.data_ptr() % 16:
        raise ValueError(f"wT rows must be 16-byte aligned multiples of 16 "
                         f"bytes, got {f} x {wt.element_size()} bytes")
    if n * k > 12288:
        raise ValueError(f"g must fit in 48 KB of shared memory, got {n}x{k}")
    dy = torch.empty((n, *wt.shape[1:]), dtype=out_dtype, device=g.device)
    lib = _lib()
    with torch.cuda.device(g.device):
        stream = torch.cuda.current_stream(g.device).cuda_stream
        err = lib.fc_dgrad_t(_DTYPES[wt.dtype], g.data_ptr(), wt.data_ptr(),
                             dy.data_ptr(), n, k, f, stream)
    build.check(lib, err, "fc_dgrad_t")
    LAUNCHES["fc_dgrad_t"] += 1
    return dy


def stage_wt(kernel2d: torch.Tensor, shape, dtype: torch.dtype) -> torch.Tensor:
    """f32 [H*C*W, K] -> the k-major wT [K, H, C, W] in ``dtype``."""
    k = kernel2d.shape[-1]
    return kernel2d.t().reshape(k, *shape).to(dtype).contiguous()


class _FcT(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, kernel2d, bias, dtype):
        n = y.shape[0]
        wt = stage_wt(kernel2d, y.shape[1:], dtype)
        out = y.reshape(n, -1) @ wt.reshape(wt.shape[0], -1).t()
        ctx.save_for_backward(y, wt)
        return out + bias.to(dtype)

    @staticmethod
    def backward(ctx, g):
        y, wt = ctx.saved_tensors
        n = g.shape[0]
        gf = g.float().contiguous()
        dy = fc_dgrad_t(gf, wt, y.dtype) if ctx.needs_input_grad[0] else None
        # weight gradient k-major in f32, then viewed as the canonical
        # [H*C*W, K] rows
        dkt = gf.t() @ y.reshape(n, -1).float()
        return dy, dkt.t(), gf.sum(0), None


def fc_t(y: torch.Tensor, kernel2d: torch.Tensor, bias: torch.Tensor,
         dtype: torch.dtype) -> torch.Tensor:
    """y [N, H, C, W], kernel2d [H*C*W, K] f32, bias [K] f32 -> logits
    [N, K] in ``dtype``. Differentiable in all three tensors."""
    return _FcT.apply(y, kernel2d, bias, dtype)
