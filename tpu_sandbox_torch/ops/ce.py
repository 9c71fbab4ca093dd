"""Fused softmax cross-entropy whose forward is a CUDA kernel.

Counterpart of ``tpu_sandbox/ops/pallas_ce.py``: ``pallas_cross_entropy``
(:49) with ``_forward`` (:69), ``_block_rows`` (:57) and the closed-form
backward ``_bwd`` (:112). The forward's per-row ``logsumexp - logit[label]``
is the kernel of ``csrc/ce.cu`` on a CUDA tensor and the plain version
below on the CPU; the mean is taken outside. The backward is
``(g / N) * (softmax(f32 logits) - onehot)`` in plain PyTorch, as the JAX
package leaves it to XLA. A vocabulary too wide for the Pallas kernel's
row block (``_block_rows`` is None) takes the plain loss: that is part of
the function's definition, not a fallback for a failed launch.
"""

from __future__ import annotations

import ctypes
from collections import Counter

import torch
import torch.nn.functional as F

from tpu_sandbox_torch.ops import build

#: launches of the CUDA kernel ("ce_fwd"); only a kernel launch adds to it
LAUNCHES: Counter = Counter()

NEG = -1e30          # the mask filler of the Pallas kernels
LANE = 128           # their lane tile
_BLOCK_N = 128

_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
_P = ctypes.c_void_p
_I = ctypes.c_int


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _block_rows(cp: int) -> int | None:
    """Rows of the Pallas kernel's row block at ``cp`` padded classes
    (a 4 MB f32 budget, multiples of 8, at most 128); None when even 8 rows
    exceed it, where the loss is the plain one."""
    budget = 4 * 1024 * 1024
    rows = (budget // (cp * 4) // 8) * 8
    return min(_BLOCK_N, rows) if rows >= 8 else None


def _lib() -> ctypes.CDLL:
    lib = build.load("ce")
    if not getattr(lib, "_bound", False):
        lib.ce_fwd.argtypes = [_I, _P, _P, _P, _I, _I, _P]
        lib.ce_fwd.restype = _I
        lib._bound = True
    return lib


def ce_rows_plain(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """logits [N, C], labels [N] -> f32 [N]: ``logsumexp - logit[label]``
    in f32, a label outside [0, C) picking 0."""
    x = logits.float()
    m = x.amax(-1, keepdim=True)
    lse = torch.log(torch.exp(x - m).sum(-1)) + m[:, 0]
    c = x.shape[-1]
    lab = labels.long()
    inside = (lab >= 0) & (lab < c)
    picked = x.gather(1, lab.clamp(0, c - 1)[:, None])[:, 0]
    return lse - torch.where(inside, picked, torch.zeros_like(picked))


def ce_rows(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Per-row cross-entropy, f32 [N]: the kernel on a CUDA tensor, the
    plain version on a CPU tensor."""
    if logits.ndim != 2 or labels.shape != logits.shape[:1]:
        raise ValueError(f"logits [N, C] and labels [N], got "
                         f"{tuple(logits.shape)} and {tuple(labels.shape)}")
    if logits.device.type == "cpu":
        return ce_rows_plain(logits, labels)
    if logits.device.type != "cuda" or labels.device != logits.device:
        raise ValueError(f"ce_fwd kernel takes logits and labels on one CUDA "
                         f"device, got {logits.device} and {labels.device}")
    if logits.dtype not in _DTYPES:
        raise ValueError(f"ce_fwd kernel takes float32 or bfloat16 logits, "
                         f"got {logits.dtype}")
    if not logits.is_contiguous():
        raise ValueError("logits must be contiguous")
    n, c = logits.shape
    labels = labels.long().contiguous()
    loss = torch.empty((n,), dtype=torch.float32, device=logits.device)
    lib = _lib()
    with torch.cuda.device(logits.device):
        stream = torch.cuda.current_stream(logits.device).cuda_stream
        err = lib.ce_fwd(_DTYPES[logits.dtype], logits.data_ptr(),
                         labels.data_ptr(), loss.data_ptr(), n, c, stream)
    build.check(lib, err, "ce_fwd")
    LAUNCHES["ce_fwd"] += 1
    return loss


class _FusedCE(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels):
        ctx.save_for_backward(logits, labels)
        return ce_rows(logits, labels).mean()

    @staticmethod
    def backward(ctx, g):
        logits, labels = ctx.saved_tensors
        n, c = logits.shape
        # softmax of the f32 logits without an f32 copy of them, then
        # (probs - onehot) in place; a label outside [0, C) has no onehot
        probs = torch.softmax(logits, -1, dtype=torch.float32)
        lab = labels.long()
        inside = ((lab >= 0) & (lab < c)).to(torch.float32)
        probs.scatter_add_(1, lab.clamp(0, c - 1)[:, None], -inside[:, None])
        probs.mul_(g / n)
        return probs.to(logits.dtype), None


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean softmax cross-entropy; logits [N, C] in any float, labels [N]
    int. Differentiable in the logits."""
    if _block_rows(round_up(logits.shape[-1], LANE)) is None:
        # vocabulary too wide for one row block: the plain loss
        return F.cross_entropy(logits.float(), labels.long())
    return _FusedCE.apply(logits, labels)
