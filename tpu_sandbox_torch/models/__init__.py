"""The port's model plans. Counterpart of ``tpu_sandbox/models/__init__.py``
(``resolves_to_s2d`` :6, ``resolve_plan`` :19, ``pick_convnet`` :36).

All three plans are ported with all of their options: the transposed
space-to-depth plan (``ConvNetS2DT``: the sparse-tap or the
scattered-3x3 conv1, the tails fused or unfused, the fused conv1+tail
backward), the NHWC space-to-depth plan (``ConvNetS2D``: the convs and
the tails each fused or not) and the plain NHWC ``ConvNet``, which an
image size not divisible by 4 also resolves to. ``use_bn`` reaches every
plan. JAX's "the Pallas kernels compile" reads here as "the model lives
on a CUDA device".
"""

from __future__ import annotations

import torch

from tpu_sandbox_torch.models.convnet import ConvNet
from tpu_sandbox_torch.models.convnet_s2d import ConvNetS2D
from tpu_sandbox_torch.models.convnet_s2d_t import ConvNetS2DT
from tpu_sandbox_torch.utils.device import resolve_device

__all__ = ["ConvNet", "ConvNetS2D", "ConvNetS2DT", "pick_convnet",
           "resolve_fused_tail", "resolve_plan", "resolves_to_s2d"]


def resolve_fused_tail(fused_tail: bool | None, device: torch.device) -> bool:
    """``None`` means the fused tail wherever its kernels run: JAX's
    "the Pallas kernels compile" read as "the model lives on a CUDA
    device". An explicit value is kept on every device. The same rule
    resolves ``fused_conv``."""
    return device.type == "cuda" if fused_tail is None else bool(fused_tail)


def resolves_to_s2d(image_size, plan: str = "auto") -> bool:
    """Does this (image_size, plan) request run a space-to-depth plan
    (NHWC or transposed)?"""
    h, w = (image_size, image_size) if isinstance(image_size, int) else image_size
    return plan != "plain" and (
        plan in ("s2d", "s2dt") or (plan == "auto" and h % 4 == 0
                                    and w % 4 == 0))


def resolve_plan(image_size, plan: str = "auto", device=None) -> str:
    """The concrete plan for a request: 's2dt', 's2d' or 'plain'. 'auto'
    gives the transposed plan where the kernels run (a CUDA ``device``,
    the default), the NHWC plan on the CPU, and the plain ConvNet when the
    image is not 4-divisible."""
    if plan not in ("auto", "s2dt", "s2d", "plain"):
        raise ValueError(f"unknown plan {plan!r}")
    if not resolves_to_s2d(image_size, plan):
        return "plain"
    if plan in ("s2d", "s2dt"):
        return plan
    return "s2dt" if resolve_device(device).type == "cuda" else "s2d"


def pick_convnet(image_size, *, plan: str = "auto", fused_tail=None,
                 fused_conv=None, sparse_conv1: bool = True,
                 fused_conv1_bwd: bool = True, **kwargs):
    """The execution-plan switch, JAX's rule:

    - 's2dt' (the card's 'auto'): ``ConvNetS2DT`` with the JAX module's
      defaults, the sparse conv1 and the fused conv1+tail backward;
    - 's2d' (the CPU's 'auto'): ``ConvNetS2D``, its convs and tails fused
      by default where the kernels run; the s2dt-only options
      ``sparse_conv1`` and ``fused_conv1_bwd`` are dropped;
    - ``fused_conv=False`` under 's2dt' drops to 's2d', since the
      transposed plan has no unfused conv;
    - 'plain', and 'auto' at image sizes not divisible by 4: the plain
      ``ConvNet``, with the space-to-depth options (``fused_tail``,
      ``fused_conv``, ``sparse_conv1``, ``fused_conv1_bwd``) dropped. An
      explicit 's2d' or 's2dt' at such a size resolves to that plan, and
      its model raises its shape error, as JAX's does.

    ``fused_tail`` and ``fused_conv`` left ``None`` resolve by the model's
    device (``resolve_fused_tail``); the other keywords (``use_bn``,
    ``dtype``, ``seed``, ...) reach every plan."""
    h, w = (image_size, image_size) if isinstance(image_size, int) else image_size
    device = resolve_device(kwargs.pop("device", None))
    resolved = resolve_plan((h, w), plan, device)
    if resolved == "plain":
        return ConvNet((h, w), device=device, **kwargs)
    if resolved == "s2dt" and fused_conv is False:
        resolved = "s2d"
    tail = resolve_fused_tail(fused_tail, device)
    if resolved == "s2dt":
        return ConvNetS2DT((h, w), fused_tail=tail, sparse_conv1=sparse_conv1,
                           fused_conv1_bwd=fused_conv1_bwd, device=device,
                           **kwargs)
    return ConvNetS2D((h, w), fused_tail=tail,
                      fused_conv=resolve_fused_tail(fused_conv, device),
                      device=device, **kwargs)
