"""The port's model plans. Counterpart of ``tpu_sandbox/models/__init__.py``.

The transposed space-to-depth plan is ported with all of its options:
the sparse-tap or the scattered-3x3 conv1, the BN/ReLU/pool tails fused
or unfused, and the fused conv1+tail backward. Every other plan raises
``NotImplementedError`` rather than running something else in its place;
ROADMAP.md (queue 2) lists what is still to port.
"""

from __future__ import annotations

import torch

from tpu_sandbox_torch.models.convnet_s2d_t import ConvNetS2DT
from tpu_sandbox_torch.utils.device import resolve_device

__all__ = ["ConvNetS2DT", "pick_convnet", "resolve_fused_tail"]


def resolve_fused_tail(fused_tail: bool | None, device: torch.device) -> bool:
    """``None`` means the fused tail wherever its kernels run: JAX's
    "the Pallas kernels compile" read as "the model lives on a CUDA
    device". An explicit value is kept on every device."""
    return device.type == "cuda" if fused_tail is None else bool(fused_tail)


def pick_convnet(image_size, *, plan: str = "auto", fused_tail=None,
                 sparse_conv1: bool = True, fused_conv1_bwd: bool = True,
                 **kwargs) -> ConvNetS2DT:
    """The execution-plan switch. 'auto' and 's2dt' give ``ConvNetS2DT``
    with the JAX module's defaults, the sparse conv1 and the fused
    conv1+tail backward, its tails fused on the card and unfused on the
    CPU unless ``fused_tail`` says otherwise; the NHWC 's2d' plan, the
    'plain' ConvNet and image sizes not divisible by 4 are not ported yet
    and raise."""
    h, w = (image_size, image_size) if isinstance(image_size, int) else image_size
    if plan not in ("auto", "s2dt"):
        raise NotImplementedError(
            f"plan {plan!r} is not ported to PyTorch yet (ROADMAP.md, queue "
            "2); only the transposed space-to-depth plan 's2dt' is")
    if h % 4 or w % 4:
        raise NotImplementedError(
            f"image size {(h, w)} resolves to the plain ConvNet, which is "
            "not ported to PyTorch yet (ROADMAP.md, queue 2)")
    device = resolve_device(kwargs.pop("device", None))
    return ConvNetS2DT((h, w), fused_tail=resolve_fused_tail(fused_tail, device),
                       sparse_conv1=sparse_conv1,
                       fused_conv1_bwd=fused_conv1_bwd, device=device, **kwargs)
