"""ConvNet: the plain NHWC ConvNet, counterpart of
``tpu_sandbox/models/convnet.py`` (``ConvNet`` :32-74).

One block per entry of ``features``: a 5x5 SAME conv (stride 1, padding
2), BN with Flax's semantics when ``use_bn``, ReLU and a 2x2/2 max pool
that floors as ``nn.max_pool``'s VALID window does; then the flatten in
the canonical (h, c, w) row order and a Dense. Any H and W run, so this
is the plan for image sizes not divisible by 4 and for ``--plan plain``.
It has no kernel of its own: the convs are ``F.conv2d`` on channels-last
views and the pool is ``F.max_pool2d``, as JAX leaves them to XLA.

The parameter and batch-stats tree is the space-to-depth plans' tree
(``conv{i}.kernel`` HWIO [5,5,ci,co], ``conv{i}.bias``,
``bn{i}.scale/bias/mean/var``, ``fc.kernel`` [H*C*W, K], ``fc.bias``), so
one bridged tree (``utils/bridge.py``) loads into all three plans.

The pool's gradient goes wholly to the first maximum of a window in
row-major order, as the gradient of ``nn.max_pool`` does (not the s2d
plans' 0.5/0.5 split of ``block_max_pool``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from tpu_sandbox_torch.models.convnet_s2d import Dense, GroupedBN, lecun_normal_
from tpu_sandbox_torch.utils.device import resolve_device


class Conv5(nn.Module):
    """Flax's ``nn.Conv(features, (5, 5), strides=1, padding=2, dtype)``:
    the kernel [5,5,ci,co] (lecun_normal) and bias, the input, kernel and
    bias cast to the compute dtype, on an NHWC tensor."""

    def __init__(self, ci: int, co: int, dtype: torch.dtype,
                 gen: torch.Generator):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(lecun_normal_(
            torch.empty(5, 5, ci, co), 25 * ci, gen))
        self.bias = nn.Parameter(torch.zeros(co))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # NHWC -> a channels-last NCHW view; HWIO -> OIHW
        y = F.conv2d(x.to(self.dtype).permute(0, 3, 1, 2),
                     self.kernel.to(self.dtype).permute(3, 2, 0, 1),
                     self.bias.to(self.dtype), padding=2)
        return y.permute(0, 2, 3, 1)


def max_pool(x: torch.Tensor) -> torch.Tensor:
    """2x2/2 max pool on NHWC, floored (``nn.max_pool``'s VALID window);
    the gradient of a tie goes to the window's first maximum."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


class ConvNet(nn.Module):
    """The plain ConvNet at any image size.

    ``image_size`` (H, W) sizes the fc as Flax's init-by-tracing does.
    Weights are drawn on the CPU from ``torch.Generator().manual_seed(seed)``
    in ConvNetS2DT's order (conv kernels, then the fc), so one seed gives
    the three plans equal state dicts at a 4-divisible size, and then moved
    to ``device`` (default ``cuda``, which must exist; pass
    ``device="cpu"`` for the CPU). Parameters stay f32; ``dtype`` is the
    compute dtype. ``use_bn=False`` registers no BN, as the JAX module then
    has no ``bn*`` variables.
    """

    def __init__(self, image_size: tuple[int, int], *, num_classes: int = 10,
                 features: tuple[int, ...] = (16, 32),
                 dtype: torch.dtype = torch.float32, seed: int = 0,
                 use_bn: bool = True,
                 device: torch.device | str | None = None):
        super().__init__()
        h, w = image_size
        self.image_size = (h, w)
        self.dtype = dtype
        self.use_bn = use_bn
        self.features = tuple(features)
        gen = torch.Generator().manual_seed(seed)
        ci = 1
        for i, co in enumerate(self.features, start=1):
            setattr(self, f"conv{i}", Conv5(ci, co, dtype, gen))
            if use_bn:
                setattr(self, f"bn{i}", GroupedBN(co, dtype))
            ci, h, w = co, h // 2, w // 2
        self.fc = Dense(h * ci * w, num_classes, dtype, gen)
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [N,H,W,C] (NHWC). Returns f32 logits [N, num_classes]."""
        for i in range(1, len(self.features) + 1):
            x = getattr(self, f"conv{i}")(x)
            if self.use_bn:
                x = getattr(self, f"bn{i}")(x)
            x = max_pool(F.relu(x))
        # canonical (h, c, w) fc row order
        x = x.permute(0, 1, 3, 2).reshape(x.shape[0], -1)
        return self.fc(x).float()
