"""ConvNetS2DT: the space-to-depth ConvNet in the transposed layout
[N, H, C, W], counterpart of ``tpu_sandbox/models/convnet_s2d_t.py``.

The same function as the reference ConvNet (conv 1->16 k5, BN, ReLU,
2x2 pool; conv 16->32 k5, BN, ReLU, pool; fc -> 10), and the same
parameter and batch-stats tree as the JAX module, so the weight bridge
(``utils/bridge.py``) is a rename. This slice ports the plan with
``fused_tail=False, sparse_conv1=False``: both convs run the scattered
3x3 conv kernel (``ops/conv_t.py``), the BN/ReLU/pool tails are plain
PyTorch, and the fc input gradient is the kernel of ``ops/fc_t.py``.

Layout: the input stage emits [N, H/4, 16, W/4] straight from the raw
28x28 batch (bilinear resize fused with space-to-depth); channel index
within C is (a*blk + b)*co + c, so BN groups, pool pairs and the kernel
scatter follow the JAX module unchanged; pool2's [N, H/4, 32, W/4] feeds
the fc, whose kernel rows are in canonical (h, c, w) order.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
from torch import nn

from tpu_sandbox_torch.models.convnet_s2d import scatter_kernel
from tpu_sandbox_torch.ops.conv_t import conv3x3_t
from tpu_sandbox_torch.ops.fc_t import fc_t
from tpu_sandbox_torch.utils.device import resolve_device


@functools.lru_cache(maxsize=8)
def resize_weights(src: int, dst: int) -> np.ndarray:
    """[dst, src] f32 bilinear interpolation matrix with the weights of
    ``jax.image.resize(..., method="bilinear")`` (antialiased): the
    triangle kernel at half-pixel centres, widened by src/dst when
    downsampling, each output row normalised by its weight sum, rows
    whose centre falls outside the input zeroed. Computed in f32, as JAX
    does."""
    f32 = np.float32
    inv_scale = f32(1.0) / (f32(dst) / f32(src))
    kernel_scale = max(inv_scale, f32(1.0))
    sample = (np.arange(dst, dtype=f32) + f32(0.5)) * inv_scale - f32(0.5)
    x = np.abs(sample[None, :] - np.arange(src, dtype=f32)[:, None]) / kernel_scale
    w = np.maximum(f32(0.0), f32(1.0) - np.abs(x)).astype(f32)   # [src, dst]
    total = w.sum(axis=0, keepdims=True, dtype=f32)
    ok = np.abs(total) > f32(1000.0) * np.finfo(np.float32).eps
    w = np.where(ok, w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample >= -0.5) & (sample <= src - 0.5)
    w = np.where(inside[None, :], w, f32(0.0)).astype(f32)
    return np.ascontiguousarray(w.T)


def as_nhw(x: torch.Tensor) -> torch.Tensor:
    """[N,H,W,1] or [N,H,W] -> [N,H,W]."""
    if x.dim() == 4:
        if x.shape[-1] != 1:
            raise ValueError("the s2d plan is for the 1-channel CNN")
        x = x[..., 0]
    return x


def space_to_depth_t(x: torch.Tensor, r: int) -> torch.Tensor:
    """[N,H,W] -> [N, H/r, r*r, W/r] (channel index a*r+b)."""
    n, h, w = x.shape
    x = x.reshape(n, h // r, r, w // r, r)
    return x.permute(0, 1, 2, 4, 3).reshape(n, h // r, r * r, w // r)


def block_max_pool_t(y: torch.Tensor, blk: int, co: int) -> torch.Tensor:
    """2x2/2 max-pool inside the channel dim: y [..., blk*blk*co, W] with
    ordering (a*blk+b)*co+c; pool pairs are the LOW bits of (a, b).
    Returns [..., (blk//2)**2*co, W]. Written with ``torch.maximum``, as
    the JAX function is, so that a tie splits the gradient 0.5/0.5
    (``max_pool2d`` would give all of it to one input)."""
    *lead, c, w = y.shape
    if c != blk * blk * co:
        raise ValueError(f"{c} channels are not {blk}x{blk} blocks of {co}")
    y = y.reshape(*lead, blk // 2, 2, blk // 2, 2, co, w)
    m = torch.maximum(
        torch.maximum(y[..., :, 0, :, 0, :, :], y[..., :, 0, :, 1, :, :]),
        torch.maximum(y[..., :, 1, :, 0, :, :], y[..., :, 1, :, 1, :, :]),
    )
    return m.reshape(*lead, (blk // 2) ** 2 * co, w)


def _lecun_normal_(t: torch.Tensor, fan_in: int,
                   gen: torch.Generator) -> torch.Tensor:
    """Flax's lecun_normal: truncated normal on [-2, 2] std, scaled so the
    variance is 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=gen)


class ConvT(nn.Module):
    """The canonical [5,5,ci,co] kernel and bias, run as the scattered
    3x3 conv on the r-block grid (``_ConvT`` on its scattered path)."""

    def __init__(self, shape: tuple[int, int, int, int], r: int,
                 dtype: torch.dtype, gen: torch.Generator):
        super().__init__()
        self.r, self.dtype = r, dtype
        self.kernel = nn.Parameter(_lecun_normal_(
            torch.empty(shape), shape[0] * shape[1] * shape[2], gen))
        self.bias = nn.Parameter(torch.zeros(shape[-1]))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # the weight rounds to the compute dtype BEFORE the scatter, and
        # the tiled bias is in the compute dtype too
        wg = scatter_kernel(self.kernel.to(self.dtype), self.r)
        reps = wg.shape[-1] // self.kernel.shape[-1]
        bias_g = self.bias.to(self.dtype).repeat(reps)
        return conv3x3_t(x.contiguous(), wg, bias_g)


class GroupedBNT(nn.Module):
    """BatchNorm over the transposed layout [..., g*co, W] with Flax
    semantics (``_GroupedBNT``): statistics in f32, the single-pass biased
    variance max(0, E[y^2] - E[y]^2), running stats updated as
    ``ra = 0.9*ra + 0.1*x`` with the biased variance, and the output cast
    to the compute dtype before ReLU and pool. Not ``nn.BatchNorm2d``,
    which updates with the unbiased variance."""

    MOMENTUM = 0.9
    EPSILON = 1e-5

    def __init__(self, features: int, dtype: torch.dtype):
        super().__init__()
        self.features, self.dtype = features, dtype
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        co = self.features
        *lead, c, w = y.shape
        yf = y.reshape(*lead, c // co, co, w).float()
        if self.training:
            red = tuple(i for i in range(yf.dim()) if i != yf.dim() - 2)
            mu = yf.mean(dim=red)
            mu2 = yf.square().mean(dim=red)
            var = torch.clamp_min(mu2 - mu.square(), 0.0)
            with torch.no_grad():
                m = self.MOMENTUM
                self.mean.copy_(m * self.mean + (1 - m) * mu)
                self.var.copy_(m * self.var + (1 - m) * var)
        else:
            mu, var = self.mean, self.var
        out = (yf - mu[:, None]) * (
            torch.rsqrt(var + self.EPSILON) * self.scale)[:, None] \
            + self.bias[:, None]
        return out.to(self.dtype).reshape(*lead, c, w)


class DenseT(nn.Module):
    """The fc over the transposed map without relayout: kernel
    [h*c*w, k] in canonical (h, c, w) rows, run through ``fc_t``."""

    def __init__(self, in_features: int, features: int, dtype: torch.dtype,
                 gen: torch.Generator):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(_lecun_normal_(
            torch.empty(in_features, features), in_features, gen))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        return fc_t(y, self.kernel, self.bias, self.dtype)


class ConvNetS2DT(nn.Module):
    """The two-block ConvNet on the transposed space-to-depth plan.

    ``image_size`` (H, W), each divisible by 4, sizes the fc as Flax's
    init-by-tracing does. Weights are drawn on the CPU from
    ``torch.Generator().manual_seed(seed)`` and then moved to ``device``
    (default ``cuda``, which must exist; pass ``device="cpu"`` for the
    CPU), so one seed gives the same weights on every device. Parameters
    stay f32; ``dtype`` is the compute dtype.
    """

    def __init__(self, image_size: tuple[int, int], *, num_classes: int = 10,
                 features: tuple[int, int] = (16, 32),
                 dtype: torch.dtype = torch.float32, seed: int = 0,
                 device: torch.device | str | None = None):
        super().__init__()
        h, w = image_size
        if h % 4 or w % 4:
            raise ValueError(f"the s2d plan needs H, W divisible by 4, got "
                             f"{image_size}")
        if len(features) != 2:
            raise ValueError("the s2d plan is the 2-block CNN")
        self.image_size = (h, w)
        self.dtype = dtype
        f1, f2 = features
        self.f1, self.f2 = f1, f2
        gen = torch.Generator().manual_seed(seed)
        self.conv1 = ConvT((5, 5, 1, f1), 4, dtype, gen)
        self.bn1 = GroupedBNT(f1, dtype)
        self.conv2 = ConvT((5, 5, f1, f2), 2, dtype, gen)
        self.bn2 = GroupedBNT(f2, dtype)
        self.fc = DenseT((h // 4) * f2 * (w // 4), num_classes, dtype, gen)
        self.to(resolve_device(device))

    def fused_input_stage(self, images: torch.Tensor,
                          image_size: tuple[int, int]) -> torch.Tensor:
        """Bilinear resize (``resize_weights``) fused with
        ``space_to_depth_t``: two small f32 contractions emit
        [N, H/4, 16, W/4] from the raw [N, h0, w0(, 1)] batch; the
        full-size image never exists."""
        H, W = image_size
        if H % 4 or W % 4:
            raise ValueError(f"image size must be divisible by 4: {image_size}")
        images = as_nhw(images)
        n, h0, w0 = images.shape
        dev = images.device
        ah4 = torch.from_numpy(resize_weights(h0, H)).to(dev).reshape(H // 4, 4, h0)
        aw4 = torch.from_numpy(resize_weights(w0, W)).to(dev).reshape(W // 4, 4, w0)
        x = images.float()
        u = torch.einsum("nij,wbj->nibw", x, aw4)           # [N, h0, 4, W/4]
        v = torch.einsum("hai,nibw->nhabw", ah4, u)
        return v.reshape(n, H // 4, 16, W // 4).to(self.dtype).contiguous()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [N,H,W,1], [N,H,W], or a pre-s2d [N,H/4,16,W/4] from
        ``fused_input_stage``. Returns f32 logits [N, num_classes]."""
        if x.dim() == 4 and x.shape[-1] != 1:
            if x.shape[2] != 16:
                raise ValueError(
                    "expected [N,H,W,1]/[N,H,W] or a fused_input_stage "
                    f"output [N,H/4,16,W/4]; got {tuple(x.shape)}")
            x = x.to(self.dtype)
        else:
            x = space_to_depth_t(as_nhw(x), 4).to(self.dtype)
        y = self.conv1(x)                                     # [N,H/4,16*f1,W/4]
        y = block_max_pool_t(torch.relu(self.bn1(y)), 4, self.f1)
        y = self.conv2(y)                                     # [N,H/4,4*f2,W/4]
        y = block_max_pool_t(torch.relu(self.bn2(y)), 2, self.f2)
        return self.fc(y).float()
