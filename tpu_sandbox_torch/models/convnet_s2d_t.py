"""ConvNetS2DT: the space-to-depth ConvNet in the transposed layout
[N, H, C, W], counterpart of ``tpu_sandbox/models/convnet_s2d_t.py``.

The same function as the reference ConvNet (conv 1->16 k5, BN, ReLU,
2x2 pool; conv 16->32 k5, BN, ReLU, pool; fc -> 10), and the same
parameter and batch-stats tree as the JAX module, so the weight bridge
(``utils/bridge.py``) is a rename. The same options, with the JAX
module's defaults: conv1 runs the sparse-tap kernel (``ops/conv5_t.py``)
unless ``sparse_conv1=False`` puts it on the scattered 3x3 conv kernel
(``ops/conv_t.py``), which conv2 always runs; the fc input gradient is the
kernel of ``ops/fc_t.py``. With ``fused_tail=True`` (the card's default
through ``pick_convnet``) a training forward takes each conv's BN
statistics from its fused-stats kernel and runs each BN/ReLU/pool tail as
the fused kernels of ``ops/bn_tail_t.py``; with the sparse conv1 and
``fused_conv1_bwd=True`` as well, conv1 and its tail are one unit
(``ops/conv1_tail_t.py``) whose backward never stores conv1's output
cotangent. With ``fused_tail=False``, and in eval mode either way, the
tails are plain PyTorch.

Layout: the input stage emits [N, H/4, 16, W/4] straight from the raw
28x28 batch (bilinear resize fused with space-to-depth); channel index
within C is (a*blk + b)*co + c, so BN groups, pool pairs and the kernel
scatter follow the JAX module unchanged; pool2's [N, H/4, 32, W/4] feeds
the fc, whose kernel rows are in canonical (h, c, w) order.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
from torch import nn

from tpu_sandbox_torch.models.convnet_s2d import (
    Conv,
    Dense,
    GroupedBN,
    as_nhw,
    scatter_kernel,
)
from tpu_sandbox_torch.ops.bn_tail_t import fused_bn_relu_pool_t
from tpu_sandbox_torch.ops.conv1_tail_t import conv1_tail_t
from tpu_sandbox_torch.ops.conv5_t import conv1_s2d_t, conv1_s2d_t_stats
from tpu_sandbox_torch.ops.conv_t import conv3x3_t, conv3x3_t_stats
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


class ConvT(Conv):
    """``Conv``'s canonical [5,5,ci,co] kernel and bias in the transposed
    layout. With ``sparse``, conv1 (r=4, one input channel) runs the
    sparse-tap union-tile conv (``_ConvT.sparse``); otherwise the
    scattered 3x3 conv on the r-block grid."""

    def __init__(self, shape: tuple[int, int, int, int], r: int,
                 dtype: torch.dtype, gen: torch.Generator,
                 sparse: bool = False):
        super().__init__(shape, r, dtype, gen, fused=True)
        self.sparse = sparse and r == 4 and shape[2] == 1

    def forward(self, x: torch.Tensor, want_stats: bool = False):
        """y, or with ``want_stats`` (y, (sum [CO,1], sumsq [CO,1])) from
        the fused-stats kernel."""
        # the weight rounds to the compute dtype BEFORE the scatter, and
        # the tiled bias is in the compute dtype too
        k, b = self.params()
        if self.sparse:
            if want_stats:
                y, s, ss = conv1_s2d_t_stats(x, k, b)
                return y, (s, ss)
            return conv1_s2d_t(x, k, b)
        wg = scatter_kernel(k, self.r)
        bias_g = b.repeat(wg.shape[-1] // k.shape[-1])
        if want_stats:
            y, s, ss = conv3x3_t_stats(x.contiguous(), wg, bias_g)
            return y, (s, ss)
        return conv3x3_t(x.contiguous(), wg, bias_g)


class GroupedBNT(GroupedBN):
    """``GroupedBN`` (Flax's BatchNorm semantics, the same variables) over
    the transposed layout [..., g*co, W] (``_GroupedBNT``)."""

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        co = self.features
        *lead, c, w = y.shape
        yf = y.reshape(*lead, c // co, co, w).float()
        if self.training:
            red = tuple(i for i in range(yf.dim()) if i != yf.dim() - 2)
            mu = yf.mean(dim=red)
            mu2 = yf.square().mean(dim=red)
            var = torch.clamp_min(mu2 - mu.square(), 0.0)
            self._update_running(mu, var)
        else:
            mu, var = self.mean, self.var
        out = (yf - mu[:, None]) * (
            torch.rsqrt(var + self.EPSILON) * self.scale)[:, None] \
            + self.bias[:, None]
        return out.to(self.dtype).reshape(*lead, c, w)

    def fused(self, y: torch.Tensor, blk: int, ysums=None) -> torch.Tensor:
        """Train-mode BN + ReLU + 2x2 block pool as the fused kernels
        (``fused_bn_relu_pool_t``), with the statistics from ``ysums``
        when the conv gave them; updates the running stats."""
        out, mu, var = fused_bn_relu_pool_t(
            y, self.scale, self.bias, self.features, blk, self.EPSILON, ysums)
        self._update_running(mu, var)
        return out

    def fused_conv1(self, x: torch.Tensor, k5: torch.Tensor,
                    cbias: torch.Tensor, blk: int) -> torch.Tensor:
        """conv1 and this BN's tail as one unit (``conv1_tail_t``): the
        forward of the sparse conv1 with stats and ``fused``, a backward
        that never stores conv1's output cotangent; updates the running
        stats."""
        out, mu, var = conv1_tail_t(x, k5, cbias, self.scale, self.bias,
                                    self.features, blk, self.EPSILON)
        self._update_running(mu, var)
        return out


class DenseT(Dense):
    """``Dense`` over the transposed map without relayout: kernel
    [h*c*w, k] in canonical (h, c, w) rows, run through ``fc_t``."""

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        return fc_t(y, self.kernel, self.bias, self.dtype)


class ConvNetS2DT(nn.Module):
    """The two-block ConvNet on the transposed space-to-depth plan.

    ``image_size`` (H, W), each divisible by 4, sizes the fc as Flax's
    init-by-tracing does. ``fused_tail`` runs each training-mode tail as
    the fused kernels on the conv's fused statistics; ``sparse_conv1``
    runs conv1 as the sparse-tap kernel, and with both it and
    ``fused_conv1_bwd`` a training step runs conv1 and its tail as one
    unit with the fused backward. ``use_bn=False`` registers no BN (the
    JAX module then has no ``bn*`` variables): each tail is ReLU and the
    block pool, the convs run without statistics and the fused conv1+tail
    unit is off. Weights are drawn on
    the CPU from ``torch.Generator().manual_seed(seed)`` and then moved to
    ``device`` (default ``cuda``, which must exist; pass ``device="cpu"``
    for the CPU), so one seed gives the same weights on every device.
    Parameters stay f32; ``dtype`` is the compute dtype.
    """

    def __init__(self, image_size: tuple[int, int], *, num_classes: int = 10,
                 features: tuple[int, int] = (16, 32),
                 dtype: torch.dtype = torch.float32, seed: int = 0,
                 fused_tail: bool = False, sparse_conv1: bool = True,
                 fused_conv1_bwd: bool = True, use_bn: bool = True,
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
        self.fused_tail, self.use_bn = fused_tail, use_bn
        self.sparse_conv1, self.fused_conv1_bwd = sparse_conv1, fused_conv1_bwd
        f1, f2 = features
        self.f1, self.f2 = f1, f2
        gen = torch.Generator().manual_seed(seed)
        self.conv1 = ConvT((5, 5, 1, f1), 4, dtype, gen, sparse=sparse_conv1)
        self.bn1 = GroupedBNT(f1, dtype) if use_bn else None
        self.conv2 = ConvT((5, 5, f1, f2), 2, dtype, gen)
        self.bn2 = GroupedBNT(f2, dtype) if use_bn else None
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
        fuse = self.fused_tail and self.use_bn and self.training
        if fuse and self.conv1.sparse and self.fused_conv1_bwd:
            y = self.bn1.fused_conv1(x, *self.conv1.params(), 4)
        else:
            y = self._tail(self.conv1(x, fuse), self.bn1, self.f1, 4, fuse)
        # y: [N,H/4,4f1,W/4]
        y = self._tail(self.conv2(y, fuse), self.bn2, self.f2, 2,
                       fuse)                                # [N,H/4,f2,W/4]
        return self.fc(y).float()

    @staticmethod
    def _tail(y, bn: GroupedBNT | None, co: int, blk: int,
              fuse: bool) -> torch.Tensor:
        """BN + ReLU + 2x2 block pool: the fused kernels on the conv's
        (y, sums) when ``fuse``, else the plain chain; ReLU + pool without
        BN."""
        if fuse:
            y, ysums = y
            return bn.fused(y, blk, ysums)
        if bn is None:
            return block_max_pool_t(torch.relu(y), blk, co)
        return block_max_pool_t(torch.relu(bn(y)), blk, co)
