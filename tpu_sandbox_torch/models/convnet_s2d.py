"""ConvNetS2D: the space-to-depth ConvNet in the NHWC layout, counterpart
of ``tpu_sandbox/models/convnet_s2d.py``: ``scatter_kernel`` (:61),
``space_to_depth`` (:86), ``block_max_pool`` (:93), ``_Conv`` (:114),
``_GroupedBN`` (:157) and ``ConvNetS2D`` (:222).

The same function as the reference ConvNet (conv 1->16 k5, BN, ReLU, 2x2
pool; conv 16->32 k5, BN, ReLU, pool; fc -> 10) and the same parameter
and batch-stats tree as the JAX module, which is also ConvNetS2DT's, so
the weight bridge (``utils/bridge.py``) is a rename and either plan loads
the other's weights. With ``fused_conv=True`` each scattered 3x3 conv
runs the kernels of ``ops/conv.py``; otherwise ``F.conv2d`` on the NHWC
tensor, as JAX leaves its unfused conv to ``lax.conv``. With
``fused_tail=True`` a training forward runs each BN/ReLU/pool tail as the
fused kernels of ``ops/bn_tail.py``, its statistics taken inside the conv
kernel when the conv is fused too. Eval mode always runs the plain tail
on the running statistics. The fc is a plain matmul in the compute dtype
(this plan has no fc kernel).

Layout: space_to_depth(4) makes [N, H/4, W/4, 16] of the resized image;
channel index within C is (a*blk + b)*co + c, so BN groups, pool pairs
and the kernel scatter follow the JAX module unchanged; pool2's
[N, H/4, W/4, 32] is transposed to the canonical (h, c, w) fc row order.

An original 5x5 tap (dx, dy) seen from an output pixel at in-block
position (a, b) reads the input block at offset P = (a+dx-2)//r, in-block
position p, with dx = r*P + p - a + 2; taps outside [0, 5) are zero.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from tpu_sandbox_torch.ops.bn_tail import fused_bn_relu_pool
from tpu_sandbox_torch.ops.conv import conv3x3, conv3x3_reference, conv3x3_stats
from tpu_sandbox_torch.utils.device import resolve_device


@functools.lru_cache(maxsize=8)
def _scatter_index(k: int, r: int):
    """Static gather indices (dx, dy clipped into the kernel) and the
    validity mask, each [3,3,r,r,r,r] over (P,Q,p,q,a,b)."""
    P, Q, p, q, a, b = np.meshgrid(
        np.arange(3), np.arange(3), np.arange(r), np.arange(r),
        np.arange(r), np.arange(r), indexing="ij",
    )
    pad = (k - 1) // 2
    dx = r * (P - 1) + p - a + pad
    dy = r * (Q - 1) + q - b + pad
    valid = (dx >= 0) & (dx < k) & (dy >= 0) & (dy < k)
    return np.clip(dx, 0, k - 1), np.clip(dy, 0, k - 1), valid


def scatter_kernel(w: torch.Tensor, r: int) -> torch.Tensor:
    """[k,k,ci,co] -> [3,3,ci*r*r,co*r*r] s2d-scattered kernel.

    A gather of ``w`` by index tensors with zeros outside the kxk support
    (``torch.where``), so autograd scatter-adds the conv's weight
    gradient back onto the canonical kernel. Requires k <= 2r+1.
    """
    k, _, ci, co = w.shape
    if k > 2 * r + 1:
        raise ValueError(f"kernel {k} too wide for block {r}")
    dx, dy, valid = _scatter_index(k, r)
    wg = w[torch.from_numpy(dx).to(w.device), torch.from_numpy(dy).to(w.device)]
    mask = torch.from_numpy(valid).to(w.device)[..., None, None]
    wg = torch.where(mask, wg, torch.zeros((), dtype=w.dtype, device=w.device))
    # [P,Q,p,q,a,b,ci,co] -> [P,Q,(p,q,ci),(a,b,co)]
    wg = wg.permute(0, 1, 2, 3, 6, 4, 5, 7)
    return wg.reshape(3, 3, r * r * ci, r * r * co)


def lecun_normal_(t: torch.Tensor, fan_in: int,
                  gen: torch.Generator) -> torch.Tensor:
    """Flax's lecun_normal: truncated normal on [-2, 2] std, scaled so the
    variance is 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    return nn.init.trunc_normal_(t, 0.0, std, -2 * std, 2 * std, generator=gen)


def as_nhw(x: torch.Tensor) -> torch.Tensor:
    """[N,H,W,1] or [N,H,W] -> [N,H,W]."""
    if x.dim() == 4:
        if x.shape[-1] != 1:
            raise ValueError("the s2d plan is for the 1-channel CNN")
        x = x[..., 0]
    return x


def space_to_depth(x: torch.Tensor, r: int) -> torch.Tensor:
    """[N,H,W] -> [N,H/r,W/r,r*r], channel index a*r+b."""
    n, h, w = x.shape
    x = x.reshape(n, h // r, r, w // r, r)
    return x.permute(0, 1, 3, 2, 4).reshape(n, h // r, w // r, r * r)


def block_max_pool(y: torch.Tensor, blk: int, co: int) -> torch.Tensor:
    """2x2/2 max-pool inside the channel dim: y [..., blk*blk*co] with
    ordering (a*blk+b)*co+c; pool pairs are the LOW bits of (a, b).
    Returns [..., (blk//2)**2*co]. Written with ``torch.maximum``, as the
    JAX function is, so that a tie splits the gradient 0.5/0.5
    (``max_pool2d`` would give all of it to one input)."""
    *lead, c = y.shape
    if c != blk * blk * co:
        raise ValueError(f"{c} channels are not {blk}x{blk} blocks of {co}")
    y = y.reshape(*lead, blk // 2, 2, blk // 2, 2, co)
    m = torch.maximum(
        torch.maximum(y[..., :, 0, :, 0, :], y[..., :, 0, :, 1, :]),
        torch.maximum(y[..., :, 1, :, 0, :], y[..., :, 1, :, 1, :]),
    )
    return m.reshape(*lead, (blk // 2) ** 2 * co)


class Conv(nn.Module):
    """The canonical [5,5,ci,co] kernel and bias (the names, shapes and
    inits of the reference's conv), applied s2d-scattered on the r-block
    grid: the conv kernels of ``ops/conv.py`` when ``fused``, else
    ``F.conv2d`` (``conv3x3_reference``)."""

    def __init__(self, shape: tuple[int, int, int, int], r: int,
                 dtype: torch.dtype, gen: torch.Generator, fused: bool):
        super().__init__()
        self.r, self.dtype, self.fused = r, dtype, fused
        self.kernel = nn.Parameter(lecun_normal_(
            torch.empty(shape), shape[0] * shape[1] * shape[2], gen))
        self.bias = nn.Parameter(torch.zeros(shape[-1]))

    def params(self) -> tuple[torch.Tensor, torch.Tensor]:
        """(kernel, bias) in the compute dtype, as JAX's ``params_only``
        fetches them for the fused conv1+tail unit."""
        return self.kernel.to(self.dtype), self.bias.to(self.dtype)

    def forward(self, x: torch.Tensor, want_stats: bool = False):
        """y, or with ``want_stats`` (y, (sum [1,CO], sumsq [1,CO])) from
        the fused-stats kernel."""
        # the weight rounds to the compute dtype BEFORE the scatter, and
        # the tiled bias is in the compute dtype too
        k, b = self.params()
        wg = scatter_kernel(k, self.r)
        bias_g = b.repeat(wg.shape[-1] // k.shape[-1])
        if self.fused:
            if want_stats:
                y, s, ss = conv3x3_stats(x, wg, bias_g)
                return y, (s, ss)
            return conv3x3(x, wg, bias_g)
        if want_stats:
            raise ValueError("stats fusion requires the fused conv")
        return conv3x3_reference(x, wg, bias_g)


class GroupedBN(nn.Module):
    """BatchNorm over grouped channels [..., g*co] with Flax semantics
    (``_GroupedBN``): statistics in f32, the single-pass biased variance
    max(0, E[y^2] - E[y]^2), running stats updated as ``ra = 0.9*ra +
    0.1*x`` with the biased variance, and the output cast to the compute
    dtype before ReLU and pool. Not ``nn.BatchNorm2d``, which updates with
    the unbiased variance."""

    MOMENTUM = 0.9
    EPSILON = 1e-5

    def __init__(self, features: int, dtype: torch.dtype):
        super().__init__()
        self.features, self.dtype = features, dtype
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))
        self.register_buffer("mean", torch.zeros(features))
        self.register_buffer("var", torch.ones(features))

    @torch.no_grad()
    def _update_running(self, mu: torch.Tensor, var: torch.Tensor) -> None:
        m = self.MOMENTUM
        self.mean.copy_(m * self.mean + (1 - m) * mu)
        self.var.copy_(m * self.var + (1 - m) * var)

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        co = self.features
        *lead, c = y.shape
        yf = y.reshape(*lead, c // co, co).float()
        if self.training:
            red = tuple(range(yf.dim() - 1))
            mu = yf.mean(dim=red)
            var = torch.clamp_min(yf.square().mean(dim=red) - mu.square(), 0.0)
            self._update_running(mu, var)
        else:
            mu, var = self.mean, self.var
        out = (yf - mu) * (torch.rsqrt(var + self.EPSILON) * self.scale) \
            + self.bias
        return out.to(self.dtype).reshape(*lead, c)

    def fused(self, y: torch.Tensor, blk: int, ysums=None) -> torch.Tensor:
        """Train-mode BN + ReLU + 2x2 block pool as the fused kernels
        (``fused_bn_relu_pool``), with the statistics from ``ysums`` when
        the conv gave them; updates the running stats."""
        out, mu, var = fused_bn_relu_pool(y, self.scale, self.bias,
                                          self.features, blk, self.EPSILON,
                                          ysums)
        self._update_running(mu, var)
        return out


class Dense(nn.Module):
    """Flax's ``Dense`` in the compute dtype: the input, the kernel
    [in, out] and the bias cast to ``dtype``, the bias added in it. A
    plain matmul: this plan has no fc kernel."""

    def __init__(self, in_features: int, features: int, dtype: torch.dtype,
                 gen: torch.Generator):
        super().__init__()
        self.dtype = dtype
        self.kernel = nn.Parameter(lecun_normal_(
            torch.empty(in_features, features), in_features, gen))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        return y.to(self.dtype) @ self.kernel.to(self.dtype) \
            + self.bias.to(self.dtype)


class ConvNetS2D(nn.Module):
    """The two-block ConvNet on the NHWC space-to-depth plan.

    ``image_size`` (H, W), each divisible by 4, sizes the fc as Flax's
    init-by-tracing does. ``fused_conv`` runs the scattered convs as the
    conv kernels; ``fused_tail`` runs each training-mode tail as the fused
    kernels, on the conv's fused statistics when ``fused_conv`` is on too.
    ``use_bn=False`` registers no BN (the JAX module then has no ``bn*``
    variables): each tail is ReLU and the block pool, and the convs run
    without statistics. Weights are drawn on the CPU from
    ``torch.Generator().manual_seed(seed)`` in ConvNetS2DT's order (so one
    seed gives both plans the same weights) and then moved to ``device``
    (default ``cuda``, which must exist; pass ``device="cpu"`` for the
    CPU). Parameters stay f32; ``dtype`` is the compute dtype.
    """

    def __init__(self, image_size: tuple[int, int], *, num_classes: int = 10,
                 features: tuple[int, int] = (16, 32),
                 dtype: torch.dtype = torch.float32, seed: int = 0,
                 fused_tail: bool = False, fused_conv: bool = False,
                 use_bn: bool = True,
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
        self.fused_tail, self.fused_conv = fused_tail, fused_conv
        self.use_bn = use_bn
        f1, f2 = features
        self.f1, self.f2 = f1, f2
        gen = torch.Generator().manual_seed(seed)
        self.conv1 = Conv((5, 5, 1, f1), 4, dtype, gen, fused_conv)
        self.bn1 = GroupedBN(f1, dtype) if use_bn else None
        self.conv2 = Conv((5, 5, f1, f2), 2, dtype, gen, fused_conv)
        self.bn2 = GroupedBN(f2, dtype) if use_bn else None
        self.fc = Dense((h // 4) * f2 * (w // 4), num_classes, dtype, gen)
        self.to(resolve_device(device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [N,H,W,1] or [N,H,W] (``prepare_inputs``' resize). Returns
        f32 logits [N, num_classes]."""
        x = as_nhw(x)
        n, h, w = x.shape
        if h % 4 or w % 4:
            raise ValueError(f"image size must be divisible by 4: {(h, w)}")
        # the statistics ride in the conv kernels when the whole fused
        # chain runs (eval BN uses the running stats)
        fuse_stats = (self.fused_conv and self.fused_tail and self.use_bn
                      and self.training)
        x = space_to_depth(x, 4).to(self.dtype)            # [N,H/4,W/4,16]
        y = self._tail(self.conv1(x, fuse_stats), fuse_stats, self.bn1,
                       self.f1, 4)
        y = self._tail(self.conv2(y, fuse_stats), fuse_stats, self.bn2,
                       self.f2, 2)
        # canonical (h, c, w) fc row order
        y = y.permute(0, 1, 3, 2).reshape(n, -1)
        return self.fc(y).float()

    def _tail(self, y, fuse_stats: bool, bn: GroupedBN | None, co: int,
              blk: int) -> torch.Tensor:
        """BN + ReLU + 2x2 block pool: the fused kernels in training mode
        when ``fused_tail`` (on the conv's sums when it gave them), else
        the plain chain; ReLU + pool without BN."""
        y, ysums = y if fuse_stats else (y, None)
        if bn is None:
            return block_max_pool(F.relu(y), blk, co)
        if self.fused_tail and self.training:
            return bn.fused(y, blk, ysums)
        return block_max_pool(F.relu(bn(y)), blk, co)
