"""Spatial partitioning of the plain ConvNet: each rank of a 'spatial'
mesh axis holds a band of the image's rows, what XLA derives for JAX's
``PjitEngine(input_spec=P('data', 'spatial'))``
(``tpu_sandbox/parallel/pjit_engine.py`` :208-211), written out:

- the input stage resizes only the band's output rows: the row block of
  the height interpolation matrix applied to the raw small image,
  gathered over the axis (``resize_band``);
- each 5x5/pad-2 conv takes a 2-row halo from each neighbour
  (``ring_shift``; the global edges take zeros, the conv's padding) and
  adds the halo's taps to the band's own conv, so its backward returns
  the halo's cotangent to the rank that owns it (``halo_conv5``);
- the 2x2/2 max pool keeps the global windows: a window belongs to the
  band that holds its first row, so a band that starts at an odd row
  hands that row to the band above it (``band_max_pool``);
- the (h, c, w) flatten makes a band a contiguous block of the fc's rows,
  so the fc is a row-parallel product over the axis (the engine's head).

Every rank makes the same collectives in the same order: a shifted tensor
is always used (times zero at an edge, or sliced away), so its backward
runs on every rank too.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from tpu_sandbox_torch.models.convnet_s2d_t import resize_weights
from tpu_sandbox_torch.parallel.collectives import CollectiveGroup, ring_shift

#: the rows a 5x5/pad-2 conv reads above and below an output row
HALO = 2
_ITEM8B = "(ROADMAP.md, queue 1 item 8b)"


def even_band(rows: int, group: CollectiveGroup) -> tuple[int, int]:
    """This rank's [lo, hi) of ``rows`` split evenly over the group."""
    if rows % group.size:
        raise ValueError(f"image height {rows} not divisible by the "
                         f"spatial={group.size} shards")
    k = rows // group.size
    return group.rank * k, (group.rank + 1) * k


def pooled_band(lo: int, hi: int, rows: int) -> tuple[int, int]:
    """The rows of a 2x2/2 VALID pool's output that the band [lo, hi) of a
    ``rows``-row map makes: the windows whose first row it holds."""
    return (lo + 1) // 2, max((lo + 1) // 2, min(hi + hi % 2,
                                                 2 * (rows // 2)) // 2)


def band_plan(rows: int, size: int, blocks: int) -> list[list[tuple]]:
    """[block][rank] = (lo, hi, rows) of each conv's input band, checking
    that every band holds the halo a conv takes from its neighbour."""
    bands = [(r * rows // size, (r + 1) * rows // size) for r in range(size)]
    plan = []
    for _ in range(blocks):
        if size > 1 and min(hi - lo for lo, hi in bands) < HALO:
            raise NotImplementedError(
                f"a band of {min(hi - lo for lo, hi in bands)} row(s) of a "
                f"{rows}-row map over spatial={size}: the halo exchange "
                f"takes {HALO} rows from the next band only {_ITEM8B}")
        plan.append([(lo, hi, rows) for lo, hi in bands])
        bands = [pooled_band(lo, hi, rows) for lo, hi in bands]
        rows //= 2
    return plan


def resize_band(images: torch.Tensor, image_size, lo: int, hi: int,
                group: CollectiveGroup) -> torch.Tensor:
    """Output rows [lo, hi) of the bilinear resize (``jax.image.resize``'s
    weights) of the raw batch whose row band this rank holds: the band is
    gathered over the group, then the rows' block of the height matrix
    and the whole width matrix are applied."""
    H, W = image_size
    whole = gather_rows(images, group)
    _, h0, w0, _ = whole.shape
    ah = torch.from_numpy(resize_weights(h0, H)[lo:hi]).to(images.device)
    aw = torch.from_numpy(resize_weights(w0, W)).to(images.device)
    return torch.einsum("hi,nijc,wj->nhwc", ah, whole.float(), aw)


def gather_rows(images: torch.Tensor, group: CollectiveGroup
                ) -> torch.Tensor:
    """The whole images of a row-banded batch [N, h, W(, C)]: every
    band, in rank order (data: no gradient)."""
    parts = group.all_gather(images.movedim(1, 0).contiguous()[None])
    return torch.cat(parts.unbind(0), 0).movedim(0, 1)


def halo_conv5(x: torch.Tensor, conv, group: CollectiveGroup
               ) -> torch.Tensor:
    """``Conv5`` (5x5, stride 1, padding 2, NHWC, the compute dtype) on a
    band of rows, with the 2-row halos above and below from the
    neighbours (zeros at the image's edges): the band's own conv, padded
    as the whole image's (so cuDNN runs the plain plan's algorithm; on a
    3004-row input it picked one ~50x slower for conv1's weight
    gradient), plus each halo's taps into the band's first and last two
    rows, a 2-row conv of the halo over zeros."""
    x = x.to(conv.dtype)
    k = conv.kernel.to(conv.dtype).permute(3, 2, 0, 1)
    top = ring_shift(x[:, -HALO:], group, 1)      # the band above's last
    bottom = ring_shift(x[:, :HALO], group, -1)   # the band below's first
    top = top * (0.0 if group.rank == 0 else 1.0)
    bottom = bottom * (0.0 if group.rank == group.size - 1 else 1.0)
    gap = x.new_zeros(x.shape[0], 2 * HALO, *x.shape[2:])

    def conv2d(t, pad, bias=None):
        return F.conv2d(t.permute(0, 3, 1, 2), k, bias, padding=pad
                        ).permute(0, 2, 3, 1)

    y = conv2d(x, HALO, conv.bias.to(conv.dtype))
    y[:, :HALO] += conv2d(torch.cat([top, gap], 1), (0, HALO))
    y[:, -HALO:] += conv2d(torch.cat([gap, bottom], 1), (0, HALO))
    return y


def band_max_pool(x: torch.Tensor, lo: int, hi: int, rows: int,
                  group: CollectiveGroup) -> torch.Tensor:
    """The 2x2/2 max pool (``nn.max_pool``'s VALID windows, a tie's
    gradient to the first maximum) of the band [lo, hi) of a ``rows``-row
    map: this rank's output rows ``pooled_band(lo, hi, rows)``. Each band
    sends its first row up; a band that ends inside a window takes it."""
    below = ring_shift(x[:, :1], group, -1)
    ext = torch.cat([x, below], 1)
    start = lo % 2
    end = min(hi + hi % 2, 2 * (rows // 2)) - lo
    end = max(start, end)
    return F.max_pool2d(ext[:, start:end].permute(0, 3, 1, 2), 2, 2
                        ).permute(0, 2, 3, 1)


def spatial_features(model, x: torch.Tensor, rows: int,
                     group: CollectiveGroup):
    """The plain ConvNet's blocks on this rank's band of a ``rows``-row
    NHWC batch: (the flattened band of the fc's input [N, k], its
    [lo, hi) within the fc's rows)."""
    blocks = len(model.features)
    plan = band_plan(rows, group.size, blocks)
    for i in range(1, blocks + 1):
        lo, hi, h = plan[i - 1][group.rank]
        x = halo_conv5(x, getattr(model, f"conv{i}"), group)
        if model.use_bn:
            x = getattr(model, f"bn{i}")(x)
        x = band_max_pool(F.relu(x), lo, hi, h, group)
    lo, hi = pooled_band(*plan[-1][group.rank])
    n, _, w, c = x.shape
    per_row = c * w
    return (x.permute(0, 1, 3, 2).reshape(n, -1), lo * per_row,
            hi * per_row)
