"""The space-to-depth kernel scatter, counterpart of
``tpu_sandbox/models/convnet_s2d.py:61-83``.

An original 5x5 tap (dx, dy) seen from an output pixel at in-block
position (a, b) reads the input block at offset P = (a+dx-2)//r, in-block
position p, with dx = r*P + p - a + 2; taps outside [0, 5) are zero.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


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
