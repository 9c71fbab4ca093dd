"""Attention: the single-device reference implementation. Counterpart of
``tpu_sandbox/ops/attention.py:19`` ``causal_attention``, the model's
attention when ``--flash`` is off.

The scores are a product in the input dtype (rounded to it, as the JAX
einsum is) and then cast to f32; the softmax statistics are f32; the
weights are rounded to v's dtype before the product with v.
"""

from __future__ import annotations

import math

import torch


def causal_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                     causal: bool = True, q_offset: int = 0,
                     kv_offset: int = 0) -> torch.Tensor:
    """q, k, v [B, S, H, D] -> [B, S, H, D]. ``q_offset`` and
    ``kv_offset`` are the global positions of the first local query and
    key."""
    d = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float()
    scores = scores / math.sqrt(d)
    if causal:
        q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
        kv_pos = kv_offset + torch.arange(k.shape[1], device=q.device)
        mask = q_pos[:, None] >= kv_pos[None, :]
        scores = scores.masked_fill(~mask, float("-inf"))
    weights = torch.nan_to_num(
        torch.exp(scores - scores.amax(-1, keepdim=True)))
    weights = weights / weights.sum(-1, keepdim=True).clamp_min(1e-30)
    return torch.einsum("bhqk,bkhd->bqhd", weights.to(v.dtype), v)
