"""Flash-ring attention: the flash kernels as ring attention's per-block
compute, with a hand-written ring backward. The port of
``tpu_sandbox/parallel/flash_ring.py`` (:48-160).

Every hop runs ``ops.flash_attention.flash_attention_with_lse`` (the
forward kernel with global offsets, f32 partials) and merges the partial
into the running one by their logsumexps:

    lse' = logaddexp(lse, lse_b)
    o'   = o exp(lse - lse') + o_b exp(lse_b - lse')

The backward is the ring's own (``FlashRingAttention``): k and v, with
their gradient accumulators, go around the ring a second time; every rank
adds its queries' share of each block's gradients through
``make_flash_bwd_lse``'s closure (the dk/dv and dq kernels against the
final merged lse) and after n hops each block's dk and dv are back on the
rank that owns it. No [S, S] scores exist on either pass.

Local shards [B, S/n, H, D] as ``ring_attention``;
``make_flash_ring_attention`` binds the mesh axis's group once.
"""

from __future__ import annotations

import torch
from torch.distributed.device_mesh import DeviceMesh

from tpu_sandbox_torch.ops.flash_attention import (
    NEG,
    flash_attention_with_lse,
    make_flash_bwd_lse,
)
from tpu_sandbox_torch.parallel.collectives import CollectiveGroup
from tpu_sandbox_torch.parallel.ring_attention import check_axis


def merge(o, lse, o_b, lse_b):
    """Combine two attention partials by their logsumexps, in f32 (o
    [B,S,H,D], lse [B,S,H]; JAX's ``_merge``)."""
    new_lse = torch.logaddexp(lse, lse_b)
    w_old = torch.exp(lse - new_lse)[..., None]
    w_new = torch.exp(lse_b - new_lse)[..., None]
    return o * w_old + o_b.float() * w_new, new_lse


def _ring_fwd(q, k, v, group, causal, block_q, block_k):
    n, idx = group.size, group.rank
    b, s_loc, h, d = q.shape
    q_off = idx * s_loc
    o = torch.zeros((b, s_loc, h, d), dtype=torch.float32, device=q.device)
    lse = torch.full((b, s_loc, h), NEG, dtype=torch.float32,
                     device=q.device)
    k, v = k.contiguous(), v.contiguous()
    for j in range(n):
        src = (idx - j) % n
        o_b, lse_b = flash_attention_with_lse(
            q, k, v, causal=causal, q_offset=q_off, kv_offset=src * s_loc,
            block_q=block_q, block_k=block_k)
        o, lse = merge(o, lse, o_b, lse_b)
        if j < n - 1:                   # the last shift would be dropped
            k, v = group.shift(k, 1), group.shift(v, 1)
    return o.to(q.dtype), lse


class FlashRingAttention(torch.autograd.Function):
    """out = attention over the ring, saving (q, k, v, out, lse): O(S/n)
    residuals a rank. The backward is JAX's ``_fr_bwd`` (:100-136)."""

    @staticmethod
    def forward(ctx, q, k, v, group, causal, block_q, block_k):
        out, lse = _ring_fwd(q, k, v, group, causal, block_q, block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = group, causal, block_q, block_k
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        group, causal, block_q, block_k = ctx.args
        n, idx = group.size, group.rank
        s_loc = q.shape[1]
        # the q side is padded and delta computed once; a hop preps only
        # the k/v block it holds
        partial_bwd = make_flash_bwd_lse(
            q, out, g.to(q.dtype), lse, causal=causal, q_offset=idx * s_loc,
            block_q=block_q, block_k=block_k)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
        dv = torch.zeros_like(dk)
        k_cur, v_cur = k.contiguous(), v.contiguous()
        for j in range(n):
            src = (idx - j) % n
            dq_c, dk_c, dv_c = partial_bwd(k_cur, v_cur, src * s_loc)
            dq += dq_c
            dk, dv = dk + dk_c, dv + dv_c
            if n > 1:
                # k, v and their gradient sums travel the ring together,
                # so after n hops each block's dk and dv are back at its
                # owner (one rank: every hop is the identity)
                dk, dv = group.shift(dk, 1), group.shift(dv, 1)
            if j < n - 1:
                k_cur, v_cur = group.shift(k_cur, 1), group.shift(v_cur, 1)
        return (dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None,
                None, None)


def flash_ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         group: CollectiveGroup, causal: bool = True,
                         block_q: int = 128, block_k: int = 128
                         ) -> torch.Tensor:
    """q, k, v: this rank's shards [B, S/n, H, D] -> the same shape, in
    q's dtype; differentiable in q, k and v. Every rank of ``group`` must
    call it (and its backward)."""
    return FlashRingAttention.apply(q, k, v, group, causal, block_q, block_k)


def make_flash_ring_attention(mesh: DeviceMesh, axis: str, *,
                              causal: bool = True, block_q: int = 128,
                              block_k: int = 128):
    """``flash_ring_attention`` over ``axis`` of ``mesh``: a function of
    this rank's shards, as ``make_ring_attention``."""
    check_axis(mesh, axis)
    group = CollectiveGroup(mesh, axis)

    def fn(q, k, v):
        return flash_ring_attention(q, k, v, group, causal, block_q, block_k)

    return fn
