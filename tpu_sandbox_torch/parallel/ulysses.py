"""Ulysses sequence parallelism: the all-to-all swap of sequence and heads.
The port of ``tpu_sandbox/parallel/ulysses.py`` (:40-103).

Each rank trades its sequence shard for a head shard with one all-to-all,
attends over the whole sequence on its heads, and trades back:

    [B, S/n, H, D] --seq_to_heads--> [B, S, H/n, D] --attention-->
    [B, S, H/n, D] --heads_to_seq--> [B, S/n, H, D]

Both swaps are ``collectives.all_to_all_tiled`` (JAX's ``all_to_all(...,
tiled=True)``): rank j's chunk of the split axis goes to rank j, and the
arrivals are concatenated in rank order. ``impl="flash"`` (the default)
attends with ``ops.flash_attention.flash_attention`` (the kernels on CUDA
tensors), ``impl="dense"`` with ``ops.attention.causal_attention``.
"""

from __future__ import annotations

from functools import partial

import torch
from torch.distributed.device_mesh import DeviceMesh

from tpu_sandbox_torch.ops.attention import causal_attention
from tpu_sandbox_torch.ops.flash_attention import flash_attention
from tpu_sandbox_torch.parallel.collectives import (
    CollectiveGroup,
    all_to_all_tiled,
)
from tpu_sandbox_torch.parallel.ring_attention import check_axis


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      group: CollectiveGroup, *, causal: bool = True,
                      impl: str = "flash") -> torch.Tensor:
    """q, k, v: this rank's shards [B, S/n, H, D] -> the same shape, in
    q's dtype. Every rank of ``group`` must call it."""
    n = group.size
    h = q.shape[2]
    if h % n:
        raise ValueError(
            f"ulysses needs heads % ranks == 0, got H={h}, n={n} "
            "(use ring attention for head-starved models)"
        )
    if impl == "flash":
        local_attn = partial(flash_attention, causal=causal)
    elif impl == "dense":
        local_attn = partial(causal_attention, causal=causal)
    else:
        raise ValueError(f"impl must be 'flash' or 'dense', got {impl!r}")

    def seq_to_heads(x):                 # [B, S/n, H, D] -> [B, S, H/n, D]
        return all_to_all_tiled(x, group, split_axis=2, concat_axis=1)

    out = local_attn(seq_to_heads(q), seq_to_heads(k), seq_to_heads(v))
    # heads_to_seq: [B, S, H/n, D] -> [B, S/n, H, D]
    return all_to_all_tiled(out.to(q.dtype), group, split_axis=1,
                            concat_axis=2)


def make_ulysses_attention(mesh: DeviceMesh, axis: str, *,
                           causal: bool = True, impl: str = "flash"):
    """``ulysses_attention`` over ``axis`` of ``mesh``: a function of this
    rank's shards, as ``make_ring_attention``."""
    check_axis(mesh, axis)
    group = CollectiveGroup(mesh, axis)

    def fn(q, k, v):
        return ulysses_attention(q, k, v, group, causal=causal, impl=impl)

    return fn
