"""Ring attention: causal attention with the sequence sharded over a mesh
axis. The port of ``tpu_sandbox/parallel/ring_attention.py`` (:49-126).

Each rank holds a contiguous S/n slice of q, k and v. The k/v blocks move
one rank on around the ring (``collectives.ring_shift``) while every rank
folds each arriving block into its queries' attention with the online
softmax, in f32. Causality uses global positions: local query i of rank r
sits at r * (S/n) + i, and the block that arrives at step j came from rank
(r - j) mod n. Plain PyTorch, differentiated by autograd, as the JAX
package leaves this one to XLA; ``parallel/flash_ring.py`` is the variant
whose blocks run through the flash kernels.

``ring_attention(q, k, v, group)`` takes this rank's shards [B, S/n, H, D];
``make_ring_attention(mesh, axis)`` binds the mesh axis's group once and
returns that function of the rank's shards.
"""

from __future__ import annotations

import math

import torch
from torch.distributed.device_mesh import DeviceMesh

from tpu_sandbox_torch.parallel.collectives import CollectiveGroup, ring_shift


def check_axis(mesh: DeviceMesh, axis: str) -> None:
    """Raise as ``make_ring_attention`` does (:117-118) when ``axis`` is
    not one of the mesh's axes."""
    names = tuple(mesh.mesh_dim_names or ())
    if axis not in names:
        raise ValueError(f"axis {axis!r} not in mesh axes {names}")


def _online_update(o, m, l, k, v, q, q_offset, src, *, local_len, causal):
    """Fold one arriving k/v block into the online-softmax state (:49-72):
    f32 scores, ``-inf`` where masked, and the ``safe_m`` guard that keeps
    a row with no visible key yet finite."""
    d = q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).float() / math.sqrt(d)
    if causal:
        q_pos = q_offset + torch.arange(q.shape[1], device=q.device)
        kv_pos = src * local_len + torch.arange(k.shape[1], device=q.device)
        mask = q_pos[:, None] >= kv_pos[None, :]
        scores = torch.where(mask, scores, float("-inf"))
    new_m = torch.maximum(m, scores.amax(-1))
    safe_m = torch.where(torch.isfinite(new_m), new_m, 0.0)
    alpha = torch.exp(torch.where(torch.isfinite(m), m - safe_m,
                                  float("-inf")))
    p = torch.exp(scores - safe_m[..., None])
    l_new = l * alpha + p.sum(-1)
    o_new = o * alpha[..., None] + torch.einsum("bhqk,bkhd->bhqd", p,
                                                v.float())
    return o_new, new_m, l_new


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   group: CollectiveGroup, *, causal: bool = True
                   ) -> torch.Tensor:
    """q, k, v: this rank's shards [B, S/n, H, D] -> [B, S/n, H, D] in q's
    dtype. Every rank of ``group`` must call it."""
    n, idx = group.size, group.rank
    b, s_local, h, d = q.shape
    q_offset = idx * s_local
    o = torch.zeros((b, h, s_local, d), dtype=torch.float32, device=q.device)
    m = torch.full((b, h, s_local), float("-inf"), device=q.device)
    l = torch.zeros((b, h, s_local), device=q.device)
    # step j holds the block that started on rank (idx - j) mod n; the
    # block is passed on after every step but the last, which JAX's loop
    # also shifts and then drops
    for j in range(n):
        o, m, l = _online_update(o, m, l, k, v, q, q_offset, (idx - j) % n,
                                 local_len=s_local, causal=causal)
        if j < n - 1:
            k, v = ring_shift(k, group), ring_shift(v, group)
    out = o / torch.clamp_min(l[..., None], 1e-30)
    return out.transpose(1, 2).to(q.dtype)


def make_ring_attention(mesh: DeviceMesh, axis: str, *, causal: bool = True):
    """``ring_attention`` over ``axis`` of ``mesh``: a function of this
    rank's shards [B, S/n, H, D] (the JAX function takes the global arrays
    sharded on dim 1; here each rank holds only its own)."""
    check_axis(mesh, axis)
    group = CollectiveGroup(mesh, axis)

    def fn(q, k, v):
        return ring_attention(q, k, v, group, causal=causal)

    return fn
