"""Expert parallelism: the top-k Mixture-of-Experts MLP. The port of
``tpu_sandbox/parallel/expert.py`` (``MoeMlp`` :36-104).

Routing is top-k with the router in f32 and a per-sequence capacity C =
``max(1, int(capacity_factor * S / E))`` an expert. k = 1 is Switch (the
combine weight is the router probability itself); k > 1 renormalizes the
top-k probabilities to sum to 1. Capacity is granted choice-major: every
token's first choice queues before any second choice, so a second choice
never evicts a first. A token past its expert's capacity gets combine
weight 0 (it rides the block's residual). The Switch load-balance loss
(eq. 4, ``E * sum_e f_e P_e`` with f over first choices) is kept as
``aux_loss`` after each forward, where JAX sows it;
``TransformerLM.aux_losses`` lists them and ``PjitEngine(task="lm")`` adds
their mean times ``aux_weight`` to the loss.

JAX dispatches and combines with one-hot einsums over [B, S, E, C]. Here
the dispatch copies each (token, choice) into its slot of [E, B*C, D]
(``index_copy``; an empty slot stays zero), the experts are two batched
products over E, and the combine gathers each (token, choice)'s slot
(``index_select``) and sums the choices, weighted, in f32: the same
values, without the [B, S, E, C] f32 one-hots (512 MiB a layer at the
LM's bench width).

Expert parallelism (``PjitEngine``'s rule ``("w_(up|down)", P("expert",
None, None))``): ``w_up`` and ``w_down`` hold only this rank's E/n
experts, ``expert_group`` is the 'expert' axis. Every rank routes all of
its rows, runs its own experts, and the combined output is summed over the
axis (``tp_region_output``); the experts' input and the combine weights
enter through ``tp_region_input``, whose backward sums their gradients
over the axis, while the router and the load-balance loss, computed whole
on every rank, are not summed. ``batch_group`` (the batch axis, when the
rows are sharded) makes f the mean over the global batch, as JAX's mean
over a sharded batch is.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from tpu_sandbox_torch.models.transformer import (
    Dense,
    TransformerConfig,
    lecun_normal,
)
from tpu_sandbox_torch.parallel.collectives import (
    CollectiveGroup,
    tp_region_input,
    tp_region_output,
)


def route(probs: torch.Tensor, k: int, capacity: int):
    """probs [B, S, E] -> (gates [B, S, K], experts [B, S, K], positions
    [B, S, K], kept [B, S, K]): the top-k experts, their gates (Switch at
    k = 1, renormalized above), each choice's place in its expert's queue
    of its sequence, choice-major (:62-80), and whether it is inside the
    capacity."""
    b, s, e = probs.shape
    top_vals, experts = probs.topk(k, dim=-1)
    gates = top_vals if k == 1 else (
        top_vals / top_vals.sum(-1, keepdim=True).clamp_min(1e-9))
    onehot = F.one_hot(experts, e)                          # [B, S, K, E]
    # choice as the slow axis: every first choice queues before any second
    oh_km = onehot.transpose(1, 2).reshape(b, k * s, e)
    pos = ((oh_km.cumsum(1) * oh_km).sum(-1) - 1).reshape(b, k, s)
    positions = pos.transpose(1, 2)
    return gates, experts, positions, positions < capacity


class MoeMlp(nn.Module):
    """Drop-in MLP of ``models.transformer.Block`` (``mlp_cls``):
    ``router`` (f32 Dense d -> E), ``w_up`` [E, d, d_ff] and ``w_down``
    [E, d_ff, d], in the model dtype."""

    def __init__(self, cfg: TransformerConfig, gen: torch.Generator):
        super().__init__()
        e = cfg.n_experts
        if e <= 0:
            raise ValueError("MoeMlp needs config.n_experts > 0")
        if not 1 <= cfg.router_top_k <= e:
            raise ValueError(
                f"router_top_k must be in [1, n_experts={e}], "
                f"got {cfg.router_top_k}")
        self.config = cfg
        d, f = cfg.d_model, cfg.d_ff
        self.router = Dense((d,), (e,), torch.float32, gen)
        # Flax's lecun_normal on a 3-D kernel counts the leading E as
        # receptive field: fan-in E*d and E*d_ff
        self.w_up = nn.Parameter(lecun_normal((e, d, f), e * d, gen))
        self.w_down = nn.Parameter(lecun_normal((e, f, d), e * f, gen))
        self.expert_group: CollectiveGroup | None = None
        self.batch_group: CollectiveGroup | None = None
        self.aux_loss: torch.Tensor | None = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg, dt = self.config, self.config.dtype
        e, k = cfg.n_experts, cfg.router_top_k
        b, s, d = x.shape
        capacity = max(1, int(cfg.capacity_factor * s / e))
        probs = torch.softmax(self.router(x.float()), dim=-1)   # [B, S, E]
        gates, experts, positions, kept = route(probs, k, capacity)

        # load balance (Switch eq. 4) over first choices
        frac_tokens = F.one_hot(experts[..., 0], e).float().mean((0, 1))
        if self.batch_group is not None:
            frac_tokens = self.batch_group.all_reduce(frac_tokens, "mean")
        self.aux_loss = e * (frac_tokens * probs.mean((0, 1))).sum()

        # this rank's experts [lo, lo + e_loc); all of them at one rank
        e_loc = self.w_up.shape[0]
        grp = self.expert_group
        lo = grp.rank * e_loc if grp is not None else 0
        xd = x.to(dt)
        if grp is not None:
            xd = tp_region_input(xd, grp)
            gates = tp_region_input(gates, grp)
        mine = kept & (experts >= lo) & (experts < lo + e_loc)
        rows = torch.arange(b, device=x.device).view(b, 1, 1)
        slot = ((experts - lo) * b + rows) * capacity + positions
        n_slots = e_loc * b * capacity
        # every (token, choice) copied to its slot, the others to a spare
        # row past the end, dropped: index_copy's backward is a gather,
        # where the backward of a gather from one padding row would
        # accumulate every empty slot into it one by one
        dest = torch.where(mine, slot, n_slots).reshape(-1)
        src = xd.unsqueeze(2).expand(b, s, k, d).reshape(b * s * k, d)
        slots = xd.new_zeros(n_slots + 1, d).index_copy(0, dest, src)
        dispatched = slots[:n_slots].view(e_loc, b * capacity, d)
        h = F.gelu(torch.bmm(dispatched, self.w_up.to(dt)),
                   approximate="tanh")
        out = torch.bmm(h, self.w_down.to(dt)).reshape(n_slots, d)
        picked = out.index_select(0, torch.where(mine, slot, 0).reshape(-1))
        # the weights in the model dtype, as JAX casts combine; the sum of
        # the choices in f32, rounded once
        weight = torch.where(mine, gates, 0.0).to(dt).float()  # [B, S, K]
        y = (weight.unsqueeze(-1) * picked.view(b, s, k, d).float()).sum(2)
        if grp is not None:
            y = tp_region_output(y, grp)
        return y.to(dt)
