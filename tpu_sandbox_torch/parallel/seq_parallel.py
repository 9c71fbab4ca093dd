"""Sequence-parallel training of the transformer LM over a ('data', 'sp')
mesh, one process a rank. The port of
``tpu_sandbox/parallel/seq_parallel.py`` (:37-145).

Rank ``d * sp + s`` holds batch rows ``[d B/dp, (d+1) B/dp)`` and sequence
slice ``[s S/sp, (s+1) S/sp)`` of the tokens, targets and global
positions. Embeddings, LayerNorms and MLPs are token-local; attention, the
only op that mixes positions, runs over the 'sp' axis as the ring
(``parallel/ring_attention.py``), Ulysses (``parallel/ulysses.py``) or
flash-ring (``parallel/flash_ring.py``). Every token weighs the same in
the global-mean loss, so the gradient is the mean over both axes:
``pmean(pmean(g, data), sp)`` is the mean over the world, one sum
all-reduce a parameter and one division
(``CollectiveGroup.mean_grads_``, which ``DataParallel.train_step`` runs
too); the loss is averaged the same way. Then optional global-norm
clipping of the mean gradients and the optimizer's step.

The JAX engine is a jitted ``shard_map``; here each rank runs the same
eager step on its own shard, and the parameters stay replicated because
every rank applies the same mean gradients.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from tpu_sandbox_torch.ops.losses import cross_entropy_loss
from tpu_sandbox_torch.parallel.collectives import CollectiveGroup
from tpu_sandbox_torch.parallel.flash_ring import flash_ring_attention
from tpu_sandbox_torch.parallel.ring_attention import check_axis, ring_attention
from tpu_sandbox_torch.parallel.ulysses import ulysses_attention
from tpu_sandbox_torch.train.optim import clip_by_global_norm_
from tpu_sandbox_torch.train.state import TrainState

#: the attention a scheme runs over the 'sp' axis, ``fn(q, k, v, group)``
SCHEMES = {"ring": ring_attention, "ulysses": ulysses_attention,
           "flash_ring": flash_ring_attention}


class SeqParallel:
    """The sequence-parallel step for ``TransformerLM`` over a mesh with a
    data axis and a sequence axis. ``model_ctor(attention_fn)`` builds the
    model (from its seed, on this rank's device); ``tx(params)`` builds
    the optimizer (``train/optim.py``: ``Adam``, ``SGD``) over the
    parameter list; ``clip_norm`` > 0 clips the mean gradients first.

    Usage, in every rank's process::

        sp = SeqParallel(ctor, tx, make_mesh({"data": 2, "sp": 2}))
        state = sp.shard_state(sp.init_state())
        loss = sp.train_step(state, *sp.shard_batch(tokens, targets))
    """

    def __init__(self, model_ctor: Callable, tx: Callable, mesh: DeviceMesh,
                 *, data_axis: str = "data", seq_axis: str = "sp",
                 attn: str = "ring", clip_norm: float = 0.0):
        for ax in (data_axis, seq_axis):
            check_axis(mesh, ax)
        if attn not in SCHEMES:
            raise ValueError(
                f"attn must be 'ring', 'ulysses' or 'flash_ring', got {attn!r}"
            )
        if mesh.size() != dist.get_world_size():
            raise ValueError(f"mesh of {mesh.size()} ranks in a world of "
                             f"{dist.get_world_size()}")
        self.mesh = mesh
        self.data = CollectiveGroup(mesh, data_axis)
        self.seq = CollectiveGroup(mesh, seq_axis)
        self.world = CollectiveGroup(None)      # the mesh spans the world
        self.tx = tx
        self.clip_norm = clip_norm
        self._ctor = model_ctor
        self.sp_model = model_ctor(partial(SCHEMES[attn], group=self.seq))
        self._local_model = None

    @property
    def local_model(self) -> torch.nn.Module:
        """The same architecture with local attention, sharing the
        parameter tensors of ``sp_model`` (built at first use)."""
        if self._local_model is None:
            local = self._ctor(None)
            for name, p in self.sp_model.named_parameters():
                owner, _, leaf = name.rpartition(".")
                setattr(local.get_submodule(owner), leaf, p)
            self._local_model = local
        return self._local_model

    @property
    def device(self) -> torch.device:
        return next(self.sp_model.parameters()).device

    def init_state(self) -> TrainState:
        """The model built from its seed (the same on every rank) and the
        optimizer over its parameters."""
        params = list(self.sp_model.parameters())
        return TrainState(self.sp_model, optimizer=self.tx(params))

    @torch.no_grad()
    def shard_state(self, state: TrainState) -> TrainState:
        """Every rank takes rank 0's parameters."""
        self.world.broadcast_params_(state.model.parameters())
        return state

    def shard_batch(self, tokens, targets):
        """tokens, targets [B, S] (numpy; targets already the next token)
        -> this rank's (tokens, targets, positions) on the model's device:
        rows of its 'data' coordinate, the sequence slice of its 'sp'
        coordinate, positions global."""
        b, s = tokens.shape
        if b % self.data.size or s % self.seq.size:
            raise ValueError(
                f"batch {tokens.shape} does not split over data="
                f"{self.data.size} x sp={self.seq.size}")
        bl, sl = b // self.data.size, s // self.seq.size
        rows = slice(self.data.rank * bl, (self.data.rank + 1) * bl)
        cols = slice(self.seq.rank * sl, (self.seq.rank + 1) * sl)
        positions = np.broadcast_to(np.arange(s, dtype=np.int32), (b, s))
        return tuple(
            torch.from_numpy(np.ascontiguousarray(x[rows, cols])).to(
                self.device)
            for x in (tokens, targets.astype(np.int64), positions))

    def train_step(self, state: TrainState, tokens: torch.Tensor,
                   targets: torch.Tensor, positions: torch.Tensor
                   ) -> torch.Tensor:
        """One step on this rank's shard; returns the loss averaged over
        every rank (the mean over the global batch)."""
        model = state.model
        model.train()
        logits = model(tokens, positions)
        loss = cross_entropy_loss(logits.reshape(-1, logits.shape[-1]),
                                  targets.reshape(-1))
        del logits
        loss.backward()
        params = list(model.parameters())
        self.world.mean_grads_(params)
        if self.clip_norm:
            clip_by_global_norm_([p.grad for p in params], self.clip_norm)
        state.apply_update()
        return self.world.all_reduce(loss.detach(), "mean")

    @torch.no_grad()
    def eval_logits(self, state: TrainState, tokens: torch.Tensor
                    ) -> torch.Tensor:
        """Single-stream logits (local attention) of whole sequences."""
        return self.local_model(tokens)
