"""Pipeline parallelism: microbatched stages over a 'pipe' mesh axis, one
process a rank. The port of ``tpu_sandbox/parallel/pipeline.py`` (:91-607).

The transformer's blocks are split into ``n_stages`` stages; rank ``i`` of
the pipe axis holds only its own stage row: ``v = circular_chunks`` chunks
of ``lps = n_layers / (n_stages v)`` layers, chunk ``c`` holding the global
layers ``[c S lps + i lps, +lps)`` (chunk-major round robin). ``v = 1`` is
GPipe. A batch is cut into M microbatches and the step runs ``M v + S - 1``
ticks; at tick ``t`` unit ``u = t - i`` decodes to (chunk, microbatch),
stage 0 embeds on chunk 0, the last stage takes the head and the loss on
the last chunk of an active unit, and every rank's stage output moves one
rank on around the pipe (``collectives.ring_shift``). The bubble is
``(S - 1) / (M v + S - 1)`` (``bubble_fraction``).

The JAX engine is one SPMD program that ``jax.value_and_grad``
differentiates, so its backward is the reverse pipeline by construction.
Here each rank runs the tick loop eagerly and autograd runs its backward,
which must issue the same collectives in the same order on every rank:

- a stage-0 tick that embeds keeps the shifted buffer it does not read in
  the graph, with a zero cotangent (``_take``, as ``lax.cond`` transposes
  the branch it did not take), so that shift's backward runs there too;
- the backward starts on every rank from the last tick's output (a zero
  cotangent) and, on the last stage, from the loss, so it walks every
  tick's shift in reverse on every rank.

Each tick's embed, stage and head run under ``torch.utils.checkpoint``
(JAX's default ``remat=True``, ``jax.checkpoint``, :527-529): the backward
keeps only the ring buffer per tick and recomputes the rest. The shift
stays outside the recomputed region, so it is issued once; the collectives
inside a tick (the 'sp' ring, the 'model' sums) are issued again by the
recompute on every rank of their group, which share a pipe index and so
recompute in the same order.

Gradients as JAX's :540-554: ``pre`` (embeddings) and ``post`` (final
LayerNorm, head) summed over 'pipe' (each is non-zero on one stage only),
everything averaged over 'data', then over 'sp'; the loss summed over
'pipe', then averaged the same way. Then the optimizer's step on this
rank's parameters, its state beside them.

``model_axis``: the stage blocks run Megatron-style (``_tp_block_step``):
each rank keeps its shard of the heads (``qkv``, ``out``) and of d_ff
(``up``, ``down``), one sum over 'model' per residual branch
(``tp_region_output``) with its conjugate on the branch's input
(``tp_region_input``), the bias added after the sum. ``seq_axis``: the
activations ride the pipe as [mb, S/sp, d] slices, attention is the ring
(``parallel/ring_attention.py``) or the flash-ring
(``parallel/flash_ring.py``) over 'sp', and the embedding takes global
positions.
"""

from __future__ import annotations

from functools import partial
from typing import Callable

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh
from torch.func import functional_call
from torch.utils.checkpoint import checkpoint

from tpu_sandbox_torch.models.transformer import Block, TransformerConfig, TransformerLM
from tpu_sandbox_torch.ops.attention import causal_attention
from tpu_sandbox_torch.ops.losses import cross_entropy_loss
from tpu_sandbox_torch.parallel.collectives import (
    CollectiveGroup,
    ring_shift,
    tp_region_input,
    tp_region_output,
)
from tpu_sandbox_torch.parallel.flash_ring import flash_ring_attention
from tpu_sandbox_torch.parallel.ring_attention import check_axis, ring_attention
from tpu_sandbox_torch.train.state import TrainState

PRE, POST = ("tok_emb", "pos_emb"), ("ln_f", "lm_head")
#: the Megatron dim of each sharded stage leaf, counted from its end
#: (:298-322): heads for qkv and out, d_ff for up and down; the out and
#: down biases and the LayerNorms stay whole on every 'model' rank
MODEL_DIMS = {"attn.qkv.kernel": -2, "attn.qkv.bias": -2,
              "attn.out.kernel": -3, "mlp.up.kernel": -1,
              "mlp.up.bias": -1, "mlp.down.kernel": -2}


def split_transformer_params(params: dict, n_stages: int):
    """A ``TransformerLM`` state dict -> (pre, stacked, post): pre and post
    keep their names, stacked maps each block leaf (``attn.qkv.kernel``)
    to the [n_layers, ...] stack of it over the blocks."""
    blocks: dict[int, dict] = {}
    for name, t in params.items():
        head, _, leaf = name.partition(".")
        if head.startswith("block"):
            blocks.setdefault(int(head[5:]), {})[leaf] = t
    if len(blocks) % n_stages:
        raise ValueError(f"{len(blocks)} layers not divisible into "
                         f"{n_stages} stages")
    order = sorted(blocks)
    stacked = {leaf: torch.stack([blocks[i][leaf] for i in order])
               for leaf in blocks[order[0]]} if order else {}
    pre = {k: t for k, t in params.items() if k.split(".")[0] in PRE}
    post = {k: t for k, t in params.items() if k.split(".")[0] in POST}
    return pre, stacked, post


def merge_transformer_params(pre: dict, stacked: dict, post: dict) -> dict:
    """Inverse of ``split_transformer_params``."""
    out = dict(pre)
    n_layers = next(iter(stacked.values())).shape[0] if stacked else 0
    for i in range(n_layers):
        out.update({f"block{i}.{leaf}": x[i] for leaf, x in stacked.items()})
    out.update(post)
    return out


def _layernorm(x, scale, bias):
    """flax ``LayerNorm(dtype=float32)`` as the JAX engine spells it (:120):
    f32, the two-pass variance, epsilon 1e-6."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    return (xf - mean) / torch.sqrt(var + 1e-6) * scale + bias


class _Take(torch.autograd.Function):
    """``a``, with ``b`` kept in the graph at a zero cotangent."""

    @staticmethod
    def forward(ctx, a, b):
        return a

    @staticmethod
    def backward(ctx, g):
        return g, torch.zeros_like(g)


def _take(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a``, for a select of ``a`` over ``b`` decided on the host: ``b``
    stays in the graph with a zero cotangent."""
    return _Take.apply(a, b)


def _holder(tensors: dict) -> nn.Module:
    """A module holding ``tensors`` as parameters under their dotted
    names."""
    root = nn.Module()
    for name, t in tensors.items():
        *path, leaf = name.split(".")
        mod = root
        for part in path:
            if part not in mod._modules:
                mod.add_module(part, nn.Module())
            mod = mod._modules[part]
        mod.register_parameter(leaf, nn.Parameter(t))
    return root


class PipelineParallel:
    """Pipelined ``TransformerLM`` training over a ('data', 'pipe') mesh,
    optionally with 'model' (tensor-parallel stages) and 'sp' (sequence-
    parallel stages). ``tx(params)`` builds the optimizer over this rank's
    parameters (``train/optim.py``: ``Adam``, ``SGD``). ``donate`` is
    accepted for the JAX signature and unused.

    Usage, in every rank's process::

        pp = PipelineParallel(cfg, tx, make_mesh({"data": 1, "pipe": 4}),
                              microbatches=2)
        state = pp.shard_state(pp.init_state())
        loss = pp.train_step(state, *pp.shard_batch(tokens, targets))
    """

    def __init__(self, config: TransformerConfig, tx: Callable,
                 mesh: DeviceMesh, *, microbatches: int,
                 data_axis: str = "data", pipe_axis: str = "pipe",
                 model_axis: str | None = None, seq_axis: str | None = None,
                 seq_attn: str = "ring", circular_chunks: int = 1,
                 donate: bool = True,
                 attention_fn: Callable | None = None):
        axes = ((data_axis, pipe_axis) + ((model_axis,) if model_axis else ())
                + ((seq_axis,) if seq_axis else ()))
        for ax in axes:
            check_axis(mesh, ax)
        shape = dict(zip(mesh.mesh_dim_names, mesh.shape))
        self.config, self.tx, self.mesh = config, tx, mesh
        self.microbatches = microbatches
        self.n_stages = shape[pipe_axis]
        self.circular_chunks = v = circular_chunks
        if v < 1:
            raise ValueError(f"circular_chunks must be >= 1, got {v}")
        if config.n_layers % (self.n_stages * v):
            raise ValueError(
                f"{config.n_layers} layers not divisible into "
                f"{self.n_stages} stages x {v} chunks")
        if v > 1 and microbatches % self.n_stages:
            raise ValueError(
                f"the circular schedule needs microbatches ({microbatches}) "
                f"divisible by n_stages ({self.n_stages})")
        if model_axis:
            m = shape[model_axis]
            if config.n_heads % m or config.d_ff % m:
                raise ValueError(
                    f"tensor-parallel stages shard heads and d_ff: n_heads="
                    f"{config.n_heads} and d_ff={config.d_ff} must divide by "
                    f"{model_axis}={m}")
        self.data = CollectiveGroup(mesh, data_axis)
        self.pipe = CollectiveGroup(mesh, pipe_axis)
        self.model = CollectiveGroup(mesh, model_axis) if model_axis else None
        self.seq = CollectiveGroup(mesh, seq_axis) if seq_axis else None
        if seq_axis:
            if attention_fn is not None:
                raise ValueError(
                    "seq_axis owns attention: pass seq_attn='ring'|"
                    "'flash_ring' instead of attention_fn")
            if seq_attn == "ring":
                attention_fn = partial(ring_attention, group=self.seq)
            elif seq_attn == "flash_ring":
                attention_fn = partial(flash_ring_attention, group=self.seq)
            else:
                raise ValueError(
                    f"seq_attn must be 'ring' or 'flash_ring', got {seq_attn!r}")
        self.attention_fn = attention_fn
        self.lps = config.n_layers // (self.n_stages * v)
        self.device = self.pipe.device
        # the block's code with no weights of its own: each layer's
        # parameters go in by functional_call
        with torch.device("meta"):
            self.block = Block(config, attention_fn, torch.Generator())
        self.leaves = [name for name, _ in self.block.named_parameters()]

    def bubble_fraction(self) -> float:
        """Idle fraction of the schedule: (S - 1) / (M v + S - 1)."""
        ticks = self.microbatches * self.circular_chunks + self.n_stages - 1
        return (self.n_stages - 1) / ticks

    # -- state --------------------------------------------------------------

    def init_state(self, seed: int = 0, params: dict | None = None) -> dict:
        """The whole model, on the CPU: ``{"pre", "stages", "post"}`` with
        every block leaf stacked [n_stages, v, lps, ...]. Drawn as
        ``TransformerLM(config, seed=seed)`` draws it, or taken from the
        single-device state dict ``params``."""
        if params is None:
            params = TransformerLM(self.config, seed=seed).state_dict()
        pre, stacked, post = split_transformer_params(params, self.n_stages)
        v, n, lps = self.circular_chunks, self.n_stages, self.lps
        # global layer order is chunk-major round robin ([v, n, lps]);
        # swap so that the stage dim leads
        stacked = {k: x.reshape(v, n, lps, *x.shape[1:]).transpose(0, 1)
                   for k, x in stacked.items()}
        return {"pre": pre, "stages": stacked, "post": post}

    def shard_state(self, params: dict) -> TrainState:
        """This rank's share of ``init_state``'s tree on its device: pre,
        post and its own stage row, every layer (chunk c, layer l) under
        ``stages.{c}.{l}``, with 'model' only its Megatron shard; and the
        optimizer over them."""
        local = {f"pre.{k}": t for k, t in params["pre"].items()}
        local.update({f"post.{k}": t for k, t in params["post"].items()})
        for leaf, x in params["stages"].items():
            row = x[self.pipe.rank]
            if self.model is not None and leaf in MODEL_DIMS:
                row = row.chunk(self.model.size,
                                MODEL_DIMS[leaf])[self.model.rank]
            for c in range(self.circular_chunks):
                for l in range(self.lps):
                    local[f"stages.{c}.{l}.{leaf}"] = row[c, l]
        holder = _holder({k: t.to(self.device,
                                  memory_format=torch.contiguous_format,
                                  copy=True)
                          for k, t in local.items()})
        return TrainState(holder, optimizer=self.tx(list(holder.parameters())))

    def shard_batch(self, tokens, targets):
        """tokens, targets [B, S] (numpy) -> this rank's (tokens, targets)
        on its device: the rows of its 'data' coordinate and, with
        ``seq_axis``, the sequence slice of its 'sp' coordinate."""
        b, s = tokens.shape
        n_sp = self.seq.size if self.seq else 1
        if s % n_sp:
            raise ValueError(f"sequence length {s} not divisible by the "
                             f"{self.seq.axis}={n_sp} shards")
        if b % self.data.size:
            raise ValueError(f"batch {b} not divisible by the "
                             f"{self.data.axis}={self.data.size} shards")
        bl, sl = b // self.data.size, s // n_sp
        j = self.seq.rank if self.seq else 0
        rows = slice(self.data.rank * bl, (self.data.rank + 1) * bl)
        cols = slice(j * sl, (j + 1) * sl)
        return tuple(torch.as_tensor(x[rows, cols]).to(self.device,
                                                       torch.int64)
                     for x in (tokens, targets))

    def stage_row(self, state: TrainState) -> dict:
        """This rank's block leaves stacked [v, lps, ...] (its Megatron
        shard with 'model')."""
        layers = [[self._layer(state, c, l) for l in range(self.lps)]
                  for c in range(self.circular_chunks)]
        return {leaf: torch.stack([torch.stack([p[leaf] for p in chunk])
                                   for chunk in layers]).detach()
                for leaf in self.leaves}

    def merged_params(self, state: TrainState) -> dict:
        """The single-device state dict of the whole model (CPU tensors):
        the stage rows gathered over 'pipe' (and the shards over
        'model'), then [n, v, lps] -> chunk-major [v, n, lps] -> [L]. Every
        rank must call it."""
        stacked = {}
        for leaf, row in self.stage_row(state).items():
            if self.model is not None and leaf in MODEL_DIMS:
                row = torch.cat(self.model.all_gather(row[None]).unbind(0),
                                MODEL_DIMS[leaf])
            full = self.pipe.all_gather(row[None])       # [n, v, lps, ...]
            stacked[leaf] = full.transpose(0, 1).reshape(
                -1, *full.shape[3:]).cpu()
        model = state.model
        pre = {k: p.detach().cpu() for k, p in
               model.get_submodule("pre").named_parameters()}
        post = {k: p.detach().cpu() for k, p in
                model.get_submodule("post").named_parameters()}
        return merge_transformer_params(pre, stacked, post)

    # -- stage compute ------------------------------------------------------

    @staticmethod
    def _params(state: TrainState, prefix: str) -> dict:
        return dict(state.model.get_submodule(prefix).named_parameters())

    def _layer(self, state: TrainState, c: int, l: int) -> dict:
        return self._params(state, f"stages.{c}.{l}")

    def _embed(self, pre: dict, tokens: torch.Tensor) -> torch.Tensor:
        """Token plus position embedding in f32, then the compute dtype
        (:439-448); positions global under 'sp'."""
        s = tokens.shape[1]
        base = self.seq.rank * s if self.seq else 0
        positions = torch.arange(base, base + s, device=tokens.device
                                 ).expand(tokens.shape)
        tok = F.embedding(tokens, pre["tok_emb.embedding"])
        pos = F.embedding(positions, pre["pos_emb.embedding"])
        return (tok + pos).to(self.config.dtype)

    def _head_loss(self, post: dict, h: torch.Tensor,
                   targets: torch.Tensor) -> torch.Tensor:
        """ln_f, lm_head and the mean cross-entropy of one microbatch
        (:450-467), the logits in the compute dtype (the CE kernel takes
        them as they are at vocab >= 4096 on the card)."""
        dt = self.config.dtype
        hn = _layernorm(h, post["ln_f.scale"], post["ln_f.bias"]).to(dt)
        logits = (hn @ post["lm_head.kernel"].to(dt)
                  + post["lm_head.bias"].to(dt))
        return cross_entropy_loss(logits.reshape(-1, logits.shape[-1]),
                                  targets.reshape(-1))

    def _tp_block_step(self, h: torch.Tensor, p: dict) -> torch.Tensor:
        """One block with Megatron tensor parallelism over 'model' (:392-
        431): local heads and d_ff columns, one sum per residual branch,
        the whole bias added after the sum."""
        dt, grp = self.config.dtype, self.model
        hn = tp_region_input(
            _layernorm(h, p["ln1.scale"], p["ln1.bias"]).to(dt), grp)
        qkv = (torch.einsum("bsd,dthk->bsthk", hn,
                            p["attn.qkv.kernel"].to(dt))
               + p["attn.qkv.bias"].to(dt))
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        attn = (self.attention_fn or causal_attention)(q, k, v)
        partial_ = torch.einsum("bshk,hkd->bsd", attn,
                                p["attn.out.kernel"].to(dt))
        h = h + (tp_region_output(partial_, grp) + p["attn.out.bias"].to(dt))
        hn = tp_region_input(
            _layernorm(h, p["ln2.scale"], p["ln2.bias"]).to(dt), grp)
        up = hn @ p["mlp.up.kernel"].to(dt) + p["mlp.up.bias"].to(dt)
        partial_ = F.gelu(up, approximate="tanh") @ p["mlp.down.kernel"].to(dt)
        return h + tp_region_output(partial_, grp) + p["mlp.down.bias"].to(dt)

    def _stage_apply(self, chunk: list, h: torch.Tensor) -> torch.Tensor:
        """The chunk's layers in order."""
        for p in chunk:
            h = (functional_call(self.block, p, (h,)) if self.model is None
                 else self._tp_block_step(h, p))
        return h

    def _tick(self, pre, chunk, post, embeds, heads, toks, tgt, buf):
        """One tick's compute: (stage output, microbatch loss / M or
        None)."""
        h = _take(self._embed(pre, toks), buf) if embeds else buf
        out = self._stage_apply(chunk, h)
        loss = (self._head_loss(post, out, tgt) / self.microbatches
                if heads else None)
        return out, loss

    # -- the pipeline -------------------------------------------------------

    def train_step(self, state: TrainState, tokens: torch.Tensor,
                   targets: torch.Tensor) -> torch.Tensor:
        """One step on this rank's share of the batch; returns the loss
        (the mean over the global batch) on every rank."""
        cfg, S, M, v = (self.config, self.n_stages, self.microbatches,
                        self.circular_chunks)
        b, s = tokens.shape
        if b % M:
            raise ValueError(f"local batch {b} not divisible by {M} "
                             "microbatches")
        mb = b // M
        tokens_mb = tokens.reshape(M, mb, s)
        targets_mb = targets.reshape(M, mb, s)
        pre, post = self._params(state, "pre"), self._params(state, "post")
        chunks = [[self._layer(state, c, l) for l in range(self.lps)]
                  for c in range(v)]
        idx, ticks = self.pipe.rank, M * v + S - 1
        buf = torch.zeros((mb, s, cfg.d_model), dtype=cfg.dtype,
                          device=self.device)
        loss_sum = torch.zeros((), dtype=torch.float32, device=self.device)
        for t in range(ticks):
            # unit u = t - idx; groups of S microbatches run chunk c before
            # the next group enters (v = 1: c == 0, m == u)
            u = t - idx
            active = 0 <= u < M * v
            uc = min(max(u, 0), M * v - 1)
            r = uc % (S * v)
            c, m = r // S, (uc // (S * v)) * S + r % S
            heads = idx == S - 1 and c == v - 1 and active
            tick = partial(self._tick, pre, chunks[c], post,
                           idx == 0 and c == 0, heads, tokens_mb[m],
                           targets_mb[m])
            out, mb_loss = checkpoint(tick, buf, use_reentrant=False,
                                      preserve_rng_state=False)
            if heads:
                loss_sum = loss_sum + mb_loss
            if t < ticks - 1:              # the last shift would be dropped
                buf = ring_shift(out, self.pipe)
        roots, cots = [out], [torch.zeros_like(out)]
        if loss_sum.requires_grad:
            roots.append(loss_sum)
            cots.append(torch.ones_like(loss_sum))
        torch.autograd.backward(roots, cots)

        params = list(state.model.parameters())
        ends = [p for name in ("pre", "post") for p in
                state.model.get_submodule(name).parameters()]
        self.pipe.sum_grads_(ends)
        self.data.mean_grads_(params)
        loss = self.data.all_reduce(self.pipe.all_reduce(loss_sum.detach()),
                                    "mean")
        if self.seq is not None:
            self.seq.mean_grads_(params)
            loss = self.seq.all_reduce(loss, "mean")
        state.apply_update()
        return loss

