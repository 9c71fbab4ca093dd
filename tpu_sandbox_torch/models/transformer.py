"""Decoder-only transformer LM. Counterpart of
``tpu_sandbox/models/transformer.py``: ``TransformerConfig`` (:30),
``SelfAttention`` (:65), ``Mlp`` (:88), ``Block`` (:99) and
``TransformerLM`` (:114), with ``mlp_cls`` (the dense ``Mlp`` or
``parallel/expert.py``'s ``MoeMlp``), ``remat`` and ``remat_policy``
(:45-54, :137-140).

The parameters keep the Flax layouts and names, so the weight bridge is a
rename: ``tok_emb.embedding`` [V, d], ``pos_emb.embedding`` [max_len, d],
``block{i}.ln1.scale``/``bias``, ``block{i}.attn.qkv.kernel`` [d, 3, H, hd]
and ``bias`` [3, H, hd], ``block{i}.attn.out.kernel`` [H, hd, d],
``block{i}.mlp.up``/``down``, ``ln_f`` and ``lm_head.kernel`` [d, V].
Parameters are f32; the compute dtype follows Flax: a Dense casts its input,
kernel and bias to it and adds the bias in it; an Embed casts its table
before the gather and ``tok + pos`` is added in it; LayerNorm computes in
f32 with epsilon 1e-6 and the fast variance E[x^2] - E[x]^2; the MLP's
gelu is the tanh approximation. Initial weights are drawn from the
CPU generator seeded with ``seed`` with Flax's distributions (lecun-normal
kernels, zero biases, N(0, 1/d) embeddings), not Flax's numbers, and then
moved to the device, so one seed gives the same weights on every device.

``remat`` runs each block under ``torch.utils.checkpoint`` (``nn.remat``):
``full`` keeps only the block's input for the backward and recomputes the
rest; ``dots`` (``jax.checkpoint_policies.checkpoint_dots``) also keeps
the output of every matrix product (``DOT_OPS``) and recomputes the rest.
Neither changes the function: the backward graph is the one the forward
recorded, the recompute fills in what it saved. A kernel launched from
Python (the flash forward) is no product, so both recompute it, as a
Pallas call is no ``dot_general`` to JAX.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
    noop_context_fn,
)

from tpu_sandbox_torch.ops.attention import causal_attention

# truncated_normal(-2, 2) has this stddev; lecun_normal divides it out
_TRUNC_STD = 0.87962566103423978
#: the matrix products whose outputs ``remat_policy="dots"`` keeps: what
#: ``Dense`` (``@``) and the plain attention's einsums lower to
DOT_OPS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                     torch.ops.aten.bmm.default,
                     torch.ops.aten.baddbmm.default})


@dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int = 256
    d_model: int = 64
    n_heads: int = 4
    n_layers: int = 2
    d_ff: int = 256
    max_len: int = 2048
    dtype: torch.dtype = torch.float32
    # MoE: 0 experts = dense MLP; > 0 with ``mlp_cls=MoeMlp``
    # (parallel/expert.py) an MoE MLP in every block, per-sequence
    # capacity ``capacity_factor * S / n_experts``, top-``router_top_k``
    # routing
    n_experts: int = 0
    capacity_factor: float = 2.0
    router_top_k: int = 1
    # recompute each block in the backward; "full" or "dots" (what the
    # backward keeps besides the block's input: nothing, or the products)
    remat: bool = False
    remat_policy: str = "full"
    fp32_logits: bool = True


def lecun_normal(shape, fan_in: int, gen: torch.Generator) -> torch.Tensor:
    """Flax's ``lecun_normal``: a normal truncated to [-2, 2] standard
    deviations with variance 1 / ``fan_in``, drawn from ``gen``."""
    t = torch.empty(shape)
    nn.init.trunc_normal_(t, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return t * (math.sqrt(1.0 / fan_in) / _TRUNC_STD)


class Dense(nn.Module):
    """Flax ``Dense``/``DenseGeneral``: contracts the input's last
    ``len(in_shape)`` axes with ``kernel`` [*in_shape, *out_shape] and adds
    ``bias`` [*out_shape], all in ``dtype``."""

    def __init__(self, in_shape, out_shape, dtype, gen):
        super().__init__()
        self.in_shape, self.out_shape = tuple(in_shape), tuple(out_shape)
        self.dtype = dtype
        self.kernel = nn.Parameter(lecun_normal(
            (*self.in_shape, *self.out_shape), math.prod(self.in_shape), gen))
        self.bias = nn.Parameter(torch.zeros(self.out_shape))

    def _contract(self, x: torch.Tensor):
        """(x @ kernel as [prod(lead), prod(out)], lead, out) in ``dtype``.
        The shapes are the kernel's, so a kernel cut into shards
        (``parallel/pjit_engine.py``) contracts its own shard."""
        n_in = len(self.in_shape)
        k_in, k_out = self.kernel.shape[:n_in], self.kernel.shape[n_in:]
        lead = x.shape[:x.ndim - n_in]
        fan_in = math.prod(k_in)
        y = x.reshape(*lead, fan_in).to(self.dtype) @ self.kernel.reshape(
            fan_in, -1).to(self.dtype)
        return y, lead, k_out

    def product(self, x: torch.Tensor) -> torch.Tensor:
        """The contraction without the bias, [*lead, *out]."""
        y, lead, k_out = self._contract(x)
        return y.reshape(*lead, *k_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y, lead, k_out = self._contract(x)
        y = y + self.bias.reshape(-1).to(self.dtype)
        return y.reshape(*lead, *k_out)


class Embed(nn.Module):
    """Flax ``Embed``: the table cast to ``dtype``, then the gather."""

    def __init__(self, num, features, dtype, gen):
        super().__init__()
        self.dtype = dtype
        table = torch.empty((num, features))
        nn.init.normal_(table, 0.0, math.sqrt(1.0 / features), generator=gen)
        self.embedding = nn.Parameter(table)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.embedding.to(self.dtype))


class LayerNorm(nn.Module):
    """Flax ``LayerNorm(dtype=float32)``: f32 statistics, epsilon 1e-6,
    var = max(E[x^2] - E[x]^2, 0), y = (x - mean) * (rsqrt(var + eps) *
    scale) + bias, f32 out."""

    def __init__(self, features):
        super().__init__()
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.float()
        mean = x.mean(-1, keepdim=True)
        var = ((x * x).mean(-1, keepdim=True) - mean * mean).clamp_min(0.0)
        return (x - mean) * (torch.rsqrt(var + 1e-6) * self.scale) + self.bias


class SelfAttention(nn.Module):
    def __init__(self, cfg: TransformerConfig, attention_fn, gen):
        super().__init__()
        hd = cfg.d_model // cfg.n_heads
        self.attention_fn = attention_fn or causal_attention
        self.qkv = Dense((cfg.d_model,), (3, cfg.n_heads, hd), cfg.dtype, gen)
        self.out = Dense((cfg.n_heads, hd), (cfg.d_model,), cfg.dtype, gen)

    def forward(self, x: torch.Tensor, *, attention_fn: Callable | None = None,
                kv_taps: list | None = None) -> torch.Tensor:
        """``attention_fn`` replaces the module's own for this call;
        ``kv_taps`` gets this layer's (k, v) [B, S, H, hd] appended (JAX's
        ``kv_cache`` sow). Both serve ``serve/decode.py``."""
        qkv = self.qkv(x)                               # [B, S, 3, H, hd]
        q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
        if kv_taps is not None:
            kv_taps.append((k, v))
        return self.out((attention_fn or self.attention_fn)(q, k, v))


class Mlp(nn.Module):
    def __init__(self, cfg: TransformerConfig, gen):
        super().__init__()
        self.up = Dense((cfg.d_model,), (cfg.d_ff,), cfg.dtype, gen)
        self.down = Dense((cfg.d_ff,), (cfg.d_model,), cfg.dtype, gen)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.down(F.gelu(self.up(x), approximate="tanh"))


class Block(nn.Module):
    """``mlp_cls(cfg, gen)`` builds the MLP: ``Mlp`` or
    ``parallel.expert.MoeMlp``."""

    def __init__(self, cfg: TransformerConfig, attention_fn, gen,
                 mlp_cls: type = Mlp):
        super().__init__()
        self.ln1 = LayerNorm(cfg.d_model)
        self.attn = SelfAttention(cfg, attention_fn, gen)
        self.ln2 = LayerNorm(cfg.d_model)
        self.mlp = mlp_cls(cfg, gen)

    def forward(self, x: torch.Tensor, *, attention_fn: Callable | None = None,
                kv_taps: list | None = None) -> torch.Tensor:
        x = x + self.attn(self.ln1(x), attention_fn=attention_fn,
                          kv_taps=kv_taps)
        return x + self.mlp(self.ln2(x))


class TransformerLM(nn.Module):
    """tokens [B, S] (+ positions [B, S]) -> logits [B, S, vocab], f32 when
    ``fp32_logits``, else in the compute dtype. ``attention_fn(q, k, v)``
    on [B, S, H, hd] replaces the plain causal attention (e.g.
    ``ops.flash_attention.flash_attention_fn()``).

    Serving's two hooks, per call (``serve/decode.py``): ``attention_fn=``
    replaces every layer's attention for this forward alone, called once a
    layer in layer order (decode's paged attention), and ``kv_taps=`` (a
    list) collects each layer's (k, v) in the compute dtype, in layer order
    (prefill). Neither changes a forward that does not pass them."""

    def __init__(self, cfg: TransformerConfig,
                 attention_fn: Callable | None = None, *,
                 mlp_cls: type = Mlp, seed: int = 0,
                 device: str | torch.device = "cpu"):
        super().__init__()
        self.config = cfg
        # drawn on the CPU, then moved: one seed, the same weights on
        # every device (as JAX's init is the same on every backend)
        gen = torch.Generator().manual_seed(seed)
        self.tok_emb = Embed(cfg.vocab_size, cfg.d_model, cfg.dtype, gen)
        self.pos_emb = Embed(cfg.max_len, cfg.d_model, cfg.dtype, gen)
        for i in range(cfg.n_layers):
            self.add_module(f"block{i}",
                            Block(cfg, attention_fn, gen, mlp_cls))
        self.ln_f = LayerNorm(cfg.d_model)
        self.lm_head = Dense((cfg.d_model,), (cfg.vocab_size,), cfg.dtype,
                             gen)
        self.to(torch.device(device))

    def forward(self, tokens: torch.Tensor,
                positions: torch.Tensor | None = None, *,
                attention_fn: Callable | None = None,
                kv_taps: list | None = None) -> torch.Tensor:
        if positions is None:
            positions = torch.arange(tokens.shape[1], device=tokens.device
                                     ).expand(tokens.shape)
        x = self.tok_emb(tokens) + self.pos_emb(positions)
        keep = (_keep_dots if self.config.remat_policy == "dots"
                else noop_context_fn)
        for i in range(self.config.n_layers):
            block = getattr(self, f"block{i}")
            if self.config.remat:
                x = checkpoint(block, x, use_reentrant=False, context_fn=keep,
                               preserve_rng_state=False,
                               attention_fn=attention_fn, kv_taps=kv_taps)
            else:
                x = block(x, attention_fn=attention_fn, kv_taps=kv_taps)
        logits = self.lm_head(self.ln_f(x))
        return logits.float() if self.config.fp32_logits else logits

    def aux_losses(self) -> list[torch.Tensor]:
        """The auxiliary losses of the last forward, one a block whose MLP
        keeps one (``MoeMlp.aux_loss``, Flax's sown ``aux_loss``
        collection); [] for the dense MLP."""
        mlps = (getattr(self, f"block{i}").mlp
                for i in range(self.config.n_layers))
        return [m.aux_loss for m in mlps
                if getattr(m, "aux_loss", None) is not None]


def _dots_policy(ctx, op, *args, **kwargs) -> CheckpointPolicy:
    return (CheckpointPolicy.MUST_SAVE if op in DOT_OPS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _keep_dots():
    return create_selective_checkpoint_contexts(_dots_policy)
