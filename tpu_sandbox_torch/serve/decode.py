"""Bucketed prefill and single-token paged decode steps. Counterpart of
``tpu_sandbox/serve/decode.py``: ``sample_token`` (:46), ``DecodeStep``
(:70), ``page_shapes`` (:93), ``init_pages`` (:104), ``make_prefill_fn``
(:117), ``make_decode_fn`` (:145) and ``build_decode_step`` (:199).

Both steps run the one ``TransformerLM`` of ``models/transformer.py``
through ``torch.func.functional_call`` on a weight dict (the LM's state
dict, name -> tensor), so several weight versions can be resident at once
and serve the same module: prefill collects each layer's K/V through the
model's ``kv_taps`` hook (JAX's ``kv_cache`` sow), decode replaces every
layer's attention for the call through its ``attention_fn`` hook. The
module itself is a skeleton on the meta device; it holds no weights.

What differs from JAX:

- No compilation. JAX compiles one prefill per bucket and one decode per
  ``max_batch``; here a prompt is padded to its bucket and the batch to
  ``max_batch``, so every call of a step has that step's shapes. The
  bucket semantics stay: ``pick_bucket``, bucket padding and shared-prefix
  positions scattered to the null block (``cache.dest_indices``).
- The page buffers are written in place (``index_put_`` on the flat
  ``[L, num_blocks * block_size, H, hd]`` view), the counterpart of JAX's
  donation: no copy of the pool a step. The steps still return them, so
  a caller can keep JAX's ``logits, k, v = step(...)`` form.
- Decode attends with a single query row. JAX pads q to 2 rows because
  XLA:CPU's q=1 matvec rounds differently from its gemm; that is a
  property of XLA:CPU, not of the function, and the port does not copy it.
  Decode against a one-shot forward at ``max_context`` is therefore a
  tolerance here (tests/test_torch_serve_decode.py), not bits.
- ``sample_token`` draws its Gumbel noise from numpy's counter-based
  Philox keyed by (seed, step index), not from ``jax.random``: a replay
  re-draws the same tokens within the port; they are not JAX's tokens.
"""

from __future__ import annotations

import itertools
import math
from dataclasses import dataclass
from typing import Any, Callable

import numpy as np
import torch
from torch.func import functional_call

from tpu_sandbox_torch.models.transformer import (TransformerConfig,
                                                  TransformerLM)
from tpu_sandbox_torch.serve.cache import CacheConfig
from tpu_sandbox_torch.utils.device import resolve_device


def gumbel_noise(seed: int, step_index: int, n: int) -> np.ndarray:
    """``n`` fp32 Gumbel draws from a generator keyed by (seed,
    step_index) alone: numpy's counter-based Philox, never a global RNG."""
    key = np.array([seed % 2**64, step_index % 2**64], np.uint64)
    gen = np.random.Generator(np.random.Philox(key=key))
    return gen.gumbel(size=n).astype(np.float32)


def sample_token(logits_row: np.ndarray, *, seed: int, step_index: int,
                 temperature: float, top_k: int = 0) -> int:
    """Replay-exact temperature/top-k sampling over one row of fp32 logits.

    The draw is keyed by (``seed``, ``step_index``), where ``step_index``
    is the request's decode-step index (number of tokens generated so far).
    A request that is preempt-requeued or replayed after replica death
    re-runs from its original prompt, recomputes identical logits, draws
    the same noise for the same indices, and so re-draws the same tokens.

    Gumbel-max over host fp32: ``argmax(logits/T + g)``.
    """
    logits = np.asarray(logits_row, np.float32) / np.float32(temperature)
    if top_k > 0 and top_k < logits.shape[-1]:
        kth = np.sort(logits)[-top_k]
        logits = np.where(logits >= kth, logits, -np.inf)
    g = gumbel_noise(seed, step_index, logits.shape[-1])
    return int((logits + g).argmax())


@dataclass(frozen=True)
class DecodeStep:
    """Step functions plus the geometry they were built for."""

    model_cfg: TransformerConfig
    cache_cfg: CacheConfig
    max_batch: int
    buckets: tuple[int, ...]
    cache_dtype: Any
    # bucket length -> prefill(params, k, v, tokens[1, bucket], dest, last)
    prefill: dict[int, Callable]
    # decode(params, k, v, tokens[max_batch, 1], lengths, block_tables)
    decode: Callable

    def pick_bucket(self, prompt_len: int) -> int:
        for b in self.buckets:
            if prompt_len <= b:
                return b
        raise ValueError(
            f"prompt of {prompt_len} tokens exceeds largest prefill bucket "
            f"{self.buckets[-1]}")


def page_shapes(model_cfg: TransformerConfig, cache_cfg: CacheConfig
                ) -> tuple[tuple[int, ...], tuple[int, ...]]:
    head_dim = model_cfg.d_model // model_cfg.n_heads
    shape = (model_cfg.n_layers, cache_cfg.num_blocks, cache_cfg.block_size,
             model_cfg.n_heads, head_dim)
    return shape, shape


def init_pages(model_cfg: TransformerConfig, cache_cfg: CacheConfig,
               cache_dtype: torch.dtype = torch.float32,
               device: str | torch.device | None = None):
    """Zeroed K and V page buffers on ``device`` (the card unless the CPU
    is asked for). Finite everywhere: masked positions multiply stale page
    content by zero weights, which must stay exact."""
    dev = resolve_device(device)
    ks, vs = page_shapes(model_cfg, cache_cfg)
    return (torch.zeros(ks, dtype=cache_dtype, device=dev),
            torch.zeros(vs, dtype=cache_dtype, device=dev))


def _flat(pages: torch.Tensor) -> torch.Tensor:
    L, nb, bs, H, D = pages.shape
    return pages.view(L, nb * bs, H, D)


def _skeleton(model_cfg: TransformerConfig) -> TransformerLM:
    """The LM's module tree on the meta device: the steps bind a weight
    dict to it per call, so it allocates nothing."""
    with torch.device("meta"):
        return TransformerLM(model_cfg, device="meta")


def make_prefill_fn(model_cfg: TransformerConfig, cache_cfg: CacheConfig,
                    cache_dtype: torch.dtype = torch.float32):
    """prefill(params, k_pages, v_pages, tokens[1, Lb], dest_idx[Lb],
    last_pos) -> (next_logits[vocab], k_pages, v_pages).

    ``dest_idx`` maps each bucket position to its flat page slot: the null
    block (slot 0) for bucket padding and shared-prefix positions, so the
    scatter never rewrites shared content. The pages are written in place.
    """
    model = _skeleton(model_cfg)

    @torch.no_grad()
    def prefill(params, k_pages, v_pages, tokens, dest_idx, last_pos):
        taps: list = []
        logits = functional_call(model, params, (tokens,),
                                 {"kv_taps": taps})
        fk, fv = _flat(k_pages), _flat(v_pages)
        for i, (k, v) in enumerate(taps):
            fk[i].index_put_((dest_idx,), k[0].to(cache_dtype))
            fv[i].index_put_((dest_idx,), v[0].to(cache_dtype))
        return logits[0, last_pos], k_pages, v_pages

    return prefill


def make_decode_fn(model_cfg: TransformerConfig, cache_cfg: CacheConfig,
                   max_batch: int, cache_dtype: torch.dtype = torch.float32):
    """decode(params, k_pages, v_pages, tokens[B, 1], lengths[B],
    block_tables[B, max_blocks]) -> (logits[B, vocab], k_pages, v_pages).

    ``lengths[b]`` counts tokens *including* the one being fed, so its
    position is ``lengths[b] - 1`` and attention covers kv positions
    ``< lengths[b]`` (the causal row for that query). Empty slots use
    ``lengths == 0``: their writes land in the null block and their
    attention weights collapse to zeros. Each layer gathers the whole
    ``max_context`` of every slot through its block table and runs a
    length-masked fp32 softmax, as JAX's does.
    """
    model = _skeleton(model_cfg)
    bs = cache_cfg.block_size
    head_dim = model_cfg.d_model // model_cfg.n_heads
    max_ctx = cache_cfg.max_context
    scale = math.sqrt(head_dim)

    @torch.no_grad()
    def decode(params, k_pages, v_pages, tokens, lengths, block_tables):
        if tokens.shape[0] != max_batch:
            raise ValueError(f"decode takes {max_batch} slots, got "
                             f"{tokens.shape[0]}")
        fk, fv = _flat(k_pages), _flat(v_pages)
        dev = tokens.device
        pos = (lengths - 1).clamp_min(0)                          # [B]
        dest = (block_tables.gather(1, (pos // bs)[:, None])[:, 0] * bs
                + pos % bs)                                       # [B]
        # flat slot of every block-table position, in sequence order
        ctx_idx = (block_tables[:, :, None] * bs
                   + torch.arange(bs, device=dev)).reshape(max_batch,
                                                            max_ctx)
        kv_mask = torch.arange(max_ctx, device=dev)[None, :] < lengths[:, None]
        layer = itertools.count()

        def attention_fn(q, k, v):
            # q/k/v: [B, 1, H, D], the new token at position lengths - 1
            i = next(layer)
            fk[i].index_put_((dest,), k[:, 0].to(cache_dtype))
            fv[i].index_put_((dest,), v[:, 0].to(cache_dtype))
            kc = fk[i][ctx_idx].to(q.dtype)                   # [B, ctx, H, D]
            vc = fv[i][ctx_idx].to(v.dtype)
            scores = torch.einsum("bqhd,bkhd->bhqk", q, kc).float() / scale
            scores = scores.masked_fill(~kv_mask[:, None, None, :],
                                        float("-inf"))
            w = torch.nan_to_num(
                torch.exp(scores - scores.amax(-1, keepdim=True)))
            w = w / w.sum(-1, keepdim=True).clamp_min(1e-30)
            return torch.einsum("bhqk,bkhd->bqhd", w.to(vc.dtype), vc)

        logits = functional_call(model, params, (tokens, pos[:, None]),
                                 {"attention_fn": attention_fn})
        return logits[:, 0], k_pages, v_pages

    return decode


def _bucket_prefill(prefill: Callable, bucket: int) -> Callable:
    """``prefill`` for prompts padded to ``bucket`` tokens, and only those:
    the counterpart of one compiled prefill a bucket."""
    def run(params, k_pages, v_pages, tokens, dest_idx, last_pos):
        if tokens.shape != (1, bucket) or dest_idx.shape != (bucket,):
            raise ValueError(
                f"prefill bucket {bucket} got tokens {tuple(tokens.shape)} "
                f"and dest_idx {tuple(dest_idx.shape)}")
        return prefill(params, k_pages, v_pages, tokens, dest_idx, last_pos)
    return run


def build_decode_step(model_cfg: TransformerConfig, cache_cfg: CacheConfig,
                      *, max_batch: int = 4,
                      buckets: tuple[int, ...] = (16, 32, 64),
                      cache_dtype: torch.dtype = torch.float32) -> DecodeStep:
    """Every step function for the given static geometry. The steps run
    where their tensors are."""
    buckets = tuple(sorted(b for b in buckets if b <= cache_cfg.max_context))
    if not buckets:
        raise ValueError("no prefill bucket fits max_context")
    prefill = make_prefill_fn(model_cfg, cache_cfg, cache_dtype)
    return DecodeStep(
        model_cfg=model_cfg, cache_cfg=cache_cfg, max_batch=max_batch,
        buckets=buckets, cache_dtype=cache_dtype,
        prefill={b: _bucket_prefill(prefill, b) for b in buckets},
        decode=make_decode_fn(model_cfg, cache_cfg, max_batch, cache_dtype),
    )
