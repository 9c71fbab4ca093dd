"""Disaggregated prefill/decode over the MPMD stage transport. Counterpart
of ``tpu_sandbox/serve/disagg.py``: ``DisaggRequest``,
``PrefillReplica.prefill_and_ship``, ``DecodeReplica.decode_from_handoff``
and ``serve_disaggregated``.

One request's serving is split between two replicas the way the MPMD
pipeline splits training between stages: a PREFILL replica runs the
prompt pass, then ships exactly this request's paged-KV block rows
(gathered on the device) plus the next-token logits over a
:class:`~tpu_sandbox_torch.mpmd.transport.Transport`; a DECODE replica
with its own page buffers imports the rows at its own freshly allocated
block ids and runs the decode loop. Block ids are private to each cache
(attention only gathers through the block table), so the handoff re-homes
the pages without touching their contents, and the generated tokens are
the tokens of the port's engine serving the same request alone: the same
steps (``serve/decode.py``), the same ``_pick_token`` policy (greedy, or
numpy's Philox keyed by (seed, step index)).

The handoff is claim-once, as a training slot is: a second decode of a
request in one generation is refused; a relaunched decode replica (a new
generation) may replay it.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from tpu_sandbox_torch.models.transformer import TransformerConfig
from tpu_sandbox_torch.serve.cache import CacheConfig, PagedKVCache
from tpu_sandbox_torch.serve.decode import (
    DecodeStep,
    build_decode_step,
    init_pages,
    sample_token,
)
from tpu_sandbox_torch.utils.device import resolve_device


@dataclass
class DisaggRequest:
    rid: str
    prompt: list[int]
    max_new_tokens: int
    seed: int = 0
    temperature: float = 0.0
    top_k: int = 0
    eos_token: int | None = None


def _edge(rid: str) -> str:
    return f"kvpage/{rid}"


def _pick_token(req: DisaggRequest, logits_row: np.ndarray,
                step_index: int) -> int:
    """Greedy, or sampled replay-exact: the engine's ``_pick_token``
    policy, keyed by (request seed, decode-step index)."""
    if req.temperature <= 0.0:
        return int(logits_row.argmax())
    return sample_token(logits_row, seed=req.seed, step_index=step_index,
                        temperature=req.temperature, top_k=req.top_k)


def _host_row(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu").numpy()
    return np.asarray(x)


class _Replica:
    """``params``: the LM's weight dict, placed on ``device`` (the card
    unless the caller asks for the CPU); the page pool in
    ``cache_dtype``."""

    def __init__(self, params, model_cfg: TransformerConfig,
                 cache_cfg: CacheConfig, transport, *,
                 step: DecodeStep | None = None, max_batch: int = 4,
                 buckets: tuple[int, ...] = (16, 32, 64),
                 cache_dtype: torch.dtype = torch.float32, device=None):
        self.device = resolve_device(device)
        self.params = {k: v.to(self.device) for k, v in params.items()}
        self.model_cfg = model_cfg
        self.cache_cfg = cache_cfg
        self.transport = transport
        # replicas may share one DecodeStep (same geometry)
        self.step = step if step is not None else build_decode_step(
            model_cfg, cache_cfg, max_batch=max_batch, buckets=buckets,
            cache_dtype=cache_dtype)
        self.cache = PagedKVCache(cache_cfg)
        self.k_pages, self.v_pages = init_pages(
            model_cfg, cache_cfg, self.step.cache_dtype, self.device)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.asarray(a).astype(np.int64),
                               device=self.device)


class PrefillReplica(_Replica):
    """Runs the prompt pass and ships the request's KV rows + logits."""

    def prefill_and_ship(self, req: DisaggRequest) -> None:
        alloc = self.cache.alloc(req.prompt, 0)
        if alloc is None:
            raise RuntimeError("prefill cache out of blocks")
        plen = len(req.prompt)
        bucket = self.step.pick_bucket(plen)
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :plen] = req.prompt
        dest = self.cache.dest_indices(alloc, bucket)
        next_logits, self.k_pages, self.v_pages = self.step.prefill[bucket](
            self.params, self.k_pages, self.v_pages,
            self._to_device(toks), self._to_device(dest), plen - 1)
        alloc.length = plen
        self.cache.commit_prefix(alloc)
        # exactly this request's block rows, in block-table order, gathered
        # on the device: a host wire stages only these rows, the device
        # wire ships them as they are, never the whole page pool
        ids = self._to_device(alloc.block_ids)
        k_rows = self.k_pages[:, ids]
        v_rows = self.v_pages[:, ids]
        self.transport.put(_edge(req.rid), 0, 0,
                           [k_rows, v_rows, next_logits])
        self.cache.free(alloc)


class DecodeReplica(_Replica):
    """Imports shipped KV rows into its own page layout and decodes."""

    def __init__(self, *args, generation: int = 0, **kwargs):
        super().__init__(*args, **kwargs)
        self.generation = generation

    def _rows(self, x) -> torch.Tensor:
        t = x if isinstance(x, torch.Tensor) else torch.from_numpy(
            np.array(x))
        return t.to(self.device, self.step.cache_dtype)

    def decode_from_handoff(self, req: DisaggRequest, *,
                            timeout: float = 60.0) -> list[int]:
        if not self.transport.claim(_edge(req.rid), 0, 0,
                                    generation=self.generation):
            raise RuntimeError(f"request {req.rid!r} already decoded "
                               f"in generation {self.generation}")
        k_rows, v_rows, next_logits = self.transport.get(
            _edge(req.rid), 0, 0, timeout=timeout)
        plen = len(req.prompt)
        alloc = self.cache.alloc(req.prompt, 0)
        if alloc is None:
            raise RuntimeError("decode cache out of blocks")
        if len(alloc.block_ids) > alloc.n_shared:
            idx = self._to_device(alloc.block_ids[alloc.n_shared:])
            self.k_pages[:, idx] = self._rows(k_rows)[:, alloc.n_shared:]
            self.v_pages[:, idx] = self._rows(v_rows)[:, alloc.n_shared:]
        alloc.length = plen
        self.cache.commit_prefix(alloc)

        generated = [_pick_token(req, _host_row(next_logits).reshape(-1),
                                 0)]
        tokens = list(req.prompt) + generated
        B = self.step.max_batch
        bs = self.cache_cfg.block_size
        while (len(generated) < req.max_new_tokens
               and (req.eos_token is None
                    or generated[-1] != req.eos_token)):
            # the incoming token's kv slot, grown exactly like the
            # engine's _ensure_capacity (one block at a time)
            if (alloc.length % bs == 0
                    and alloc.length // bs >= len(alloc.block_ids)):
                if not self.cache.grow(alloc):
                    raise RuntimeError("decode cache out of blocks")
            toks = np.zeros((B, 1), np.int32)
            toks[0, 0] = tokens[-1]
            lengths = np.zeros((B,), np.int32)
            lengths[0] = len(tokens)
            tables = np.zeros((B, self.cache_cfg.max_blocks_per_seq),
                              np.int32)
            tables[0] = self.cache.block_table(alloc)
            logits, self.k_pages, self.v_pages = self.step.decode(
                self.params, self.k_pages, self.v_pages,
                self._to_device(toks), self._to_device(lengths),
                self._to_device(tables))
            alloc.length = len(tokens)
            tok = _pick_token(req, _host_row(logits)[0], len(generated))
            generated.append(tok)
            tokens.append(tok)
        self.cache.free(alloc)
        return generated


def serve_disaggregated(prefill: PrefillReplica, decode: DecodeReplica,
                        req: DisaggRequest, *,
                        timeout: float = 60.0) -> list[int]:
    """One request through the split path: prompt on the prefill replica,
    pages over the transport, tokens from the decode replica."""
    prefill.prefill_and_ship(req)
    return decode.decode_from_handoff(req, timeout=timeout)
