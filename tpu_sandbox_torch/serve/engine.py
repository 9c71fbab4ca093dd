"""Continuous-batching serve engine (plus the static-batch baseline).
Counterpart of ``tpu_sandbox/serve/engine.py``: the same classes, queue,
admission, preemption, shedding and versioned weights, on the port's
steps (``serve/decode.py``). An engine runs on one device, the card unless
the CPU is asked for; its weights are the LM's state dict (name ->
tensor), moved to that device when installed.

``ContinuousEngine`` owns the steps, the page buffers, and the
paged allocator, and advances the whole replica one decode step at a time:

- **admit at step granularity** — every step first fills free decode slots
  from the waiting queue (prefill runs per request, padded to its bucket);
- **evict at step granularity** — sequences that finish release their
  blocks immediately, and the freed slots/blocks are available to the very
  next admit, no batch barrier;
- **preempt-to-requeue** — when a sequence crosses a block boundary and no
  block can be allocated, the newest-admitted sequence is evicted and its
  request goes back to the waiting queue intact (greedy decode + bitwise
  steps make the replay identical).

``StaticEngine`` is the control: admit a full batch, decode until *all* of
it finishes, then admit the next batch. Same steps, same
allocator — the bench compares scheduling policy only.

Decoding is greedy argmax over fp32 logits by default — deterministic,
which is what makes requeue/replay and the replica zero-loss story exact
rather than probabilistic. Sampled decode (``temperature``/``top_k`` on the
request) keeps the same guarantee: the sampler key is derived from the
request seed folded with the decode-step index, so a replayed request
re-draws identical tokens (see ``serve/decode.py:sample_token``).

SLO guardrails live here too:

- requests may carry an absolute **deadline** (engine clock); waiting or
  active requests past their deadline are **shed** — removed from the
  system with an explicit :class:`ShedRecord` instead of silently rotting
  in the queue;
- ``ServeConfig.max_waiting`` bounds the admission queue — on overload
  ``submit`` first sheds oldest-past-deadline waiters, then sheds the
  incoming request if the queue is still full (the caller learns from the
  ``False`` return and the shed record);
- ``load_report()`` exposes the backpressure signals (queue depth,
  block-pool pressure, decode-step lag) replicas publish to the KV store.
"""

from __future__ import annotations

import time
import weakref
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable

import numpy as np
import torch

from tpu_sandbox_torch.models.transformer import TransformerConfig
from tpu_sandbox_torch.obs import get_recorder, get_registry
from tpu_sandbox_torch.serve.cache import CacheConfig, PagedKVCache, SeqAlloc
from tpu_sandbox_torch.serve.decode import (DecodeStep, build_decode_step,
                                            init_pages, sample_token)
from tpu_sandbox_torch.utils.device import resolve_device

# engines with a live decode loop / replica thread, for the conftest leak
# fixture (mirrors kvstore.live_servers())
_LIVE_ENGINES: "weakref.WeakSet" = weakref.WeakSet()


def live_engines() -> list:
    return [e for e in _LIVE_ENGINES if e.active_requests or e.waiting]


@dataclass(frozen=True)
class ServeConfig:
    model: TransformerConfig = field(default_factory=TransformerConfig)
    cache: CacheConfig = field(default_factory=CacheConfig)
    max_batch: int = 4
    buckets: tuple[int, ...] = (16, 32, 64)
    cache_dtype: Any = torch.float32
    eos_token: int | None = None  # None -> run to max_new_tokens
    max_waiting: int = 0          # admission-queue bound; 0 = unbounded


@dataclass
class Request:
    rid: str
    prompt: list[int]
    max_new_tokens: int
    arrival: float = 0.0  # engine clock time the request became visible
    preemptions: int = 0  # times evicted-to-requeue so far
    deadline: float | None = None  # engine clock; past it -> shed, not served
    temperature: float = 0.0       # 0 -> greedy argmax
    top_k: int = 0                 # 0 -> full vocab
    seed: int = 0                  # sampler key; folded with the step index
    ver: int | None = None         # pinned weight version; None -> pin to the
                                   # engine's current version at admit
    tc: dict | None = None         # trace context (wire form); never affects
                                   # tokens, only the flight recorder


@dataclass
class RequestResult:
    rid: str
    tokens: list[int]             # generated tokens only
    ttft: float                   # first-token latency (s, engine clock)
    itl: list[float]              # inter-token latencies (s)
    finished_at: float = 0.0
    preemptions: int = 0
    ver: int = 0                  # weight version every token was decoded on
    tc: dict | None = None        # decode span context; parents the verdict


@dataclass
class ShedRecord:
    """Terminal verdict for a request the engine refused or gave up on.
    A shed request never also produces a RequestResult."""
    rid: str
    reason: str       # "queue_full" | "deadline" | explicit shed reason
    shed_at: float
    preemptions: int = 0
    tc: dict | None = None  # shed-instant context; parents the verdict


@dataclass
class _Slot:
    request: Request
    alloc: SeqAlloc
    tokens: list[int]             # prompt + generated
    generated: list[int] = field(default_factory=list)
    first_token_at: float | None = None
    last_token_at: float | None = None
    itl: list[float] = field(default_factory=list)
    preemptions: int = 0
    ver: int = 0                      # weight version this slot decodes on
    logprob_sum: float = 0.0          # sum of chosen-token logprobs
    tc: dict | None = None            # admit span context
    admitted_mono: float | None = None  # real monotonic time of admission
                                        # (the engine clock may be a fake)


#: "this version is not resident" — distinct from None, which is a valid
#: params value for stub-step engines that never touch weights
_MISSING = object()


def _token_logprob(logits_row: np.ndarray, token: int) -> float:
    """Logprob of ``token`` under fp32 ``logits_row`` (stable logsumexp).
    Fed into the ``engine.logprob`` series the canary analysis compares —
    a weight regression shows up as the model scoring its own chosen
    tokens lower, with no reference labels needed."""
    row = np.asarray(logits_row, np.float64)
    m = float(row.max())
    return float(row[int(token)] - m - np.log(np.exp(row - m).sum()))


def _host(x) -> np.ndarray:
    """A step's logits as host numpy (a stub step may return numpy)."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu").numpy()
    return np.asarray(x)


class _EngineBase:
    def __init__(self, params, config: ServeConfig,
                 step: DecodeStep | None = None,
                 clock: Callable[[], float] = time.monotonic,
                 device: str | torch.device | None = None):
        self.config = config
        # the card unless the caller asks for the CPU; no card is an error
        self.device = resolve_device(device)
        # weights are versioned: requests pin the version they started on
        # and decode on it to the last token, even across a swap (grouped
        # decode below). The boot version 0 is retained forever — it is the
        # rollback target when nothing was ever promoted.
        self.version = 0
        self._params_by_ver: dict[int, Any] = {0: self._place(params)}
        self.step_fns = step or build_decode_step(
            config.model, config.cache, max_batch=config.max_batch,
            buckets=config.buckets, cache_dtype=config.cache_dtype)
        self.cache = PagedKVCache(config.cache)
        self.k_pages, self.v_pages = init_pages(
            config.model, config.cache, config.cache_dtype, self.device)
        self.clock = clock
        self.waiting: deque[Request] = deque()
        self.slots: list[_Slot | None] = [None] * config.max_batch
        self.results: dict[str, RequestResult] = {}
        self.shed: dict[str, ShedRecord] = {}
        self.steps = 0
        self.last_step_at: float | None = None
        _LIVE_ENGINES.add(self)

    # -- public --------------------------------------------------------------

    @property
    def params(self):
        """The *current* version's weights (the long-standing single-version
        API; versioned access goes through ``_params_for``)."""
        return self._params_by_ver[self.version]

    @params.setter
    def params(self, value) -> None:
        self._params_by_ver[self.version] = self._place(value)

    def _place(self, params):
        """A weight dict on the engine's device (None stays None: stub
        engines run weightless)."""
        if params is None:
            return None
        return {k: v.to(self.device) for k, v in params.items()}

    @property
    def active_requests(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    def swap_params(self, params, version: int) -> int:
        """Install ``params`` as weight ``version`` and make it current,
        between decode steps. Resident paged-KV state is NOT drained: live
        slots keep decoding on the version they pinned at admit (grouped
        decode), only the prefix cache is flushed — its K/V was computed
        under other weights. Returns the number of cache entries flushed."""
        t_swap = time.monotonic()
        self._params_by_ver[int(version)] = self._place(params)
        self.version = int(version)
        flushed = self.cache.flush_prefix_cache()
        self._gc_params()
        get_registry().counter("engine.swap").inc()
        # process-level span (no request parent): the critpath analyzer
        # overlaps it against resident requests' gaps — a swap stalls
        # every request on this engine, and that stall should be blamed
        # on the swap, not on "queue_wait"
        get_recorder().complete("swap:pause", t_swap,
                                args={"ver": int(version),
                                      "flushed": int(flushed)})
        return flushed

    def has_version(self, ver: int) -> bool:
        return int(ver) in self._params_by_ver

    def _params_for(self, ver: int):
        """Weights for ``ver``, or the ``_MISSING`` sentinel (None is a
        valid params value — stub engines run weightless)."""
        return self._params_by_ver.get(int(ver), _MISSING)

    def _gc_params(self) -> None:
        keep = {self.version, 0}
        keep.update(s.ver for s in self.slots if s is not None)
        keep.update(int(r.ver) for r in self.waiting if r.ver is not None)
        for ver in [v for v in self._params_by_ver if v not in keep]:
            del self._params_by_ver[ver]

    def submit(self, request: Request) -> bool:
        """Admit ``request`` to the waiting queue. Returns False when the
        request was shed instead (bounded queue full even after expired
        waiters were swept) — a ShedRecord is written either way, so every
        submitted request reaches exactly one terminal verdict."""
        if self.cache.blocks_needed(request.prompt, request.max_new_tokens) \
                > self.config.cache.max_blocks_per_seq:
            raise ValueError(f"request {request.rid} exceeds max context")
        limit = self.config.max_waiting
        if limit and len(self.waiting) >= limit:
            # shed-on-overload: oldest-past-deadline first, then the arrival
            self.shed_expired()
            if len(self.waiting) >= limit:
                self._record_shed(request, "queue_full")
                return False
        self.waiting.append(request)
        return True

    @property
    def idle(self) -> bool:
        return not self.waiting and self.active_requests == 0

    def run_until_idle(self, max_steps: int = 100_000) -> None:
        for _ in range(max_steps):
            if self.idle:
                return
            self.step()
        raise RuntimeError("serve engine failed to drain")

    def drain_to_requests(self) -> list[Request]:
        """Evict everything in flight back to request form (original prompt,
        arrival preserved) — the replica's SIGTERM path."""
        out = []
        for i, slot in enumerate(self.slots):
            if slot is None:
                continue
            self.cache.free(slot.alloc, cache_prefix=False)
            out.append(slot.request)
            self.slots[i] = None
        out.extend(self.waiting)
        self.waiting.clear()
        return out

    # -- SLO guardrails ------------------------------------------------------

    def _record_shed(self, request: Request, reason: str,
                     preemptions: int | None = None,
                     tc: dict | None = None) -> None:
        # the shed instant is the trace's terminal node for this request;
        # its context rides the ShedRecord so the replica's verdict
        # instant stays chained
        ctx = get_recorder().instant(
            f"shed:{reason}", parent=tc if tc is not None else request.tc,
            args={"rid": request.rid})
        get_registry().counter("engine.shed", labels={"reason": reason}).inc()
        self.shed[request.rid] = ShedRecord(
            rid=request.rid, reason=reason, shed_at=self.clock(),
            preemptions=request.preemptions if preemptions is None
            else preemptions,
            tc=None if ctx is None else ctx.to_wire())

    def shed_expired(self) -> int:
        """Shed every waiting or active request whose deadline has passed,
        oldest (queue head / earliest-admitted slot) first. Runs at submit
        overload and at the top of every step, so a request past its
        deadline can never be admitted or produce a late result."""
        now = self.clock()
        n = 0
        keep: deque[Request] = deque()
        while self.waiting:
            req = self.waiting.popleft()
            if req.deadline is not None and now > req.deadline:
                self._record_shed(req, "deadline")
                n += 1
            else:
                keep.append(req)
        self.waiting = keep
        for i, slot in enumerate(self.slots):
            if slot is None:
                continue
            dl = slot.request.deadline
            if dl is not None and now > dl:
                self.cache.free(slot.alloc, cache_prefix=False)
                self.slots[i] = None
                self._record_shed(slot.request, "deadline",
                                  preemptions=slot.preemptions)
                n += 1
        return n

    def shed_waiting(self, reason: str) -> int:
        """Shed the entire waiting queue (the ``shed_storm`` fault)."""
        n = len(self.waiting)
        while self.waiting:
            self._record_shed(self.waiting.popleft(), reason)
        return n

    def load_report(self) -> dict:
        """Backpressure signals a replica publishes to the KV store.

        ``prefix_digest`` rides along so the gateway can route by prefix
        affinity from the load reports alone — no extra KV round trips per
        request (see ``cache.PagedKVCache.resident_prefix_digest``)."""
        now = self.clock()
        cache = self.cache
        rec_stats = get_recorder().stats()
        return {
            "queue_depth": len(self.waiting),
            "active": self.active_requests,
            "ver": self.version,  # the swap ack the deploy controller reads
            "max_batch": self.config.max_batch,
            "free_block_frac": cache.free_blocks / cache.config.num_blocks,
            "steps": self.steps,
            "step_age": None if self.last_step_at is None
            else now - self.last_step_at,
            "shed": len(self.shed),
            "done": len(self.results),
            "prefix_digest": cache.resident_prefix_digest(),
            "recorder": rec_stats,
            # a silently-dropping recorder must be visible at the top
            # level of every load report, not buried in a nested dict
            "dropped_events": rec_stats["dropped"],
        }

    # -- shared mechanics ----------------------------------------------------

    def _admit_from_waiting(self) -> bool:
        """Admit (or resolve) the queue head. True = the head was consumed
        (admitted, or shed because its pinned version is gone); False = the
        head is blocked on capacity and the loop should stop."""
        req = self.waiting[0]
        ver = self.version if req.ver is None else int(req.ver)
        if self._params_for(ver) is _MISSING:
            # the pinned weights no longer exist in this process (respawn
            # after a swap): an explicit shed verdict, so the
            # client restarts a fresh single-version lifecycle — never a
            # silent decode on different weights than the pin
            self.waiting.popleft()
            self._record_shed(req, "stale_version")
            return True
        if not self._try_admit(req):
            return False
        self.waiting.popleft()
        return True

    def _try_admit(self, request: Request) -> bool:
        free = [i for i, s in enumerate(self.slots) if s is None]
        if not free:
            return False
        # reserve the prompt's blocks only; decode grows the allocation one
        # block at a time, so block pressure shows up as preempt-to-requeue
        # rather than refused admission
        alloc = self.cache.alloc(request.prompt, 0)
        if alloc is None:
            return False
        self._prefill(request, alloc, free[0])
        return True

    def _prefill(self, request: Request, alloc: SeqAlloc, slot_idx: int):
        cfg = self.config
        t_admit = time.monotonic()
        ver = self.version if request.ver is None else int(request.ver)
        request.ver = ver  # pin sticks to the request: preempt-to-requeue
                           # and drain replay on these weights, swap or not
        params = self._params_for(ver)
        if params is _MISSING:
            raise KeyError(
                f"request {request.rid} pinned to version {ver} but no such "
                f"params are resident (admit through the queue, which sheds "
                f"stale pins)")
        plen = len(request.prompt)
        bucket = self.step_fns.pick_bucket(plen)
        toks = np.zeros((1, bucket), np.int32)
        toks[0, :plen] = request.prompt
        dest = self.cache.dest_indices(alloc, bucket).astype(np.int32)
        t_prefill = time.monotonic()
        next_logits, self.k_pages, self.v_pages = self.step_fns.prefill[bucket](
            params, self.k_pages, self.v_pages,
            self._to_device(toks), self._to_device(dest), plen - 1)
        alloc.length = plen
        self.cache.commit_prefix(alloc)
        slot = _Slot(request=request, alloc=alloc, tokens=list(request.prompt),
                     preemptions=request.preemptions, ver=ver)
        # the admit span covers admission bookkeeping plus the prefill
        # compute; the prefill child span carves the compute out so the
        # critpath analyzer can tell "slow admission" from "big prompt".
        # The decode span that follows is emitted retrospectively at
        # retire time, anchored here
        ctx = get_recorder().complete("admit", t_admit, parent=request.tc,
                                      args={"rid": request.rid})
        get_recorder().complete("prefill", t_prefill, parent=ctx,
                                args={"rid": request.rid, "plen": plen})
        slot.tc = None if ctx is None else ctx.to_wire()
        slot.admitted_mono = time.monotonic()
        self.slots[slot_idx] = slot
        row = _host(next_logits).reshape(-1)
        token = self._pick_token(slot, row)
        slot.logprob_sum += _token_logprob(row, token)
        self._emit_token(slot, token)
        if self._finished(slot):
            self._retire(slot_idx)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        """Host indices as int64 on the engine's device."""
        return torch.as_tensor(a.astype(np.int64), device=self.device)

    def _pick_token(self, slot: _Slot, logits_row: np.ndarray) -> int:
        """Greedy argmax, or sampled via a key derived from (request seed,
        decode-step index). The step index is ``len(slot.generated)`` — on
        requeue the request replays from its original prompt, so every
        re-draw folds the same index into the same key and the sampled
        trajectory is bitwise identical to the unfaulted run."""
        req = slot.request
        if req.temperature <= 0.0:
            return int(logits_row.argmax())
        return sample_token(logits_row, seed=req.seed,
                            step_index=len(slot.generated),
                            temperature=req.temperature, top_k=req.top_k)

    def _emit_token(self, slot: _Slot, token: int) -> None:
        now = self.clock()
        if slot.first_token_at is None:
            slot.first_token_at = now
        elif slot.last_token_at is not None:
            slot.itl.append(now - slot.last_token_at)
        slot.last_token_at = now
        slot.generated.append(token)
        slot.tokens.append(token)

    def _finished(self, slot: _Slot) -> bool:
        if len(slot.generated) >= slot.request.max_new_tokens:
            return True
        eos = self.config.eos_token
        return eos is not None and slot.generated and slot.generated[-1] == eos

    def _retire(self, i: int) -> None:
        slot = self.slots[i]
        self.slots[i] = None
        self.cache.free(slot.alloc)
        req = slot.request
        ctx = get_recorder().complete(
            "decode",
            slot.admitted_mono if slot.admitted_mono is not None
            else time.monotonic(),
            parent=slot.tc,
            args={"rid": req.rid, "tokens": len(slot.generated)})
        tc = None if ctx is None else ctx.to_wire()
        if req.deadline is not None and self.clock() > req.deadline:
            # finished, but past the promise: the verdict is SHED, never a
            # late result
            self._record_shed(req, "deadline", preemptions=slot.preemptions,
                              tc=tc)
            return
        get_registry().counter("engine.done").inc()
        get_registry().histogram("engine.ttft").observe(
            slot.first_token_at - req.arrival)
        get_registry().histogram("engine.logprob").observe(
            slot.logprob_sum / max(1, len(slot.generated)))
        self.results[req.rid] = RequestResult(
            rid=req.rid, tokens=list(slot.generated),
            ttft=slot.first_token_at - req.arrival,
            itl=list(slot.itl), finished_at=self.clock(),
            preemptions=slot.preemptions, ver=slot.ver, tc=tc)

    def _preempt(self, i: int) -> None:
        """Evict slot i back to the waiting queue (front: it has seniority)."""
        slot = self.slots[i]
        self.slots[i] = None
        self.cache.free(slot.alloc, cache_prefix=False)
        req = slot.request
        req.preemptions = slot.preemptions + 1
        self.waiting.appendleft(req)

    def _ensure_capacity(self, i: int) -> bool:
        """Grow slot i's allocation for its next token; on block pressure
        preempt the newest other slot and retry. False = slot i itself must
        be preempted (nothing left to evict)."""
        slot = self.slots[i]
        need_block = slot.alloc.length % self.config.cache.block_size == 0 \
            and slot.alloc.length // self.config.cache.block_size \
            >= len(slot.alloc.block_ids)
        if not need_block:
            return True
        while not self.cache.grow(slot.alloc):
            victims = [j for j, s in enumerate(self.slots)
                       if s is not None and j != i]
            if not victims:
                return False
            self._preempt(max(victims, key=lambda j: self.slots[j].alloc.seq_id))
        return True

    def _decode_active(self) -> None:
        """One decode step over every occupied slot. Around a
        weight swap the batch can hold slots pinned to different versions:
        one decode call runs per resident version, with the other
        versions' rows zeroed out (length 0 masks their reads, table 0
        scatters their writes to the null block — exactly the treatment
        empty slots already get), so every sequence decodes every token on
        the weights it pinned at admit, never a blend."""
        B = self.config.max_batch
        cfg = self.config.cache
        # resolve capacity for every slot first: growing one slot may
        # preempt another that was already swept, so the batch is built
        # only from the survivors
        for i in range(B):
            if self.slots[i] is not None and not self._ensure_capacity(i):
                self._preempt(i)
        by_ver: dict[int, list[int]] = {}
        for i, slot in enumerate(self.slots):
            if slot is not None:
                by_ver.setdefault(slot.ver, []).append(i)
        if not by_ver:
            return
        rows: dict[int, np.ndarray] = {}
        for ver in sorted(by_ver):
            members = by_ver[ver]
            tokens = np.zeros((B, 1), np.int32)
            lengths = np.zeros((B,), np.int32)
            tables = np.zeros((B, cfg.max_blocks_per_seq), np.int32)
            for i in members:
                slot = self.slots[i]
                tokens[i, 0] = slot.tokens[-1]
                lengths[i] = len(slot.tokens)
                tables[i] = self.cache.block_table(slot.alloc)
            logits, self.k_pages, self.v_pages = self.step_fns.decode(
                self._params_by_ver[ver], self.k_pages, self.v_pages,
                self._to_device(tokens), self._to_device(lengths),
                self._to_device(tables))
            logits = _host(logits)
            for i in members:
                rows[i] = logits[i]
        self.steps += 1
        self.last_step_at = self.clock()
        for i in sorted(rows):
            slot = self.slots[i]
            slot.alloc.length = len(slot.tokens)
            token = self._pick_token(slot, rows[i])
            slot.logprob_sum += _token_logprob(rows[i], token)
            self._emit_token(slot, token)
            if self._finished(slot):
                self._retire(i)


class ContinuousEngine(_EngineBase):
    """Admit/evict at decode-step granularity — freed slots refill before
    the next step, nothing waits for a batch to finish."""

    def step(self) -> None:
        self.shed_expired()
        while self.waiting:
            if not self._admit_from_waiting():
                break
        self._decode_active()


class StaticEngine(_EngineBase):
    """Batch-barrier control: fill the batch once, then decode until every
    member finishes before admitting again."""

    def step(self) -> None:
        self.shed_expired()
        if self.active_requests == 0:
            while self.waiting:
                if not self._admit_from_waiting():
                    break
        self._decode_active()
