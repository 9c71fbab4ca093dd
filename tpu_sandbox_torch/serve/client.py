"""Client-side SLO machinery: deadlines, retry-on-shed, straggler hedging.
Counterpart of ``tpu_sandbox/serve/client.py``.

``ServeClient`` wraps the producer half of the replica protocol
(serve/replica.py) with the three things a caller under an SLO needs:

- **deadlines** — every submit stamps a wall-clock deadline into the
  request body; replicas shed rather than serve past it, and the explicit
  SHED verdict in the result slot means the client never hangs on a
  request the system gave up on;
- **retry with jittered backoff** — a SHED verdict (or a request that lost
  its lease and was never rescued) is retried up to ``max_retries`` times
  with a fresh deadline, pacing the polls with the same jittered
  exponential backoff the KV client uses (``kvstore._backoff_delays``);
- **hedging** — if a request has no verdict and no live lease after
  ``hedge_after`` seconds, the client appends a duplicate queue entry so
  another replica races the straggler. Safe by construction: verdict
  publication is claim-once (serve/done/<rid>) and result bodies are
  bitwise identical across executions (greedy or seeded-sampled decode),
  so a hedge can only waste compute, never change an answer.

Direct-to-KV traffic honors the canary split too: when the deploy
controller has live traffic shares up (``deploy/shares/<fleet>``), each
submit draws a weight version by share and writes the ``serve/pin``
before enqueueing, so the first claimer decodes on the drawn version.
Without this, KV-path requests would all land on whatever version their
claimer happens to run — diluting the canary's share of traffic and the
baseline-vs-canary comparison both. A retry redraws (it is a new
lifecycle; the pin was cleared with the verdict). The draws are JAX's:
``random.Random(share_seed)``, so both packages' clients pin the same
version sequence for the same seed.
"""

from __future__ import annotations

import json
import random
import time
from dataclasses import dataclass, field

from tpu_sandbox_torch.runtime.kvstore import _backoff_delays
from tpu_sandbox_torch.serve.replica import (enqueue, k_done, k_lease, k_pin,
                                             k_result, submit_request)


@dataclass
class ClientStats:
    submitted: int = 0
    completed: int = 0
    shed: int = 0
    retries: int = 0
    hedges: int = 0
    #: gateway-path only: connections moved to another gateway after a
    #: connect failure / mid-frame EOF / hello timeout
    failovers: int = 0


class RetriesExhausted(RuntimeError):
    """The retry budget burned out on terminal sheds. Typed — a caller
    under an SLO must distinguish "the system refused after every retry"
    from a verdict dict it might forget to check — and carries the
    evidence: the last shed reason and the per-attempt timeline."""

    def __init__(self, rid: str, verdict: dict, attempts: list[dict]):
        self.rid = rid
        self.verdict = verdict
        self.last_reason = verdict.get("reason", "")
        self.attempts = attempts
        super().__init__(
            f"retries exhausted for {rid}: last shed reason "
            f"{self.last_reason!r} after {len(attempts)} attempt(s)")


@dataclass
class _Pending:
    prompt: list[int]
    max_new_tokens: int
    deadline_s: float | None
    temperature: float
    top_k: int
    seed: int
    submitted_at: float = 0.0
    retries_left: int = 0
    hedged: bool = False
    # one entry per submit/retry: {submitted_at, shed_reason?, resolved_at?}
    attempts: list = field(default_factory=list)


class ServeClient:
    """One producer's view of the serve plane. Not thread-safe; make one
    per producer thread (they share the KV store, not this object)."""

    def __init__(self, kv, *, deadline_s: float | None = None,
                 max_retries: int = 2, hedge_after: float | None = None,
                 backoff_base: float = 0.02, backoff_cap: float = 0.5,
                 share_seed: int = 0):
        self.kv = kv
        self.deadline_s = deadline_s
        self.max_retries = max_retries
        self.hedge_after = hedge_after
        self.backoff_base = backoff_base
        self.backoff_cap = backoff_cap
        self.stats = ClientStats()
        self._pending: dict[str, _Pending] = {}
        # canary-share draws: seeded so a test or replay submits the same
        # version sequence; the deploy keys live at the store ROOT while
        # a fleet view's serve keys live under fleet/<name>/
        self._share_rng = random.Random(share_seed)
        prefix = getattr(kv, "prefix", "") or ""
        if prefix.startswith("fleet/") and prefix.endswith("/"):
            self._deploy_kv = kv.raw
            self._fleet = prefix[len("fleet/"):-1]
        else:
            self._deploy_kv = kv
            self._fleet = ""

    def _pin_share(self, rid: str) -> int | None:
        """Honor the deploy controller's live canary split: draw a weight
        version by share and pin the rid to it BEFORE the enqueue, so the
        first claimer decodes on the drawn version. No live shares (the
        overwhelmingly common case) costs one try_get. Never a
        correctness gate — a pin the fleet cannot serve yet just decodes
        on the pinned version once a replica acks it."""
        from tpu_sandbox_torch.deploy.registry import read_shares
        from tpu_sandbox_torch.gateway.routing import pick_by_share

        shares = read_shares(self._deploy_kv, self._fleet)
        if not shares:
            return None
        ver = pick_by_share(shares, self._share_rng.random())
        if ver is not None:
            self.kv.set(k_pin(rid), str(int(ver)))
        return ver

    def submit(self, rid: str, prompt, max_new_tokens: int, *,
               deadline_s: float | None = None, temperature: float = 0.0,
               top_k: int = 0, seed: int = 0) -> None:
        d = self.deadline_s if deadline_s is None else deadline_s
        p = _Pending(prompt=list(map(int, prompt)),
                     max_new_tokens=int(max_new_tokens), deadline_s=d,
                     temperature=temperature, top_k=top_k, seed=seed,
                     submitted_at=time.time(),
                     retries_left=self.max_retries)
        p.attempts.append({"submitted_at": p.submitted_at})
        self._pin_share(rid)
        submit_request(
            self.kv, rid, p.prompt, p.max_new_tokens,
            deadline_unix=None if d is None else p.submitted_at + d,
            temperature=temperature, top_k=top_k, seed=seed)
        self._pending[rid] = p
        self.stats.submitted += 1

    def result(self, rid: str, timeout: float = 60.0) -> dict:
        """Block until ``rid`` has a terminal verdict, retrying sheds and
        hedging stragglers along the way. Returns the "ok" verdict body
        (tokens and metadata). A shed that outlives the retry budget
        raises :class:`RetriesExhausted` — except for rids this client
        never submitted (no budget to speak of), whose SHED verdict is
        returned as data."""
        p = self._pending.get(rid)
        deadline = time.monotonic() + timeout
        while True:
            for delay in _backoff_delays(max(deadline - time.monotonic(), 0),
                                         base=self.backoff_base,
                                         cap=self.backoff_cap):
                raw = self.kv.try_get(k_result(rid))
                if raw is not None:
                    verdict = json.loads(raw)
                    if verdict.get("verdict", "ok") != "SHED":
                        self._pending.pop(rid, None)
                        self.stats.completed += 1
                        return verdict
                    if p is None:
                        self.stats.shed += 1
                        return verdict
                    if p.retries_left <= 0:
                        self._pending.pop(rid, None)
                        self.stats.shed += 1
                        if p.attempts:
                            p.attempts[-1].update(
                                shed_reason=verdict.get("reason", ""),
                                resolved_at=time.time())
                        raise RetriesExhausted(rid, verdict, p.attempts)
                    self._retry(rid, p, verdict)
                    break
                if p is not None:
                    self._maybe_hedge(rid, p)
                time.sleep(delay)
            else:
                raise TimeoutError(f"no verdict for {rid} within {timeout}s")

    def _retry(self, rid: str, p: _Pending,
               verdict: dict | None = None) -> None:
        """Re-enqueue a shed request with a fresh deadline. The old verdict
        and its claim marker are cleared first so the replay can publish —
        by the time the client sees a SHED it is terminal, nobody else
        writes that slot again. The weight-version pin goes too: a retry
        is a new lifecycle and pins whatever its claimer then runs."""
        p.retries_left -= 1
        if p.attempts:
            p.attempts[-1].update(
                shed_reason="" if verdict is None
                else verdict.get("reason", ""),
                resolved_at=time.time())
        p.submitted_at = time.time()
        p.attempts.append({"submitted_at": p.submitted_at})
        p.hedged = False
        self.kv.delete(k_result(rid))
        self.kv.delete(k_done(rid))
        self.kv.delete(k_pin(rid))
        self._pin_share(rid)  # a retry redraws the canary split
        submit_request(
            self.kv, rid, p.prompt, p.max_new_tokens,
            deadline_unix=None if p.deadline_s is None
            else p.submitted_at + p.deadline_s,
            temperature=p.temperature, top_k=p.top_k, seed=p.seed)
        self.stats.retries += 1

    def _maybe_hedge(self, rid: str, p: _Pending) -> None:
        if p.hedged or self.hedge_after is None:
            return
        if time.time() - p.submitted_at < self.hedge_after:
            return
        if self.kv.try_get(k_lease(rid)) is not None:
            return  # someone is demonstrably working on it
        # no verdict, no lease: append a duplicate entry; claim-once is per
        # entry so a second replica can race the (possibly dead) first
        enqueue(self.kv, rid)
        p.hedged = True
        self.stats.hedges += 1
