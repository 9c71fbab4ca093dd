"""Seeded chaos campaigns: compose every fault family the platform
already survives one-at-a-time, fire them against a live multi-gateway
fleet mid-workload, and audit the wreckage. The port's copy of
``tpu_sandbox/runtime/chaos.py``: the same schedules, the same mailbox
keys and the same audit bytes.

The existing fault hooks are scattered across planes — replica mailboxes
(``serve/cmd/<tag>``: shed_storm, stall_replica), agent mailboxes
(``agent/cmd/<id>``: kill_agent, partition_host), process kills (gateway
SIGKILL / ``Gateway.kill()``), leader death (autoscaler / deploy
controller resign-or-kill). Each is exercised by a hand-written scenario
somewhere in the test tree. This module composes them: a seed expands
into a deterministic fault schedule over a replayed workload trace
(:mod:`tpu_sandbox_torch.obs.workload`), and the campaign ends with the fleet
invariants that must hold *no matter what fired*:

- **exactly one terminal verdict per request** — every submitted rid
  holds a ``serve/result`` body (zero lost), and the claim-once
  ``serve/done`` marker arbitrated every publication race (zero
  duplicated answers; duplicated *compute* is allowed and counted).
- **alert discipline** — every durable alert record has its claim
  marker: the claim-once ``raise_alert`` ordering held through any
  monitor death the campaign caused.
- **byte-identical audit** — the campaign's claim audit (fault firing
  sequence + per-rid verdict kind and token digest) serializes
  canonically; running the same seed twice against a fresh fleet yields
  the same bytes. This is the determinism receipt: verdict *bodies* are
  bitwise by the serve protocol, the firing *sequence* is pinned by the
  seed, and campaign-level retries scrub timing-dependent sheds so the
  terminal state is timing-free.

Determinism is sequence-level, not wall-clock-level: submits and fault
fires interleave in one thread in seeded order (ties break submit-first),
so "kill gateway gw1 after the 14th arrival" means the same thing on a
loaded laptop and a quiet CI box. What is NOT deterministic — which
replica executed a rid, how many scavenges raced — stays out of the
audit bytes and in the human-facing report instead.

The campaign drives gateways and agents through injected hooks (a test
kills an in-process ``Gateway``; ``chip_smoke.py``'s ``path_chaos``
SIGKILLs a real gateway process) — the orchestrator owns sequencing and auditing, never process
management.
"""

from __future__ import annotations

import hashlib
import json
import random
import time
from dataclasses import dataclass, field
from typing import Callable

from tpu_sandbox_torch.obs import get_recorder, workload
from tpu_sandbox_torch.obs.health import K_ALERT_PREFIX, k_alert_claim
from tpu_sandbox_torch.serve.replica import (enqueue, k_cmd, k_done,
                                             k_pin, k_result)

#: audit schema — bump on any field change, the workload.py discipline
AUDIT_SCHEMA = "tpu-sandbox.chaos-audit/1"

#: every action a schedule may draw; the campaign validates that each
#: scheduled action has an executor (mailbox-backed or injected hook)
CHAOS_ACTIONS = ("kill_gateway", "kill_agent", "partition_host",
                 "kill_leader", "shed_storm", "stall_replica")

#: actions the campaign executes itself through the serve fault mailbox;
#: everything else needs a hook from the embedder
MAILBOX_ACTIONS = ("shed_storm", "stall_replica")


@dataclass(frozen=True)
class ChaosFault:
    """One scheduled fault: fire ``action`` on ``target`` once the
    campaign clock passes ``at_s`` (trace-relative seconds, same axis as
    the workload's arrival times). ``stall_replica`` targets carry the
    stall duration as ``tag:seconds``, the FaultPlan syntax."""

    at_s: float
    action: str
    target: str

    def as_dict(self) -> dict:
        return {"at_s": self.at_s, "action": self.action,
                "target": self.target}


def build_schedule(seed: int, *, duration_s: float,
                   targets: dict[str, list[str]],
                   n_faults: int = 4) -> list[ChaosFault]:
    """Expand a seed into a fault schedule. ``targets`` maps action ->
    candidate target list; only actions with candidates are drawn, so an
    embedder without agents simply omits the agent actions. Same seed +
    same targets dict -> same schedule, element for element (the draws
    consume the Random stream in a fixed order)."""
    rng = random.Random(seed)
    unknown = sorted(set(targets) - set(CHAOS_ACTIONS))
    if unknown:
        raise ValueError(f"unknown chaos actions: {unknown}")
    actions = [a for a in CHAOS_ACTIONS if targets.get(a)]
    if not actions:
        raise ValueError("no action has candidate targets")
    faults = []
    for _ in range(n_faults):
        action = actions[rng.randrange(len(actions))]
        pool = targets[action]
        target = pool[rng.randrange(len(pool))]
        faults.append(ChaosFault(
            at_s=round(rng.uniform(0.0, duration_s), 6),
            action=action, target=target))
    return sorted(faults, key=lambda f: (f.at_s, f.action, f.target))


@dataclass
class CampaignResult:
    """What one campaign did and whether the invariants held."""

    seed: int
    fired: list[dict] = field(default_factory=list)
    submitted: int = 0
    admitted: int = 0
    door_shed: int = 0
    retried: int = 0
    lost: list[str] = field(default_factory=list)
    #: rid -> {"verdict": kind, "tokens": digest} — the deterministic half
    verdicts: dict[str, dict] = field(default_factory=dict)
    failures: list[str] = field(default_factory=list)

    @property
    def ok(self) -> bool:
        return not self.failures and not self.lost

    def audit_bytes(self) -> str:
        """The canonical claim audit: fault firing sequence + per-rid
        terminal state, sorted keys, compact separators, one trailing
        newline — the workload.py canonicalization discipline, so two
        same-seed campaigns diff byte-for-byte. Deliberately excludes
        everything timing-flavored (which replica executed, scavenge
        counts, retry counts, wall stamps)."""
        return json.dumps(
            {"schema": AUDIT_SCHEMA, "seed": self.seed,
             "faults": self.fired,
             "verdicts": {rid: self.verdicts[rid]
                          for rid in sorted(self.verdicts)},
             "lost": sorted(self.lost)},
            sort_keys=True, separators=(",", ":")) + "\n"


def _token_digest(verdict: dict) -> str:
    """Short stable digest of a verdict's answer bytes. Tokens are
    bitwise-identical across executions of a rid, so this is the
    deterministic fingerprint the audit carries instead of the list."""
    tokens = verdict.get("tokens", [])
    blob = json.dumps(tokens, separators=(",", ":")).encode()
    return hashlib.sha256(blob).hexdigest()[:16]


class ChaosCampaign:
    """One seeded campaign against a live fleet.

    ``kv`` is the fleet-scoped serve-plane view (the same one the
    replicas and gateways use for this fleet). ``submit`` is the
    embedder's door: ``submit(rid, prompt, max_new_tokens) -> bool``
    (admitted?) — typically a failover :class:`GatewayClient` so a
    killed gateway costs latency, not the campaign. ``hooks`` maps the
    non-mailbox actions to executors (``kill_gateway`` -> kill that
    gateway process/object, ``kill_leader`` -> kill/resign the named
    controller, ...).

    Prompts are derived from the trace deterministically: rows sharing a
    ``chain`` label share their leading block of tokens, so prefix
    routing has real structure to find; the rest of the prompt is seeded
    by the rid. ``time_scale`` compresses the trace's arrival axis (and
    the fault schedule with it) so a 1-second trace can run a 100 ms
    campaign in the fast tier."""

    def __init__(self, kv, trace: dict,
                 submit: Callable[[str, list, int], bool], *,
                 seed: int, schedule: list[ChaosFault],
                 hooks: dict[str, Callable[[str], None]] | None = None,
                 time_scale: float = 1.0, vocab: int = 64,
                 block_size: int = 8, max_retries: int = 10,
                 verdict_timeout: float = 30.0):
        self.kv = kv
        self.trace = trace
        self.submit = submit
        self.seed = seed
        self.schedule = list(schedule)
        self.hooks = dict(hooks or {})
        self.time_scale = time_scale
        self.vocab = vocab
        self.block_size = block_size
        self.max_retries = max_retries
        self.verdict_timeout = verdict_timeout
        for f in self.schedule:
            if f.action not in CHAOS_ACTIONS:
                raise ValueError(f"unknown action {f.action!r}")
            if f.action not in MAILBOX_ACTIONS \
                    and f.action not in self.hooks:
                raise ValueError(f"scheduled {f.action!r} has no hook")

    # -- inputs ---------------------------------------------------------------

    def prompt_for(self, row: dict) -> list[int]:
        """Deterministic tokens for a trace row: the first block comes
        from the chain label (shared prefix = shared bytes), the rest
        from the rid."""
        n = max(1, int(row["prompt_tokens"]))
        head = random.Random(f"chain:{row['chain']}")
        tail = random.Random(f"rid:{row['rid']}")
        k = min(self.block_size, n)
        return [head.randrange(self.vocab) for _ in range(k)] + \
               [tail.randrange(self.vocab) for _ in range(n - k)]

    # -- fault execution ------------------------------------------------------

    def _fire(self, f: ChaosFault) -> None:
        get_recorder().instant(f"chaos:{f.action}",
                               args={"target": f.target,
                                     "at_s": f.at_s, "seed": self.seed})
        if f.action in MAILBOX_ACTIONS:
            tag, _, dur = f.target.partition(":")
            body = {"action": f.action}
            if dur:
                body["duration"] = float(dur)
            # the same mailbox FaultInjector posts to; the fleet view
            # prefixes it
            self.kv.set(k_cmd(tag), json.dumps(body))
        else:
            self.hooks[f.action](f.target)

    # -- the campaign ---------------------------------------------------------

    def run(self) -> CampaignResult:
        """Replay the trace and fire the schedule in one seeded
        interleaving, then wait out verdicts (retrying sheds — a shed is
        an answer, but campaigns measure loss, and a retried rid must
        still converge to its one bitwise verdict), then audit."""
        res = CampaignResult(seed=self.seed)
        rows = workload.replay_order(self.trace)
        events: list[tuple[float, int, object]] = \
            [(row["t_s"] * self.time_scale, 0, row) for row in rows] + \
            [(f.at_s * self.time_scale, 1, f) for f in self.schedule]
        # ties submit-first, then rid/action order: the interleaving is a
        # pure function of (trace, schedule), never of the host's clock
        events.sort(key=lambda e: (
            e[0], e[1],
            e[2].action if e[1] else e[2]["rid"]))  # type: ignore[union-attr]
        rids: dict[str, dict] = {}
        with get_recorder().span("campaign", args={"seed": self.seed}):
            t0 = time.monotonic()
            for at, kind, payload in events:
                lag = t0 + at - time.monotonic()
                if lag > 0:
                    time.sleep(lag)
                if kind == 1:
                    self._fire(payload)
                    res.fired.append(payload.as_dict())
                else:
                    rid = payload["rid"]
                    rids[rid] = payload
                    res.submitted += 1
                    if self.submit(rid, self.prompt_for(payload),
                                   int(payload["decode_tokens"])):
                        res.admitted += 1
                    else:
                        res.door_shed += 1
            self._await_verdicts(res, rids)
        return res

    def _await_verdicts(self, res: CampaignResult,
                        rids: dict[str, dict]) -> None:
        """Poll the store (not any gateway — gateways may be dead) until
        every rid holds a terminal verdict. SHED verdicts are cleared and
        re-enqueued up to ``max_retries`` times: the campaign's loss
        metric is about *requests*, and a request the fleet answered
        'not now' under a shed_storm must still converge to its bitwise
        answer once the storm passes."""
        retries: dict[str, int] = {}
        open_rids = set(rids)
        deadline = time.monotonic() + self.verdict_timeout
        while open_rids and time.monotonic() < deadline:
            for rid in sorted(open_rids):
                raw = self.kv.try_get(k_result(rid))
                if raw is None:
                    continue
                verdict = json.loads(raw)
                if verdict.get("verdict", "ok") != "SHED":
                    res.verdicts[rid] = {"verdict": "ok",
                                         "tokens": _token_digest(verdict)}
                    open_rids.discard(rid)
                    continue
                if retries.get(rid, 0) >= self.max_retries:
                    res.verdicts[rid] = {"verdict": "SHED", "tokens": ""}
                    open_rids.discard(rid)
                    continue
                retries[rid] = retries.get(rid, 0) + 1
                res.retried += 1
                # the ServeClient._retry delete-triple, then a fresh
                # shared-queue entry (the request body persists)
                self.kv.delete(k_result(rid))
                self.kv.delete(k_done(rid))
                self.kv.delete(k_pin(rid))
                enqueue(self.kv, rid)
            time.sleep(0.01)
        res.lost = sorted(open_rids)
        for rid in res.lost:
            res.failures.append(f"no terminal verdict for {rid} "
                                f"within {self.verdict_timeout}s")
        # exactly-one-verdict: the claim marker must exist wherever a
        # verdict does (the result write is gated on winning it)
        for rid in sorted(res.verdicts):
            if self.kv.try_get(k_done(rid)) is None:
                res.failures.append(
                    f"verdict without done-claim for {rid}")


def check_alert_claims(kv) -> list[str]:
    """The alert half of the audit: every durable alert record must have
    won (or lost) its claim through the raise_alert ordering — a record
    with NO claim key means some monitor died between the idempotent set
    and the add() gate and no successor completed it, i.e. an alert that
    was recorded but never accounted as fired-exactly-once. ``kv`` is
    the view the monitors wrote through (fleet view for per-fleet
    monitors, root for global)."""
    failures = []
    for key in kv.keys(K_ALERT_PREFIX):
        parts = key[len(K_ALERT_PREFIX):].split("/")
        if len(parts) != 3:
            failures.append(f"malformed alert record key {key!r}")
            continue
        rule, subject, window = parts
        if kv.try_get(k_alert_claim(rule, subject, int(window))) is None:
            failures.append(
                f"alert {rule}/{subject}/{window} recorded but unclaimed")
    return failures


def prefix_probe(client, prompt: list[int], rid: str,
                 max_new_tokens: int = 4) -> bool:
    """Ask a (surviving) gateway to route one request whose prefix is
    known-resident and report whether prefix routing actually engaged —
    the post-campaign check that failover didn't degrade the door to
    blind load balancing. Uses the gateway's own routed_prefix counter
    so the answer reflects the routing decision, not a guess from
    outside. The probe's rid becomes a real request; callers wait out
    its verdict like any other."""
    before = client.gateway_stats()["stats"].get("routed_prefix", 0)
    client.submit(rid, prompt, max_new_tokens)
    after = client.gateway_stats()["stats"].get("routed_prefix", 0)
    return after > before
