"""The health plane: declarative rules over durable time series,
anomaly detectors for the known policy pathologies, and claim-once
alerts that control planes consume. The port's copy of
``tpu_sandbox/obs/health.py``, writing the same keys and bodies.

The recorder and the metrics make the system legible; this module
makes it *watched*. A
leader-elected :class:`HealthMonitor` (any number of candidates,
``LeaseElection`` on ``obs/health/leader``) evaluates two kinds of
checks on a fixed cadence:

* **rules** over the tsdb ring (:mod:`tpu_sandbox_torch.obs.tsdb`):
  :class:`BurnRateRule` is the classic multi-window SLO burn — the
  bad-event fraction must exceed ``burn × budget`` in BOTH a short and
  a long window before it fires (fast detection without flapping on a
  single bad bucket); :class:`ThresholdRule` compares the newest gauge
  value or histogram-digest field (p99 TTFT vs the deadline, goodput
  vs calibrated capacity, recorder drops > 0) against a bound.
* **detectors** over durable control-plane state, one per named
  pathology: :class:`OscillationDetector` counts autoscale
  direction-flips in the event log; :class:`StarvationDetector` watches
  the scheduler's vtime ledger for a tenant whose service stalls while
  it still has queued work; :class:`CascadeDetector` diffs per-job
  preemption counts for preempt→requeue→preempt cycles.

Alert protocol — exactly-once through monitor failover:

1. the alert RECORD ``obs/alert/rec/<rule>/<subject>/<window_idx>`` is
   written with a plain idempotent ``set``: every monitor evaluating
   the same window writes byte-identical content, so a monitor killed
   mid-evaluation cannot lose or corrupt the record;
2. the one-time notification (registry counter + recorder instant) is
   gated by ``kv.add`` on the matching CLAIM key — exactly one monitor
   observes 1, no matter how many evaluate the window (GL-R301: the
   claim key carries ``window_idx`` as its scope discriminator);
3. the ACTIVE key ``obs/health/active/<rule>/<subject>`` is a TTL'd
   condition flag, refreshed every evaluation while the rule still
   fires. Control planes read ONLY this key: a gateway excludes
   replicas with an active ``replica_burn``, the autoscaler backs off
   on active ``autoscale_oscillation``, the scheduler stamps a
   ``starved`` job event on active ``tenant_starvation``. Recovery is
   TTL expiry — no delete ordering to race on.

Everything takes an injectable ``clock`` so the seeded-pathology tests
drive whole detection windows in microseconds.
"""

from __future__ import annotations

import json
import time
from collections import deque
from dataclasses import dataclass

from tpu_sandbox_torch.runtime.election import LeaseElection

from . import tsdb
from .metrics import get_registry
from .record import get_recorder

K_ALERT_PREFIX = "obs/alert/rec/"
K_CLAIM_PREFIX = "obs/alert/claim/"
K_ACTIVE_PREFIX = "obs/health/active/"
LEADER_PREFIX = "obs/health/leader"


def k_alert_record(rule: str, subject: str, window_idx: int) -> str:
    return f"{K_ALERT_PREFIX}{rule}/{subject}/{window_idx}"


def k_alert_claim(rule: str, subject: str, window_idx: int) -> str:
    return f"{K_CLAIM_PREFIX}{rule}/{subject}/{window_idx}"


def k_active(rule: str, subject: str) -> str:
    return f"{K_ACTIVE_PREFIX}{rule}/{subject}"


def raise_alert(kv, rule: str, subject: str, window_idx: int,
                body: dict, *, active_ttl: float) -> bool:
    """The durable alert write: idempotent record, claim-once
    notification gate, TTL'd active flag — in that order, so a monitor
    killed between any two steps leaves a state a successor completes
    without double-firing. Returns True iff THIS caller won the claim
    (and therefore owns the one-time notification side effects)."""
    blob = json.dumps(body, sort_keys=True)
    kv.set(k_alert_record(rule, subject, window_idx), blob)
    claimed = kv.add(k_alert_claim(rule, subject, window_idx)) == 1
    kv.set_ttl(k_active(rule, subject), blob, active_ttl)
    return claimed


def alerts(kv, *, rule: str | None = None) -> list[dict]:
    """Every durable alert record (optionally one rule's), oldest
    first — the postmortem feed."""
    prefix = K_ALERT_PREFIX + (f"{rule}/" if rule else "")
    out = []
    for key in kv.keys(prefix):
        raw = kv.try_get(key)
        if raw is None:
            continue
        try:
            out.append(json.loads(raw))
        except ValueError:
            continue
    out.sort(key=lambda a: (a.get("wall", 0.0), a.get("rule", ""),
                            a.get("subject", "")))
    return out


def active_alerts(kv) -> list[dict]:
    """Currently-held alert conditions (TTL'd flags still live)."""
    out = []
    for key in kv.keys(K_ACTIVE_PREFIX):
        raw = kv.try_get(key)
        if raw is None:
            continue
        try:
            out.append(json.loads(raw))
        except ValueError:
            continue
    out.sort(key=lambda a: (a.get("rule", ""), a.get("subject", "")))
    return out


def active_subjects(kv, rule: str) -> set[str]:
    """The subjects currently flagged by ``rule`` — what control planes
    poll (replica tags for ``replica_burn``, tenants for
    ``tenant_starvation``, ``fleet`` for fleet-wide rules)."""
    prefix = f"{K_ACTIVE_PREFIX}{rule}/"
    return {key[len(prefix):] for key in kv.keys(prefix)}


# -- rules over the tsdb ------------------------------------------------------

@dataclass(frozen=True)
class BurnRateRule:
    """Multi-window SLO burn over two counter series: fire when
    ``bad / (bad + good)`` exceeds ``burn * budget`` in BOTH the short
    and the long trailing window. ``per_proc`` evaluates each producing
    process separately (per-replica burn); otherwise the subject is
    ``fleet``. Label variants of each series are summed."""

    name: str
    bad: str
    good: str
    budget: float
    burn: float = 4.0
    short_buckets: int = 3
    long_buckets: int = 12
    per_proc: bool = False

    def evaluate(self, kv, now_bucket: int) -> list[tuple[str, dict]]:
        bad_rows = tsdb.read_series(kv, self.bad)
        good_rows = tsdb.read_series(kv, self.good)
        if self.per_proc:
            procs = sorted({r["proc"] for r in bad_rows}
                           | {r["proc"] for r in good_rows})
            fired = []
            for p in procs:
                res = self._burn(bad_rows, good_rows, now_bucket, proc=p)
                if res is not None:
                    fired.append((p, res))
            return fired
        res = self._burn(bad_rows, good_rows, now_bucket, proc=None)
        return [] if res is None else [("fleet", res)]

    def _burn(self, bad_rows, good_rows, now_bucket, *, proc):
        def _sum(rows, buckets):
            since = now_bucket - buckets + 1
            return sum(float(r["v"]) for r in rows
                       if r["kind"] == "counter" and r["bucket"] >= since
                       and (proc is None or r["proc"] == proc))

        def _rate(buckets):
            b = _sum(bad_rows, buckets)
            tot = b + _sum(good_rows, buckets)
            return None if tot <= 0 else b / tot

        short, long = _rate(self.short_buckets), _rate(self.long_buckets)
        if short is None or long is None:
            return None  # no traffic in a window -> no verdict
        threshold = self.burn * self.budget
        if short >= threshold and long >= threshold:
            return {"short_rate": round(short, 6),
                    "long_rate": round(long, 6),
                    "budget": self.budget, "burn": self.burn}
        return None


@dataclass(frozen=True)
class ThresholdRule:
    """Compare the newest gauge value (or ``field`` of the newest
    histogram digest) against a bound. ``op`` is ``">"`` (alert when
    above, e.g. p99 TTFT vs deadline, recorder drops vs 0) or ``"<"``
    (alert when below, e.g. goodput vs calibrated capacity)."""

    name: str
    series: str
    threshold: float
    op: str = ">"
    field: str | None = None
    per_proc: bool = False

    def evaluate(self, kv, now_bucket: int) -> list[tuple[str, dict]]:
        del now_bucket  # thresholds read the latest point, not a window
        rows = tsdb.read_series(kv, self.series)
        subjects = sorted({r["proc"] for r in rows}) if self.per_proc \
            else [None]
        fired = []
        for p in subjects:
            v = tsdb.latest_value(rows, proc=p, field=self.field)
            if v is None:
                continue
            breached = v > self.threshold if self.op == ">" \
                else v < self.threshold
            if breached:
                fired.append((p if p is not None else "fleet",
                              {"value": v, "threshold": self.threshold,
                               "op": self.op, "series": self.series}))
        return fired


@dataclass(frozen=True)
class BaselineDeltaRule:
    """Compare one process's newest series value against the pooled
    baseline of a set of incumbent processes — the canary-analysis shape:
    the subject is the freshly-swapped replica, the baseline is everyone
    still on the incumbent version. Fires when the subject breaches
    ``baseline * threshold`` (``mode="ratio"``) or ``baseline +
    threshold`` (``mode="delta"``) in the direction of ``op``. Same
    no-verdict discipline as :class:`BurnRateRule`: a side with no data
    (no traffic yet, TTL'd rows expired) yields no verdict rather than a
    false one."""

    name: str
    series: str
    subject: str                # tsdb proc name of the canary
    baseline: tuple[str, ...]   # tsdb proc names of the incumbents
    threshold: float
    mode: str = "delta"         # "delta" | "ratio"
    op: str = ">"               # ">" fires above the bound, "<" below
    field: str | None = None    # histogram digest field (None -> gauge)

    def evaluate(self, kv, now_bucket: int) -> list[tuple[str, dict]]:
        del now_bucket  # like ThresholdRule: newest point, not a window
        rows = tsdb.read_series(kv, self.series)
        subject_v = tsdb.latest_value(rows, proc=self.subject,
                                      field=self.field)
        base_vals = [v for p in self.baseline
                     if (v := tsdb.latest_value(rows, proc=p,
                                                field=self.field))
                     is not None]
        if subject_v is None or not base_vals:
            return []  # no traffic on a side -> no verdict
        base = sum(base_vals) / len(base_vals)
        bound = base * self.threshold if self.mode == "ratio" \
            else base + self.threshold
        breached = subject_v > bound if self.op == ">" else subject_v < bound
        if not breached:
            return []
        return [(self.subject,
                 {"value": subject_v, "baseline": base, "bound": bound,
                  "mode": self.mode, "op": self.op, "series": self.series,
                  "n_baseline": len(base_vals)})]

    def has_data(self, kv) -> bool:
        """True when BOTH sides have live points — the controller counts
        a canary evaluation as evidence only when this holds."""
        rows = tsdb.read_series(kv, self.series)
        if tsdb.latest_value(rows, proc=self.subject,
                             field=self.field) is None:
            return False
        return any(tsdb.latest_value(rows, proc=p, field=self.field)
                   is not None for p in self.baseline)


def default_rules(*, ttft_deadline_s: float | None = None,
                  goodput_floor: float | None = None,
                  shed_budget: float = 0.05) -> list:
    """The stock SLO rule set: fleet and per-replica shed burn, recorder
    drop visibility, and (when bounds are given) p99-TTFT and goodput
    thresholds."""
    rules: list = [
        BurnRateRule(name="shed_burn", bad="engine.shed",
                     good="engine.done", budget=shed_budget),
        BurnRateRule(name="replica_burn", bad="engine.shed",
                     good="engine.done", budget=shed_budget,
                     per_proc=True),
        ThresholdRule(name="recorder_drops", series="obs.recorder.dropped",
                      threshold=0.0, op=">", per_proc=True),
    ]
    if ttft_deadline_s is not None:
        rules.append(ThresholdRule(name="ttft_slo", series="engine.ttft",
                                   threshold=ttft_deadline_s, op=">",
                                   field="p99"))
    if goodput_floor is not None:
        rules.append(ThresholdRule(name="goodput_floor",
                                   series="serve.goodput",
                                   threshold=goodput_floor, op="<"))
    return rules


# -- anomaly detectors over durable control-plane state -----------------------

class OscillationDetector:
    """Autoscale oscillation: the replica count sign-flipping inside a
    rolling window of evaluations. Reads the durable
    ``serve/autoscale/events/<n>`` log incrementally (the tail pointer
    is our cursor); ``min_replicas`` bootstrap events never count."""

    name = "autoscale_oscillation"

    def __init__(self, *, window_evals: int = 8, flip_threshold: int = 3):
        self.window_evals = int(window_evals)
        self.flip_threshold = int(flip_threshold)
        self._seen_tail = 0
        self._recent: deque[tuple[int, str]] = deque()
        self._evals = 0

    def observe(self, kv) -> list[tuple[str, dict]]:
        from tpu_sandbox_torch.serve.autoscale import K_EVENT_TAIL, k_event

        self._evals += 1
        tail = int(kv.try_get(K_EVENT_TAIL) or b"0")
        for n in range(self._seen_tail, tail):
            raw = kv.try_get(k_event(n))
            if raw is None:
                continue
            ev = json.loads(raw)
            if ev.get("action") in ("scale_up", "scale_down") \
                    and ev.get("reason") != "min_replicas":
                self._recent.append((self._evals, ev["action"]))
        self._seen_tail = tail
        horizon = self._evals - self.window_evals
        while self._recent and self._recent[0][0] <= horizon:
            self._recent.popleft()
        actions = [a for _, a in self._recent]
        flips = sum(1 for prev, cur in zip(actions, actions[1:])
                    if prev != cur)
        if flips >= self.flip_threshold:
            return [("fleet", {"flips": flips,
                               "window_evals": self.window_evals,
                               "actions": actions})]
        return []


class StarvationDetector:
    """Tenant starvation: a tenant with queued work whose normalized
    vtime stops advancing while another tenant's does. Under weighted
    fair sharing every ACTIVE tenant's vtime advances at the same rate
    (the charge is ``hosts·dt/share``), so a starved tenant shows up as
    a per-window vtime delta at least ``ratio``× below the busiest
    tenant's — for ``consecutive`` evaluations, to ride out admission
    churn."""

    name = "tenant_starvation"

    def __init__(self, *, ratio: float = 5.0, consecutive: int = 2):
        self.ratio = float(ratio)
        self.consecutive = int(consecutive)
        self._prev: dict[str, float] | None = None
        self._streak: dict[str, int] = {}

    def observe(self, kv) -> list[tuple[str, dict]]:
        from tpu_sandbox_torch.runtime.scheduler import (
            K_QUEUED_PREFIX,
            K_VTIME_PREFIX,
        )

        vt: dict[str, float] = {}
        for key in kv.keys(K_VTIME_PREFIX):
            raw = kv.try_get(key)
            if raw is None:
                continue
            try:
                vt[key[len(K_VTIME_PREFIX):]] = float(raw)
            except ValueError:
                continue
        queued: dict[str, int] = {}
        for key in kv.keys(K_QUEUED_PREFIX):
            raw = kv.try_get(key)
            if raw is None:
                continue
            try:
                queued[key[len(K_QUEUED_PREFIX):]] = int(raw)
            except ValueError:
                continue
        if self._prev is None:
            self._prev = vt
            return []
        deltas = {t: v - self._prev.get(t, v) for t, v in vt.items()}
        self._prev = vt
        peak = max(deltas.values(), default=0.0)
        fired = []
        for tenant in sorted(set(deltas) | set(queued)):
            d = deltas.get(tenant, 0.0)
            starving = (queued.get(tenant, 0) > 0 and peak > 0.0
                        and d * self.ratio <= peak)
            streak = self._streak.get(tenant, 0) + 1 if starving else 0
            self._streak[tenant] = streak
            if streak >= self.consecutive:
                fired.append((tenant, {"vtime_delta": d,
                                       "peak_delta": peak,
                                       "queued": queued.get(tenant, 0),
                                       "ratio": self.ratio}))
        return fired


class CascadeDetector:
    """Preemption cascade: one job accumulating preempt→requeue→preempt
    cycles faster than ``cycles`` per rolling window. The scheduler
    bumps a durable per-job counter at every ``preempt_sent``; we diff
    it per evaluation."""

    name = "preemption_cascade"

    def __init__(self, *, cycles: int = 3, window_evals: int = 8):
        self.cycles = int(cycles)
        self.window_evals = int(window_evals)
        self._prev: dict[str, int] = {}
        self._recent: dict[str, deque] = {}
        self._evals = 0

    def observe(self, kv) -> list[tuple[str, dict]]:
        from tpu_sandbox_torch.runtime.scheduler import K_PREEMPTS_PREFIX

        self._evals += 1
        fired = []
        horizon = self._evals - self.window_evals
        counts: dict[str, int] = {}
        for key in kv.keys(K_PREEMPTS_PREFIX):
            raw = kv.try_get(key)
            if raw is None:
                continue
            try:
                counts[key[len(K_PREEMPTS_PREFIX):]] = int(raw)
            except ValueError:
                continue
        for job_id, c in counts.items():
            delta = c - self._prev.get(job_id, 0)
            self._prev[job_id] = c
            hist = self._recent.setdefault(job_id, deque())
            if delta > 0:
                hist.append((self._evals, delta))
        for job_id, hist in self._recent.items():
            while hist and hist[0][0] <= horizon:
                hist.popleft()
            in_window = sum(d for _, d in hist)
            if in_window >= self.cycles:
                fired.append((job_id, {"preemptions": in_window,
                                       "window_evals": self.window_evals}))
        return fired


def default_detectors() -> list:
    return [OscillationDetector(), StarvationDetector(), CascadeDetector()]


# -- the monitor --------------------------------------------------------------

class HealthMonitor:
    """Leader-elected evaluation loop. Run any number of candidates;
    :meth:`step` is a no-op (returns None) on non-leaders. On the
    leader it evaluates every rule and detector once and returns the
    list of alert bodies THIS monitor claimed (usually empty).

    Detector state is monitor-local; after a failover the successor
    rebuilds it within one window, which is why the acceptance bound is
    detection ≤ 2 evaluation windows."""

    def __init__(self, kv, member_id: str = "health-0", *,
                 window_s: float = 1.0, bucket_s: float = 1.0,
                 rules=None, detectors=None, election_ttl: float = 3.0,
                 active_windows: float = 3.0, clock=time.time):
        self.kv = kv
        self.window_s = float(window_s)
        self.bucket_s = float(bucket_s)
        self.rules = list(default_rules() if rules is None else rules)
        self.detectors = list(default_detectors() if detectors is None
                              else detectors)
        self.election = LeaseElection(kv, member_id, ttl=election_ttl,
                                      prefix=LEADER_PREFIX)
        self.active_ttl = float(active_windows) * self.window_s
        self.clock = clock
        self.evals = 0

    def step(self, *, candidate: bool = True) -> list[dict] | None:
        if not self.election.step(candidate=candidate):
            return None
        self.evals += 1
        now = float(self.clock())
        window_idx = int(now // self.window_s)
        now_bucket = int(now // self.bucket_s)
        claimed = []
        for rule in self.rules:
            for subject, payload in rule.evaluate(self.kv, now_bucket):
                body = self._fire(rule.name, subject, window_idx,
                                  payload, now)
                if body is not None:
                    claimed.append(body)
        for det in self.detectors:
            for subject, payload in det.observe(self.kv):
                body = self._fire(det.name, subject, window_idx,
                                  payload, now)
                if body is not None:
                    claimed.append(body)
        return claimed

    def resign(self) -> None:
        self.election.resign()

    def _fire(self, rule: str, subject: str, window_idx: int,
              payload: dict, now: float) -> dict | None:
        """Onset vs refresh: a condition already active just has its
        TTL flag renewed — new records (and notifications) happen only
        on a rising edge."""
        existing = self.kv.try_get(k_active(rule, subject))
        if existing is not None:
            self.kv.set_ttl(k_active(rule, subject), existing,
                            self.active_ttl)
            return None
        body = dict(payload)
        body.update(rule=rule, subject=subject,
                    window_idx=int(window_idx), wall=now)
        if raise_alert(self.kv, rule, subject, window_idx, body,
                       active_ttl=self.active_ttl):
            get_registry().counter("health.alerts",
                                   labels={"rule": rule}).inc()
            get_recorder().instant("health:alert",
                                   args={"rule": rule, "subject": subject})
            return body
        return None
