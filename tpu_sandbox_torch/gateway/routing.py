"""Routing + admission policy as pure functions: state in, decision out.
The port's copy of ``tpu_sandbox/gateway/routing.py``.

Nothing in this module touches a socket or the KV store — the gateway
assembles :class:`ReplicaView`\\ s from cached load reports and calls in;
tests drive the exact same code with hand-built views (the cluster-twin
discipline from ROADMAP item 6, applied from day one here).

Three decisions live here:

- **freshness** — a view is routable only while its load report is young.
  Age is LOCAL: the gateway stamps when it last saw a report's bytes
  change and bounds that local age (never wall-clock arithmetic against a
  remote stamp — cross-host skew makes that meaningless, and the KV TTL
  already drops dead replicas' reports entirely).
- **routing** — deepest resident-prefix match wins (the vLLM/SGLang
  production pattern): the request's chain hashes are matched against
  each replica's advertised digest, and the deepest hit minimizes cold
  prefill work. Ties, and requests with no resident prefix anywhere,
  fall back to least-loaded. Deterministic throughout (ties break on
  tag) so routing decisions are replayable from the report snapshot.
- **admission** — SLO feasibility: from a replica's queued work and a
  calibrated per-replica service rate, estimate when an admitted request
  would finish; if that already overruns the deadline, shed at the door
  with an explicit verdict instead of letting the request rot in a queue
  and be shed deep in the engine after burning its patience.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class ReplicaView:
    """One replica's routable state, assembled from its load report plus
    the gateway's local bookkeeping."""

    tag: str
    queue_depth: int = 0
    active: int = 0
    max_batch: int = 1
    free_block_frac: float = 1.0
    digest: frozenset = field(default_factory=frozenset)
    #: seconds since the gateway last saw this report's bytes CHANGE
    #: (local monotonic age, not remote wall arithmetic)
    age_s: float = 0.0
    #: requests this gateway routed here that the report predates
    pending_local: int = 0
    #: weight version the replica last acked (deploy rolling updates);
    #: 0 = boot weights / old-format report
    ver: int = 0

    @property
    def load(self) -> int:
        """Work in the replica's system as the gateway best knows it."""
        return self.queue_depth + self.active + self.pending_local


def parse_report(tag: str, report: dict, *, age_s: float,
                 pending_local: int = 0) -> ReplicaView:
    """Load-report JSON -> view. Missing fields degrade to a routable but
    unattractive default rather than erroring: an old-format replica is
    still a replica."""
    return ReplicaView(
        tag=tag,
        queue_depth=int(report.get("queue_depth", 0)),
        active=int(report.get("active", 0)),
        max_batch=int(report.get("max_batch", 1)),
        free_block_frac=float(report.get("free_block_frac", 1.0)),
        digest=frozenset(report.get("prefix_digest", ())),
        age_s=age_s,
        pending_local=pending_local,
        ver=int(report.get("ver", 0)),
    )


def fresh(views: list[ReplicaView], max_age_s: float) -> list[ReplicaView]:
    """Views whose reports are young enough to route on. A report past
    ``max_age_s`` describes a replica that existed, not one that does."""
    return [v for v in views if v.age_s <= max_age_s]


def match_depth(chain: list[str], view: ReplicaView) -> int:
    """How many leading full blocks of the request's prompt are resident
    on ``view``. A chain hash covers its whole prefix, so the DEEPEST
    digest member alone decides — intermediate misses (evicted mid-chain
    entries) don't shrink the answer the hash can still prove."""
    for depth in range(len(chain), 0, -1):
        if chain[depth - 1] in view.digest:
            return depth
    return 0


def least_loaded(views: list[ReplicaView]) -> ReplicaView:
    return min(views, key=lambda v: (v.load, v.tag))


def choose(chain: list[str], views: list[ReplicaView], *,
           exclude: frozenset = frozenset()) -> tuple[ReplicaView, int] | None:
    """Pick the routing target: deepest resident-prefix match, falling
    back to least-loaded when nothing is resident anywhere. Returns
    ``(view, match_depth)`` or None when no candidate remains (caller
    falls back to the shared queue). ``exclude`` removes tags — the
    hedge path must not duplicate onto the replica it is hedging."""
    views = [v for v in views if v.tag not in exclude]
    if not views:
        return None
    best = max(views, key=lambda v: (match_depth(chain, v), -v.load, v.tag))
    depth = match_depth(chain, best)
    if depth == 0:
        return least_loaded(views), 0
    return best, depth


def pick_by_share(shares: dict[int, float], draw: float) -> int | None:
    """Weighted draw over version-pinned traffic shares (the canary
    split): ``draw`` in [0, 1) lands in one version's normalized share
    band. Deterministic given the draw, ordered by version so the split
    is replayable. None when the shares carry no weight."""
    vers = sorted(v for v in shares if shares[v] > 0)
    total = sum(shares[v] for v in vers)
    if total <= 0:
        return None
    acc = 0.0
    for v in vers:
        acc += shares[v] / total
        if draw < acc:
            return v
    return vers[-1]


def pin_version(views: list[ReplicaView], ver: int) -> list[ReplicaView]:
    """Views currently running weight version ``ver`` — the canary split
    routes within this subset (caller falls back to all views when no
    fresh replica has acked ``ver`` yet)."""
    return [v for v in views if v.ver == int(ver)]


def estimate_completion_s(view: ReplicaView, service_rate_rps: float) -> float:
    """Seconds until a request admitted to ``view`` NOW would finish:
    everything already in its system plus this request, drained at the
    calibrated per-replica rate. Request-granularity M/D/1 — coarse on
    purpose; the calibration absorbs batching effects."""
    if service_rate_rps <= 0:
        raise ValueError(f"service rate must be > 0, got {service_rate_rps}")
    return (view.load + 1) / service_rate_rps


def feasible(view: ReplicaView, service_rate_rps: float,
             deadline_s: float | None) -> tuple[bool, float]:
    """(can this request make its deadline on this replica, estimate).
    No deadline means nothing to miss — always feasible."""
    est = estimate_completion_s(view, service_rate_rps)
    return (deadline_s is None or est <= deadline_s), est


def admit(view: ReplicaView, *, mode: str, service_rate_rps: float,
          deadline_s: float | None,
          occupancy_bound: int) -> tuple[bool, str, float]:
    """The door decision: (admit?, reason, estimate_s).

    - ``feasible``  — shed when the completion estimate overruns the
      deadline (reason ``infeasible``);
    - ``occupancy`` — the classic bound: shed when the replica's known
      queue already holds ``occupancy_bound`` requests (reason
      ``queue_full``), deadline ignored at the door;
    - ``none``      — always admit (the engine's own guardrails still
      apply downstream).
    """
    if mode == "feasible":
        ok, est = feasible(view, service_rate_rps, deadline_s)
        return ok, "" if ok else "infeasible", est
    est = estimate_completion_s(view, service_rate_rps)
    if mode == "occupancy":
        q = view.queue_depth + view.pending_local
        ok = q < occupancy_bound
        return ok, "" if ok else "queue_full", est
    if mode == "none":
        return True, "", est
    raise ValueError(f"unknown admission mode {mode!r}")
