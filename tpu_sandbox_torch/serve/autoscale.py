"""Load-signal autoscaler: replica load reports in, gang resizes out.
The port's copy of ``tpu_sandbox/serve/autoscale.py``: the same keys,
events and job specs.

The control loop closes the autoscaling gap: the elastic
runtime restarts replicas that die, but nothing *added or removed* them
from load signals. This does, by composing three existing pieces:

- **signal** — replicas publish TTL'd load reports (``serve/load/<tag>``,
  see replica.py): queue depth, block-pool pressure, decode-step lag.
  The autoscaler averages queue depth across live reports; expired
  reports (dead or stalled replicas) drop out via TTL, shrinking the
  denominator instead of poisoning the average.
- **actuator** — each replica is a one-host :class:`JobSpec` submitted to
  the ``ClusterScheduler`` (``<prefix>-rep-<k>``). Scaling up submits a
  new job at serve priority, which preempts lower-priority training when
  the pool is full (the serve/train colocation story); scaling down
  cancels the newest replica job, whose SIGTERM drain requeues every
  in-flight request — zero tokens lost. Existing replicas are never
  disturbed by a scale event.
- **leadership** — any number of autoscaler candidates may run; a
  ``LeaseElection`` on ``serve/autoscale/leader`` picks one actor, and a
  successor recovers the current replica set from the durable job queue
  (no autoscaler-local state matters).

Hysteresis: a scale decision needs the signal to point the same way for
``hysteresis_ticks`` consecutive leader ticks, and ``cooldown_s`` must
have passed since the last action — load spikes shorter than that ride
on shedding and the bounded queue instead of churning the pool.

Every action appends a ``serve/autoscale/events/<n>`` record; together
with the scheduler's ``job_events`` stamps the full scale timeline is
reconstructable from the store alone.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass

from tpu_sandbox_torch.obs import get_registry
from tpu_sandbox_torch.obs.health import active_subjects
from tpu_sandbox_torch.runtime.election import LeaseElection
from tpu_sandbox_torch.runtime.scheduler import (
    TERMINAL_STATES,
    JobSpec,
    cancel_job,
    list_jobs,
    submit_job,
)
from tpu_sandbox_torch.serve.replica import read_load_reports

K_EVENT_TAIL = "serve/autoscale/tail"
K_JOB_IDX = "serve/autoscale/idx"


def k_event(n: int) -> str:
    return f"serve/autoscale/events/{n}"


def autoscale_events(kv) -> list[dict]:
    """Every autoscale decision, in order — the scale timeline."""
    out = []
    for n in range(int(kv.try_get(K_EVENT_TAIL) or b"0")):
        raw = kv.try_get(k_event(n))
        if raw is not None:
            out.append(json.loads(raw))
    return out


@dataclass(frozen=True)
class AutoscaleConfig:
    min_replicas: int = 1
    max_replicas: int = 4
    # mean engine queue depth per live replica that triggers a resize
    scale_up_depth: float = 4.0
    scale_down_depth: float = 0.5
    hysteresis_ticks: int = 3
    cooldown_s: float = 2.0
    # the replica gang's tenancy in the shared pool: high priority so a
    # load spike preempts low-priority training, returned on scale-down
    priority: int = 10
    tenant: str = "serve"
    share: float = 1.0
    job_prefix: str = "serve"
    admission_timeout: float = 120.0
    # scale-up pre-warming: when set, every replica spawns with
    # JAX_COMPILATION_CACHE_DIR pointed here (the JAX package's key, so
    # either package's autoscaler can drive either replica). A JAX
    # replica's XLA compiles persist there and later scale-ups
    # deserialize them; the port's replica runs eager PyTorch, compiles
    # nothing a cache would keep, and ignores the key. Each scale_up
    # event records whether the new replica will find the cache warm
    # (entries present) or cold.
    compile_cache_dir: str = ""


class ReplicaAutoscaler:
    """Leader-elected control loop sizing the serve replica gang.

    ``replica_argv`` is the JobSpec agent command template for one replica
    host (same ``{agent_id}``/``{kv_port}``/... placeholders as any other
    cluster job). Call :meth:`tick` on a cadence; it is a no-op on
    non-leaders and between hysteresis windows.
    """

    def __init__(self, kv, replica_argv: list[str], *,
                 cfg: AutoscaleConfig = AutoscaleConfig(),
                 member_id: str = "autoscaler-0",
                 election_ttl: float = 3.0):
        self.kv = kv
        self.replica_argv = list(replica_argv)
        self.cfg = cfg
        self.election = LeaseElection(kv, member_id, ttl=election_ttl,
                                      prefix="serve/autoscale/leader")
        self._up_streak = 0
        self._down_streak = 0
        self._last_action = 0.0

    # -- observability -------------------------------------------------------

    def replica_jobs(self) -> list[dict]:
        """Live (queued or running) replica jobs, oldest first — recovered
        from the durable job queue, so a fresh leader sees the same gang."""
        prefix = f"{self.cfg.job_prefix}-rep-"
        return [j for j in list_jobs(self.kv)
                if j["job_id"].startswith(prefix)
                and j["state"] not in TERMINAL_STATES]

    def load_signal(self) -> tuple[float, int]:
        """(mean queue depth over live reports, number of live reports)."""
        reports = read_load_reports(self.kv)
        if not reports:
            return 0.0, 0
        depths = [r.get("queue_depth", 0) for r in reports.values()]
        return sum(depths) / len(depths), len(reports)

    # -- control loop --------------------------------------------------------

    def tick(self) -> dict | None:
        """One control iteration; returns the event dict when an action was
        taken, else None."""
        if not self.election.step(candidate=True):
            self._up_streak = self._down_streak = 0
            return None
        jobs = self.replica_jobs()
        n = len(jobs)
        if n < self.cfg.min_replicas:
            # bootstrap / repair: the floor needs no hysteresis
            return self._scale_up(n, depth=0.0, reason="min_replicas")
        if active_subjects(self.kv, "autoscale_oscillation"):
            # the health plane caught us flapping: freeze load-driven
            # scaling (floor repair above still runs) until the alert's
            # TTL expires — the loop backs off its own oscillation
            self._up_streak = self._down_streak = 0
            get_registry().counter("autoscale.backoff").inc()
            return None
        depth, n_reports = self.load_signal()
        if depth >= self.cfg.scale_up_depth:
            self._up_streak += 1
            self._down_streak = 0
        elif depth <= self.cfg.scale_down_depth:
            self._down_streak += 1
            self._up_streak = 0
        else:
            self._up_streak = self._down_streak = 0
        if time.monotonic() - self._last_action < self.cfg.cooldown_s:
            return None
        if self._up_streak >= self.cfg.hysteresis_ticks \
                and n < self.cfg.max_replicas:
            return self._scale_up(n, depth=depth, reason="queue_depth")
        if self._down_streak >= self.cfg.hysteresis_ticks \
                and n > self.cfg.min_replicas:
            return self._scale_down(jobs, depth=depth)
        return None

    def compile_cache_state(self) -> str:
        """'warm' when the shared compile-cache dir has entries a new
        replica can deserialize, 'cold' when it is empty/absent,
        'disabled' when no cache dir is configured."""
        d = self.cfg.compile_cache_dir
        if not d:
            return "disabled"
        try:
            with os.scandir(d) as it:
                return "warm" if any(True for _ in it) else "cold"
        except OSError:
            return "cold"

    def _scale_up(self, n: int, *, depth: float, reason: str) -> dict:
        idx = self.kv.add(K_JOB_IDX)  # never reuse an id, even post-sweep
        job_id = f"{self.cfg.job_prefix}-rep-{idx}"
        env = {}
        cache_state = self.compile_cache_state()
        if self.cfg.compile_cache_dir:
            os.makedirs(self.cfg.compile_cache_dir, exist_ok=True)
            env["JAX_COMPILATION_CACHE_DIR"] = self.cfg.compile_cache_dir
        submit_job(self.kv, JobSpec(
            job_id=job_id, hosts=1, world_size=1,
            agent_argv=self.replica_argv, priority=self.cfg.priority,
            admission_timeout=self.cfg.admission_timeout,
            tenant=self.cfg.tenant, share=self.cfg.share, env=env))
        return self._record("scale_up", job_id, n, n + 1, depth, reason,
                            compile_cache=cache_state)

    def _scale_down(self, jobs: list[dict], *, depth: float) -> dict:
        victim = jobs[-1]["job_id"]  # newest replica drains and requeues
        cancel_job(self.kv, victim)
        return self._record("scale_down", victim, len(jobs), len(jobs) - 1,
                            depth, "queue_depth")

    def _record(self, action: str, job_id: str, n_before: int, n_after: int,
                depth: float, reason: str, **extra) -> dict:
        self._up_streak = self._down_streak = 0
        self._last_action = time.monotonic()
        event = {"action": action, "job_id": job_id, "n_before": n_before,
                 "n_after": n_after, "queue_depth": round(depth, 3),
                 "reason": reason, "wall": time.time(), **extra}
        n = self.kv.add(K_EVENT_TAIL) - 1
        self.kv.set(k_event(n), json.dumps(event))
        get_registry().counter("autoscale.events",
                               labels={"action": action}).inc()
        get_registry().gauge("autoscale.replicas").set(n_after)
        return event
