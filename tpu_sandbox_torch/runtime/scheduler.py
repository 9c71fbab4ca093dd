"""Multi-tenant cluster scheduler: many jobs, one host pool, one KV store.
The port's copy of ``tpu_sandbox/runtime/scheduler.py``: the same durable
queue schema, so either package's scheduler serves the other's jobs.

:class:`~tpu_sandbox_torch.runtime.host_agent.AgentLauncher` runs exactly one
job on a dedicated set of hosts. This module is its promotion to a small
cluster scheduler: a durable job queue in the KV store,
gang scheduling of heterogeneous jobs onto a shared pool, and priority
preemption — a high-priority job arriving on a full pool SIGTERMs a
low-priority job's agents, which checkpoint through the existing
preemption vote and resume bitwise when hosts free up.

Division of labor — the scheduler deliberately knows nothing about
generations, budgets, or elections. All of that stays inside each job's
:class:`~tpu_sandbox_torch.runtime.host_agent.HostAgent` gang, running in its
own KV namespace (``job/<id>/...``, see ``kvstore.for_job``). The
scheduler only:

- keeps the durable queue under the cluster-level ``sched/*`` prefix,
- spawns/respawns a job's agent processes as a gang (never partial),
- watches each job's namespaced ``job/done`` verdict key,
- SIGTERMs a victim gang to preempt it (indistinguishable, to the job,
  from the machines being reclaimed — the path the elastic runtime
  already proves bitwise), and re-queues it for an uncharged resume.

The robustness contract this buys: one job's host death, wedged rank, or
partition never touches a neighbor job, because nothing a job does —
election churn, budget charging, fault claims, health sweeps — can reach
outside its namespace. Scheduler death doesn't kill jobs either: agents
are spawned *without* pdeathsig, so running gangs finish (or keep
recovering) on their own, and a restarted scheduler adopts them from the
store.

KV schema (cluster level, outside every job namespace)::

    sched/seq                     admission-order counter (atomic)
    sched/jobs/<id>/spec          JobSpec JSON (durable across schedulers)
    sched/jobs/<id>/seq           this job's submission sequence number
    sched/jobs/<id>/state         queued|running|preempting|done|failed|
                                  preempted|cancelled|timeout
    sched/jobs/<id>/cancel        cancellation request flag
    sched/jobs/<id>/verdict       copy of the job's final job/done record
    sched/jobs/<id>/event/<name>  wall-clock stamps (submitted, admitted,
                                  readmitted, preempt_sent, preempted, ...)
                                  — receipts for queue and preemption
                                  seconds; never compared against a local
                                  clock

plus, per job, everything ``host_agent.py`` documents — under
``job/<id>/`` instead of bare.
"""

from __future__ import annotations

import json
import os
import signal
import subprocess
import time
from dataclasses import asdict, dataclass, field
from typing import Mapping

from tpu_sandbox_torch.obs import get_recorder, get_registry
from tpu_sandbox_torch.runtime.host_agent import (
    K_JOB_DONE,
    _agent_hb_key,
    assign_ranks,
)
from tpu_sandbox_torch.runtime.kvstore import (
    ENV_JOB_ID,
    KVClient,
    KVServer,
    for_job,
    job_namespace,
)
from tpu_sandbox_torch.runtime.watchdog import Watchdog

K_SEQ = "sched/seq"
JOBS_PREFIX = "sched/jobs/"
K_VTIME_PREFIX = "sched/vtime/"
#: TTL'd per-tenant queued-job counts — the health plane's evidence that
#: a starved tenant actually has work waiting (sched/queued/<tenant>)
K_QUEUED_PREFIX = "sched/queued/"
#: durable per-job preemption counters (sched/preempts/<job_id>) — the
#: cascade detector diffs these per evaluation window
K_PREEMPTS_PREFIX = "sched/preempts/"

#: states a job can be observed in; terminal ones never change again
QUEUED, RUNNING, PREEMPTING = "queued", "running", "preempting"
TERMINAL_STATES = ("done", "failed", "preempted", "cancelled", "timeout")


def k_spec(job_id: str) -> str:
    return f"sched/jobs/{job_id}/spec"


def k_state(job_id: str) -> str:
    return f"sched/jobs/{job_id}/state"


def k_seq(job_id: str) -> str:
    return f"sched/jobs/{job_id}/seq"


def k_cancel(job_id: str) -> str:
    return f"sched/jobs/{job_id}/cancel"


def k_verdict(job_id: str) -> str:
    return f"sched/jobs/{job_id}/verdict"


def k_event(job_id: str, name: str) -> str:
    return f"sched/jobs/{job_id}/event/{name}"


@dataclass
class JobSpec:
    """One queue entry, durable as JSON in the store.

    ``agent_argv`` is a command *template* for one host agent process;
    each element is ``str.format``-ed with ``agent_id``, ``kv_port``,
    ``job_id``, ``num_agents`` and ``world_size`` (e.g.
    ``["python", "train.py", "--agent-id", "{agent_id}", ...]``). The
    template, not a callable, is what makes the queue durable: a fresh
    scheduler process can respawn any job's agents from the store alone.

    ``hosts`` is the gang size — the job runs on exactly this many pool
    slots or not at all. ``world_size`` need not divide by ``hosts``
    (the leader publishes a balanced rank-assignment table). Higher
    ``priority`` wins; equal priority is FIFO by submission order. A job
    that cannot be admitted within ``admission_timeout`` seconds is
    timed out and its namespace swept clean.
    """

    job_id: str
    hosts: int
    world_size: int
    agent_argv: list[str]
    priority: int = 0
    admission_timeout: float = 120.0
    env: dict[str, str] = field(default_factory=dict)
    # weighted fair share: jobs naming a tenant are admitted (within a
    # priority band) in order of the tenant's accumulated normalized
    # service — host-seconds / share — so one tenant cannot starve the
    # pool. Untenanted jobs keep plain FIFO-by-seq semantics.
    tenant: str = ""
    share: float = 1.0
    # MPMD co-gangs: jobs naming the same cogroup are admitted
    # all-or-nothing as one "gang of gangs" — a cross-mesh pipeline's
    # per-stage HostAgent groups are useless admitted piecemeal (stage 1
    # without stage 0 just blocks on the transport until it times out).
    # Preemption makes room for the whole group's host total, and
    # backfill never slips one member of the head's own group in early.
    cogroup: str = ""

    def __post_init__(self):
        if not job_namespace(self.job_id):
            raise ValueError(
                f"cluster jobs need a real job id (got {self.job_id!r}); "
                "the bare default namespace is reserved for single-job runs"
            )
        if self.hosts < 1:
            raise ValueError(f"hosts must be >= 1, got {self.hosts}")
        if self.share <= 0:
            raise ValueError(f"share must be > 0, got {self.share}")
        assign_ranks(self.world_size, self.hosts)  # validates the gang shape
        self.format_argv(agent_id=0, kv_port=0)  # fail bad templates early

    def format_argv(self, *, agent_id: int, kv_port: int) -> list[str]:
        fields = {
            "agent_id": agent_id, "kv_port": kv_port,
            "job_id": self.job_id, "num_agents": self.hosts,
            "world_size": self.world_size,
        }
        try:
            return [a.format(**fields) for a in self.agent_argv]
        except (KeyError, IndexError, ValueError) as e:
            raise ValueError(
                f"bad agent_argv template {self.agent_argv!r}: {e} "
                f"(known placeholders: {sorted(fields)})"
            ) from e

    def to_json(self) -> str:
        return json.dumps(asdict(self))

    @classmethod
    def from_json(cls, text: str) -> "JobSpec":
        return cls(**json.loads(text))


# ---------------------------------------------------------------------------
# queue API — usable from any client against the scheduler's store
# ---------------------------------------------------------------------------


def submit_job(kv: KVClient, spec: JobSpec) -> int:
    """Enqueue ``spec``; returns its admission sequence number. The queue
    is durable: everything a (possibly future) scheduler needs to run the
    job lives in the store after this returns."""
    if kv.try_get(k_spec(spec.job_id)) is not None:
        raise ValueError(f"job id {spec.job_id!r} already exists")
    seq = kv.add(K_SEQ, 1)
    kv.set(k_spec(spec.job_id), spec.to_json())
    kv.set(k_seq(spec.job_id), str(seq))
    kv.set(k_state(spec.job_id), QUEUED)
    kv.set(k_event(spec.job_id, "submitted"), f"{time.time():.6f}")
    get_recorder().instant("job:submitted", args={"job": spec.job_id})
    return seq


def list_jobs(kv: KVClient) -> list[dict]:
    """Every job the store knows, queued order first. Each entry:
    ``{job_id, state, seq, priority, hosts, world_size, tenant, share}``."""
    out = []
    for key in kv.keys(JOBS_PREFIX):
        if not key.endswith("/spec"):
            continue
        raw = kv.try_get(key)
        if raw is None:
            continue
        spec = JobSpec.from_json(raw.decode())
        state = kv.try_get(k_state(spec.job_id))
        seq = kv.try_get(k_seq(spec.job_id))
        out.append({
            "job_id": spec.job_id,
            "state": (state or b"?").decode(),
            "seq": int(seq or 0),
            "priority": spec.priority,
            "hosts": spec.hosts,
            "world_size": spec.world_size,
            "tenant": spec.tenant,
            "share": spec.share,
            "cogroup": spec.cogroup,
        })
    return sorted(out, key=lambda j: j["seq"])


def cancel_job(kv: KVClient, job_id: str) -> None:
    """Request cancellation; the scheduler sweeps a queued job immediately
    and SIGTERMs a running job's gang (it checkpoints and exits like a
    preemption, but is not re-queued)."""
    kv.set(k_cancel(job_id), b"1")


def job_events(kv: KVClient, job_id: str) -> dict[str, float]:
    """The job's wall-clock event stamps (receipts). Differences
    between two stamps are meaningful — they come from the scheduler's
    clock — but never mix them with the caller's own clock."""
    out = {}
    prefix = k_event(job_id, "")
    for key in kv.keys(prefix):
        raw = kv.try_get(key)
        if raw is not None:
            out[key[len(prefix):]] = float(raw)
    return out


# ---------------------------------------------------------------------------
# the scheduler
# ---------------------------------------------------------------------------


class _RunningJob:
    """Scheduler-side handle for an admitted gang. ``procs`` is empty for
    an *adopted* job (admitted by a dead predecessor scheduler): those
    can't be respawned, only monitored via verdict + agent heartbeats."""

    def __init__(self, spec: JobSpec, seq: int, procs, *, adopted=False):
        self.spec = spec
        self.seq = seq
        self.procs: dict[int, subprocess.Popen] = procs
        self.adopted = adopted
        self.preempting = False
        self.cancelling = False
        self.respawns = 0
        self.watchdog: Watchdog | None = None
        self.kill_at = 0.0  # SIGKILL escalation deadline while preempting


class ClusterScheduler:
    """Serve the durable queue on a pool of ``pool_size`` host slots.

    Scheduling policy, smallest thing that honors the contract:

    - **Gang, all-or-nothing.** A job launches with its full ``hosts``
      gang or not at all; there is no partial admission, ever.
    - **Strict priority, FIFO within a priority, conservative backfill.**
      The head of the queue is considered first each tick. When the head
      is blocked with no room on the way (nothing preemptable, nothing
      winding down), *strictly lower-priority* jobs that fit the free
      slots may start behind it — strictly lower, so the head keeps
      preemption rights over every backfilled gang and can only be
      delayed by one preemption drain, never indefinitely. Once the head
      has burned ``backfill_guard_frac`` of its admission window,
      backfill stops: the remaining window is reserved for making room,
      not for new tenants to churn through.
    - **Preemption frees exactly what's needed.** When the head job
      outranks running work, the lowest-priority victims (newest first)
      are SIGTERMed until enough slots will free. Victims checkpoint via
      the normal preemption vote, exit with a ``preempted`` verdict, are
      NOT charged a restart, and re-enter the queue at their original
      sequence number to resume bitwise when slots return.
    - **Admission deadline.** A job still queued ``admission_timeout``
      seconds after the scheduler first saw it (deadline measured on the
      scheduler's own monotonic clock; it restarts with the scheduler)
      is timed out and its entire KV namespace swept — no leaked claims.

    ``until_idle`` serving returns when no job is queued or running; use
    ``stop()`` from another thread (or a signal) to stop a long server.
    """

    def __init__(
        self,
        pool_size: int,
        *,
        kv_server: KVServer | None = None,
        kv_port: int | None = None,
        poll: float = 0.05,
        drain_timeout: float = 60.0,
        respawn_limit: int = 16,
        preempt_kill_timeout: float = 120.0,
        adopt_timeout: float = 15.0,
        backfill_guard_frac: float = 0.5,
        extra_env: Mapping[str, str] | None = None,
        verbose: bool = True,
    ):
        if pool_size < 1:
            raise ValueError(f"pool_size must be >= 1, got {pool_size}")
        if kv_server is not None and kv_port is not None:
            raise ValueError("pass kv_server OR kv_port, not both")
        self.pool_size = pool_size
        self._kv_server = kv_server
        # kv_port = connect to a store hosted elsewhere: the deployment
        # shape where the store (and the jobs) outlive this scheduler
        # process, so a successor can adopt
        self._connect_port = kv_port
        self._owns_server = kv_server is None and kv_port is None
        self.poll = poll
        self.drain_timeout = drain_timeout
        self.respawn_limit = respawn_limit
        self.preempt_kill_timeout = preempt_kill_timeout
        self.adopt_timeout = adopt_timeout
        if not 0.0 <= backfill_guard_frac <= 1.0:
            raise ValueError(
                f"backfill_guard_frac must be in [0, 1], got "
                f"{backfill_guard_frac}")
        self.backfill_guard_frac = backfill_guard_frac
        self.extra_env = dict(extra_env or {})
        self.verbose = verbose
        self.kv: KVClient | None = None
        self._server: KVServer | None = None
        self._running: dict[str, _RunningJob] = {}
        self._queue_deadline: dict[str, float] = {}
        # tenant -> accumulated normalized service (host-seconds / share),
        # mirrored to the store under sched/vtime/<tenant> on every charge
        # tick: a successor scheduler loads the ledger in start() and
        # keeps converging to the same weighted shares instead of
        # forgetting every tenant's accumulated debt at each failover
        self._tenant_vtime: dict[str, float] = {}
        self._last_charge = time.monotonic()
        # jobs already stamped with a `starved` event — the health plane
        # may hold the alert active for many ticks; the event fires once
        self._starved_stamped: set[str] = set()
        self._stop = False

    # -- lifecycle ----------------------------------------------------------

    def _log(self, msg: str) -> None:
        if self.verbose:
            print(f"[scheduler] {msg}", flush=True)

    def start(self) -> "ClusterScheduler":
        if self.kv is None:
            if self._connect_port is not None:
                self.kv = KVClient(port=self._connect_port)
            else:
                self._server = self._kv_server or KVServer()
                self.kv = KVClient(port=self._server.port)
            self._load_vtime()
            self._adopt_orphans()
        return self

    def _load_vtime(self) -> None:
        """Restore the durable fair-share ledger a predecessor left in
        the store (sched/vtime/<tenant>)."""
        for key in self.kv.keys(K_VTIME_PREFIX):
            raw = self.kv.try_get(key)
            if raw is None:
                continue
            try:
                self._tenant_vtime[key[len(K_VTIME_PREFIX):]] = float(raw)
            except ValueError:
                continue

    def close(self) -> None:
        for job in self._running.values():
            for p in job.procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
        self._running.clear()
        if self.kv is not None:
            self.kv.close()
            self.kv = None
        if self._owns_server and self._server is not None:
            self._server.stop()
        self._server = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()

    @property
    def kv_port(self) -> int:
        if self._server is not None:
            return self._server.port
        return self._connect_port

    def stop(self) -> None:
        self._stop = True

    def submit(self, spec: JobSpec) -> int:
        return submit_job(self.start().kv, spec)

    # -- adoption -----------------------------------------------------------

    def _adopt_orphans(self) -> None:
        """A predecessor scheduler died: jobs it admitted are (possibly)
        still running — their agents survive scheduler death by design.
        Re-attach to every non-terminal admitted job so its verdict is
        reaped and its slots are accounted; a gang whose agents are gone
        (no heartbeats) gets failed and swept instead of leaking slots
        forever."""
        for entry in list_jobs(self.kv):
            if entry["state"] not in (RUNNING, PREEMPTING):
                continue
            raw = self.kv.try_get(k_spec(entry["job_id"]))
            if raw is None:
                continue
            spec = JobSpec.from_json(raw.decode())
            job = _RunningJob(spec, entry["seq"], {}, adopted=True)
            job.preempting = entry["state"] == PREEMPTING
            job.watchdog = Watchdog(
                for_job(self.kv, spec.job_id), spec.hosts,
                timeout=self.adopt_timeout, grace=self.adopt_timeout,
                key_fn=_agent_hb_key,
            )
            self._running[spec.job_id] = job
            self._log(f"adopted running job {spec.job_id!r} "
                      f"({spec.hosts} host(s), seq {job.seq})")

    # -- serving ------------------------------------------------------------

    def serve(self, *, until_idle: bool = True,
              timeout: float | None = None) -> dict[str, str]:
        """Run the scheduling loop; returns ``{job_id: final state}`` for
        every job observed. With ``until_idle`` (default) it returns once
        nothing is queued or running; otherwise it serves until
        :meth:`stop` or ``timeout``."""
        self.start()
        deadline = None if timeout is None else time.monotonic() + timeout
        while not self._stop:
            queued = self._tick()
            if until_idle and not queued and not self._running:
                break
            if deadline is not None and time.monotonic() >= deadline:
                break
            time.sleep(self.poll)
        return {j["job_id"]: j["state"] for j in list_jobs(self.kv)}

    def _tick(self) -> list[dict]:
        """One scheduling pass; returns the currently queued entries."""
        self._poll_cancellations()
        self._poll_running()
        self._charge_tenants()
        queued = [j for j in list_jobs(self.kv) if j["state"] == QUEUED]
        self._publish_queue_state(queued)
        self._admit_or_preempt(queued)
        return [j for j in list_jobs(self.kv) if j["state"] == QUEUED]

    def _publish_queue_state(self, queued: list[dict]) -> None:
        """Queue-shape metrics into the registry plus the durable
        per-tenant queued counts the starvation detector cross-checks;
        also surfaces an active starvation alert as a one-shot
        ``starved`` job event on every affected queued job."""
        from tpu_sandbox_torch.obs.health import active_subjects

        reg = get_registry()
        reg.gauge("sched.queue.depth").set(len(queued))
        reg.gauge("sched.running").set(len(self._running))
        counts: dict[str, int] = {}
        for entry in queued:
            tenant = entry.get("tenant")
            if tenant:
                counts[tenant] = counts.get(tenant, 0) + 1
        ttl = max(1.0, 10 * self.poll)
        for tenant, n in counts.items():
            self.kv.set_ttl(f"{K_QUEUED_PREFIX}{tenant}", str(n), ttl)
            reg.gauge("sched.tenant.queued",
                      labels={"tenant": tenant}).set(n)
        starved = active_subjects(self.kv, "tenant_starvation")
        if not starved:
            return
        for entry in queued:
            job_id = entry["job_id"]
            if entry.get("tenant") in starved \
                    and job_id not in self._starved_stamped:
                self._starved_stamped.add(job_id)
                self._stamp_event(job_id, "starved")
                self._log(f"job {job_id!r}: tenant "
                          f"{entry['tenant']!r} flagged starved by the "
                          "health plane")

    # -- cancellation -------------------------------------------------------

    def _poll_cancellations(self) -> None:
        for key in self.kv.keys(JOBS_PREFIX):
            if not key.endswith("/cancel"):
                continue
            job_id = key[len(JOBS_PREFIX):-len("/cancel")]
            state = (self.kv.try_get(k_state(job_id)) or b"").decode()
            if state == QUEUED:
                self._log(f"job {job_id!r}: cancelled while queued")
                self._finish_job(job_id, "cancelled", verdict=None)
            elif state in (RUNNING, PREEMPTING):
                job = self._running.get(job_id)
                if job is not None and not job.cancelling:
                    job.cancelling = True
                    self._log(f"job {job_id!r}: cancelling (SIGTERM gang)")
                    self._terminate_gang(job)
            else:
                self.kv.delete(k_cancel(job_id))  # already terminal

    # -- running jobs -------------------------------------------------------

    def _poll_running(self) -> None:
        for job_id, job in list(self._running.items()):
            jkv = for_job(self.kv, job_id)
            raw = jkv.try_get(K_JOB_DONE)
            if raw is not None:
                self._reap(job, json.loads(raw))
                continue
            if job.preempting or job.cancelling:
                self._escalate_preempt(job)
                continue
            if job.adopted:
                self._check_adopted(job)
            else:
                self._respawn_dead_agents(job)

    def _reap(self, job: _RunningJob, verdict: dict) -> None:
        """A job's own leader posted the terminal verdict; drain its agent
        processes (they exit on their own once they see it) and route by
        how the job ended and why."""
        job_id = job.spec.job_id
        drain_deadline = time.monotonic() + self.drain_timeout
        for p in job.procs.values():
            while p.poll() is None and time.monotonic() < drain_deadline:
                time.sleep(self.poll)
            if p.poll() is None:
                p.kill()
                p.wait()
        del self._running[job_id]
        preempted = bool(verdict.get("preempted"))
        if job.preempting and preempted and not job.cancelling:
            # scheduler-initiated preemption: checkpointed, uncharged —
            # back into the queue at its original seq for a bitwise resume
            jkv = for_job(self.kv, job_id)
            jkv.delete(K_JOB_DONE)
            self.kv.delete(k_state(job_id))
            self.kv.set(k_state(job_id), QUEUED)
            self._stamp_event(job_id, "preempted")
            self._log(f"job {job_id!r}: preempted cleanly; re-queued "
                      f"(seq {job.seq}) for resume")
            return
        if job.cancelling:
            state = "cancelled"
        elif verdict.get("ok"):
            state = "done"
        elif preempted:
            state = "preempted"  # external preemption (not ours): terminal
        else:
            state = "failed"
        self._finish_job(job_id, state, verdict=verdict)

    def _respawn_dead_agents(self, job: _RunningJob) -> None:
        for aid, p in list(job.procs.items()):
            code = p.poll()
            if code is None:
                continue
            jkv = for_job(self.kv, job.spec.job_id)
            if jkv.try_get(K_JOB_DONE) is not None:
                return  # verdict just landed; reap on the next pass
            job.respawns += 1
            if job.respawns > self.respawn_limit:
                self._log(
                    f"job {job.spec.job_id!r}: agent {aid} died (exit "
                    f"{code}) with the respawn limit "
                    f"({self.respawn_limit}) spent; failing the job"
                )
                for q in job.procs.values():
                    if q.poll() is None:
                        q.kill()
                        q.wait()
                del self._running[job.spec.job_id]
                self._finish_job(
                    job.spec.job_id, "failed",
                    verdict={"ok": False,
                             "reason": "agent respawn limit exceeded"},
                )
                return
            self._log(
                f"job {job.spec.job_id!r}: agent {aid} died (exit {code}); "
                f"respawning [{job.respawns}/{self.respawn_limit}]"
            )
            job.procs[aid] = self._spawn_agent(job.spec, aid)

    def _check_adopted(self, job: _RunningJob) -> None:
        """Adopted gangs have no Popen handles — the only liveness signal
        is their agents' heartbeats. All-silent past the watchdog window
        means the gang died with the old scheduler: fail the job so its
        slots free instead of leaking forever."""
        health = job.watchdog.check()
        dead = [h.rank for h in health if not h.alive]
        if len(dead) == job.spec.hosts:
            self._log(
                f"adopted job {job.spec.job_id!r}: all {job.spec.hosts} "
                "agent(s) silent — gang is gone; failing the job"
            )
            del self._running[job.spec.job_id]
            self._finish_job(
                job.spec.job_id, "failed",
                verdict={"ok": False,
                         "reason": "adopted gang no longer heartbeating"},
            )

    # -- preemption ---------------------------------------------------------

    def _terminate_gang(self, job: _RunningJob) -> None:
        job.kill_at = time.monotonic() + self.preempt_kill_timeout
        for p in job.procs.values():
            if p.poll() is None:
                try:
                    p.terminate()
                except OSError:
                    pass

    def _escalate_preempt(self, job: _RunningJob) -> None:
        """A preempted/cancelled gang that never posts its verdict (ranks
        wedged past every in-job escalation) is eventually SIGKILLed; the
        job goes back to the queue (preemption) or terminal (cancel), and
        its budget machinery settles the score on re-admission."""
        if not job.procs or time.monotonic() < job.kill_at:
            return
        if all(p.poll() is not None for p in job.procs.values()):
            # gang died without a verdict (e.g. SIGKILL raced the save)
            pass
        else:
            self._log(f"job {job.spec.job_id!r}: verdict never posted "
                      f"after {self.preempt_kill_timeout:.0f}s; SIGKILL")
            for p in job.procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
        job_id = job.spec.job_id
        del self._running[job_id]
        if job.cancelling:
            self._finish_job(job_id, "cancelled", verdict=None)
        else:
            self.kv.set(k_state(job_id), QUEUED)
            self._stamp_event(job_id, "preempt_killed")
            self._log(f"job {job_id!r}: re-queued after hard kill (its "
                      "restart budget will charge the unclean stop)")

    # -- admission ----------------------------------------------------------

    def _slots_free(self) -> int:
        used = sum(j.spec.hosts for j in self._running.values())
        return self.pool_size - used

    def _charge_tenants(self) -> None:
        """Accrue each running tenant's normalized service. Charged per
        tick so fair share reflects time actually held, not job count."""
        now = time.monotonic()
        dt, self._last_charge = now - self._last_charge, now
        for job in self._running.values():
            tenant = job.spec.tenant
            if tenant:
                vt = (self._tenant_vtime.get(tenant, 0.0)
                      + job.spec.hosts * dt / job.spec.share)
                self._tenant_vtime[tenant] = vt
                # durable ledger: a successor scheduler resumes the
                # 2:1 convergence instead of resetting every debt
                self.kv.set(f"{K_VTIME_PREFIX}{tenant}", repr(vt))
                get_registry().gauge("sched.tenant.vtime",
                                     labels={"tenant": tenant}).set(vt)

    def tenant_vtime(self, tenant: str) -> float:
        return self._tenant_vtime.get(tenant, 0.0)

    def _admit_or_preempt(self, queued: list[dict]) -> None:
        if not queued:
            return
        # priority first; within a band, tenants with the least normalized
        # service go first (untenanted jobs charge nothing and stay pure
        # FIFO among themselves); seq breaks the remaining ties
        order = sorted(queued, key=lambda j: (
            -j["priority"],
            self._tenant_vtime.get(j["tenant"], 0.0) if j["tenant"] else 0.0,
            j["seq"]))
        # expire everyone's admission deadline, not just the head's — a
        # low-priority job stuck behind a high-priority head must still
        # time out on schedule
        now = time.monotonic()
        for entry in order:
            dl = self._queue_deadline.get(entry["job_id"])
            if dl is None:
                raw = self.kv.try_get(k_spec(entry["job_id"]))
                spec_t = JobSpec.from_json(raw.decode())
                self._queue_deadline[entry["job_id"]] = (
                    now + spec_t.admission_timeout
                )
            elif now >= dl:
                self._log(f"job {entry['job_id']!r}: admission deadline "
                          "passed; timing out (namespace swept)")
                self._finish_job(entry["job_id"], "timeout", verdict=None)
        order = [e for e in order
                 if (self.kv.try_get(k_state(e["job_id"])) or b"").decode()
                 == QUEUED]
        if not order:
            return
        head = order[0]
        raw = self.kv.try_get(k_spec(head["job_id"]))
        if raw is None:
            return
        spec = JobSpec.from_json(raw.decode())
        group = self._cogroup_members(order, head, spec)
        needed = sum(s.hosts for s, _ in group)
        free = self._slots_free()
        if needed <= free:
            for member, seq in group:
                self._admit(member, seq)
            return
        # not enough room: can lower-priority running work make room?
        victims = self._pick_victims(spec, free, needed=needed)
        if victims:
            for member, _ in group:
                self._queue_deadline[member.job_id] = (
                    time.monotonic() + member.admission_timeout
                )  # give the group a fresh window while its room is made
            for victim in victims:
                victim.preempting = True
                self.kv.set(k_state(victim.spec.job_id), PREEMPTING)
                self._stamp_event(victim.spec.job_id, "preempt_sent")
                get_registry().counter("sched.preemptions").inc()
                # durable cycle count for the cascade detector
                self.kv.add(f"{K_PREEMPTS_PREFIX}{victim.spec.job_id}")
                self._log(
                    f"preempting job {victim.spec.job_id!r} (priority "
                    f"{victim.spec.priority}) to admit "
                    f"{spec.job_id!r} (priority {spec.priority})"
                )
                self._terminate_gang(victim)
            return
        self._try_backfill(order, spec, free, needed=needed)

    def _cogroup_members(self, order: list[dict], head: dict,
                         head_spec: JobSpec) -> list[tuple[JobSpec, int]]:
        """The head plus every other queued member of its cogroup, as
        ``(spec, seq)`` pairs — an MPMD pipeline's stage gangs admit
        all-or-nothing, one gang of gangs. A solo head is its own
        singleton group."""
        group = [(head_spec, head["seq"])]
        if not head_spec.cogroup:
            return group
        for entry in order[1:]:
            if entry.get("cogroup") != head_spec.cogroup:
                continue
            raw = self.kv.try_get(k_spec(entry["job_id"]))
            if raw is None:
                continue
            group.append((JobSpec.from_json(raw.decode()), entry["seq"]))
        return group

    def _try_backfill(self, order: list[dict], head_spec: JobSpec,
                      free: int, needed: int | None = None) -> None:
        """The head is blocked and no preemption can help it. Strictly
        lower-priority queued jobs that fit the free slots may start
        behind it: strictly lower keeps the head's preemption rights over
        every backfilled gang, so backfill can delay the head by at most
        one preemption drain — never indefinitely. The starvation guard
        stops backfilling once the head has consumed
        ``backfill_guard_frac`` of its admission window, reserving the
        rest of the window for room to appear rather than churn."""
        if needed is None:
            needed = head_spec.hosts
        if free < 1 or len(order) < 2:
            return
        pending = sum(
            j.spec.hosts for j in self._running.values()
            if j.preempting or j.cancelling
        )
        if free + pending >= needed:
            return  # the head's room is already on its way: don't take it
        dl = self._queue_deadline.get(head_spec.job_id)
        if dl is not None and dl - time.monotonic() <= (
                (1.0 - self.backfill_guard_frac)
                * head_spec.admission_timeout):
            return  # head too close to its deadline; stop churning
        for entry in order[1:]:
            if free < 1:
                return
            if entry["priority"] >= head_spec.priority:
                continue  # the head couldn't preempt it back out: skip
            raw = self.kv.try_get(k_spec(entry["job_id"]))
            if raw is None:
                continue
            cand = JobSpec.from_json(raw.decode())
            if head_spec.cogroup and cand.cogroup == head_spec.cogroup:
                continue  # the head's own co-gang never backfills itself
            if cand.hosts > free:
                continue
            self._stamp_event(cand.job_id, "backfilled")
            self._log(
                f"backfilling job {cand.job_id!r} (priority "
                f"{cand.priority}, {cand.hosts} host(s)) behind blocked "
                f"head {head_spec.job_id!r} (priority {head_spec.priority})"
            )
            self._admit(cand, entry["seq"])
            free = self._slots_free()

    def _pick_victims(self, spec: JobSpec, free: int,
                      needed: int | None = None) -> list[_RunningJob]:
        """Lowest priority first, newest first within a priority; only
        strictly-lower-priority jobs are preemptable, and only if the
        freed slots actually satisfy ``needed`` hosts — the head job
        alone, or its whole cogroup (never preempt for nothing). Jobs
        already winding down are counted as pending room rather than
        re-victimized."""
        if needed is None:
            needed = spec.hosts
        pending = sum(
            j.spec.hosts for j in self._running.values()
            if j.preempting or j.cancelling
        )
        if free + pending >= needed:
            return []  # enough room is already on its way
        candidates = sorted(
            (j for j in self._running.values()
             if not j.preempting and not j.cancelling
             and j.spec.priority < spec.priority),
            key=lambda j: (j.spec.priority, -j.seq),
        )
        chosen: list[_RunningJob] = []
        room = free + pending
        for j in candidates:
            if room >= needed:
                break
            chosen.append(j)
            room += j.spec.hosts
        return chosen if room >= needed else []

    def _spawn_agent(self, spec: JobSpec, aid: int) -> subprocess.Popen:
        env = dict(os.environ)
        env.update(self.extra_env)
        env.update(spec.env)
        env[ENV_JOB_ID] = spec.job_id
        return subprocess.Popen(
            spec.format_argv(agent_id=aid, kv_port=self.kv_port),
            env=env,
        )

    def _admit(self, spec: JobSpec, seq: int) -> None:
        jkv = for_job(self.kv, spec.job_id)
        jkv.delete(K_JOB_DONE)  # stale verdict from before a resume
        procs: dict[int, subprocess.Popen] = {}
        try:
            for aid in range(spec.hosts):
                procs[aid] = self._spawn_agent(spec, aid)
        except OSError as e:
            # gang or nothing: a half-spawned gang is torn down, never run
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
            self._log(f"job {spec.job_id!r}: gang spawn failed ({e})")
            self._finish_job(spec.job_id, "failed",
                            verdict={"ok": False, "reason": f"spawn: {e}"})
            return
        self._running[spec.job_id] = _RunningJob(spec, seq, procs)
        self._queue_deadline.pop(spec.job_id, None)
        self.kv.set(k_state(spec.job_id), RUNNING)
        resumed = self.kv.try_get(k_event(spec.job_id, "admitted"))
        name = "admitted" if resumed is None else "readmitted"
        get_registry().counter("sched.admissions",
                               labels={"kind": name}).inc()
        self._stamp_event(spec.job_id, name)
        self._log(
            f"job {spec.job_id!r}: {name} — gang of {spec.hosts} host(s), "
            f"world {spec.world_size}, priority {spec.priority}"
        )

    def _stamp_event(self, job_id: str, name: str) -> None:
        """One job-lifecycle stamp, twice: the durable wall-clock KV key
        (receipts, resume detection) and a flight-recorder instant
        (the merged timeline)."""
        self.kv.set(k_event(job_id, name), f"{time.time():.6f}")
        get_recorder().instant(f"job:{name}", args={"job": job_id})

    # -- terminal bookkeeping ----------------------------------------------

    def _finish_job(self, job_id: str, state: str,
                    verdict: dict | None) -> None:
        """Move a job to a terminal state and sweep every key it could
        have leaked: its whole ``job/<id>/`` namespace (claims, budgets,
        election, health — gone as a unit). The ``sched/jobs/<id>/*``
        entry stays as the durable record (spec, seq, events, verdict,
        terminal state) — which also makes job ids single-use. After
        this, ``kv.keys("job/<id>/")`` is empty — the clean-queue
        invariant the admission-timeout test asserts."""
        self._queue_deadline.pop(job_id, None)
        ns = job_namespace(job_id)
        if ns:
            self.kv.delete_prefix(ns)
        self.kv.delete(k_cancel(job_id))
        if verdict is not None:
            self.kv.set(k_verdict(job_id), json.dumps(verdict))
        self.kv.set(k_state(job_id), state)
        self._stamp_event(job_id, state)
        self._log(f"job {job_id!r}: {state}")
