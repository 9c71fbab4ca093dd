"""Deterministic fault injection — the test half of the detect→recover loop.
The port's copy of ``tpu_sandbox/runtime/faults.py``: the same plan
vocabulary, environment name and KV keys, so either package's supervisor
can drive the other's ranks.

The supervisor (runtime/supervisor.py) can only be trusted if rank death,
preemption, wedged ranks, and corrupt checkpoints are *reproducible*; this
module makes failures first-class inputs instead of flaky sleeps-and-kills
in tests:

- ``FaultPlan``     — a declarative list of :class:`Fault` entries ("rank 1
                      dies at optimizer step 7", "rank 0 receives SIGTERM at
                      step 4", ...), serialized through one env var so it
                      crosses the supervisor→worker process boundary.
- ``FaultInjector`` — lives inside the worker's training loop; at every
                      step boundary ``maybe_fire(step)`` fires any fault
                      scheduled for (this rank, this step). Each fault is
                      claimed through the shared KV store, so it fires
                      exactly once *across elastic restarts* — replaying
                      the same step after recovery must not re-kill the
                      worker, or the job would crash-loop forever.

Actions:

``kill``            SIGKILL self — the hard crash the watchdog + supervisor
                    must turn into a restart, not a hang.
``sigterm``         SIGTERM self — models a spot or maintenance preemption notice; the
                    trainer's PreemptionHandler turns it into save+exit(75).
``hang_heartbeat``  stop publishing heartbeats while the process keeps
                    running — the wedged-not-dead case only the watchdog
                    (never exit-code polling) can detect.
``corrupt_ckpt``    scribble garbage over the newest checkpoint step under
                    ``target`` — exercises restore's quarantine-and-fall-
                    back path (checkpoint.py).
``corrupt_shard``   scribble garbage over this rank's shard file in the
                    newest SEALED sharded-checkpoint step under ``target``
                    — the step still *looks* committed (manifest intact),
                    so only the SHA-256 verification can catch it.
``kill_during_commit``  SIGKILL self from INSIDE the checkpoint commit
                    window (after this rank's shard is written and claimed,
                    on rank 0 right before the manifest rename) — the
                    torn-step case the two-phase protocol exists for. Fired
                    via ``maybe_fire_commit`` from the checkpoint layer's
                    commit hook, never at a step boundary.
``kill_agent``      SIGKILL this rank's *host agent* (host_agent.py) — the
                    host-death / leader-death case of the cross-host design.
                    The rank posts a command on the agent's KV mailbox
                    (``agent/cmd/<id>``); the agent executes it, and its
                    PR_SET_PDEATHSIG children die with it, exactly like a
                    machine vanishing.
``partition_host``  the agent stops talking to the KV store for ``target``
                    seconds while its ranks keep running — the network
                    partition only agent-level heartbeat monitoring can see.
                    Routed through the same agent mailbox.
``shed_storm``      post a shed order on a serve replica's fault mailbox
                    (``serve/cmd/<target>``): the replica sheds its whole
                    local waiting queue with explicit SHED verdicts — the
                    burst-overload case the SLO layer must answer without
                    hanging any client.
``stall_replica``   freeze the replica named by ``target`` for longer than
                    its lease TTL (``serve/cmd/<tag>:<seconds>`` target
                    syntax). Its leases lapse, peers scavenge its claims,
                    and the client-side hedging/retry path gets a live
                    straggler to race. Same mailbox, consumed by
                    ``ReplicaWorker._poll_faults``.
"""

from __future__ import annotations

import json
import os
import signal
from dataclasses import asdict, dataclass
from pathlib import Path
from typing import Callable, Mapping, MutableMapping

ENV_PLAN = "TPU_SANDBOX_FAULT_PLAN"

ACTIONS = ("kill", "sigterm", "hang_heartbeat", "corrupt_ckpt",
           "corrupt_shard", "kill_during_commit", "kill_agent",
           "partition_host", "shed_storm", "stall_replica")

#: Actions that fire inside the checkpoint commit window (via
#: ``maybe_fire_commit``) rather than at an optimizer-step boundary.
COMMIT_ACTIONS = ("kill_during_commit",)

#: Actions executed by this rank's HOST AGENT, not by the rank itself:
#: the rank claims the fault at its step boundary, then posts a command on
#: the agent's KV mailbox. Requires agent-mode elastic runs (a KV store and
#: TPU_SANDBOX_AGENT_ID in the rank's env).
AGENT_ACTIONS = ("kill_agent", "partition_host")

#: Actions executed by a serve REPLICA: posted to its fault mailbox
#: (``serve/cmd/<tag>``), consumed once per fault by the replica's poll
#: loop. ``target`` names the replica tag; ``stall_replica`` may append
#: ``:<seconds>`` for the stall duration.
SERVE_ACTIONS = ("shed_storm", "stall_replica")

ENV_AGENT_ID = "TPU_SANDBOX_AGENT_ID"


def agent_cmd_key(agent_id: int | str) -> str:
    """The agent's fault-command mailbox (single-slot: agents consume it
    with delete-after-read)."""
    return f"agent/cmd/{agent_id}"


def serve_cmd_key(tag: str) -> str:
    """A serve replica's fault mailbox (single-slot, delete-after-read —
    mirrors the agent mailbox; key layout owned by serve/replica.py)."""
    return f"serve/cmd/{tag}"


def agent_id_from_env(environ: Mapping[str, str] | None = None) -> int | None:
    raw = (environ or os.environ).get(ENV_AGENT_ID, "")
    return int(raw) if raw else None


@dataclass(frozen=True)
class Fault:
    rank: int
    step: int
    action: str
    target: str | None = None  # corrupt_ckpt/corrupt_shard: checkpoint dir

    def __post_init__(self):
        if self.action not in ACTIONS:
            raise ValueError(
                f"unknown fault action {self.action!r}; choose from {ACTIONS}"
            )
        if self.action in ("corrupt_ckpt", "corrupt_shard") and not self.target:
            raise ValueError(
                f"{self.action} needs target=<checkpoint dir>"
            )
        if self.action in SERVE_ACTIONS and not self.target:
            raise ValueError(
                f"{self.action} needs target=<replica tag>"
                + (":<seconds>" if self.action == "stall_replica" else "")
            )
        if self.action == "partition_host" and self.target is not None:
            try:
                float(self.target)
            except ValueError:
                raise ValueError(
                    "partition_host target must be a duration in seconds, "
                    f"got {self.target!r}"
                ) from None


class FaultPlan:
    """An ordered set of faults, round-trippable through one env var."""

    def __init__(self, faults: list[Fault] | tuple[Fault, ...] = ()):
        self.faults = list(faults)

    def add(self, rank: int, step: int, action: str,
            target: str | None = None) -> "FaultPlan":
        self.faults.append(Fault(rank, step, action, target))
        return self

    def __len__(self) -> int:
        return len(self.faults)

    def to_json(self) -> str:
        return json.dumps([asdict(f) for f in self.faults])

    @classmethod
    def from_json(cls, text: str) -> "FaultPlan":
        return cls([Fault(**d) for d in json.loads(text)])

    def to_env(self, env: MutableMapping[str, str] | None = None) -> dict:
        """Write the plan into ``env`` (default: a fresh copy of
        ``os.environ``) and return that mapping — hand it to Popen."""
        env = dict(os.environ) if env is None else env
        env[ENV_PLAN] = self.to_json()
        return env

    @classmethod
    def from_env(cls, environ: Mapping[str, str] | None = None) -> "FaultPlan":
        """The plan the launcher serialized, or an empty plan (the normal,
        fault-free run) when the env var is unset."""
        raw = (environ or os.environ).get(ENV_PLAN, "")
        return cls.from_json(raw) if raw else cls()


class FaultInjector:
    """Worker-side trigger. Call ``maybe_fire(step)`` at every optimizer-step
    boundary; faults scheduled for (rank, step) fire at most once globally.

    ``kv``: a KVClient sharing the supervisor's store. When present, each
    fault is claimed with an atomic counter (``fault/<i>/claimed``) that
    survives worker restarts — the claim, not the process, is what makes a
    kill-at-step-7 happen once instead of on every replay of step 7.
    Without a store (single-process tests) claims are process-local.
    In cluster mode hand a job-scoped view (``kvstore.for_job``): claims
    and agent mailboxes then live inside the job's namespace, so job A's
    fault plan can never fire on (or be claimed by) job B.

    ``on_hang_heartbeat``: callback that silences this rank's liveness
    publishing (wire it to ``Heartbeat.stop``); the process itself keeps
    training, which is the point of that fault.
    """

    def __init__(
        self,
        plan: FaultPlan,
        rank: int,
        kv=None,
        *,
        on_hang_heartbeat: Callable[[], None] | None = None,
        agent_id: int | None = None,
    ):
        self.plan = plan
        self.rank = rank
        self.kv = kv
        self.on_hang_heartbeat = on_hang_heartbeat
        # which host agent owns this rank (agent-mode elastic runs set
        # TPU_SANDBOX_AGENT_ID in the worker env); agent-targeted faults
        # are posted to that agent's mailbox
        self.agent_id = agent_id if agent_id is not None else (
            agent_id_from_env()
        )
        self._claimed_local: set[int] = set()

    def _claim(self, index: int) -> bool:
        if index in self._claimed_local:
            return False
        self._claimed_local.add(index)
        if self.kv is not None:
            return self.kv.add(f"fault/{index}/claimed", 1) == 1
        return True

    def maybe_fire(self, step: int) -> list[Fault]:
        """Fire this rank's step-boundary faults scheduled exactly at
        ``step``; returns the faults that fired (kill, of course, never
        returns). Commit-window faults are skipped here — they belong to
        :meth:`maybe_fire_commit`."""
        fired = []
        for i, f in enumerate(self.plan.faults):
            if f.rank != self.rank or f.step != step:
                continue
            if f.action in COMMIT_ACTIONS:
                continue
            if not self._claim(i):
                continue
            self._fire(f)
            fired.append(f)
        return fired

    def maybe_fire_commit(self, step: int) -> list[Fault]:
        """Fire this rank's commit-window faults for ``step``. Called by
        the sharded checkpoint's commit hook, i.e. from INSIDE the
        two-phase save — after this rank's shard claim, and on rank 0
        between claim-gathering and the manifest rename. The KV claim
        still applies: the relaunched generation re-saves the same step
        without being re-killed."""
        fired = []
        for i, f in enumerate(self.plan.faults):
            if f.rank != self.rank or f.step != step:
                continue
            if f.action not in COMMIT_ACTIONS:
                continue
            if not self._claim(i):
                continue
            self._fire(f)
            fired.append(f)
        return fired

    def _fire(self, f: Fault) -> None:
        # announce BEFORE executing: instants flush to disk, so even a
        # self-SIGKILL on the next line leaves its mark on the timeline
        from tpu_sandbox_torch.obs import get_recorder

        get_recorder().instant(f"fault:{f.action}",
                               args={"rank": self.rank, "step": f.step})
        if f.action in ("kill", "kill_during_commit"):
            os.kill(os.getpid(), signal.SIGKILL)
        elif f.action == "sigterm":
            # handler (trainer.PreemptionHandler) runs at the next bytecode
            # boundary; the in-flight step then finishes before save+exit
            os.kill(os.getpid(), signal.SIGTERM)
        elif f.action == "hang_heartbeat":
            if self.on_hang_heartbeat is not None:
                self.on_hang_heartbeat()
        elif f.action == "corrupt_ckpt":
            corrupt_latest_step(f.target)
        elif f.action == "corrupt_shard":
            corrupt_latest_shard(f.target, rank=self.rank)
        elif f.action in AGENT_ACTIONS:
            if self.kv is None or self.agent_id is None:
                raise RuntimeError(
                    f"{f.action} needs a KV store and {ENV_AGENT_ID} in the "
                    "worker env — agent-mode elastic runs only (--agents N)"
                )
            self.kv.set(
                agent_cmd_key(self.agent_id),
                json.dumps({"action": f.action, "arg": f.target}),
            )
        elif f.action in SERVE_ACTIONS:
            if self.kv is None:
                raise RuntimeError(f"{f.action} needs a KV store")
            tag, _, dur = f.target.partition(":")
            body = {"action": f.action}
            if dur:
                body["duration"] = float(dur)
            self.kv.set(serve_cmd_key(tag), json.dumps(body))


# -- checkpoint corruption (also used directly by tests) -------------------

def corrupt_step_dir(step_dir: str | os.PathLike) -> list[Path]:
    """Overwrite every regular file under ``step_dir`` with garbage bytes
    (keeping the layout, so the step still *looks* committed — the nastier
    corruption mode). Returns the files touched."""
    touched = []
    for p in sorted(Path(step_dir).rglob("*")):
        if p.is_file():
            p.write_bytes(b"\xde\xad\xbe\xef garbage " * 4)
            touched.append(p)
    return touched


def _sealed_sharded_steps(root: Path) -> list[Path]:
    """Sealed ShardedCheckpoint step dirs (``step-XXXXXXXX/`` holding a
    MANIFEST.json), sorted by step number."""
    out = []
    for p in root.glob("step-*"):
        tail = p.name.split("-", 1)[1]
        if p.is_dir() and tail.isdigit() and (p / "MANIFEST.json").exists():
            out.append(p)
    return sorted(out, key=lambda p: int(p.name.split("-", 1)[1]))


def corrupt_latest_shard(
    directory: str | os.PathLike, rank: int = 0
) -> Path | None:
    """Scribble over ONE shard file of the newest *sealed* sharded step —
    the manifest stays intact, so the step still looks committed and only
    the restore-time SHA-256 check (or the verifier) can tell. Prefers
    rank ``rank``'s shard, falls back to the first shard present. Returns
    the file corrupted, or None when no sealed sharded step exists."""
    root = Path(directory)
    if not root.is_dir():
        return None
    sealed = _sealed_sharded_steps(root)
    if not sealed:
        return None
    sd = sealed[-1]
    target = sd / f"shard-{rank:05d}.npz"
    if not target.exists():
        shards = sorted(sd.glob("shard-*.npz"))
        if not shards:
            return None
        target = shards[0]
    target.write_bytes(b"\xde\xad\xbe\xef bitrot " * 4)
    return target


def corrupt_latest_step(directory: str | os.PathLike) -> Path | None:
    """Corrupt the newest committed checkpoint step under ``directory``.

    Understands all three on-disk layouts in this repo: orbax step
    directories (numeric child dirs), sealed ShardedCheckpoint step dirs
    (``step-XXXXXXXX/`` with a manifest), and HostCheckpoint step files
    (``step-*.npz``). Returns what was corrupted, or None when the dir
    holds no steps yet.
    """
    root = Path(directory)
    if not root.is_dir():
        return None
    step_dirs = [p for p in root.iterdir() if p.is_dir() and p.name.isdigit()]
    if step_dirs:
        latest = max(step_dirs, key=lambda p: int(p.name))
        corrupt_step_dir(latest)
        return latest
    sealed = _sealed_sharded_steps(root)
    if sealed:
        corrupt_step_dir(sealed[-1])
        return sealed[-1]
    npzs = [
        p for p in root.glob("step-*.npz")
        if p.stem.split("-", 1)[1].isdigit()
    ]
    if npzs:
        # numeric, not lexicographic: step-10 is newer than step-2
        latest = max(npzs, key=lambda p: int(p.stem.split("-", 1)[1]))
        latest.write_bytes(b"\xde\xad\xbe\xef not a zipfile")
        return latest
    return None
