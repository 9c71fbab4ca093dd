"""Elastic supervisor: close the detect→recover loop over worker processes.
The port's copy of ``tpu_sandbox/runtime/supervisor.py`` (jax-free there
too): the same environment names, KV keys and exit-code contract.

The repo already *detects* failure (runtime/watchdog.py heartbeats +
bounded rendezvous) and can *resume* (train/checkpoint.py); until now
nothing acted on a failure — a crashed rank still took the whole job down,
exactly the reference's failure story (SURVEY §5). This module is the
missing actor, following the elastic-agent design torchelastic
popularized: a single supervisor process owns the KV store, spawns one
worker process per rank, and monitors two independent signals —

- **exit codes** (``Popen.poll``): crash, clean finish, or the distinct
  "preempted" code below;
- **heartbeats** (``Watchdog`` over the KV store): the wedged-not-dead
  rank that exit codes can never see (alive as a process, silent for
  ``heartbeat_timeout`` — e.g. stuck in a collective whose peer vanished).

On any failure the whole *generation* is torn down (a survivor of a dead
peer is blocked in a collective and useless) and relaunched after bounded
exponential backoff, up to ``max_restarts`` charged restarts. A generation
whose culprit ranks all exited with :data:`PREEMPTED_EXIT_CODE` — the code
the trainer's SIGTERM handler uses after finishing its in-flight step and
saving — is a *preemption*: it restarts promptly and does **not** charge
the restart budget (preemption is the dominant real-world failure of
rented accelerators and is not the job's fault). Workers re-join through ``wait_for_world``'s
generation-scoped rendezvous; the supervisor clears the per-generation
health keys so every generation starts from a clean plane.
"""

from __future__ import annotations

import os
import signal
import subprocess
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, Mapping, Sequence

from tpu_sandbox_torch.runtime.kvstore import (
    DEFAULT_JOB,
    ENV_JOB_ID,
    KVClient,
    KVServer,
    for_job,
)
from tpu_sandbox_torch.runtime.watchdog import Watchdog, _hb_key

#: Exit code meaning "I was preempted: state is saved, restart me for free".
#: 75 is sysexits' EX_TEMPFAIL — transient failure, retry is appropriate.
PREEMPTED_EXIT_CODE = 75

ENV_KV_PORT = "TPU_SANDBOX_KV_PORT"
ENV_GENERATION = "TPU_SANDBOX_GENERATION"

#: KV key a preempted rank sets so its peers stop at the same boundary.
PREEMPT_KEY = "preempt/requested"


def _pdeathsig_preexec():
    """preexec_fn that makes the child die (SIGKILL) when its parent does —
    the "host death kills everything on the host" contract a per-host agent
    needs (runtime/host_agent.py): SIGKILLing the agent must not orphan its
    rank processes into zombie trainers that keep heartbeating into the next
    generation. Linux PR_SET_PDEATHSIG; silently a no-op elsewhere."""
    try:
        import ctypes
        import ctypes.util

        libc = ctypes.CDLL(ctypes.util.find_library("c") or "libc.so.6",
                           use_errno=True)
        libc.prctl(1, signal.SIGKILL, 0, 0, 0)  # 1 == PR_SET_PDEATHSIG
    except Exception:
        pass


class RankGroup:
    """Spawn/poll/stop a set of local rank processes.

    The proc-management core shared by the single-host :class:`Supervisor`
    and the per-host ``HostAgent``: owns the Popen handles, caches exit
    codes across polls, and implements the SIGTERM→wait→SIGKILL teardown
    escalation (SIGTERM gives the trainer's preemption handler a chance to
    save; SIGKILL unwedges ranks stuck in a native collective).
    """

    def __init__(
        self,
        *,
        term_timeout: float = 30.0,
        kill_on_parent_death: bool = False,
    ):
        self.term_timeout = term_timeout
        self._preexec = _pdeathsig_preexec if kill_on_parent_death else None
        self._procs: list[subprocess.Popen] = []
        self._codes: list[int | None] = []

    def spawn(
        self,
        cmds: Sequence[Sequence[str]],
        env: Mapping[str, str] | None = None,
    ) -> None:
        if self._procs and any(c is None for c in self.poll()):
            raise RuntimeError("RankGroup.spawn while previous group runs")
        self._procs = [
            subprocess.Popen(list(cmd),
                             env=None if env is None else dict(env),
                             preexec_fn=self._preexec)
            for cmd in cmds
        ]
        self._codes = [None] * len(self._procs)

    def __len__(self) -> int:
        return len(self._procs)

    def poll(self) -> list[int | None]:
        """Exit codes so far (None = still running); cached once observed."""
        for i, p in enumerate(self._procs):
            if self._codes[i] is None:
                self._codes[i] = p.poll()
        return list(self._codes)

    @property
    def running(self) -> bool:
        return any(c is None for c in self.poll())

    def terminate_all(self) -> None:
        for p in self._procs:
            if p.poll() is None:
                try:
                    p.terminate()
                except OSError:
                    pass

    def teardown(self) -> list[int | None]:
        """SIGTERM everyone, wait up to ``term_timeout``, SIGKILL stragglers;
        returns the final exit codes."""
        self.terminate_all()
        deadline = time.monotonic() + self.term_timeout
        for p in self._procs:
            if p.poll() is None:
                try:
                    p.wait(timeout=max(0.1, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    p.kill()
                    p.wait()
        return self.poll()


class RestartBudgetExceeded(RuntimeError):
    """The job kept dying after ``max_restarts`` charged restarts (or blew
    through ``max_preemptions``); carries the full generation history."""

    def __init__(self, msg: str, result: "ElasticResult"):
        super().__init__(msg)
        self.result = result


@dataclass
class GenerationReport:
    generation: int
    outcome: str  # "ok" | "failure" | "preemption" | "wedged"
    exit_codes: list[int | None]
    culprits: list[int]  # ranks that initiated the failure (pre-teardown)
    elapsed: float


@dataclass
class ElasticResult:
    world_size: int
    generations: list[GenerationReport] = field(default_factory=list)
    restarts_charged: int = 0
    preemptions: int = 0

    @property
    def ok(self) -> bool:
        return bool(self.generations) and self.generations[-1].outcome == "ok"

    def summary(self) -> str:
        gens = ", ".join(
            f"gen{g.generation}:{g.outcome}" for g in self.generations
        )
        return (
            f"{len(self.generations)} generation(s) [{gens}]; "
            f"{self.restarts_charged} restart(s) charged, "
            f"{self.preemptions} preemption(s)"
        )


class Supervisor:
    """Spawn/monitor/relaunch one process per rank until the job finishes.

    ``command_for_generation(generation, kv_port) -> list[argv]`` builds
    the per-rank commands fresh for every generation (fresh coordinator
    ports, ``--resume`` flags, ... live in the builder, which keeps this
    class free of any training-specific knowledge). Each worker inherits
    ``TPU_SANDBOX_KV_PORT`` and ``TPU_SANDBOX_GENERATION`` in its env on
    top of ``os.environ`` and ``extra_env``.

    A SIGTERM delivered to the supervisor itself (the whole job being
    preempted) is forwarded to every worker; once the generation winds
    down it is reported as a preemption and the supervisor stops
    relaunching — the job's next incarnation resumes from the checkpoint.
    """

    def __init__(
        self,
        world_size: int,
        command_for_generation: Callable[[int, int], Sequence[Sequence[str]]],
        *,
        max_restarts: int = 3,
        max_preemptions: int = 32,
        backoff: float = 1.0,
        backoff_max: float = 30.0,
        heartbeat_timeout: float = 60.0,
        grace: float = 180.0,
        poll: float = 0.1,
        term_timeout: float = 30.0,
        extra_env: Mapping[str, str] | None = None,
        kv_server: KVServer | None = None,
        verbose: bool = True,
        job_id: str = "",
    ):
        if world_size < 1:
            raise ValueError(f"world_size must be >= 1, got {world_size}")
        self.world_size = world_size
        self.job_id = job_id
        self.command_for_generation = command_for_generation
        self.max_restarts = max_restarts
        self.max_preemptions = max_preemptions
        self.backoff = backoff
        self.backoff_max = backoff_max
        self.heartbeat_timeout = heartbeat_timeout
        self.grace = grace
        self.poll = poll
        self.term_timeout = term_timeout
        self.extra_env = dict(extra_env or {})
        self._kv_server = kv_server
        self._owns_server = kv_server is None
        self.verbose = verbose
        self._external_preempt = False
        self._group = RankGroup(term_timeout=term_timeout)

    # -- logging ----------------------------------------------------------

    def _log(self, msg: str) -> None:
        if self.verbose:
            print(f"[supervisor] {msg}", flush=True)

    # -- health-plane reset ------------------------------------------------

    def _reset_health_plane(self, kv: KVClient) -> None:
        """A new generation must not inherit the dead one's liveness or
        rendezvous state: a frozen heartbeat stamp would read as an
        immediately-dead rank, and unequal rendezvous counters (a rank that
        died before joining) would wedge ``wait_for_world`` forever. Fault
        claims are deliberately NOT cleared — a fault fires once per job,
        not once per generation. Checkpoint shard-done claims ARE cleared:
        they are per-commit-attempt state, and a relaunched generation
        re-reaching the same step must gather fresh claims, never its dead
        predecessor's (the claims are generation-scoped and TTL'd as well —
        this sweep is the belt to those braces, and keeps a long-lived
        server from accumulating dead keys across generations)."""
        for r in range(self.world_size):
            kv.delete(_hb_key(r))
            kv.delete(f"rendezvous/gen/{r}")
        kv.delete(PREEMPT_KEY)
        kv.delete_prefix("ckpt/")

    def _reset_job_plane(self, kv: KVClient) -> None:
        """Job-start sweep for an EXTERNAL long-lived KV server reused
        across supervisor runs: the previous job's fault claims would make
        this job's identical fault plan never fire, and its stale commit
        claims could alias this job's. Runs once, before generation 1 —
        within a job, fault claims persist across generations (fire-once
        semantics)."""
        kv.delete_prefix("fault/")
        kv.delete_prefix("ckpt/")

    # -- teardown ----------------------------------------------------------

    def _teardown(self, codes: list[int | None]) -> None:
        """Stop every still-running worker (SIGTERM→wait→SIGKILL via the
        :class:`RankGroup`) and fill in the final exit codes."""
        final = self._group.teardown()
        for i, c in enumerate(final):
            if codes[i] is None:
                codes[i] = c

    # -- one generation ----------------------------------------------------

    def _run_generation(self, gen: int, kv: KVClient, kv_port: int
                        ) -> GenerationReport:
        cmds = [list(c) for c in self.command_for_generation(gen, kv_port)]
        if len(cmds) != self.world_size:
            raise ValueError(
                f"command_for_generation returned {len(cmds)} commands for "
                f"world_size {self.world_size}"
            )
        env = dict(os.environ)
        env.update(self.extra_env)
        env[ENV_KV_PORT] = str(kv_port)
        env[ENV_GENERATION] = str(gen)
        env[ENV_JOB_ID] = self.job_id or DEFAULT_JOB
        start = time.monotonic()
        self._group.spawn(cmds, env)
        watchdog = Watchdog(
            kv, self.world_size,
            timeout=self.heartbeat_timeout, grace=self.grace,
        )
        codes: list[int | None] = [None] * self.world_size
        try:
            while any(c is None for c in codes):
                codes = self._group.poll()
                culprits = [
                    r for r, c in enumerate(codes) if c not in (None, 0)
                ]
                if culprits:
                    # initiator-only classification: codes produced later by
                    # our own teardown (SIGTERM/SIGKILL of blocked peers)
                    # must not turn a preemption into a charged failure
                    preempted = all(
                        codes[r] == PREEMPTED_EXIT_CODE for r in culprits
                    )
                    self._teardown(codes)
                    outcome = "preemption" if preempted else "failure"
                    return GenerationReport(
                        gen, outcome, codes, culprits,
                        time.monotonic() - start,
                    )
                wedged = [r for r in watchdog.dead_ranks() if codes[r] is None]
                if wedged:
                    self._teardown(codes)
                    return GenerationReport(
                        gen, "wedged", codes, wedged,
                        time.monotonic() - start,
                    )
                time.sleep(self.poll)
        finally:
            # belt and braces: never leak workers past a generation, even
            # when the monitor loop itself raises (e.g. KeyboardInterrupt)
            if self._group.running:
                self._teardown(codes)
        return GenerationReport(
            gen, "ok", codes, [], time.monotonic() - start
        )

    # -- the elastic loop --------------------------------------------------

    def _install_forwarder(self):
        """Forward a supervisor-level SIGTERM to the workers (whole-job
        preemption). Returns the previous handler, restored by run()."""
        def fwd(signum, frame):
            self._external_preempt = True
            self._group.terminate_all()
        try:
            return signal.signal(signal.SIGTERM, fwd)
        except ValueError:
            return None  # not the main thread (tests); skip forwarding

    def run(self) -> ElasticResult:
        result = ElasticResult(self.world_size)
        server = self._kv_server or KVServer()
        # job-scoped view: a shared external store can host several
        # supervised jobs whose health/budget/fault keys never collide
        kv = for_job(KVClient(port=server.port), self.job_id)
        self._reset_job_plane(kv)
        prev_handler = self._install_forwarder()
        gen = 0
        try:
            while True:
                gen += 1
                self._reset_health_plane(kv)
                kv.set("elastic/generation", str(gen))
                self._log(
                    f"generation {gen}: launching {self.world_size} worker(s)"
                )
                report = self._run_generation(gen, kv, server.port)
                result.generations.append(report)
                if report.outcome == "ok":
                    self._log(f"done: {result.summary()}")
                    return result
                if report.outcome == "preemption":
                    result.preemptions += 1
                    if self._external_preempt:
                        self._log(
                            "preempted from outside; state saved — exiting "
                            "without relaunch: " + result.summary()
                        )
                        return result
                    if result.preemptions > self.max_preemptions:
                        raise RestartBudgetExceeded(
                            f"more than {self.max_preemptions} preemptions; "
                            "refusing to thrash: " + result.summary(),
                            result,
                        )
                    delay = self.backoff  # prompt, no exponential ramp
                else:  # failure / wedged: charge the budget
                    result.restarts_charged += 1
                    if result.restarts_charged > self.max_restarts:
                        raise RestartBudgetExceeded(
                            f"rank(s) {report.culprits} {report.outcome} in "
                            f"generation {gen} and the restart budget "
                            f"({self.max_restarts}) is spent: "
                            + result.summary(),
                            result,
                        )
                    delay = min(
                        self.backoff * (2 ** (result.restarts_charged - 1)),
                        self.backoff_max,
                    )
                self._log(
                    f"generation {gen} {report.outcome} "
                    f"(culprit rank(s) {report.culprits}, exit codes "
                    f"{report.exit_codes}); relaunching in {delay:.1f}s "
                    f"[{result.restarts_charged}/{self.max_restarts} "
                    f"restarts charged, {result.preemptions} preemption(s)]"
                )
                time.sleep(delay)
        finally:
            if prev_handler is not None:
                try:
                    signal.signal(signal.SIGTERM, prev_handler)
                except ValueError:
                    pass
            kv.close()
            if self._owns_server:
                server.stop()



def main_argv_for_rank(base: Sequence[str], rank: int) -> list[str]:
    """Tiny helper for builders: ``base + ["--rank", str(rank)]``."""
    return [*base, "--rank", str(rank)]
