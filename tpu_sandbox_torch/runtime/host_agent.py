"""Cross-host elastic supervision: per-host agents + an elected leader.
The port's copy of ``tpu_sandbox/runtime/host_agent.py``: the same KV
schema, ``TPU_SANDBOX_*`` environment and exit code 75, so either
package's agents drive either package's ranks.

The single-host Supervisor (runtime/supervisor.py) owns the KV store and
Popens every rank locally, so a real multi-host job dies with the first
*host*. This module splits that role in two:

- :class:`HostAgent` — one per host. Spawns and monitors only its LOCAL
  ranks (through the shared :class:`~tpu_sandbox_torch.runtime.supervisor
  .RankGroup`, with PR_SET_PDEATHSIG so agent death kills its ranks like a
  machine vanishing), publishes an agent-level heartbeat
  (``agent_hb/<id>``), executes generation commands it reads from the KV
  store, and reports local outcomes. Every agent also participates in
  leader election (runtime/election.py).

- the **leader** — whichever agent currently holds the lease. It drives the
  generation lifecycle as KV commands with per-host acks under deadlines
  and charges the restart/preemption budget through central KV counters,
  so host loss, agent death, and rank death all funnel into one
  teardown→relaunch state machine. Leadership is soft state: a new leader
  reconstructs everything it needs (current generation, whether teardown
  was posted, which acks/reports landed, what was already charged) from
  the store, which is what makes leader death mid-generation survivable.

KV schema (all under the job's namespace — bare keys for the default job,
``job/<id>/``-prefixed for every other job; see kvstore.for_job)::

    elastic/generation          current generation number (int)
    gen/<n>/launch              launch command {world_size, at_gen, assign}
                                where assign is the rank-assignment table
                                {agent_id: [ranks...]} (heterogeneous hosts:
                                world_size need not divide by num_agents)
    gen/<n>/coordinator         torch.distributed rendezvous port, set by
                                rank-0's agent
    gen/<n>/ack/launch/<a>      agent <a> spawned its ranks for gen n
    gen/<n>/teardown            teardown command {reason, kind}
    gen/<n>/ack/teardown/<a>    agent <a>'s local ranks are down {exit_codes}
    gen/<n>/report/<a>          agent <a>'s local outcome
                                {outcome, exit_codes, culprits}
    agent_hb/<a>                agent liveness stamp
    agent/cmd/<a>               fault mailbox (runtime/faults.py)
    budget/restarts             charged restarts (atomic counter)
    budget/preemptions          uncharged preemptions (atomic counter)
    budget/claim/<n>            add()-wins guard: generation n charged once,
                                even across a leader failover mid-resolution
    job/done                    terminal verdict {ok, preempted, reason}

One machine stands in for N hosts by running N agent *processes*
(:class:`AgentLauncher` — it owns the KV server and respawns dead agents,
playing the cluster scheduler). Nothing in the agent itself assumes
colocation except the KV server's loopback bind (see ROADMAP follow-ups).
"""

from __future__ import annotations

import json
import os
import signal
import socket
import time
from dataclasses import dataclass
from typing import Callable, Mapping, Sequence

from tpu_sandbox_torch.obs import get_recorder
from tpu_sandbox_torch.runtime.election import LeaseElection
from tpu_sandbox_torch.runtime.faults import agent_cmd_key
from tpu_sandbox_torch.runtime.kvstore import (
    ENV_JOB_ID,
    DEFAULT_JOB,
    KVClient,
    KVServer,
    for_job,
)
from tpu_sandbox_torch.runtime.supervisor import (
    ENV_GENERATION,
    ENV_KV_PORT,
    PREEMPT_KEY,
    PREEMPTED_EXIT_CODE,
    RankGroup,
)
from tpu_sandbox_torch.runtime.watchdog import Heartbeat, Watchdog, _hb_key

ENV_AGENT_ID = "TPU_SANDBOX_AGENT_ID"

K_GENERATION = "elastic/generation"
K_JOB_DONE = "job/done"
K_RESTARTS = "budget/restarts"
K_PREEMPTIONS = "budget/preemptions"


def _agent_hb_key(agent_id: int) -> str:
    return f"agent_hb/{agent_id}"


def k_launch(gen: int) -> str:
    return f"gen/{gen}/launch"


def k_coordinator(gen: int) -> str:
    return f"gen/{gen}/coordinator"


def k_launch_ack(gen: int, agent_id: int) -> str:
    return f"gen/{gen}/ack/launch/{agent_id}"


def k_teardown(gen: int) -> str:
    return f"gen/{gen}/teardown"


def k_teardown_ack(gen: int, agent_id: int) -> str:
    return f"gen/{gen}/ack/teardown/{agent_id}"


def k_report(gen: int, agent_id: int) -> str:
    return f"gen/{gen}/report/{agent_id}"


def k_charge_claim(gen: int) -> str:
    return f"budget/claim/{gen}"


def assign_ranks(world_size: int, num_agents: int) -> list[list[int]]:
    """Balanced contiguous rank blocks for heterogeneous gangs.

    ``world_size`` need not divide evenly: the first ``world % agents``
    agents take one extra rank (e.g. world 3 on 2 hosts -> [[0, 1], [2]]).
    Contiguity is load-bearing — rank 0 (the rendezvous host)
    always lands on agent 0, and checkpoint shard locality per host stays
    a contiguous slice. Every agent gets at least one rank: a host with
    nothing to run can't ack launches, so an over-provisioned gang is an
    admission-time error, not a silent idle host."""
    if num_agents < 1:
        raise ValueError(f"num_agents must be >= 1, got {num_agents}")
    if world_size < num_agents:
        raise ValueError(
            f"world_size {world_size} < {num_agents} agents: every host "
            "must own at least one rank"
        )
    base, extra = divmod(world_size, num_agents)
    blocks, start = [], 0
    for a in range(num_agents):
        n = base + (1 if a < extra else 0)
        blocks.append(list(range(start, start + n)))
        start += n
    return blocks


def ranks_for_agent(agent_id: int, num_agents: int, world_size: int
                    ) -> list[int]:
    """Contiguous rank block for one agent (see :func:`assign_ranks`)."""
    return assign_ranks(world_size, num_agents)[agent_id]


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@dataclass
class AgentConfig:
    agent_id: int
    num_agents: int
    world_size: int
    kv_port: int
    kv_host: str = "127.0.0.1"
    heartbeat_interval: float = 0.5
    heartbeat_timeout: float = 60.0   # rank wedge detection (leader-side)
    agent_timeout: float = 10.0       # agent/host wedge detection
    grace: float = 180.0              # rank startup grace (torch import etc.)
    lease_ttl: float = 3.0
    poll: float = 0.05
    term_timeout: float = 30.0        # SIGTERM→SIGKILL escalation for ranks
    ack_timeout: float = 60.0         # teardown-ack deadline
    agent_wait: float = 120.0         # relaunch gate: wait for agents alive
    max_restarts: int = 3
    max_preemptions: int = 32
    backoff: float = 1.0
    backoff_max: float = 30.0
    verbose: bool = True
    # Multi-tenancy: which job's KV namespace this agent lives in. The
    # default job keeps the historical bare key schema; any other id puts
    # every key (election, budgets, generations, heartbeats, fault claims)
    # under job/<id>/ so concurrent jobs on one store cannot collide.
    job_id: str = ""

    @property
    def local_ranks(self) -> list[int]:
        return ranks_for_agent(self.agent_id, self.num_agents,
                               self.world_size)


class _LeaderState:
    """Leader-only soft state, rebuilt from the store on takeover. Nothing
    here is authoritative: a fresh leader starting from zero re-reads the
    generation, teardown, acks, reports, and the charge claim, and resumes
    exactly where the dead leader stopped."""

    def __init__(self):
        self.rank_watchdog: Watchdog | None = None
        self.agent_watchdog: Watchdog | None = None
        self.resolved_gen = 0         # highest gen whose outcome we handled
        self.teardown_deadline: dict[int, float] = {}
        self.next_launch_at = 0.0
        self.gate_deadline: dict[int, float] = {}


class HostAgent:
    """One host's member of the elastic job; see the module docstring.

    ``rank_commands(generation, rank, coordinator_port) -> argv`` builds
    the worker command for one LOCAL rank; each worker additionally
    inherits ``TPU_SANDBOX_KV_PORT``, ``TPU_SANDBOX_GENERATION`` and
    ``TPU_SANDBOX_AGENT_ID`` on top of ``os.environ`` and ``extra_env``.

    ``run()`` blocks until the job reaches a terminal verdict and returns
    the agent's exit code: 0 (job ok), 1 (job failed), or
    :data:`PREEMPTED_EXIT_CODE` (whole job preempted; state saved).
    """

    def __init__(
        self,
        config: AgentConfig,
        rank_commands: Callable[[int, int, int], Sequence[str]],
        *,
        extra_env: Mapping[str, str] | None = None,
    ):
        self.cfg = config
        self.rank_commands = rank_commands
        self.extra_env = dict(extra_env or {})
        self.aid = config.agent_id
        self.kv: KVClient | None = None
        self.hb: Heartbeat | None = None
        self.election: LeaseElection | None = None
        self.group = RankGroup(
            term_timeout=config.term_timeout, kill_on_parent_death=True
        )
        self._spawned_gen = 0
        self._spawned_ranks: list[int] = list(config.local_ranks)
        self._reported_gen = 0
        self._acked_teardown_gen = 0
        self._partition_until = 0.0
        self._external_preempt = False
        self._leader_state: _LeaderState | None = None
        # bias the first election toward agent 0 (deterministic tests, and
        # no thundering claim herd at job start); failover is unaffected —
        # the bias lapses once the agent has been alive for ~a lease ttl
        self._candidacy_after = time.monotonic() + (
            0.0 if self.aid == 0 else config.lease_ttl + 1.0
        )

    # -- logging ------------------------------------------------------------

    def _log(self, msg: str) -> None:
        if self.cfg.verbose:
            print(f"[agent {self.aid}] {msg}", flush=True)

    # -- the agent loop -----------------------------------------------------

    def run(self) -> int:
        cfg = self.cfg
        # All of this agent's KV traffic — election included — goes through
        # the job-scoped view, so two jobs sharing one store elect separate
        # leaders, charge separate budgets, and sweep separate namespaces.
        self.kv = for_job(KVClient(cfg.kv_host, cfg.kv_port), cfg.job_id)
        self.election = LeaseElection(
            self.kv, self.aid, ttl=cfg.lease_ttl, prefix="leader"
        )
        self.hb = Heartbeat(
            self.kv, self.aid, cfg.heartbeat_interval,
            key=_agent_hb_key(self.aid),
        ).start()
        prev_handler = self._install_forwarder()
        self._log(
            f"up: ranks {cfg.local_ranks} of world {cfg.world_size} "
            f"({cfg.num_agents} agents)"
        )
        try:
            while True:
                if self._partition_tick():
                    time.sleep(cfg.poll)
                    continue
                self._poll_fault_cmd()
                verdict = self.kv.try_get(K_JOB_DONE)
                if verdict is not None:
                    return self._finish(json.loads(verdict))
                leading = self.election.step(
                    candidate=time.monotonic() >= self._candidacy_after
                )
                if leading and self._leader_state is None:
                    self._leader_state = _LeaderState()
                    self._log(
                        f"elected leader (term {self.election.term})"
                    )
                elif not leading and self._leader_state is not None:
                    self._leader_state = None
                    self._log("deposed (a newer leader established itself)")
                self._agent_tick()
                if leading:
                    self._leader_tick()
                time.sleep(cfg.poll)
        finally:
            try:
                if self.group.running:
                    self.group.teardown()
            finally:
                if prev_handler is not None:
                    try:
                        signal.signal(signal.SIGTERM, prev_handler)
                    except ValueError:
                        pass
                self.hb.stop()
                self.kv.close()

    def _finish(self, verdict: dict) -> int:
        if self.group.running:
            self.group.teardown()
        self._log(f"job done: {verdict.get('reason', '')}".rstrip(": "))
        if verdict.get("ok"):
            return 0
        return PREEMPTED_EXIT_CODE if verdict.get("preempted") else 1

    def _install_forwarder(self):
        """A SIGTERM to the agent is the whole host being preempted:
        forward it to the local ranks (their PreemptionHandler saves and
        exits 75) and remember, so a leader among us reports the job
        preempted instead of relaunching."""
        def fwd(signum, frame):
            self._external_preempt = True
            self.group.terminate_all()
        try:
            return signal.signal(signal.SIGTERM, fwd)
        except ValueError:
            return None  # not the main thread (in-process tests)

    # -- fault mailbox ------------------------------------------------------

    def _poll_fault_cmd(self) -> None:
        raw = self.kv.try_get(agent_cmd_key(self.aid))
        if raw is None:
            return
        self.kv.delete(agent_cmd_key(self.aid))
        cmd = json.loads(raw)
        action = cmd.get("action")
        if action == "kill_agent":
            self._log("fault: kill_agent — dying uncleanly (SIGKILL self; "
                      "pdeathsig takes the local ranks with us)")
            # last words for the postmortem: instants flush to disk, so
            # the merged timeline shows the kill even though nothing of
            # this process survives the next line
            rec = get_recorder()
            rec.instant("fault:kill_agent", args={"agent": self.aid})
            rec.flush()
            os.kill(os.getpid(), signal.SIGKILL)
        elif action == "partition_host":
            dur = float(cmd.get("arg") or 5.0)
            get_recorder().instant("fault:partition_host",
                                   args={"agent": self.aid, "duration": dur})
            self._log(
                f"fault: partition_host — silent toward the KV store for "
                f"{dur:.1f}s (local ranks keep running)"
            )
            self.hb.stop()  # the beat thread must go silent too
            self._partition_until = time.monotonic() + dur
        else:
            self._log(f"ignoring unknown agent command {action!r}")

    def _partition_tick(self) -> bool:
        """True while the simulated partition holds (all KV traffic,
        including heartbeats and election, is suppressed)."""
        if not self._partition_until:
            return False
        if time.monotonic() < self._partition_until:
            self.group.poll()  # keep watching local ranks; can't report yet
            return True
        self._partition_until = 0.0
        self._log("partition healed; rejoining the control plane")
        self.hb.start()
        return False

    # -- per-agent duties (every agent, leader included) --------------------

    def _current_gen(self) -> int:
        raw = self.kv.try_get(K_GENERATION)
        return 0 if raw is None else int(raw)

    def _gen_assignment(self, gen: int) -> dict[int, list[int]]:
        """The generation's rank-assignment table, read from the launch
        record the leader published. Pre-table records (or a record that
        hasn't landed yet) fall back to the config-derived split — both
        sides compute :func:`assign_ranks` deterministically, so the
        fallback agrees with what the table would have said."""
        raw = self.kv.try_get(k_launch(gen))
        if raw is not None:
            table = json.loads(raw).get("assign")
            if table:
                return {int(a): [int(r) for r in rs]
                        for a, rs in table.items()}
        blocks = assign_ranks(self.cfg.world_size, self.cfg.num_agents)
        return dict(enumerate(blocks))

    def _agent_tick(self) -> None:
        gen = self._current_gen()
        if gen == 0:
            return
        if self.kv.try_get(k_teardown(gen)) is not None:
            self._ack_teardown(gen)
            return
        if self.kv.try_get(k_launch(gen)) is None:
            return
        if self._spawned_gen != gen:
            self._maybe_spawn(gen)
            return
        self._monitor_local(gen)

    def _ack_teardown(self, gen: int) -> None:
        if self._acked_teardown_gen == gen:
            return
        codes: list[int | None] = []
        if len(self.group) and (self.group.running
                                or self._spawned_gen == gen):
            # kill whatever local ranks exist — even ones from an OLDER
            # generation (a partition can strand us with zombies the rest
            # of the job already moved past); the ack below is the leader's
            # guarantee that this host carries nothing into the next gen
            final = self.group.teardown()
            if self._spawned_gen == gen:
                codes = final
            self._log(
                f"gen {gen}: teardown complete, local exit codes {final}"
            )
        self.kv.set(
            k_teardown_ack(gen, self.aid),
            json.dumps({"exit_codes": codes}),
        )
        self._acked_teardown_gen = gen

    def _maybe_spawn(self, gen: int) -> None:
        cfg = self.cfg
        ranks = self._gen_assignment(gen).get(self.aid, cfg.local_ranks)
        if self.kv.try_get(k_launch_ack(gen, self.aid)) is not None:
            # a previous incarnation of this agent acked this generation and
            # died; pdeathsig killed its ranks with it. Report the loss so
            # the leader tears down fast instead of waiting out a heartbeat
            # timeout on ranks that will never speak again.
            if (self._reported_gen != gen
                    and self.kv.try_get(k_report(gen, self.aid)) is None):
                self._report(gen, "failure", {}, ranks,
                             note="agent restarted; local ranks lost")
            self._reported_gen = gen
            return
        if 0 in ranks:
            # rank 0 lives here: its host picks the torch.distributed
            # rendezvous port (must be free on THIS machine) and publishes
            # it for everyone
            port = _free_port()
            self.kv.set(k_coordinator(gen), str(port))
        else:
            raw = self.kv.try_get(k_coordinator(gen))
            if raw is None:
                return  # rank-0's agent hasn't published yet; retry
            port = int(raw)
        env = dict(os.environ)
        env.update(self.extra_env)
        env[ENV_KV_PORT] = str(cfg.kv_port)
        env[ENV_GENERATION] = str(gen)
        env[ENV_AGENT_ID] = str(self.aid)
        env[ENV_JOB_ID] = cfg.job_id or DEFAULT_JOB
        cmds = [
            list(self.rank_commands(gen, r, port)) for r in ranks
        ]
        self.group.spawn(cmds, env)
        self._spawned_gen = gen
        self._spawned_ranks = list(ranks)
        self._reported_gen = 0
        self.kv.set(k_launch_ack(gen, self.aid), b"1")
        self._log(f"gen {gen}: spawned local rank(s) {ranks}")

    def _monitor_local(self, gen: int) -> None:
        if self._reported_gen == gen:
            return
        codes = self.group.poll()
        ranks = self._spawned_ranks
        culprits = [r for r, c in zip(ranks, codes) if c not in (None, 0)]
        if culprits:
            # initiator-only classification (same rule as the Supervisor):
            # only pre-teardown exits decide preemption vs failure
            preempted = all(
                c == PREEMPTED_EXIT_CODE
                for r, c in zip(ranks, codes) if r in culprits
            )
            outcome = "preemption" if preempted else "failure"
            self._report(gen, outcome, dict(zip(ranks, codes)), culprits)
        elif all(c == 0 for c in codes):
            self._report(gen, "ok", dict(zip(ranks, codes)), [])

    def _report(self, gen: int, outcome: str, codes: dict, culprits: list,
                note: str = "") -> None:
        self.kv.set(
            k_report(gen, self.aid),
            json.dumps({
                "outcome": outcome, "culprits": culprits, "note": note,
                "exit_codes": {str(r): c for r, c in codes.items()},
            }),
        )
        self._reported_gen = gen
        self._log(f"gen {gen}: local outcome {outcome}"
                  + (f" (culprits {culprits})" if culprits else ""))

    # -- leader duties ------------------------------------------------------

    def _leader_tick(self) -> None:
        # Re-verify leadership: _agent_tick may have blocked in a rank
        # teardown for longer than the lease TTL, in which case a peer has
        # legitimately taken over and acting now would be a stale leader
        # mutating shared state (the classic fencing problem).
        if not self.election.step(candidate=False):
            self._leader_state = None
            self._log("deposed (a newer leader established itself)")
            return
        st = self._leader_state
        gen = self._current_gen()
        if gen == 0:
            self._reset_job_plane()
            self._advance_generation(1)
            return
        if self.kv.try_get(k_teardown(gen)) is None:
            if self.kv.try_get(k_launch(gen)) is None:
                # predecessor died between bumping the generation and
                # publishing the launch; no ranks exist yet, so publishing
                # (with a fresh health plane) is safe and unblocks everyone
                self._publish_generation(gen)
                return
            self._monitor_generation(gen, st)
        else:
            if st.resolved_gen < gen:
                self._maybe_resolve(gen, st)
            if st.resolved_gen >= gen:
                self._maybe_relaunch(gen, st)

    def _reset_job_plane(self) -> None:
        """Job-start sweep (mirrors Supervisor._reset_job_plane): stale
        fault claims or commit claims from a previous job on a long-lived
        external store must not bleed into this one."""
        self.kv.delete_prefix("fault/")
        self.kv.delete_prefix("ckpt/")

    def _reset_health_plane(self) -> None:
        for r in range(self.cfg.world_size):
            self.kv.delete(_hb_key(r))
            self.kv.delete(f"rendezvous/gen/{r}")
        self.kv.delete(PREEMPT_KEY)
        self.kv.delete_prefix("ckpt/")

    def _advance_generation(self, gen: int) -> None:
        get_recorder().instant("generation:advance", args={"gen": gen})
        self.kv.set(K_GENERATION, str(gen))
        self._publish_generation(gen)

    def _publish_generation(self, gen: int) -> None:
        get_recorder().instant("generation:publish", args={"gen": gen})
        st = self._leader_state
        self._reset_health_plane()
        self.kv.delete(k_coordinator(gen))
        blocks = assign_ranks(self.cfg.world_size, self.cfg.num_agents)
        # the rank-assignment table rides in the launch record: agents
        # spawn exactly the ranks the leader assigned them, so world sizes
        # that don't divide by the host count gang-schedule cleanly
        self.kv.set(
            k_launch(gen),
            json.dumps({
                "world_size": self.cfg.world_size, "at_gen": gen,
                "assign": {str(a): rs for a, rs in enumerate(blocks)},
            }),
        )
        st.rank_watchdog = st.agent_watchdog = None  # fresh grace per gen
        self._ensure_watchdogs(st)
        sizes = "+".join(str(len(b)) for b in blocks)
        self._log(
            f"gen {gen}: launch posted "
            f"({self.cfg.num_agents} host(s), rank split {sizes})"
        )

    def _ensure_watchdogs(self, st: _LeaderState) -> None:
        """Leadership taken over mid-generation (or mid-teardown): rebuild
        the observers. Their grace restarts, trading a little detection
        latency for never flagging a stamp the new leader hasn't watched."""
        if st.rank_watchdog is None:
            st.rank_watchdog = Watchdog(
                self.kv, self.cfg.world_size,
                timeout=self.cfg.heartbeat_timeout, grace=self.cfg.grace,
            )
        if st.agent_watchdog is None:
            st.agent_watchdog = Watchdog(
                self.kv, self.cfg.num_agents,
                timeout=self.cfg.agent_timeout,
                grace=max(self.cfg.agent_timeout, 30.0),
                key_fn=_agent_hb_key,
            )

    def _reports(self, gen: int) -> dict[int, dict]:
        out = {}
        for a in range(self.cfg.num_agents):
            raw = self.kv.try_get(k_report(gen, a))
            if raw is not None:
                out[a] = json.loads(raw)
        return out

    def _monitor_generation(self, gen: int, st: _LeaderState) -> None:
        reports = self._reports(gen)
        bad = {a: r for a, r in reports.items() if r["outcome"] != "ok"}
        if bad:
            a, r = next(iter(sorted(bad.items())))
            self._post_teardown(
                gen, kind=r["outcome"],
                reason=(f"agent {a} reported {r['outcome']} "
                        f"(culprit rank(s) {r['culprits']}"
                        + (f"; {r['note']}" if r.get("note") else "") + ")"),
            )
            return
        if len(reports) == self.cfg.num_agents:
            self._post_job_done(ok=True, reason="all ranks finished")
            return
        self._ensure_watchdogs(st)
        # Wedged RANKS: only frozen stamps count (a key that disappeared is
        # a clean deregister; a rank that dies pre-first-beat surfaces as an
        # exit code in its agent's report instead). Ranks of agents that
        # already reported are done, not wedged.
        owner = {
            r: a for a, ranks in self._gen_assignment(gen).items()
            for r in ranks
        }
        health = st.rank_watchdog.check()
        wedged = [
            h.rank for h in health
            if not h.alive and h.age is not None and owner[h.rank] not in
            reports
        ]
        if wedged:
            ages = {h.rank: round(h.age, 1) for h in health
                    if h.rank in wedged}
            self._post_teardown(
                gen, kind="wedged",
                reason=(f"rank(s) {wedged} stopped heartbeating "
                        f"(stamp ages {ages}, timeout "
                        f"{self.cfg.heartbeat_timeout}s)"),
            )
            return
        # Wedged AGENTS (host dead or partitioned): silent toward the store
        # for > agent_timeout with no final report. Their ranks may look
        # perfectly healthy — that is the case only this check can see.
        ahealth = st.agent_watchdog.check()
        silent = [h.rank for h in ahealth
                  if not h.alive and h.rank not in reports]
        if silent:
            ages = {h.rank: (round(h.age, 1) if h.age is not None else None)
                    for h in ahealth if h.rank in silent}
            self._post_teardown(
                gen, kind="wedged",
                reason=(f"agent(s) {silent} silent for "
                        f">{self.cfg.agent_timeout}s (stamp ages {ages}) — "
                        "host dead or partitioned"),
            )

    def _post_teardown(self, gen: int, *, kind: str, reason: str) -> None:
        self._log(f"gen {gen}: teardown ({reason})")
        self.kv.set(
            k_teardown(gen), json.dumps({"kind": kind, "reason": reason})
        )

    def _maybe_resolve(self, gen: int, st: _LeaderState) -> None:
        deadline = st.teardown_deadline.setdefault(
            gen, time.monotonic() + self.cfg.ack_timeout
        )
        acks = [
            a for a in range(self.cfg.num_agents)
            if self.kv.try_get(k_teardown_ack(gen, a)) is not None
        ]
        if len(acks) < self.cfg.num_agents and time.monotonic() < deadline:
            return
        # non-blocking: _maybe_resolve only runs after _post_teardown wrote
        # the record, but a blocking get() here would park the leader past
        # its lease TTL if the store hiccups — re-observe next tick instead
        raw_td = self.kv.try_get(k_teardown(gen))
        if raw_td is None:
            return
        td = json.loads(raw_td)
        reports = self._reports(gen)
        outcomes = {r["outcome"] for r in reports.values()}
        if "failure" in outcomes:
            outcome = "failure"
        elif "preemption" in outcomes:
            outcome = "preemption"
        elif td["kind"] == "wedged":
            outcome = "wedged"
        else:
            outcome = "failure"
        charged = self.kv.add(k_charge_claim(gen), 1) == 1
        if outcome == "preemption":
            preemptions = (self.kv.add(K_PREEMPTIONS, 1) if charged
                           else int(self.kv.try_get(K_PREEMPTIONS) or 0))
            restarts = int(self.kv.try_get(K_RESTARTS) or 0)
            if self._external_preempt:
                self._post_job_done(
                    ok=False, preempted=True,
                    reason="preempted from outside; state saved — exiting "
                           "without relaunch",
                )
                return
            if preemptions > self.cfg.max_preemptions:
                self._post_job_done(
                    ok=False,
                    reason=(f"more than {self.cfg.max_preemptions} "
                            "preemptions; refusing to thrash"),
                )
                return
            delay = self.cfg.backoff  # prompt, no exponential ramp
        else:
            restarts = (self.kv.add(K_RESTARTS, 1) if charged
                        else int(self.kv.try_get(K_RESTARTS) or 0))
            preemptions = int(self.kv.try_get(K_PREEMPTIONS) or 0)
            if restarts > self.cfg.max_restarts:
                self._post_job_done(
                    ok=False,
                    reason=(f"generation {gen} {outcome} ({td['reason']}) "
                            f"and the restart budget "
                            f"({self.cfg.max_restarts}) is spent"),
                )
                return
            delay = min(
                self.cfg.backoff * (2 ** max(restarts - 1, 0)),
                self.cfg.backoff_max,
            )
        st.resolved_gen = gen
        st.next_launch_at = time.monotonic() + delay
        st.gate_deadline[gen] = (
            time.monotonic() + delay + self.cfg.agent_wait
        )
        self._log(
            f"gen {gen} {outcome} ({td['reason']}); acks {acks}; "
            f"relaunching in >={delay:.1f}s "
            f"[{restarts}/{self.cfg.max_restarts} restarts charged"
            + (" +1 this gen" if charged and outcome != "preemption" else "")
            + f", {preemptions} preemption(s)]"
        )

    def _maybe_relaunch(self, gen: int, st: _LeaderState) -> None:
        if time.monotonic() < st.next_launch_at:
            return
        # Relaunch gate: every agent must (a) have acked the teardown — its
        # local ranks are genuinely dead, so a partitioned host's zombies
        # can't beat into the next generation's health plane — and (b) be
        # heartbeating right now, so the new generation has a full world.
        self._ensure_watchdogs(st)
        ahealth = {h.rank: h for h in st.agent_watchdog.check()}
        waiting = [
            a for a in range(self.cfg.num_agents)
            if self.kv.try_get(k_teardown_ack(gen, a)) is None
            or not ahealth[a].alive
        ]
        if waiting:
            if time.monotonic() > st.gate_deadline.get(gen, 0.0):
                self._post_job_done(
                    ok=False,
                    reason=(f"agent(s) {waiting} never returned after the "
                            f"gen-{gen} teardown (waited "
                            f"{self.cfg.agent_wait:.0f}s); a replacement "
                            "host is required"),
                )
            return
        self._advance_generation(gen + 1)

    def _post_job_done(self, *, ok: bool, preempted: bool = False,
                       reason: str = "") -> None:
        gens = self._current_gen()
        restarts = int(self.kv.try_get(K_RESTARTS) or 0)
        preemptions = int(self.kv.try_get(K_PREEMPTIONS) or 0)
        summary = (
            f"{gens} generation(s); {restarts} restart(s) charged, "
            f"{preemptions} preemption(s)"
        )
        self._log(f"done ({'ok' if ok else 'failed'}): {reason} — {summary}")
        self.kv.set(
            K_JOB_DONE,
            json.dumps({
                "ok": ok, "preempted": preempted,
                "reason": reason, "summary": summary,
                "restarts": restarts, "preemptions": preemptions,
                "generations": gens,
            }),
        )


class AgentLauncher:
    """Single-machine, single-job agent runner: owns the KV server, spawns
    one agent process per simulated host, and replaces any agent that dies
    before the job's terminal verdict (a real scheduler rescheduling a
    lost host). The launcher has NO job knowledge — all coordination lives
    in the agents; killing the launcher's children in any order must never
    deadlock the job. The multi-job promotion of this class is
    :class:`tpu_sandbox_torch.runtime.scheduler.ClusterScheduler` (durable
    queue, gang scheduling, priority preemption); this one stays as the
    zero-ceremony path for one job on one machine.

    ``agent_command(agent_id, kv_port) -> argv`` builds one agent process's
    command line.
    """

    def __init__(
        self,
        num_agents: int,
        agent_command: Callable[[int, int], Sequence[str]],
        *,
        kv_server: KVServer | None = None,
        respawn_limit: int = 16,
        poll: float = 0.1,
        drain_timeout: float = 60.0,
        extra_env: Mapping[str, str] | None = None,
        verbose: bool = True,
    ):
        if num_agents < 1:
            raise ValueError(f"num_agents must be >= 1, got {num_agents}")
        self.num_agents = num_agents
        self.agent_command = agent_command
        self._kv_server = kv_server
        self._owns_server = kv_server is None
        self.respawn_limit = respawn_limit
        self.poll = poll
        self.drain_timeout = drain_timeout
        self.extra_env = dict(extra_env or {})
        self.verbose = verbose
        self.respawns = 0

    def _log(self, msg: str) -> None:
        if self.verbose:
            print(f"[launcher] {msg}", flush=True)

    def run(self) -> int:
        import subprocess

        server = self._kv_server or KVServer()
        kv = KVClient(port=server.port)
        env = dict(os.environ)
        env.update(self.extra_env)
        procs: dict[int, subprocess.Popen] = {}

        def spawn(aid: int):
            procs[aid] = subprocess.Popen(
                list(self.agent_command(aid, server.port)), env=env
            )

        def forward(signum, frame):
            for p in procs.values():
                if p.poll() is None:
                    try:
                        p.terminate()
                    except OSError:
                        pass
        try:
            prev = signal.signal(signal.SIGTERM, forward)
        except ValueError:
            prev = None
        try:
            for a in range(self.num_agents):
                spawn(a)
            self._log(f"spawned {self.num_agents} host agent(s), "
                      f"kv port {server.port}")
            while True:
                verdict = kv.try_get(K_JOB_DONE)
                if verdict is not None:
                    return self._drain(json.loads(verdict), procs)
                for a, p in list(procs.items()):
                    code = p.poll()
                    if code is None:
                        continue
                    if kv.try_get(K_JOB_DONE) is not None:
                        break  # verdict just landed; drain on next pass
                    self.respawns += 1
                    if self.respawns > self.respawn_limit:
                        self._log(
                            f"agent {a} died (exit {code}) and the respawn "
                            f"limit ({self.respawn_limit}) is spent; "
                            "aborting the job"
                        )
                        for q in procs.values():
                            if q.poll() is None:
                                q.kill()
                        return 1
                    self._log(
                        f"agent {a} died (exit {code}); respawning "
                        f"[{self.respawns}/{self.respawn_limit}]"
                    )
                    spawn(a)
                time.sleep(self.poll)
        finally:
            if prev is not None:
                try:
                    signal.signal(signal.SIGTERM, prev)
                except ValueError:
                    pass
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
            kv.close()
            if self._owns_server:
                server.stop()

    def _drain(self, verdict: dict, procs) -> int:
        """Job verdict posted: let the agents see it and exit on their own
        (they clean their ranks), then report the verdict's exit code."""
        deadline = time.monotonic() + self.drain_timeout
        for p in procs.values():
            while p.poll() is None and time.monotonic() < deadline:
                time.sleep(self.poll)
            if p.poll() is None:
                p.kill()
                p.wait()
        ok = verdict.get("ok", False)
        self._log(
            f"job {'ok' if ok else 'FAILED'}: "
            f"{verdict.get('reason', '')} — {verdict.get('summary', '')}"
        )
        if ok:
            return 0
        return PREEMPTED_EXIT_CODE if verdict.get("preempted") else 1
