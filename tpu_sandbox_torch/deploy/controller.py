"""Leader-elected deployment controller: rolling weight swaps, canary
analysis, automatic rollback — exactly-once through controller death.
The port's copy of ``tpu_sandbox/deploy/controller.py``: the same keys and
events, so either package's controller rolls out to either's replicas.

Any number of :class:`DeployController` candidates may run; a
``LeaseElection`` on ``deploy/leader/<fleet>`` picks one actor per fleet
(the autoscaler pattern). The leader's tick reconstructs the entire
rollout state from the store alone, so a successor resumes mid-rollout
with nothing but the registry keys:

1. **consider** — with no rollout active, the highest registered version
   above the fleet target is the candidate. Its artifact is re-verified
   on disk (``verify_step_dir``) FIRST: a torn or corrupt export gets a
   claim-once ``reject`` record and no replica is ever told about it.
   A clean candidate gets the claim-once ``rec`` begin record.
2. **canary** — the least-loaded live replica by fresh load report
   (queued + active work; ties and report-less fleets fall back to tag
   order; the choice is persisted in the rollout's phase records so it
   neither flaps nor changes across controller failover) receives a
   ``swap`` command through its ``serve/cmd/<tag>`` mailbox (idempotent,
   re-sent with local patience until the replica's TTL load report acks
   the new version; the replica stages the artifact chunk-streamed —
   ``runtime.staging`` via ``registry.load_step_params`` — after its
   verify-before-touch checksum pass, so a swap never doubles host
   memory mid-roll). Once acked, version-pinned traffic shares go up for
   the gateway (``deploy/shares/<fleet>``) and two
   :class:`~tpu_sandbox_torch.obs.health.BaselineDeltaRule` instances compare
   the canary's p99 TTFT and mean chosen-token logprob in the tsdb
   against the incumbent replicas. ``regress_streak`` consecutive firing
   evaluations -> claim-once FAIL verdict (+ a ``canary_regression``
   health alert); ``canary_evals`` clean evaluations **with data on both
   sides** -> claim-once PASS.
3. **roll / rollback** — on PASS the remaining replicas swap one at a
   time (the controller advances only on the acked load report); on FAIL
   every swapped replica converges back to the previous version by the
   same one-at-a-time protocol. Either way the shares key is cleared,
   the target is (re)established, and a claim-once ``done`` record ends
   the rollout.

Every decision follows the ``raise_alert`` ordering — idempotent record
``set`` first, ``add()``-gated claim second — so a controller killed
between the two leaves state a successor completes without double-firing
(the claim gates events/counters; records may be rewritten with a fresh
wall stamp, which is informational only).

Leader-local state (canary streaks, swap-command patience stamps) resets
on failover; like the health monitor's detectors, a successor rebuilds
it within one evaluation window — which is why the acceptance bound is
rollback within 2 windows, not 1.
"""

from __future__ import annotations

import json
import time
from dataclasses import dataclass

from tpu_sandbox_torch.deploy.registry import (append_event,
                                               current_target, fleet_label,
                                               k_ro, k_shares, k_target,
                                               registry_versions,
                                               rollout_phase)
from tpu_sandbox_torch.gateway.fleet import fleet_kv
from tpu_sandbox_torch.obs import get_registry
from tpu_sandbox_torch.obs.health import BaselineDeltaRule, raise_alert
from tpu_sandbox_torch.runtime.election import LeaseElection
from tpu_sandbox_torch.serve.replica import k_cmd, read_load_reports


@dataclass(frozen=True)
class DeployConfig:
    #: traffic share routed to the canary while under analysis
    canary_share: float = 0.25
    #: clean evaluations (both sides reporting data) needed to pass
    canary_evals: int = 3
    #: consecutive firing evaluations needed to fail (and roll back)
    regress_streak: int = 2
    #: local patience before re-sending an unacked swap command
    swap_resend_s: float = 1.0
    #: tsdb bucket width the canary rules read
    bucket_s: float = 1.0
    #: alert window for the canary_regression health alert
    window_s: float = 1.0
    alert_ttl_windows: float = 3.0
    #: canary p99 TTFT may not exceed baseline * ttft_ratio (None = off)
    ttft_ratio: float | None = 1.5
    #: canary mean logprob may not fall below baseline + logprob_delta
    #: (delta is negative: how much worse the canary may score; None = off)
    logprob_delta: float | None = -0.5


class DeployController:
    """One candidate's view of the deployment control loop. Call
    :meth:`tick` on a cadence; it is a no-op on non-leaders and returns
    the decision event dict when the leader acted this tick."""

    def __init__(self, kv, *, fleet: str = "", member_id: str = "deploy-0",
                 cfg: DeployConfig = DeployConfig(),
                 election_ttl: float = 3.0, clock=time.time):
        self.kv = kv                       # root store: registry + rollout
        self.skv = fleet_kv(kv, fleet)     # fleet view: serve protocol keys
        self.fleet = fleet
        self.cfg = cfg
        self.clock = clock
        self.election = LeaseElection(
            kv, member_id, ttl=election_ttl,
            prefix=f"deploy/leader/{fleet_label(fleet)}")
        self._clean_evals = 0
        self._regress = 0
        self._last_cmd: dict[tuple[str, int], float] = {}

    # -- control loop --------------------------------------------------------

    def tick(self):
        """One control iteration; returns the decision event dict when
        this tick decided something, else None."""
        if not self.election.step(candidate=True):
            # follower: leader-local canary state must not survive into a
            # later leadership stint with stale evidence
            self._clean_evals = self._regress = 0
            self._last_cmd.clear()
            return None
        return self._leader_tick()

    def _leader_tick(self):
        target = current_target(self.kv, self.fleet)
        versions = registry_versions(self.kv, self.fleet)
        active = self._active_rollout(versions, target)
        if active is None:
            return self._leader_consider(versions, target)
        return self._leader_advance(active, versions)

    def _active_rollout(self, versions: dict[int, dict],
                        target: int) -> dict | None:
        """The unfinished rollout, reconstructed from the store: a ``rec``
        begin record with neither a ``done`` nor a ``reject`` record. At
        most one exists by construction (consider only begins when none
        is active)."""
        for seq in sorted(versions, reverse=True):
            phase = rollout_phase(self.kv, self.fleet, seq)
            if phase["rec"] is not None and phase["done"] is None \
                    and phase["reject"] is None:
                return phase
        return None

    def _leader_consider(self, versions: dict[int, dict], target: int):
        """Pick and begin (or reject) the next candidate version."""
        for seq in sorted(versions, reverse=True):
            if seq <= target:
                break
            phase = rollout_phase(self.kv, self.fleet, seq)
            if phase["done"] is not None or phase["reject"] is not None:
                continue  # already rolled back or rejected: skip forever
            step_dir = versions[seq].get("step_dir", "")
            problems = self._verify_artifact(step_dir)
            if problems:
                # the hard gate: a torn/corrupt artifact never reaches a
                # replica — no swap command exists for a rejected version
                return self._decide(
                    seq, "reject", "rejclaim",
                    {"ver": seq, "step_dir": step_dir,
                     "problems": problems[:8], "wall": self.clock()},
                    "rejected", problems=len(problems))
            self._clean_evals = self._regress = 0
            return self._decide(
                seq, "rec", "claim",
                {"ver": seq, "step_dir": step_dir, "prev": int(target),
                 "wall": self.clock()},
                "promote_begin", prev=int(target))
        return None

    def _leader_advance(self, phase: dict, versions: dict[int, dict]):
        """Drive the active rollout one step: canary, then roll or roll
        back, then seal the outcome."""
        seq = int(phase["ver"])
        rec = phase["rec"]
        prev = int(rec.get("prev", 0))
        if not phase["rec_claimed"]:
            # predecessor died between record and claim: complete it
            # (claim-once keeps the begin event single)
            self._complete_claim(seq, "claim", "promote_begin", prev=prev)
        reports = read_load_reports(self.skv)
        tags = sorted(reports)
        if not tags:
            return None  # no live fleet to drive; reports are TTL'd
        if phase["verdict"] is None:
            return self._leader_canary(seq, rec, prev, reports, tags)
        return self._leader_converge(phase, seq, rec, prev, reports, tags)

    def _pick_canary(self, seq: int, reports: dict,
                     tags: list[str]) -> str:
        """The canary replica: least-loaded by its fresh load report
        (queued + active work), ties and report-less fleets falling back
        to tag order. Persisted in the rollout's phase records the first
        time it is chosen, so the choice neither flaps between ticks as
        load shifts nor changes under a controller failover mid-canary —
        the successor swaps (and measures) the same replica. A persisted
        canary whose report vanished (replica died) is re-chosen."""
        raw = self.kv.try_get(k_ro(self.fleet, seq, "canary"))
        if raw is not None:
            tag = json.loads(raw).get("tag", "")
            if tag in reports:
                return tag
        canary = min(tags, key=lambda t: (
            int(reports[t].get("queue_depth", 0))
            + int(reports[t].get("active", 0)), t))
        self.kv.set(k_ro(self.fleet, seq, "canary"), json.dumps(
            {"ver": seq, "tag": canary, "wall": self.clock()}))
        return canary

    def _leader_canary(self, seq: int, rec: dict, prev: int,
                       reports: dict, tags: list[str]):
        cfg = self.cfg
        canary = self._pick_canary(seq, reports, tags)
        ack = int(reports[canary].get("ver", 0))
        if ack != seq:
            err = reports[canary].get("swap_error")
            if isinstance(err, dict) and int(err.get("ver", -1)) == seq:
                # the replica tried and cannot load this artifact —
                # equivalent to a failed canary, same rollback path
                return self._fail_canary(seq, canary,
                                         [{"swap_error": err}])
            self._send_swap(canary, seq, rec.get("step_dir"))
            return None
        if len(tags) < 2:
            # nobody to baseline against: canary analysis is vacuous
            return self._decide(
                seq, "verdict", "vclaim",
                {"ver": seq, "outcome": "pass", "reason": "no_baseline",
                 "wall": self.clock()},
                "canary_pass", reason="no_baseline")
        self.kv.set(k_shares(self.fleet), json.dumps({
            "seq": seq,
            "shares": {str(seq): cfg.canary_share,
                       str(prev): round(1.0 - cfg.canary_share, 6)}}))
        rules = self._canary_rules(canary, [t for t in tags if t != canary])
        now_bucket = int(float(self.clock()) // cfg.bucket_s)
        fired = [payload for rule in rules
                 for _subject, payload in rule.evaluate(self.kv, now_bucket)]
        has_data = any(rule.has_data(self.kv) for rule in rules)
        if fired:
            self._regress += 1
            self._clean_evals = 0
        elif has_data:
            self._clean_evals += 1
            self._regress = 0
        if self._regress >= cfg.regress_streak:
            return self._fail_canary(seq, canary, fired)
        if self._clean_evals >= cfg.canary_evals:
            return self._decide(
                seq, "verdict", "vclaim",
                {"ver": seq, "outcome": "pass",
                 "clean_evals": self._clean_evals, "wall": self.clock()},
                "canary_pass")
        return None

    def _fail_canary(self, seq: int, canary: str, evidence: list[dict]):
        now = float(self.clock())
        event = self._decide(
            seq, "verdict", "vclaim",
            {"ver": seq, "outcome": "fail", "canary": canary,
             "evidence": evidence[:4], "wall": now},
            "canary_fail", canary=canary)
        if event is not None:
            window_idx = int(now // self.cfg.window_s)
            raise_alert(
                self.kv, "canary_regression", fleet_label(self.fleet),
                window_idx,
                {"rule": "canary_regression",
                 "subject": fleet_label(self.fleet), "ver": seq,
                 "canary": canary, "evidence": evidence[:4],
                 "window_idx": window_idx, "wall": now},
                active_ttl=self.cfg.alert_ttl_windows * self.cfg.window_s)
        return event

    def _leader_converge(self, phase: dict, seq: int, rec: dict, prev: int,
                         reports: dict, tags: list[str]):
        outcome = (phase["verdict"] or {}).get("outcome")
        if not phase["verdict_claimed"]:
            self._complete_claim(
                seq, "vclaim",
                "canary_pass" if outcome == "pass" else "canary_fail")
        if outcome == "pass":
            goal_ver, goal_dir = seq, rec.get("step_dir")
        else:
            goal_ver = prev
            goal_dir = (registry_versions(self.kv, self.fleet)
                        .get(prev, {}).get("step_dir")
                        if prev else None)
        behind = [t for t in tags
                  if int(reports[t].get("ver", 0)) != goal_ver]
        if behind:
            # strictly one replica in flight: advance only on its ack
            self._send_swap(behind[0], goal_ver, goal_dir)
            return None
        self.kv.delete(k_shares(self.fleet))
        if outcome == "pass":
            self.kv.set(k_target(self.fleet), str(seq))
        done_outcome = "promoted" if outcome == "pass" else "rolled_back"
        self._clean_evals = self._regress = 0
        return self._decide(
            seq, "done", "doneclaim",
            {"ver": seq, "outcome": done_outcome, "target": goal_ver,
             "replicas": len(tags), "wall": self.clock()},
            done_outcome, target=goal_ver)

    # -- mechanics -----------------------------------------------------------

    def _canary_rules(self, canary: str,
                      baseline: list[str]) -> list[BaselineDeltaRule]:
        def proc(tag: str) -> str:
            return tag.replace("/", "-")  # tsdb proc names are slash-free

        base = tuple(proc(t) for t in baseline)
        rules = []
        if self.cfg.ttft_ratio is not None:
            rules.append(BaselineDeltaRule(
                name="canary_ttft", series="engine.ttft",
                subject=proc(canary), baseline=base,
                threshold=self.cfg.ttft_ratio, mode="ratio", op=">",
                field="p99"))
        if self.cfg.logprob_delta is not None:
            rules.append(BaselineDeltaRule(
                name="canary_logprob", series="engine.logprob",
                subject=proc(canary), baseline=base,
                threshold=self.cfg.logprob_delta, mode="delta", op="<",
                field="mean"))
        return rules

    def _send_swap(self, tag: str, seq: int, step_dir) -> None:
        """Idempotent swap command with local re-send patience. The
        mailbox is delete-on-read, so a replica killed mid-swap simply
        gets the command again after respawn — exactly-once lives in the
        claim-once phase records, not in the mailbox."""
        key = (tag, int(seq))
        now = time.monotonic()
        if now - self._last_cmd.get(key, float("-inf")) \
                < self.cfg.swap_resend_s:
            return
        self._last_cmd[key] = now
        cmd = {"action": "swap", "ver": int(seq)}
        if step_dir:
            cmd["step_dir"] = str(step_dir)
        self.skv.set(k_cmd(tag), json.dumps(cmd))
        get_registry().counter("deploy.swap_sent").inc()

    def _verify_artifact(self, step_dir: str) -> list[str]:
        from tpu_sandbox_torch.train.checkpoint import verify_step_dir

        if not step_dir:
            return ["torn: version record has no step_dir"]
        return verify_step_dir(step_dir)

    def _decide(self, seq: int, kind: str, claim: str, body: dict,
                action: str, **event_extra):
        """Record-then-claim, the raise_alert ordering: the idempotent
        record lands first, the add()-gated claim arbitrates the one-time
        event/counter. Killed between the two -> successor re-records and
        wins the claim itself; killed after -> successor's add sees >1
        and stays silent."""
        self.kv.set(k_ro(self.fleet, seq, kind), json.dumps(body))
        return self._complete_claim(seq, claim, action, **event_extra)

    def _complete_claim(self, seq: int, claim: str, action: str,
                        **event_extra):
        if self.kv.add(k_ro(self.fleet, seq, claim)) != 1:
            return None
        event = {"action": action, "fleet": fleet_label(self.fleet),
                 "ver": int(seq), "wall": float(self.clock()),
                 **event_extra}
        append_event(self.kv, event)
        get_registry().counter("deploy.events",
                               labels={"action": action}).inc()
        return event

    def resign(self) -> None:
        self.election.resign()
