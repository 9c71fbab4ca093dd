"""Serve replicas behind a KV-backed request queue — zero-loss by protocol.
Counterpart of ``tpu_sandbox/serve/replica.py``: the same keys, bodies,
``TPU_SANDBOX_*`` environment names and exit code, so either package's
producer talks to either package's replica. Run one as

    TPU_SANDBOX_KV_PORT=<port> python -m tpu_sandbox_torch.serve.replica \
        --config '{"model": {...}, "cache": {...}}' [--force-cpu]

on the card (or the CPU with ``--force-cpu``; with no card and no
``--force-cpu`` it fails). ``--fleet NAME`` (or ``TPU_SANDBOX_FLEET``)
serves one tenant fleet: the whole request plane below lives under
``fleet/<NAME>/`` (``gateway/fleet.py``). The deploy controller's
``swap`` command installs a published weight version (``_apply_swap``),
restored onto the engine's device.

The KV store (the same one the elastic runtime coordinates through) holds
the whole request plane:

    serve/req/<rid>      request body  {rid, prompt, max_new_tokens}
    serve/queue/tail     atomic entry counter (``add()``)
    serve/queue/<n>      entry n -> rid  (requeues append fresh entries)
    serve/claim/<n>      claim-once marker: first ``add()`` == 1 wins
    serve/lease/<rid>    TTL heartbeat while a replica works the request
    serve/scavenged/<n>  claim-once marker so an orphaned entry is
                         requeued exactly once
    serve/tq/<tag>/tail  targeted queue: entries the gateway routed to one
    serve/tq/<tag>/<n>   specific replica (prefix-cache affinity). Only the
                         owner claims its own targeted entries; peers
                         scavenge a dead owner's entries back to the shared
                         queue (see ``scavenge``), so routing is an
                         optimization, never a new loss case.
    serve/tclaim/<tag>/<n>  claim-once markers for targeted entries
    serve/tscav/<tag>/<n>   scavenged-once markers for targeted entries
    serve/result/<rid>   terminal verdict — a token result or an explicit
                         SHED body; idempotent for results (greedy or
                         seeded-sampled decode over bitwise-deterministic
                         steps: every execution of a request writes
                         identical bytes)
    serve/done/<rid>     claim-once verdict marker: the first publisher
                         (result or SHED) wins, so a request reaches
                         exactly one terminal verdict even when a shed
                         races a scavenged duplicate execution
    serve/load/<tag>     TTL'd per-replica load report (queue depth,
                         block-pool pressure, decode-step lag) — the
                         autoscaler's input; also carries the running
                         weight version (``ver``), which is the swap ack
                         the deploy controller advances on
    serve/pin/<rid>      weight-version pin, written by the first claimer:
                         every later execution of the rid (requeue,
                         scavenge, drain) decodes on this version, so a
                         verdict is always single-version and replays are
                         bitwise. Cleared only by a client retry, which
                         starts a fresh lifecycle.
    serve/cmd/<tag>      fault mailbox (shed_storm / stall_replica /
                         swap — the deploy controller's rolling update;
                         launch_counts — a measurement window's end)
    serve/total          number of distinct requests the producer will pose

Loss cases and their answers:

- **SIGTERM (drain path)** — the replica evicts every in-flight sequence
  back to request form and appends fresh queue entries, then exits with
  ``PREEMPTED_EXIT_CODE`` so the elastic budget treats it as preemption.
- **SIGKILL (no goodbye)** — its claims stay but the leases expire;
  any peer's scavenge pass requeues claimed-unleased-unresulted entries
  (at most once per entry via ``serve/scavenged/<n>``).
- **Double execution** — a slow-but-alive claimant racing a scavenged
  duplicate wastes compute, never correctness: results are identical and
  the write is idempotent.

Replicas run as ranks of a ``HostAgent`` gang (``runtime/host_agent.py``),
so the elastic runtime relaunches them; the tag then defaults to
``replica-a<agent>-g<generation>``.
"""

from __future__ import annotations

import argparse
import json
import os
import signal
import sys
import time
from dataclasses import dataclass
from typing import Sequence

from tpu_sandbox_torch.obs import get_recorder
from tpu_sandbox_torch.runtime.kvstore import KVClient
from tpu_sandbox_torch.runtime.supervisor import (ENV_KV_PORT,
                                                  PREEMPTED_EXIT_CODE)

K_TOTAL = "serve/total"
K_TAIL = "serve/queue/tail"
#: a directory: the replica process writes its kernel launch counts there
#: when it ends (``launches-<tag>.json``), as the elastic ranks do, and
#: when its mailbox's ``launch_counts`` command ends a window
ENV_LAUNCH_COUNTS = "TPU_SANDBOX_LAUNCH_COUNTS"


def k_req(rid: str) -> str:
    return f"serve/req/{rid}"


def k_queue(seq: int) -> str:
    return f"serve/queue/{seq}"


def k_claim(seq: int) -> str:
    return f"serve/claim/{seq}"


def k_lease(rid: str) -> str:
    return f"serve/lease/{rid}"


def k_scavenged(seq: int) -> str:
    return f"serve/scavenged/{seq}"


def k_result(rid: str) -> str:
    return f"serve/result/{rid}"


def k_done(rid: str) -> str:
    return f"serve/done/{rid}"


def k_pin(rid: str) -> str:
    return f"serve/pin/{rid}"


def k_load(tag: str) -> str:
    return f"serve/load/{tag}"


def k_cmd(tag: str) -> str:
    return f"serve/cmd/{tag}"


def k_tq_tail(tag: str) -> str:
    return f"serve/tq/{tag}/tail"


def k_tq(tag: str, seq: int) -> str:
    return f"serve/tq/{tag}/{seq}"


def k_tq_claim(tag: str, seq: int) -> str:
    return f"serve/tclaim/{tag}/{seq}"


def k_tq_scavenged(tag: str, seq: int) -> str:
    return f"serve/tscav/{tag}/{seq}"


# -- producer side -----------------------------------------------------------


def write_request(kv, rid: str, prompt: Sequence[int],
                  max_new_tokens: int, *, deadline_unix: float | None = None,
                  temperature: float = 0.0, top_k: int = 0,
                  seed: int = 0, tc: dict | None = None,
                  gw: str | None = None) -> None:
    """Write the request body without enqueueing — the gateway writes the
    body once, then targets the entry at the replica routing chose.
    ``deadline_unix`` is wall clock (``time.time()``) so it survives the
    hop between client and replica processes; replicas translate it to
    their engine clock at claim time. ``tc`` is the submit trace context
    (``TraceContext.to_wire()``); it rides the body so the claim span can
    chain to the gateway's enqueue span. ``gw`` is the routing gateway's
    HA identity; replicas count claims per gateway in their load reports
    so the chaos claim audit can show a killed gateway's in-flight work
    being finished by the fleet. The body is written exactly once per rid
    either way, so adding these keys never perturbs the idempotent-
    verdict contract."""
    body = {"rid": rid, "prompt": list(map(int, prompt)),
            "max_new_tokens": int(max_new_tokens)}
    if deadline_unix is not None:
        body["deadline_unix"] = float(deadline_unix)
    if temperature > 0.0:
        body.update(temperature=float(temperature), top_k=int(top_k),
                    seed=int(seed))
    if tc is not None:
        body["tc"] = tc
    if gw is not None:
        body["gw"] = str(gw)
    kv.set(k_req(rid), json.dumps(body))


def submit_request(kv, rid: str, prompt: Sequence[int],
                   max_new_tokens: int, *, deadline_unix: float | None = None,
                   temperature: float = 0.0, top_k: int = 0,
                   seed: int = 0) -> None:
    """Queue one request on the shared queue (any replica may claim it)."""
    write_request(kv, rid, prompt, max_new_tokens,
                  deadline_unix=deadline_unix, temperature=temperature,
                  top_k=top_k, seed=seed)
    enqueue(kv, rid)


def enqueue(kv, rid: str) -> int:
    n = kv.add(K_TAIL) - 1
    kv.set(k_queue(n), rid)
    return n


def enqueue_to(kv, tag: str, rid: str) -> int:
    """Append an entry to one replica's targeted queue. The request body
    must already be written (``write_request``)."""
    n = kv.add(k_tq_tail(tag)) - 1
    kv.set(k_tq(tag, n), rid)
    return n


def targeted_tags(kv) -> list[str]:
    """Replica tags that have (or had) a targeted queue — scavenge scope."""
    tags = {k.split("/")[2] for k in kv.keys("serve/tq/")
            if k.count("/") >= 3}
    return sorted(tags)


def announce_total(kv, total: int) -> None:
    kv.set(K_TOTAL, str(total))


def results_done(kv) -> bool:
    total = kv.try_get(K_TOTAL)
    if total is None:
        return False
    return len(kv.keys("serve/result/")) >= int(total)


def read_result(kv, rid: str, timeout: float = 60.0) -> dict:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        raw = kv.try_get(k_result(rid))
        if raw is not None:
            return json.loads(raw)
        time.sleep(0.02)
    raise TimeoutError(f"no result for {rid} within {timeout}s")


def read_load_reports(kv) -> dict[str, dict]:
    """Current (unexpired) per-replica load reports, keyed by replica tag."""
    out = {}
    for key in kv.keys("serve/load/"):
        raw = kv.try_get(key)
        if raw is not None:
            out[key[len("serve/load/"):]] = json.loads(raw)
    return out


# -- replica side ------------------------------------------------------------


@dataclass
class ReplicaStats:
    claimed: int = 0
    completed: int = 0
    requeued: int = 0
    scavenged: int = 0
    shed: int = 0
    stalls: int = 0
    swaps: int = 0
    swap_errors: int = 0


class ReplicaWorker:
    """One replica: claims queue entries into a local engine, publishes
    results, heartbeats leases, scavenges orphans. Pure poll loop — no
    threads of its own, so it embeds cleanly in tests and in the worker
    process main below."""

    def __init__(self, kv: KVClient, engine, *, tag: str = "replica",
                 lease_ttl: float = 3.0, claim_depth: int | None = None,
                 scavenge_interval: float | None = None,
                 load_interval: float | None = None,
                 ts_flusher=None, publish_ts: bool = True,
                 swap_loader=None):
        from tpu_sandbox_torch.obs.tsdb import TimeSeriesFlusher

        self.kv = kv
        self.engine = engine
        self.tag = tag
        # durable time-series trail, flushed on the load-report cadence;
        # the health plane's per-replica rules read it under this proc
        self.ts_flusher = ts_flusher
        if self.ts_flusher is None and publish_ts:
            self.ts_flusher = TimeSeriesFlusher(
                kv, tag.replace("/", "-") or "replica")
        self.lease_ttl = lease_ttl
        self.claim_depth = claim_depth or 2 * engine.config.max_batch
        self.scavenge_interval = scavenge_interval or lease_ttl
        self.load_interval = load_interval or lease_ttl / 2
        self._scanned = 0
        self._gw_claims: dict[str, int] = {}  # routing gateway -> claims
        self._tq_scanned = 0  # cursor into our own targeted queue
        self._tq_hole_slot = -1   # targeted slot seen tail-bumped but empty
        self._tq_hole_since = 0.0
        self._published: set[str] = set()
        self._pin_skipped: set[str] = set()
        # swap command -> params hook (tests/benches inject stub weights);
        # None falls back to the artifact path in the command
        self.swap_loader = swap_loader
        self._swap_error: dict | None = None
        self._next_scavenge = time.monotonic() + self.scavenge_interval
        self._next_load = 0.0  # publish on the first tick
        self.stats = ReplicaStats()
        self._draining = False

    # one request currently inside the local engine per rid
    def _local_load(self) -> int:
        return self.engine.active_requests + len(self.engine.waiting)

    def request_drain(self) -> None:
        self._draining = True

    def tick(self) -> bool:
        """One poll-loop iteration. Returns False when all work is done
        (or a drain was requested and completed)."""
        if self._draining:
            self.drain()
            return False
        if results_done(self.kv):
            return False
        self._poll_faults()
        # targeted entries first (the gateway routed them here for prefix
        # affinity — serving them elsewhere wastes the resident cache), then
        # top up from the shared queue
        tq_tail = int(self.kv.try_get(k_tq_tail(self.tag)) or b"0")
        while self._tq_scanned < tq_tail \
                and self._local_load() < self.claim_depth:
            n = self._tq_scanned
            rid_raw = self.kv.try_get(k_tq(self.tag, n))
            if rid_raw is None:
                # tail bumped, entry body not visible yet (the producer is
                # mid-write). We are the only claimer of this queue, so
                # skipping would strand the request forever — peers defer
                # to a live owner. Hold the cursor and retry, advancing
                # only once the hole proves permanent (producer died
                # between bump and set: no rid was ever written, so
                # nothing is lost by moving on).
                if self._tq_hole_slot != n:
                    self._tq_hole_slot = n
                    self._tq_hole_since = time.monotonic()
                elif time.monotonic() - self._tq_hole_since > self.lease_ttl:
                    self._tq_scanned += 1
                break
            self._tq_scanned += 1
            self._claim_entry(rid_raw, k_tq_claim(self.tag, n))
        tail = int(self.kv.try_get(K_TAIL) or b"0")
        while self._scanned < tail and self._local_load() < self.claim_depth:
            n = self._scanned
            self._scanned += 1
            self._claim_entry(self.kv.try_get(k_queue(n)), k_claim(n))
        if not self.engine.idle:
            self.engine.step()
        self._heartbeat()
        self._publish_new()
        self._publish_load()
        if time.monotonic() >= self._next_scavenge:
            self._next_scavenge = time.monotonic() + self.scavenge_interval
            self.scavenge()
        return True

    def run(self, poll: float = 0.005, timeout: float = 300.0) -> None:
        deadline = time.monotonic() + timeout
        while self.tick():
            if time.monotonic() > deadline:
                raise TimeoutError(f"replica {self.tag} timed out")
            if self.engine.idle:
                time.sleep(poll)

    def _claim_entry(self, rid_raw: bytes | None, claim_key: str) -> bool:
        """Lease-then-claim one queue entry into the local engine. False
        when the entry is absent (tail bumped, body not written yet —
        shared-queue scans revisit via scavenge; targeted scans hold the
        cursor and retry, since only the owner claims there), already
        resulted, or lost the claim race."""
        if rid_raw is None:
            return False
        t_claim = time.monotonic()
        rid = rid_raw.decode()
        if self.kv.try_get(k_result(rid)) is not None:
            return False
        # lease before claim: a scavenger never sees a fresh claim
        # without a heartbeat (spurious requeues would still be safe,
        # just wasted work)
        self.kv.set_ttl(k_lease(rid), self.tag, self.lease_ttl)
        if self.kv.add(claim_key) != 1:
            return False
        body = json.loads(self.kv.get(k_req(rid)))
        # per-gateway claim attribution for the HA/chaos claim audit: a
        # request stamped by a since-killed gateway showing up here is the
        # fleet finishing that gateway's in-flight work
        gw = body.get("gw")
        if gw is not None:
            self._gw_claims[gw] = self._gw_claims.get(gw, 0) + 1
        # a rid can come around again legitimately: a client that saw
        # our SHED verdict cleared it and re-enqueued. Forget that we
        # published, so the fresh execution's verdict goes out too
        # (the claim-once serve/done marker still arbitrates races).
        self._published.discard(rid)
        req = self._to_request(body)
        # version pin: the FIRST claimer of a rid stamps the weight version
        # it will decode on; every re-execution (requeue, scavenge, another
        # replica) reads the pin back and decodes on the same version, so
        # the published verdict is single-version and bitwise-replayable
        pin_raw = self.kv.try_get(k_pin(rid))
        if pin_raw is not None:
            req.ver = int(pin_raw)
        else:
            req.ver = int(self.engine.version)
            self.kv.set(k_pin(rid), str(req.ver))
        ctx = get_recorder().complete(
            "claim", t_claim, parent=body.get("tc"),
            args={"rid": rid, "replica": self.tag})
        if ctx is not None:
            req.tc = ctx.to_wire()
        self.engine.submit(req)
        self.stats.claimed += 1
        return True

    def _to_request(self, body: dict):
        """Queue-entry body -> engine Request, translating the wall-clock
        deadline into this engine's clock (monotonic clocks don't travel
        between processes, wall clock does)."""
        from tpu_sandbox_torch.serve.engine import Request

        deadline = None
        if body.get("deadline_unix") is not None:
            deadline = self.engine.clock() \
                + (float(body["deadline_unix"]) - time.time())
        return Request(
            rid=body["rid"], prompt=body["prompt"],
            max_new_tokens=body["max_new_tokens"],
            arrival=self.engine.clock(), deadline=deadline,
            temperature=float(body.get("temperature", 0.0)),
            top_k=int(body.get("top_k", 0)),
            seed=int(body.get("seed", 0)))

    def _poll_faults(self) -> None:
        """Consume the replica fault mailbox (serve/cmd/<tag>): shed_storm
        sheds the local waiting queue, stall_replica freezes this poll
        loop long enough for leases to lapse (peers scavenge the claims).
        launch_counts ends a measurement window: the kernel launches since
        the last one go out (``_write_launch_counts``) and the next window
        counts from 0."""
        raw = self.kv.try_get(k_cmd(self.tag))
        if raw is None:
            return
        self.kv.delete(k_cmd(self.tag))
        cmd = json.loads(raw)
        action = cmd.get("action")
        if action == "shed_storm":
            self.stats.shed += self.engine.shed_waiting("fault:shed_storm")
        elif action == "stall_replica":
            self.stats.stalls += 1
            time.sleep(float(cmd.get("duration", 2 * self.lease_ttl)))
        elif action == "swap":
            self._apply_swap(cmd)
        elif action == "launch_counts":
            from tpu_sandbox_torch import ops

            _write_launch_counts(self.tag, self)
            ops.reset_launch_counts()

    def _apply_swap(self, cmd: dict) -> None:
        """Install the commanded weight version between decode steps.
        Verify-before-touch: a manifest that fails its checksums leaves the
        engine exactly as it was, with the error in the load report (the
        controller reads it and rolls back). Idempotent — the controller
        re-sends until the load report acks the version, so a replica
        killed mid-swap just swaps again after respawn."""
        ver = int(cmd.get("ver", 0))
        if ver == self.engine.version:
            return  # already there: a re-sent command, not an error
        step_dir = cmd.get("step_dir")
        if step_dir:
            from tpu_sandbox_torch.train.checkpoint import verify_step_dir

            problems = verify_step_dir(step_dir)
            if problems:
                self._swap_error = {"ver": ver, "error": "verify",
                                    "problems": [str(p) for p in problems][:4]}
                self.stats.swap_errors += 1
                return
        params, loaded = None, False
        if self.swap_loader is not None:
            params = self.swap_loader(cmd)
            loaded = params is not None
        elif step_dir:
            from tpu_sandbox_torch.deploy.registry import load_step_params

            try:
                params = load_step_params(step_dir, self.engine.params)
                loaded = True
            except Exception as exc:  # torn mid-read, shape mismatch, ...
                self._swap_error = {"ver": ver, "error": "load",
                                    "problems": [str(exc)[:200]]}
                self.stats.swap_errors += 1
                return
        elif self.engine.has_version(ver):
            # no artifact and no hook: a rollback to weights this process
            # still holds (None is valid params for stub engines)
            params = self.engine._params_by_ver[ver]
            loaded = True
        if not loaded:
            self._swap_error = {"ver": ver, "error": "no_params"}
            self.stats.swap_errors += 1
            return
        flushed = self.engine.swap_params(params, ver)
        self._swap_error = None
        self.stats.swaps += 1
        get_recorder().instant(
            "swap", args={"replica": self.tag, "ver": ver,
                          "prefix_flushed": flushed})

    def drain(self) -> int:
        """Requeue everything in flight; the SIGTERM path. Finished-but-
        unpublished verdicts go out first so nothing computed is lost.
        Targeted entries we never even claimed are handed back too —
        claimed first (so the scavenger can't requeue them a second time),
        then re-enqueued on the shared queue for any peer."""
        self._publish_new()
        requests = self.engine.drain_to_requests()
        for req in requests:
            if req.rid in self._published or \
                    self.kv.try_get(k_result(req.rid)) is not None:
                continue
            enqueue(self.kv, req.rid)
            self.kv.delete(k_lease(req.rid))
            self.stats.requeued += 1
        tq_tail = int(self.kv.try_get(k_tq_tail(self.tag)) or b"0")
        for n in range(tq_tail):
            if self.kv.try_get(k_tq_claim(self.tag, n)) is not None:
                continue  # claimed: drained above or already resulted
            rid_raw = self.kv.try_get(k_tq(self.tag, n))
            if rid_raw is None:
                continue
            rid = rid_raw.decode()
            if self.kv.try_get(k_result(rid)) is not None:
                continue
            if self.kv.add(k_tq_claim(self.tag, n)) != 1:
                continue  # a scavenger beat us to it
            # mark moved-to-shared so a later scavenger (seeing a claimed,
            # leaseless, unresulted entry) doesn't requeue it a second time
            self.kv.add(k_tq_scavenged(self.tag, n))
            enqueue(self.kv, rid)
            self.stats.requeued += 1
        return self.stats.requeued

    def scavenge(self) -> int:
        """Requeue claimed entries whose worker went silent (no lease, no
        result). Each entry is requeued at most once, by one scavenger.

        Targeted queues are covered too: only the owner scans its own
        queue, so a dead replica's routed entries would otherwise sit
        unclaimed forever. An unclaimed targeted entry is rescued once the
        owner's TTL'd load report is gone (dead or wedged past the TTL); a
        claimed-and-leaseless one is rescued exactly like a shared entry.
        Rescues land on the SHARED queue — the owner is presumed dead, any
        peer may serve. A spurious rescue (owner merely slow) wastes
        compute, never correctness: verdicts stay claim-once."""
        n_rescued = 0
        tail = int(self.kv.try_get(K_TAIL) or b"0")
        for n in range(tail):
            if self.kv.try_get(k_claim(n)) is None:
                continue
            rid_raw = self.kv.try_get(k_queue(n))
            if rid_raw is None:
                continue
            rid = rid_raw.decode()
            if self.kv.try_get(k_result(rid)) is not None:
                continue
            if self.kv.try_get(k_lease(rid)) is not None:
                continue  # someone is alive and working it
            if self.kv.add(k_scavenged(n)) != 1:
                continue  # another scavenger took this entry
            # exactly one scavenger reaches here per entry, so these
            # instants appear once on the merged timeline per rescue
            get_recorder().instant("lease:expired",
                                   args={"rid": rid, "entry": n})
            enqueue(self.kv, rid)
            get_recorder().instant(
                "scavenge:requeue",
                args={"rid": rid, "entry": n, "by": self.tag})
            n_rescued += 1
        for tag in targeted_tags(self.kv):
            owner_alive = tag == self.tag \
                or self.kv.try_get(k_load(tag)) is not None
            tq_tail = int(self.kv.try_get(k_tq_tail(tag)) or b"0")
            for n in range(tq_tail):
                rid_raw = self.kv.try_get(k_tq(tag, n))
                if rid_raw is None:
                    continue
                rid = rid_raw.decode()
                if self.kv.try_get(k_result(rid)) is not None:
                    continue
                if self.kv.try_get(k_lease(rid)) is not None:
                    continue
                claimed = self.kv.try_get(k_tq_claim(tag, n)) is not None
                if not claimed and owner_alive:
                    continue  # owner will claim it in its own time
                if tag == self.tag and not claimed:
                    continue  # our own backlog: tick claims it, not scavenge
                if self.kv.add(k_tq_scavenged(tag, n)) != 1:
                    continue
                get_recorder().instant(
                    "lease:expired",
                    args={"rid": rid, "entry": n, "owner": tag})
                # claim the original too, so a resurrected owner does not
                # re-execute it (racy owners only waste compute; verdict
                # publication stays claim-once either way)
                self.kv.add(k_tq_claim(tag, n))
                enqueue(self.kv, rid)
                get_recorder().instant(
                    "scavenge:requeue",
                    args={"rid": rid, "entry": n, "owner": tag,
                          "by": self.tag})
                n_rescued += 1
        self.stats.scavenged += n_rescued
        return n_rescued

    def _heartbeat(self) -> None:
        for slot in self.engine.slots:
            if slot is not None:
                self.kv.set_ttl(k_lease(slot.request.rid), self.tag,
                                self.lease_ttl)
        for req in self.engine.waiting:
            self.kv.set_ttl(k_lease(req.rid), self.tag, self.lease_ttl)

    def _publish_new(self) -> None:
        # tokens are bitwise identical across executions of a rid; the
        # ttft_s timing metadata is execution-specific, which is fine —
        # the claim-once serve/done marker means exactly one body lands,
        # and timing is observability, not an answer
        for rid, res in self.engine.results.items():
            if rid in self._published:
                continue
            # pin fence: an execution that somehow ran on a different
            # version than the rid's pin (pin written by a racing claimer
            # after our claim) must not publish — let the lease lapse and
            # the scavenger replay it on the pinned version
            pin_raw = self.kv.try_get(k_pin(rid))
            if pin_raw is not None and int(pin_raw) != int(
                    getattr(res, "ver", 0)):
                if rid not in self._pin_skipped:
                    self._pin_skipped.add(rid)
                    get_recorder().instant(
                        "verdict:pin_mismatch",
                        args={"rid": rid, "ran": getattr(res, "ver", 0),
                              "pin": int(pin_raw)})
                continue
            # the publish SPAN and verdict INSTANT are trace-only; the
            # verdict BODY below is untouched, so bitwise-identical
            # republication still holds
            t_pub = time.monotonic()
            self._publish_verdict(rid, {
                "rid": rid, "verdict": "ok", "tokens": res.tokens,
                "preemptions": res.preemptions, "replica": self.tag,
                "ver": int(getattr(res, "ver", 0)),
                "ttft_s": round(res.ttft, 6)})
            pub_ctx = get_recorder().complete(
                "publish", t_pub, parent=getattr(res, "tc", None),
                args={"rid": rid})
            get_recorder().instant(
                "verdict", parent=pub_ctx,
                args={"rid": rid, "verdict": "ok"})
            self.stats.completed += 1
        for rid, rec in self.engine.shed.items():
            if rid in self._published:
                continue
            t_pub = time.monotonic()
            self._publish_verdict(rid, {
                "rid": rid, "verdict": "SHED", "reason": rec.reason,
                "preemptions": rec.preemptions, "replica": self.tag})
            pub_ctx = get_recorder().complete(
                "publish", t_pub, parent=getattr(rec, "tc", None),
                args={"rid": rid})
            get_recorder().instant(
                "verdict", parent=pub_ctx,
                args={"rid": rid, "verdict": "SHED"})
            self.stats.shed += 1

    def _publish_verdict(self, rid: str, body: dict) -> None:
        """Exactly-one-verdict: the first publisher claims serve/done/<rid>
        and writes the result slot; a loser (a shed racing a scavenged
        duplicate's result, or vice versa) leaves the winner's verdict
        alone. Result bodies are identical across executions, so which ok
        writer wins is unobservable."""
        if self.kv.add(k_done(rid)) == 1:
            self.kv.set(k_result(rid), json.dumps(body))
        self.kv.delete(k_lease(rid))
        self._published.add(rid)

    def _publish_load(self) -> None:
        now = time.monotonic()
        if now < self._next_load:
            return
        self._next_load = now + self.load_interval
        report = dict(self.engine.load_report(), tag=self.tag,
                      wall=time.time())
        if self._gw_claims:
            report["gw_claims"] = dict(sorted(self._gw_claims.items()))
        if self._swap_error is not None:
            report["swap_error"] = self._swap_error
        self.kv.set_ttl(k_load(self.tag), json.dumps(report),
                        max(3 * self.load_interval, self.lease_ttl))
        if self.ts_flusher is not None:
            self.ts_flusher.flush()


# -- worker process main -----------------------------------------------------


def load_flax_npz(path: str) -> dict:
    """A Flax ``params`` tree saved as one npz of '/'-joined paths
    (``block0/attn/qkv/kernel``) -> the port's state dict, through the
    weight bridge (``utils/bridge.py::params_from_flax``)."""
    import numpy as np

    from tpu_sandbox_torch.utils.bridge import params_from_flax

    tree: dict = {}
    with np.load(path) as z:
        for key in z.files:
            *parents, leaf = key.split("/")
            node = tree
            for name in parents:
                node = node.setdefault(name, {})
            node[leaf] = z[key]
    return params_from_flax({"params": tree})


def _build_engine(cfg: dict, device):
    """The engine of ``main``: the LM at the config's widths with fp32
    weights and compute (as JAX's replica forces), from the port's seeded
    init (``param_seed``) or, when ``params_npz`` names a file, from JAX's
    weights through the bridge."""
    import torch

    from tpu_sandbox_torch.models.transformer import (TransformerConfig,
                                                      TransformerLM)
    from tpu_sandbox_torch.serve.cache import CacheConfig
    from tpu_sandbox_torch.serve.engine import ContinuousEngine, ServeConfig

    mcfg = TransformerConfig(**{**dict(
        vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
        max_len=128), **cfg.get("model", {})},
        dtype=torch.float32)
    if cfg.get("params_npz"):
        params = load_flax_npz(cfg["params_npz"])
    else:
        params = TransformerLM(mcfg, seed=int(cfg.get("param_seed", 0)),
                               device=device).state_dict()
    scfg = ServeConfig(
        model=mcfg,
        cache=CacheConfig(**cfg.get("cache", {})),
        max_batch=cfg.get("max_batch", 4),
        buckets=tuple(cfg.get("buckets", (16, 32))),
        max_waiting=cfg.get("max_waiting", 0),
    )
    return ContinuousEngine(params, scfg, device=device)


def _write_launch_counts(tag: str, worker: ReplicaWorker) -> None:
    """With ``TPU_SANDBOX_LAUNCH_COUNTS`` set (a directory), the process's
    kernel launches of the port since its last ``launch_counts`` command
    (else over its whole life), its swaps and its claims, as
    ``launches-<tag>.json`` there, replaced whole so that a reader never
    sees part of it."""
    out = os.environ.get(ENV_LAUNCH_COUNTS)
    if not out:
        return
    from pathlib import Path

    from tpu_sandbox_torch import ops

    path = Path(out) / f"launches-{tag.replace('/', '-')}.json"
    tmp = path.with_suffix(".tmp")
    tmp.write_text(json.dumps({"tag": tag, "launches": ops.launch_counts(),
                               "swaps": worker.stats.swaps,
                               "claimed": worker.stats.claimed}))
    os.replace(tmp, path)


def main(argv: Sequence[str] | None = None) -> int:
    from tpu_sandbox_torch.utils.device import resolve_device

    p = argparse.ArgumentParser()
    p.add_argument("--config", required=True,
                   help="JSON: model/cache/max_batch/buckets/param_seed/"
                        "params_npz/lease-ttl overrides")
    p.add_argument("--tag", default=None)
    p.add_argument("--fleet", default=os.environ.get(
        "TPU_SANDBOX_FLEET", ""),
        help="tenant fleet this replica serves: its whole request plane "
             "lives under fleet/<name>/ so several model fleets share one "
             "store behind one gateway")
    p.add_argument("--force-cpu", action="store_true",
                   help="serve on the CPU; without it the replica needs "
                        "a CUDA card")
    args = p.parse_args(argv)
    cfg = json.loads(args.config)
    device = resolve_device("cpu" if args.force_cpu else "cuda")

    port = int(os.environ[ENV_KV_PORT])
    tag = args.tag or (
        f"replica-a{os.environ.get('TPU_SANDBOX_AGENT_ID', '?')}"
        f"-g{os.environ.get('TPU_SANDBOX_GENERATION', '?')}")
    kv = KVClient(port=port)
    if args.fleet:
        from tpu_sandbox_torch.gateway.fleet import fleet_kv

        kv = fleet_kv(kv, args.fleet)
    worker = ReplicaWorker(
        kv, _build_engine(cfg, device), tag=tag,
        lease_ttl=float(cfg.get("lease_ttl", 3.0)))

    def on_term(signum, frame):
        worker.request_drain()

    signal.signal(signal.SIGTERM, on_term)
    try:
        worker.run(timeout=float(cfg.get("timeout", 300.0)))
    finally:
        kv.close()
        _write_launch_counts(tag, worker)
        get_recorder().flush()
    if worker._draining:
        print(f"[{tag}] drained: requeued {worker.stats.requeued} "
              f"in-flight request(s)", flush=True)
        return PREEMPTED_EXIT_CODE
    print(f"[{tag}] done: {worker.stats.__dict__}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
