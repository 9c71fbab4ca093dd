"""The gateway process: one socket front door for the replica fleet.
The port's copy of ``tpu_sandbox/gateway/server.py``: the same keys
(``gateway/hb/<id>``, ``serve/tq/<tag>/``, ``serve/pin/<rid>``,
``deploy/shares/<fleet>``), flags, log lines and verdict bodies. It touches
no tensor; the replicas behind it run on the card.

``Gateway`` terminates client TCP connections (wire protocol in
``gateway/wire.py``), decides routing and admission per request, and
talks to the serve plane through the same KV keys replicas use — it is a
*client* of the serve protocol, not a new authority. Every correctness
property (claim-once verdicts, lease scavenging, drain/requeue) is
enforced by that protocol underneath; the gateway only decides *where*
work lands and *whether* it is worth landing at all.

Per admitted request:

1. hash the prompt's full blocks (``serve/cache.chain_digest``) with the
   fleet's block size;
2. match against the replica digests cached from ``serve/load/<tag>``
   reports; route to the deepest resident-prefix match via that replica's
   targeted queue (``serve/tq/<tag>/``), falling back to least-loaded,
   falling back to the shared queue when no report is fresh;
3. before enqueueing, run the admission policy (SLO feasibility by
   default). A door shed claims ``serve/done/<rid>`` and writes an
   explicit SHED verdict — the audit invariant "every rid gets exactly
   one terminal verdict" holds no matter where the shed happens.

Load reports are cached with *local* staleness: the gateway stamps
``time.monotonic()`` when a report's bytes change and ages against that
stamp — never wall-clock arithmetic against the replica's own clock
(cross-host skew; GL-R302). A report the KV TTL already expired drops
out of the table entirely on the next refresh.

The server is a plain asyncio loop on a daemon thread: the KV round
trips it performs per request are sub-millisecond against the local
store, so handlers call them inline; only verdict *waits* yield the loop
(``asyncio.sleep`` polling), keeping every other connection live while
one blocks on a slow decode.

**HA**: any number of gateways may front the same store — all shared
state (load reports, verdict slots, claim markers) already lives in the
KV store, and claim-once ``serve/done/<rid>`` arbitration makes
concurrent door sheds, hedges, and clears race-safe by construction.
Each gateway registers a TTL'd ``gateway/hb/<id>`` lease so clients and
the chaos harness can discover the live set
(:func:`live_gateway_endpoints`); a SIGKILLed gateway simply drops off
that list when its lease lapses, and every request it routed is still
claimable, scavengable, and verdict-bearing without it. Requests are
stamped with the routing gateway's id (``write_request(..., gw=...)``)
so replicas can attribute claims per gateway — the chaos claim audit's
evidence that a killed gateway's in-flight work was finished by the
fleet, not lost.
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
import json
import os
import random
import signal
import socket
import ssl
import sys
import threading
import time
import weakref
from dataclasses import dataclass, field

from tpu_sandbox_torch.deploy.registry import read_shares
from tpu_sandbox_torch.gateway import routing, wire
from tpu_sandbox_torch.gateway.fleet import (DEFAULT_FLEET, FleetSpec,
                                             fleet_kv)
from tpu_sandbox_torch.obs import get_recorder, get_registry
from tpu_sandbox_torch.obs.health import active_subjects
from tpu_sandbox_torch.runtime.kvstore import KVClient
from tpu_sandbox_torch.runtime.supervisor import ENV_KV_PORT
from tpu_sandbox_torch.serve.cache import chain_digest
from tpu_sandbox_torch.serve.replica import (enqueue, enqueue_to, k_done,
                                             k_lease, k_pin, k_req, k_result,
                                             write_request)

#: rid -> routed-replica memory per fleet, for hedge target exclusion; a
#: bounded ring — forgetting an old route only costs hedge precision
ROUTE_MEMORY = 4096

_LIVE_GATEWAYS: "weakref.WeakSet[Gateway]" = weakref.WeakSet()


def live_gateways() -> list["Gateway"]:
    """Gateways constructed but not yet closed — the conftest leak check."""
    return [g for g in _LIVE_GATEWAYS if not g.closed]


def k_gateway_hb(gateway_id: str) -> str:
    """The gateway's TTL'd liveness lease: value JSON {host, port, wall}."""
    return f"gateway/hb/{gateway_id}"


def live_gateway_endpoints(kv) -> list[tuple[str, str, int]]:
    """(gateway_id, host, port) for every gateway whose heartbeat lease is
    still live, sorted by id — the discovery surface a failover client or
    the chaos harness reads instead of a static endpoint list. A SIGKILLed
    gateway drops off when its lease TTL lapses; nothing deletes it."""
    out = []
    for key in kv.keys("gateway/hb/"):
        raw = kv.try_get(key)
        if raw is None:
            continue  # lapsed between list and read
        body = json.loads(raw)
        out.append((key[len("gateway/hb/"):],
                    str(body["host"]), int(body["port"])))
    return sorted(out)


@dataclass
class GatewayStats:
    connections: int = 0
    requests: int = 0
    admitted: int = 0
    shed_door: int = 0
    routed_prefix: int = 0      # targeted, with a resident-prefix match
    routed_balance: int = 0     # targeted, least-loaded fallback
    routed_shared: int = 0      # no fresh report anywhere: shared queue
    hedges: int = 0
    clears: int = 0
    auth_failures: int = 0
    protocol_errors: int = 0
    tls_handshake_failures: int = 0


@dataclass
class _ReplicaEntry:
    """One replica's last-seen load report plus the local change stamp."""

    raw: bytes
    report: dict
    changed_at: float  # time.monotonic() when ``raw`` last changed


@dataclass
class _FleetState:
    spec: FleetSpec
    kv: object  # fleet-scoped KV view, used only on the gateway thread
    replicas: dict = field(default_factory=dict)   # tag -> _ReplicaEntry
    inflight: dict = field(default_factory=dict)   # tag -> routed-unreported
    routes: dict = field(default_factory=dict)     # rid -> tag (bounded)
    last_refresh: float = -1e9
    # replica tags under an active health-plane replica_burn alert:
    # excluded from targeted routing until the alert's TTL expires
    unhealthy: frozenset = frozenset()
    # live canary traffic shares {version: share} from the deploy
    # controller (deploy/shares/<fleet>), None outside a canary phase
    shares: dict | None = None

    def note_route(self, rid: str, tag: str) -> None:
        self.routes.pop(rid, None)
        self.routes[rid] = tag
        while len(self.routes) > ROUTE_MEMORY:
            self.routes.pop(next(iter(self.routes)))


class Gateway:
    """Accepts client connections, routes requests across the fleet(s).

    One instance owns one listening socket, one KV connection (a clone of
    the one passed in — the gateway thread must not share a socket with
    the caller), and one routing table per fleet. ``start()`` returns
    once the port is bound; ``close()`` is idempotent and joins the
    thread."""

    def __init__(self, kv: KVClient, fleets: list[FleetSpec] | None = None,
                 *, host: str = "127.0.0.1", port: int = 0,
                 token: str | None = None, admission: str = "feasible",
                 policy: str = "prefix", policy_seed: int = 0,
                 max_report_age_s: float = 5.0,
                 refresh_min_s: float = 0.02, wait_cap_s: float = 60.0,
                 gateway_id: str | None = None, tls=None,
                 hb_ttl: float = 3.0):
        specs = fleets or [FleetSpec(name=DEFAULT_FLEET)]
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate fleet names: {names}")
        if admission not in ("feasible", "occupancy", "none"):
            raise ValueError(f"unknown admission mode {admission!r}")
        if policy not in ("prefix", "random"):
            raise ValueError(f"unknown routing policy {policy!r}")
        self._kv = kv.clone()
        self._fleets = {
            s.name: _FleetState(spec=s, kv=fleet_kv(self._kv, s.name))
            for s in specs
        }
        self._host = host
        self._requested_port = port
        self._token = token
        self.admission = admission
        # 'prefix' is the product; 'random' is the control arm the bench
        # measures the TTFT win against (uniform over fresh views)
        self.policy = policy
        self._rng = random.Random(policy_seed)
        self.max_report_age_s = max_report_age_s
        self.refresh_min_s = refresh_min_s
        self.wait_cap_s = wait_cap_s
        # the HA identity: stamped into every routed request (gw field)
        # and onto the gateway/hb/<id> liveness lease. The pid-derived
        # default is unique enough for ad-hoc runs; HA fleets and chaos
        # campaigns pass stable explicit ids.
        self.gateway_id = gateway_id or f"gw-{os.getpid()}"
        self._tls = tls  # ssl.SSLContext for the listener, or None
        self.hb_ttl = hb_ttl
        self.stats = GatewayStats()
        self.port: int | None = None
        self.closed = False
        self.killed = False
        self._thread: threading.Thread | None = None
        self._loop: asyncio.AbstractEventLoop | None = None
        self._stop: asyncio.Event | None = None
        self._writers: set = set()   # open connections, for abrupt kill()
        self._started = threading.Event()
        self._startup_error: BaseException | None = None
        _LIVE_GATEWAYS.add(self)

    # -- lifecycle -----------------------------------------------------------

    def start(self) -> "Gateway":
        self._thread = threading.Thread(
            target=self._thread_main, name="gateway", daemon=True)
        self._thread.start()
        if not self._started.wait(10.0):
            raise RuntimeError("gateway did not start within 10s")
        if self._startup_error is not None:
            raise RuntimeError("gateway failed to start") \
                from self._startup_error
        return self

    def close(self) -> None:
        if self.closed:
            return
        self.closed = True
        if self._loop is not None and self._thread is not None \
                and self._thread.is_alive() and self._stop is not None:
            with contextlib.suppress(RuntimeError):  # loop already gone
                self._loop.call_soon_threadsafe(self._stop.set)
            self._thread.join(timeout=5.0)
        if not self.killed:
            # a clean shutdown retires its lease immediately; a kill()
            # leaves it to lapse, exactly like a SIGKILLed process would
            with contextlib.suppress(ConnectionError, OSError):
                self._kv.delete(k_gateway_hb(self.gateway_id))
        self._kv.close()

    def kill(self) -> None:
        """Die abruptly: drop every open connection mid-whatever, stop
        answering, leave the heartbeat lease to TTL out — the in-process
        stand-in for SIGKILL that chaos campaigns fire. Unlike
        :meth:`close`, nothing is flushed or retired; clients see a
        mid-frame EOF and must fail over."""
        if self.closed:
            return
        self.killed = True
        if self._loop is not None and self._thread is not None \
                and self._thread.is_alive() and self._stop is not None:
            def _abort() -> None:
                for w in list(self._writers):
                    with contextlib.suppress(Exception):
                        transport = w.transport
                        if transport is not None:
                            transport.abort()
                self._stop.set()
            with contextlib.suppress(RuntimeError):
                self._loop.call_soon_threadsafe(_abort)
        self.close()

    def __enter__(self) -> "Gateway":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _thread_main(self) -> None:
        try:
            asyncio.run(self._amain())
        except BaseException as e:  # surface bind errors to start()
            self._startup_error = e
        finally:
            self._started.set()

    async def _amain(self) -> None:
        self._loop = asyncio.get_running_loop()
        self._stop = asyncio.Event()
        # TLS handshake failures (plaintext probes, wrong-CA alerts, bad
        # protocol versions) never reach _handle, and asyncio's sslproto
        # only debug-logs them (SSLError is an OSError). The one hook that
        # sees every failed handshake is the SSLObject the context builds —
        # install a counting subclass bound to this gateway's stats. The
        # context must therefore not be shared across gateways.
        if self._tls is not None:
            stats = self.stats

            class _CountingSSLObject(ssl.SSLObject):
                def do_handshake(sslobj) -> None:
                    try:
                        super().do_handshake()
                    except (ssl.SSLWantReadError, ssl.SSLWantWriteError):
                        raise  # handshake still in progress, not a failure
                    except Exception:
                        stats.tls_handshake_failures += 1
                        raise

            self._tls.sslobject_class = _CountingSSLObject
        server = await asyncio.start_server(
            self._handle, self._host, self._requested_port,
            ssl=self._tls,
            ssl_handshake_timeout=5.0 if self._tls is not None else None)
        self.port = server.sockets[0].getsockname()[1]
        hb = asyncio.ensure_future(self._heartbeat())
        self._started.set()
        try:
            async with server:
                await self._stop.wait()
                # leaving this block waits (Server.wait_closed, Python
                # 3.12.1+) until every connection has dropped: end the
                # open ones, or a connected client would hold the loop,
                # and its heartbeat, past close() (kill() aborted them)
                for w in list(self._writers):
                    w.close()
        finally:
            hb.cancel()
            with contextlib.suppress(asyncio.CancelledError):
                await hb

    async def _heartbeat(self) -> None:
        """Refresh the gateway/hb/<id> liveness lease on a half-TTL
        cadence. The lease is discovery, not authority: losing it (or the
        whole gateway) costs clients a failover, never a request."""
        body = json.dumps({"host": self._host, "port": self.port,
                           "wall": time.time()})
        while True:
            self._kv.set_ttl(k_gateway_hb(self.gateway_id), body,
                             self.hb_ttl)
            await asyncio.sleep(self.hb_ttl / 2)

    # -- connection handling -------------------------------------------------

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        if self.killed or self.closed:
            # accepted before kill() or close() and handled after it:
            # neither saw this connection, so drop it here (a kill() as
            # SIGKILL would)
            writer.transport.abort()
            return
        self.stats.connections += 1
        self._writers.add(writer)
        sock = writer.get_extra_info("socket")
        if sock is not None:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        authed = self._token is None
        try:
            while True:
                op, payload = await wire.read_frame(reader)
                if op == wire.OP_HELLO:
                    authed = await self._hello(writer, payload)
                    if not authed:
                        return
                    continue
                if not authed:
                    # any op before a good hello is an auth failure, even a
                    # well-formed one — close, never serve
                    self.stats.auth_failures += 1
                    await wire.write_response(
                        writer, wire.ST_AUTH, {"error": "hello required"})
                    return
                if op not in wire.KNOWN_OPS:
                    raise wire.ProtocolError(f"unknown op {op}")
                status, resp = await self._dispatch(op,
                                                   wire.decode_body(payload))
                await wire.write_response(writer, status, resp)
        except asyncio.IncompleteReadError as e:
            # bare EOF between frames is a clean disconnect; EOF mid-frame
            # is a protocol violation (truncated frame)
            if e.partial:
                self.stats.protocol_errors += 1
        except wire.ProtocolError:
            self.stats.protocol_errors += 1
        except (ConnectionError, OSError):
            pass  # peer vanished; nothing to answer
        finally:
            # a request exists only once its 'S' frame fully dispatched, so
            # closing here never strands one — it just ends the conversation
            self._writers.discard(writer)
            writer.close()
            with contextlib.suppress(ConnectionError, OSError):
                await writer.wait_closed()

    async def _hello(self, writer: asyncio.StreamWriter,
                     payload: bytes) -> bool:
        body = wire.decode_body(payload) if payload else {}
        if self._token is None or body.get("token") == self._token:
            await wire.write_response(writer, wire.ST_OK, {})
            return True
        self.stats.auth_failures += 1
        await wire.write_response(
            writer, wire.ST_AUTH, {"error": "bad token"})
        return False

    async def _dispatch(self, op: int, body: dict) -> tuple[int, dict]:
        if op == wire.OP_STATS:
            return wire.ST_OK, self._stats_body()
        if op == wire.OP_METRICS:
            return wire.ST_OK, self._metrics_body()
        try:
            fleet = self._fleet_of(body)
        except KeyError as e:
            return wire.ST_ERR, {"error": str(e)}
        try:
            if op == wire.OP_SUBMIT:
                return self._submit(fleet, body)
            if op == wire.OP_WAIT:
                return await self._wait(fleet, body)
            if op == wire.OP_TRY:
                return self._try(fleet, body)
            if op == wire.OP_HEDGE:
                return self._hedge(fleet, body)
            return self._clear(fleet, body)
        except (KeyError, TypeError, ValueError) as e:
            # a malformed *body* (missing rid, bad types) fails the one
            # request, not the connection — the framing was fine
            return wire.ST_ERR, {"error": f"{type(e).__name__}: {e}"}

    def _fleet_of(self, body: dict) -> _FleetState:
        name = body.get("fleet", DEFAULT_FLEET)
        state = self._fleets.get(name)
        if state is None:
            raise KeyError(f"unknown fleet {name!r} "
                           f"(serving: {sorted(self._fleets)})")
        return state

    # -- routing table -------------------------------------------------------

    def _refresh(self, fleet: _FleetState) -> None:
        """Re-read ``serve/load/`` if the cache is older than the refresh
        floor. A report whose bytes changed gets a new local change stamp
        and resets the routed-but-unreported count (the replica has since
        told us what it actually sees); a report the TTL expired drops its
        replica from the table."""
        if time.monotonic() - fleet.last_refresh < self.refresh_min_s:
            return
        fleet.last_refresh = time.monotonic()
        seen = set()
        for key in fleet.kv.keys("serve/load/"):
            raw = fleet.kv.try_get(key)
            if raw is None:
                continue  # expired between list and read
            tag = key[len("serve/load/"):]
            seen.add(tag)
            entry = fleet.replicas.get(tag)
            if entry is None or entry.raw != raw:
                fleet.replicas[tag] = _ReplicaEntry(
                    raw=raw, report=json.loads(raw),
                    changed_at=time.monotonic())
                fleet.inflight[tag] = 0
        for tag in [t for t in fleet.replicas if t not in seen]:
            del fleet.replicas[tag]
            fleet.inflight.pop(tag, None)
        # the health plane's verdict rides the same refresh cadence: a
        # replica with an active per-replica burn alert keeps reporting
        # (it is alive) but is excluded from targeted routing until the
        # alert's TTL lapses
        fleet.unhealthy = frozenset(
            active_subjects(fleet.kv, "replica_burn"))
        # canary traffic shares live at the store ROOT (the deploy plane
        # spans fleets), keyed by the fleet's name
        fleet.shares = read_shares(self._kv, fleet.spec.name)

    def _views(self, fleet: _FleetState) -> list[routing.ReplicaView]:
        now = time.monotonic()
        return [
            routing.parse_report(
                tag, entry.report, age_s=now - entry.changed_at,
                pending_local=fleet.inflight.get(tag, 0))
            for tag, entry in sorted(fleet.replicas.items())
        ]

    # -- ops -----------------------------------------------------------------

    def _submit(self, fleet: _FleetState, body: dict) -> tuple[int, dict]:
        self.stats.requests += 1
        rid = body["rid"]
        prompt = [int(t) for t in body["prompt"]]
        max_new = int(body["max_new_tokens"])
        deadline_s = body.get("deadline_s")
        if deadline_s is not None:
            deadline_s = float(deadline_s)
        rec = get_recorder()
        t_route = time.monotonic()
        self._refresh(fleet)
        chain = chain_digest(prompt, fleet.spec.block_size)
        # workload-trace riders on the route span: enough to replay this
        # request against a twin (obs/workload.py) without the payload
        route_args = {"rid": rid, "plen": len(prompt),
                      "chain": str(chain[-1]) if chain else "",
                      "fleet": fleet.spec.name or "default"}
        if deadline_s is not None:
            route_args["deadline_s"] = round(deadline_s, 6)
        views = routing.fresh(self._views(fleet), self.max_report_age_s)
        if fleet.shares:
            # canary split: draw a version by share, route within the
            # replicas acked at that version. No fresh replica at the
            # drawn version yet (swap mid-ack) -> route over everyone;
            # the version pin at claim keeps correctness regardless —
            # shares are a traffic split, never a correctness gate.
            drawn = routing.pick_by_share(fleet.shares, self._rng.random())
            if drawn is not None:
                pinned = routing.pin_version(views, drawn)
                if pinned:
                    views = pinned
        if self.policy == "random":
            healthy = [v for v in views if v.tag not in fleet.unhealthy]
            choice = None
            if healthy:
                v = healthy[self._rng.randrange(len(healthy))]
                choice = (v, routing.match_depth(chain, v))
        else:
            choice = routing.choose(chain, views, exclude=fleet.unhealthy)
        if choice is None:
            if deadline_s is not None and self.admission == "feasible":
                # a deadline-carrying request against a fleet with ZERO
                # fresh reports cannot have its feasibility estimated —
                # and a dead fleet would let it rot until the client's
                # whole retry budget burned. Fast-fail at the door with
                # the same claim-once verdict slot as door:infeasible.
                route_ctx = rec.complete(
                    "route", t_route, parent=body.get("tc"),
                    args={**route_args, "routed": "none"})
                with rec.span("door:no_replicas", parent=route_ctx,
                              args={"rid": rid}):
                    self._door_shed(fleet, rid, "no_replicas", 0.0)
                return wire.ST_OK, {"admitted": False,
                                    "reason": "no_replicas",
                                    "estimate_s": 0.0, "replica": ""}
            # no deadline to defend (or admission is not feasibility-
            # based): admit to the shared queue — a warming-up fleet will
            # claim it, and engine-side guardrails still apply
            route_ctx = rec.complete("route", t_route, parent=body.get("tc"),
                                     args={**route_args, "routed": "shared"})
            with rec.span("enqueue", parent=route_ctx,
                          args={"rid": rid}) as sp:
                self._enqueue_request(fleet, body, rid, prompt, max_new,
                                      deadline_s, target=None, tc=sp.ctx)
            self.stats.routed_shared += 1
            self.stats.admitted += 1
            return wire.ST_OK, {"admitted": True, "replica": "",
                                "depth": 0, "routed": "shared"}
        view, depth = choice
        ok, reason, est = routing.admit(
            view, mode=self.admission,
            service_rate_rps=fleet.spec.service_rate_rps,
            deadline_s=deadline_s,
            occupancy_bound=fleet.spec.occupancy_bound)
        route_ctx = rec.complete("route", t_route, parent=body.get("tc"),
                                 args={**route_args, "replica": view.tag})
        if not ok:
            # the trace's terminal span for a door shed: door:<reason>
            with rec.span(f"door:{reason}", parent=route_ctx,
                          args={"rid": rid}):
                self._door_shed(fleet, rid, reason, est)
            return wire.ST_OK, {"admitted": False, "reason": reason,
                                "estimate_s": round(est, 6),
                                "replica": view.tag}
        with rec.span("enqueue", parent=route_ctx,
                      args={"rid": rid, "target": view.tag}) as sp:
            self._enqueue_request(fleet, body, rid, prompt, max_new,
                                  deadline_s, target=view.tag, tc=sp.ctx)
        if depth > 0:
            self.stats.routed_prefix += 1
        else:
            self.stats.routed_balance += 1
        self.stats.admitted += 1
        return wire.ST_OK, {"admitted": True, "replica": view.tag,
                            "depth": depth, "estimate_s": round(est, 6),
                            "routed": "prefix" if depth else "balance"}

    def _enqueue_request(self, fleet: _FleetState, body: dict, rid: str,
                         prompt: list[int], max_new: int,
                         deadline_s: float | None,
                         target: str | None, tc=None) -> None:
        write_request(
            fleet.kv, rid, prompt, max_new,
            deadline_unix=None if deadline_s is None
            else time.time() + deadline_s,
            temperature=float(body.get("temperature", 0.0)),
            top_k=int(body.get("top_k", 0)),
            seed=int(body.get("seed", 0)),
            tc=None if tc is None else tc.to_wire(),
            gw=self.gateway_id)
        if target is None:
            enqueue(fleet.kv, rid)
        else:
            enqueue_to(fleet.kv, target, rid)
            fleet.inflight[target] = fleet.inflight.get(target, 0) + 1
            fleet.note_route(rid, target)

    def _door_shed(self, fleet: _FleetState, rid: str, reason: str,
                   est: float) -> None:
        """Refuse at the door with the same claim-once verdict discipline
        replicas use: first publisher of serve/done/<rid> wins, so a
        door shed racing a retry's fresh execution still yields exactly
        one terminal verdict per rid."""
        self.stats.shed_door += 1
        get_registry().counter("gateway.shed.door",
                               labels={"reason": reason}).inc()
        if fleet.kv.add(k_done(rid)) == 1:
            fleet.kv.set(k_result(rid), json.dumps({
                "rid": rid, "verdict": "SHED", "reason": f"door:{reason}",
                "estimate_s": round(est, 6), "replica": "gateway"}))

    async def _wait(self, fleet: _FleetState,
                    body: dict) -> tuple[int, dict]:
        rid = body["rid"]
        timeout = min(float(body.get("timeout", 30.0)), self.wait_cap_s)
        deadline = time.monotonic() + timeout
        while True:
            raw = fleet.kv.try_get(k_result(rid))
            if raw is not None:
                return wire.ST_OK, json.loads(raw)
            if time.monotonic() >= deadline:
                return wire.ST_TIMEOUT, {"rid": rid, "timeout_s": timeout}
            await asyncio.sleep(0.01)

    def _try(self, fleet: _FleetState, body: dict) -> tuple[int, dict]:
        raw = fleet.kv.try_get(k_result(body["rid"]))
        if raw is None:
            return wire.ST_MISSING, {"rid": body["rid"]}
        return wire.ST_OK, json.loads(raw)

    def _hedge(self, fleet: _FleetState, body: dict) -> tuple[int, dict]:
        """Duplicate a verdictless, leaseless request onto the next-best
        replica, excluding wherever we routed it first (hedging onto the
        suspect straggler is no hedge at all). Claim-once verdicts make
        the duplicate harmless."""
        rid = body["rid"]
        if fleet.kv.try_get(k_result(rid)) is not None:
            return wire.ST_OK, {"hedged": False, "reason": "verdict"}
        if fleet.kv.try_get(k_lease(rid)) is not None:
            return wire.ST_OK, {"hedged": False, "reason": "lease"}
        raw = fleet.kv.try_get(k_req(rid))
        if raw is None:
            return wire.ST_MISSING, {"rid": rid}
        req = json.loads(raw)
        self._refresh(fleet)
        first = fleet.routes.get(rid, "")
        chain = chain_digest(req["prompt"], fleet.spec.block_size)
        views = routing.fresh(self._views(fleet), self.max_report_age_s)
        exclude = fleet.unhealthy | ({first} if first else set())
        choice = routing.choose(chain, views, exclude=frozenset(exclude))
        if choice is None:
            enqueue(fleet.kv, rid)
            replica = ""
        else:
            view, _depth = choice
            enqueue_to(fleet.kv, view.tag, rid)
            fleet.inflight[view.tag] = fleet.inflight.get(view.tag, 0) + 1
            replica = view.tag
        self.stats.hedges += 1
        return wire.ST_OK, {"hedged": True, "replica": replica}

    def _clear(self, fleet: _FleetState, body: dict) -> tuple[int, dict]:
        """Clear a terminal SHED verdict so a retry's fresh execution can
        publish — the socket form of ServeClient._retry's delete pair."""
        rid = body["rid"]
        fleet.kv.delete(k_result(rid))
        fleet.kv.delete(k_done(rid))
        # a retry is a NEW lifecycle: drop the weight-version pin so the
        # fresh execution pins whatever its claimer currently runs
        fleet.kv.delete(k_pin(rid))
        self.stats.clears += 1
        return wire.ST_OK, {"rid": rid}

    def _stats_body(self) -> dict:
        fleets = {}
        for name, fleet in self._fleets.items():
            self._refresh(fleet)
            fleets[name or "default"] = {
                "replicas": {
                    v.tag: {"queue_depth": v.queue_depth, "active": v.active,
                            "pending_local": v.pending_local,
                            "digest_len": len(v.digest),
                            "age_s": round(v.age_s, 3)}
                    for v in self._views(fleet)
                },
            }
        return {"stats": dict(self.stats.__dict__), "fleets": fleets,
                "admission": self.admission}

    def _metrics_body(self) -> dict:
        """The OP_METRICS scrape: this process's registry snapshot and
        recorder stats, plus each replica's recorder stats as last seen
        riding its TTL'd load report — one scrape sees whether ANY
        process in the fleet is silently dropping trace events."""
        replica_recorders = {}
        for name, fleet in self._fleets.items():
            self._refresh(fleet)
            for tag, entry in sorted(fleet.replicas.items()):
                stats = entry.report.get("recorder")
                if stats is not None:
                    replica_recorders[f"{name or 'default'}/{tag}"] = stats
        own = get_recorder().stats()
        return {"registry": get_registry().snapshot(),
                "recorder": own,
                "replica_recorders": replica_recorders,
                # fleet-wide drop total: the one number the
                # recorder_drops health rule and an operator both want
                "dropped_events": own["dropped"] + sum(
                    s.get("dropped", 0)
                    for s in replica_recorders.values())}


# -- gateway process main -----------------------------------------------------


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="serving gateway: routes client requests across the "
                    "replica fleet(s) behind one socket endpoint")
    p.add_argument("--kv-port", type=int,
                   default=int(os.environ.get(ENV_KV_PORT, "0")))
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=0)
    p.add_argument("--token",
                   default=os.environ.get("TPU_SANDBOX_GATEWAY_TOKEN"))
    p.add_argument("--admission", default="feasible",
                   choices=["feasible", "occupancy", "none"])
    p.add_argument("--policy", default="prefix",
                   choices=["prefix", "random"])
    p.add_argument("--fleets", default=None,
                   help="JSON list of FleetSpec kwargs; default is the "
                        "single bare-namespace fleet")
    p.add_argument("--gateway-id", default=None,
                   help="stable HA identity for the gateway/hb lease and "
                        "request stamping (default: gw-<pid>)")
    p.add_argument("--tls-cert", default=None,
                   help="server certificate PEM; with --tls-key, every "
                        "external connection must speak TLS")
    p.add_argument("--tls-key", default=None)
    args = p.parse_args(argv)
    if not args.kv_port:
        p.error(f"--kv-port or {ENV_KV_PORT} required")
    if bool(args.tls_cert) != bool(args.tls_key):
        p.error("--tls-cert and --tls-key go together")
    fleets = None
    if args.fleets:
        fleets = [FleetSpec(**f) for f in json.loads(args.fleets)]
    tls = None
    if args.tls_cert:
        tls = wire.make_server_ssl_context(args.tls_cert, args.tls_key)
    kv = KVClient(port=args.kv_port)
    gw = Gateway(kv, fleets, host=args.host, port=args.port,
                 token=args.token, admission=args.admission,
                 policy=args.policy, gateway_id=args.gateway_id, tls=tls)
    gw.start()
    print(f"[gateway] {gw.gateway_id} listening on {args.host}:{gw.port} "
          f"(admission={args.admission}, "
          f"tls={'on' if tls is not None else 'off'})", flush=True)
    stopped = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: stopped.set())
    try:
        stopped.wait()
    finally:
        gw.close()
        kv.close()
        # the route and enqueue spans still buffered (the recorder writes
        # every 64 records) would go with the process otherwise
        get_recorder().flush()
        print(f"[gateway] closed: {gw.stats.__dict__}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
