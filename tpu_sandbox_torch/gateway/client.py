"""Socket-path serve client: ``ServeClient``'s API over the gateway wire.
The port's copy of ``tpu_sandbox/gateway/client.py``.

``GatewayClient`` presents the same submit / result / retry / hedge
surface as ``serve/client.py::ServeClient`` but talks to a ``Gateway``
over TCP instead of to the KV store directly — the shape a real external
caller has, with no store credentials and no knowledge of the serve key
schema. Differences that exist because the door does:

- ``submit`` returns **False when the gateway sheds at the door**
  (infeasible deadline / full fleet). The verdict slot still holds an
  explicit SHED body, so ``result`` on a refused rid returns that verdict
  (or retries it, same as any other shed) rather than hanging.
- verdict waits are **server-side**: one 'W' frame parks on the gateway
  until the verdict lands or the bounded wait expires, instead of the
  client polling the store — clients pace retries/hedges between waits.
- retry and hedge go through the gateway ('C' clear + fresh 'S';
  'E' hedge), which re-routes with current fleet state — the retry of a
  shed request may land on a different replica than the original.

**Failover**: the client takes a gateway *list* (``endpoints``) and
treats every connection-shaped failure — connect refusal, mid-frame EOF,
hello timeout, TLS handshake that dies under it — as "this gateway is
gone, try the next", cycling with jittered backoff. Correctness across a
failover leans on the same store the gateways share: verdict slots,
claim markers, and queue entries all outlive any one gateway, so a
reissued 'W'/'T'/'C'/'E' is exactly the same operation against the same
state. The one op that is NOT blindly reissued is 'S': after a failover
mid-submit the client first polls the verdict slot ('T') on the new
gateway — a request whose verdict landed before the old gateway died is
returned, never re-executed. (A submit that died *before* the verdict is
reissued; re-enqueueing is harmless — replicas skip entries whose rid
already has a result, and claim-once publication arbitrates any race.)

**TLS**: pass ``tls=wire.make_client_ssl_context(ca_pem)`` and the
socket is wrapped before the first frame — the shared-secret hello rides
inside the encrypted channel. Auth rejection (ST_AUTH) is deterministic
and never fails over: every gateway shares the secret, so the next one
would only say no again.
"""

from __future__ import annotations

import random
import socket
import time
from dataclasses import dataclass, field

from tpu_sandbox_torch.gateway import wire
from tpu_sandbox_torch.obs import get_recorder, get_registry
from tpu_sandbox_torch.serve.client import ClientStats, RetriesExhausted

__all__ = ["GatewayClient", "GatewayError", "GatewayAuthError",
           "RetriesExhausted"]


@dataclass
class _Pending:
    prompt: list[int]
    max_new_tokens: int
    deadline_s: float | None
    temperature: float
    top_k: int
    seed: int
    submitted_at: float = 0.0
    retries_left: int = 0
    hedged: bool = False
    # one entry per submit/retry: {submitted_at, shed_reason?, resolved_at?}
    attempts: list = field(default_factory=list)


class GatewayError(Exception):
    """The gateway answered ST_ERR — a request-level failure."""


class GatewayAuthError(GatewayError):
    """Hello refused: wrong or missing shared secret."""


class GatewayClient:
    """One caller's connection to the gateway fleet. Not thread-safe; make
    one per caller thread (they share the gateways, not this socket).

    ``port`` keeps the single-gateway call sites working; HA callers pass
    ``endpoints=[(host, port), ...]`` instead and the client fails over
    down the list (wrapping around, jittered backoff between full
    cycles). ``tls`` is an ``ssl.SSLContext`` from
    :func:`wire.make_client_ssl_context`, applied to every connection."""

    def __init__(self, port: int | None = None, *, host: str = "127.0.0.1",
                 token: str | None = None, fleet: str = "",
                 deadline_s: float | None = None, max_retries: int = 2,
                 hedge_after: float | None = None,
                 connect_timeout: float = 5.0,
                 endpoints: list[tuple[str, int]] | None = None,
                 tls=None, failover_cycles: int = 3,
                 backoff_base: float = 0.05, backoff_cap: float = 0.5):
        if endpoints is None:
            if port is None:
                raise ValueError("need port or endpoints")
            endpoints = [(host, int(port))]
        if not endpoints:
            raise ValueError("endpoints must not be empty")
        self.fleet = fleet
        self.deadline_s = deadline_s
        self.max_retries = max_retries
        self.hedge_after = hedge_after
        self.connect_timeout = connect_timeout
        self.failover_cycles = failover_cycles
        self.backoff_base = backoff_base
        self.backoff_cap = backoff_cap
        self.stats = ClientStats()
        self._endpoints = [(str(h), int(p)) for h, p in endpoints]
        self._idx = 0  # endpoint currently connected (or next to try)
        self._tls = tls
        self._token = token
        self._rng = random.Random()  # backoff jitter only, never routing
        self._pending: dict[str, _Pending] = {}
        self._sock: socket.socket | None = None
        self._connect_any()

    @property
    def endpoint(self) -> tuple[str, int]:
        """The gateway this client is currently connected to."""
        return self._endpoints[self._idx]

    def close(self) -> None:
        if self._sock is not None:
            self._sock.close()
            self._sock = None

    def __enter__(self) -> "GatewayClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- connection + failover -----------------------------------------------

    def _connect_one(self, host: str, port: int) -> socket.socket:
        """Connect + (optional) TLS wrap + hello, all under the connect
        timeout — a gateway that accepts but never answers hello is as
        dead as one that refuses the SYN."""
        sock = socket.create_connection((host, port),
                                       timeout=self.connect_timeout)
        try:
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            if self._tls is not None:
                sock = self._tls.wrap_socket(sock, server_hostname=host)
            if self._token is not None:
                wire.send_frame(sock, wire.OP_HELLO, {"token": self._token})
                status, body = wire.recv_response(sock)
                if status != wire.ST_OK:
                    raise GatewayAuthError(
                        body.get("error", "hello refused"))
            sock.settimeout(None)
            return sock
        except BaseException:
            sock.close()
            raise

    def _connect_any(self) -> None:
        """Walk the endpoint list from the current index until one
        connects; jittered backoff between full cycles. Auth rejection
        raises immediately (deterministic — the next gateway holds the
        same secret); only connection-shaped failures advance the walk."""
        last: Exception | None = None
        for cycle in range(self.failover_cycles):
            for _ in range(len(self._endpoints)):
                host, port = self._endpoints[self._idx]
                try:
                    self._sock = self._connect_one(host, port)
                    return
                except GatewayAuthError:
                    raise
                except (ConnectionError, TimeoutError, OSError) as e:
                    last = e
                    self._idx = (self._idx + 1) % len(self._endpoints)
            delay = min(self.backoff_cap,
                        self.backoff_base * (2 ** cycle))
            time.sleep(self._rng.uniform(0, delay))
        raise GatewayError(
            f"no gateway reachable (tried {self._endpoints} "
            f"x{self.failover_cycles} cycles)") from last

    def _failover(self) -> None:
        self.close()
        self._idx = (self._idx + 1) % len(self._endpoints)
        self.stats.failovers += 1
        get_registry().counter("client.failovers").inc()
        self._connect_any()

    def _call(self, op: int, body: dict) -> tuple[int, dict]:
        wire.send_frame(self._sock, op, dict(body, fleet=self.fleet))
        return wire.recv_response(self._sock)

    def _call_robust(self, op: int, body: dict) -> tuple[int, dict]:
        """One op, surviving gateway death: connection-shaped failures
        fail over and reissue. 'W'/'T'/'C'/'E' reissue verbatim (the
        store state they act on outlives the gateway); 'S' first re-polls
        the verdict slot so a request that already completed is never
        re-executed."""
        failed_over = False
        budget = self.failover_cycles * len(self._endpoints)
        while True:
            try:
                if failed_over and op == wire.OP_SUBMIT:
                    status, verdict = self._call(
                        wire.OP_TRY, {"rid": body["rid"]})
                    if status == wire.ST_OK:
                        # the old gateway died after the verdict landed;
                        # surface it as an admit — result() finds it
                        return wire.ST_OK, {
                            "admitted": True,
                            "replica": verdict.get("replica", ""),
                            "depth": 0, "routed": "failover"}
                return self._call(op, body)
            except (ConnectionError, TimeoutError, OSError) as e:
                failed_over = True
                budget -= 1
                if budget < 0:
                    # every reconnect succeeded but the op itself keeps
                    # dying mid-frame — stop chasing a flapping fleet
                    raise GatewayError(
                        f"op {op} kept failing across failovers") from e
                self._failover()

    def _checked(self, op: int, body: dict) -> tuple[int, dict]:
        status, resp = self._call_robust(op, body)
        if status == wire.ST_ERR:
            raise GatewayError(resp.get("error", "gateway error"))
        if status == wire.ST_AUTH:
            raise GatewayAuthError(resp.get("error", "auth required"))
        return status, resp

    # -- the ServeClient surface ---------------------------------------------

    def submit(self, rid: str, prompt, max_new_tokens: int, *,
               deadline_s: float | None = None, temperature: float = 0.0,
               top_k: int = 0, seed: int = 0) -> bool:
        """Route one request through the door. True when admitted; False
        when the gateway shed it there (its SHED verdict is already in
        place, and ``result`` will burn a retry on it like any shed)."""
        d = self.deadline_s if deadline_s is None else deadline_s
        p = _Pending(prompt=[int(t) for t in prompt],
                     max_new_tokens=int(max_new_tokens), deadline_s=d,
                     temperature=temperature, top_k=top_k, seed=seed,
                     submitted_at=time.time(),
                     retries_left=self.max_retries)
        p.attempts.append({"submitted_at": p.submitted_at})
        self._pending[rid] = p
        self.stats.submitted += 1
        return self._submit_body(rid, p)

    def _submit_body(self, rid: str, p: _Pending) -> bool:
        body = {"rid": rid, "prompt": p.prompt,
                "max_new_tokens": p.max_new_tokens}
        if p.deadline_s is not None:
            body["deadline_s"] = p.deadline_s
        if p.temperature > 0.0:
            body.update(temperature=p.temperature, top_k=p.top_k,
                        seed=p.seed)
        # the trace ROOT: every downstream span of this request chains
        # back to this submit via the tc carried in the wire frame
        with get_recorder().span("submit", args={"rid": rid}) as sp:
            if sp.ctx is not None:
                body["tc"] = sp.ctx.to_wire()
            _status, resp = self._checked(wire.OP_SUBMIT, body)
        return bool(resp.get("admitted"))

    def result(self, rid: str, timeout: float = 60.0) -> dict:
        """Block until ``rid`` has a terminal verdict, retrying sheds and
        hedging stragglers. Same contract as ``ServeClient.result``: the
        "ok" verdict is returned; a shed that outlives the retry budget
        raises :class:`RetriesExhausted` (a rid this client never
        submitted gets its SHED verdict back as data)."""
        p = self._pending.get(rid)
        deadline = time.monotonic() + timeout
        while True:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                raise TimeoutError(f"no verdict for {rid} within {timeout}s")
            # bounded server-side wait; short slices so hedge checks run
            slice_s = min(remaining,
                          0.25 if self.hedge_after is not None else 5.0)
            status, verdict = self._checked(
                wire.OP_WAIT, {"rid": rid, "timeout": slice_s})
            if status != wire.ST_OK:
                if p is not None:
                    self._maybe_hedge(rid, p)
                continue
            if verdict.get("verdict", "ok") != "SHED":
                self._pending.pop(rid, None)
                self.stats.completed += 1
                return verdict
            if p is None:
                self.stats.shed += 1
                return verdict
            if p.retries_left <= 0:
                self._pending.pop(rid, None)
                self.stats.shed += 1
                if p.attempts:
                    p.attempts[-1].update(
                        shed_reason=verdict.get("reason", ""),
                        resolved_at=time.time())
                raise RetriesExhausted(rid, verdict, p.attempts)
            self._retry(rid, p, verdict)

    def _retry(self, rid: str, p: _Pending,
               verdict: dict | None = None) -> None:
        p.retries_left -= 1
        if p.attempts:
            p.attempts[-1].update(
                shed_reason="" if verdict is None
                else verdict.get("reason", ""),
                resolved_at=time.time())
        p.submitted_at = time.time()
        p.attempts.append({"submitted_at": p.submitted_at})
        p.hedged = False
        self._checked(wire.OP_CLEAR, {"rid": rid})
        self._submit_body(rid, p)  # fresh deadline, fresh routing
        self.stats.retries += 1
        get_registry().counter("client.retries").inc()

    def _maybe_hedge(self, rid: str, p: _Pending) -> None:
        if p.hedged or self.hedge_after is None:
            return
        if time.time() - p.submitted_at < self.hedge_after:
            return
        status, resp = self._checked(wire.OP_HEDGE, {"rid": rid})
        # "already has a verdict/lease" answers are not hedges; only an
        # actual duplicate enqueue consumes this request's hedge
        if status == wire.ST_OK and resp.get("hedged"):
            p.hedged = True
            self.stats.hedges += 1
            get_registry().counter("client.hedges").inc()

    # -- extras ---------------------------------------------------------------

    def try_result(self, rid: str) -> dict | None:
        status, verdict = self._checked(wire.OP_TRY, {"rid": rid})
        return verdict if status == wire.ST_OK else None

    def gateway_stats(self) -> dict:
        _status, body = self._checked(wire.OP_STATS, {})
        return body

    def metrics(self) -> dict:
        """Live fleet metrics scrape: the gateway's registry snapshot,
        its recorder stats, and per-replica recorder stats riding the
        TTL'd load reports."""
        _status, body = self._checked(wire.OP_METRICS, {})
        return body
