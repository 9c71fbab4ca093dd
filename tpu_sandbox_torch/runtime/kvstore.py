"""Python face of the native TCP KV store (rendezvous/coordination): the
port's copy of ``tpu_sandbox/runtime/kvstore.py`` over its own copy of the
C++ source (``native/src/kvstore.cpp``, built by ``native/build.py`` into
``_build/``).

Role parity with torch's TCPStore behind env:// rendezvous (reference
test_init.py:76-91, SURVEY §2.3): rank-0 hosts the store, every rank
connects, and coordination primitives (key exchange, counters, barriers)
build on set/get/add. The training ranks rendezvous through
``torch.distributed`` (``runtime/bootstrap.py``); this store serves the
elastic plane: heartbeats, generation-scoped rendezvous, fault claims,
preemption flags and the sharded checkpoint's commit claims.
"""

from __future__ import annotations

import ctypes
import os
import random
import threading
import time
import weakref


def _env_token() -> str | None:
    """Default shared-secret for both ends: set TPU_SANDBOX_KV_TOKEN on
    every host of a cross-host job and servers require it, clients send it
    — respawned workers inherit the auth story through the environment
    with no extra flag plumbing."""
    return os.environ.get("TPU_SANDBOX_KV_TOKEN") or None


def _backoff_delays(timeout: float, *, base: float = 0.02, cap: float = 0.5):
    """Jittered exponential backoff delays, exhausted at a hard deadline.

    Yields the next sleep until ``timeout`` seconds (monotonic) have
    elapsed since the first ``next()``; the generator then ends, which is
    the caller's signal to give up. Each delay is the exponential envelope
    scaled by a uniform factor in [0.5, 1.5) — when an elastic restart
    relaunches a whole gang at once, unjittered clients hammer the
    listening socket in lockstep — and the final sleep is clamped so no
    caller oversleeps its own deadline."""
    deadline = time.monotonic() + timeout
    delay = base
    while True:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            return
        yield min(delay * (0.5 + random.random()), remaining)
        delay = min(delay * 2, cap)


def _lib() -> ctypes.CDLL:
    global _cached
    try:
        return _cached
    except NameError:
        pass
    from tpu_sandbox_torch.native.build import load_library

    lib = load_library("kvstore")
    lib.kv_server_start.restype = ctypes.c_void_p
    lib.kv_server_start.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p,
    ]
    lib.kv_server_port.restype = ctypes.c_int
    lib.kv_server_port.argtypes = [ctypes.c_void_p]
    lib.kv_server_stop.restype = None
    lib.kv_server_stop.argtypes = [ctypes.c_void_p]
    lib.kv_connect.restype = ctypes.c_int
    lib.kv_connect.argtypes = [ctypes.c_char_p, ctypes.c_int]
    lib.kv_request.restype = ctypes.c_int64
    lib.kv_request.argtypes = [
        ctypes.c_int, ctypes.c_char, ctypes.c_char_p, ctypes.c_int64,
        ctypes.c_char_p, ctypes.c_int64, ctypes.c_char_p, ctypes.c_int64,
    ]
    lib.kv_response.restype = ctypes.c_int64
    lib.kv_response.argtypes = [ctypes.c_int, ctypes.c_char_p,
                                ctypes.c_int64]
    lib.kv_close.restype = None
    lib.kv_close.argtypes = [ctypes.c_int]
    _cached = lib
    return lib


# Every live KVServer registers here so the test suite can detect servers a
# test forgot to stop (the C++ accept/worker threads are invisible to Python's
# threading.enumerate, so a leak check needs this explicit registry). WeakSet:
# the registry must not keep abandoned servers alive on its own.
_live_servers: "weakref.WeakSet[KVServer]" = weakref.WeakSet()


def live_servers() -> list["KVServer"]:
    """Servers constructed but not yet stop()ed (GC'd ones drop out)."""
    return [s for s in _live_servers if s._handle]


class KVServer:
    """In-process store server (rank 0 runs one). port=0 -> OS-assigned.

    ``bind`` defaults to loopback — the single-host topology needs nothing
    more, and an open port with no auth is not a default anyone should
    inherit. Cross-host deployment: ``bind="0.0.0.0"`` plus a shared-secret
    ``token`` (default: the TPU_SANDBOX_KV_TOKEN env var), which every
    connection must present in an opening hello frame before any store op
    is served. Auth without transport encryption: the token gates access,
    it does not hide traffic from the network path — run on a trusted
    fabric (DCN) or tunnel."""

    def __init__(self, port: int = 0, *, bind: str = "127.0.0.1",
                 token: str | None = None):
        if token is None:
            token = _env_token()
        self._lib = _lib()
        self._handle = self._lib.kv_server_start(
            bind.encode(), port, (token or "").encode()
        )
        if not self._handle:
            raise RuntimeError(
                f"kv_server_start failed on {bind}:{port}"
            )
        self.port = self._lib.kv_server_port(self._handle)
        self.bind = bind
        self.token = token
        _live_servers.add(self)

    def stop(self) -> None:
        if self._handle:
            self._lib.kv_server_stop(self._handle)
            self._handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.stop()


class KVClient:
    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        *,
        connect_timeout: float = 10.0,
        token: str | None = None,
    ):
        """Connect with bounded retry: worker processes race the rank-0
        server's listen() (an elastic restart relaunches everyone at once),
        so a refused connection within ``connect_timeout`` seconds is
        "server not up yet", not an error. ``connect_timeout=0`` restores
        the old single-attempt behavior.

        ``token`` (default: the TPU_SANDBOX_KV_TOKEN env var) is sent as
        the opening hello frame of every connection — required by servers
        started with a token, a no-op against servers without one."""
        if token is None:
            token = _env_token()
        self._lib = _lib()
        self.host, self.port = host, port
        self.token = token
        self.connect_timeout = connect_timeout
        retries = _backoff_delays(connect_timeout)
        while True:
            self._fd = self._lib.kv_connect(host.encode(), port)
            if self._fd >= 0:
                break
            delay = next(retries, None)
            if delay is None:
                raise ConnectionError(
                    f"kv_connect {host}:{port} failed "
                    f"(retried for {connect_timeout}s)"
                )
            time.sleep(delay)
        self._hello()
        # one request-response in flight per connection: the wire protocol is
        # length-prefixed with no framing recovery, so concurrent callers
        # (e.g. a Heartbeat thread sharing the owner's client) must serialize
        self._mu = threading.Lock()

    def _hello(self) -> None:
        """Authenticate this connection (first frame, before any store op).
        A raw round trip on purpose: runs inside _reconnect, which executes
        under _request's lock — re-entering _request would deadlock."""
        if not self.token:
            return
        tok = self.token.encode()
        out = ctypes.create_string_buffer(8)
        n = self._round_trip(b"H", tok, b"", out, 8)
        if n < 0:
            self._lib.kv_close(self._fd)
            self._fd = -1
            raise ConnectionError(
                f"kv auth to {self.host}:{self.port} failed — token "
                "rejected (TPU_SANDBOX_KV_TOKEN mismatch?)"
            )

    # Idempotent reads may be transparently retried on a fresh connection
    # after a transient socket error: re-running them cannot change store
    # state. Writes (set/add/delete/...) stay single-shot and fail loud —
    # a retried add() would double-count and a retried set() could resurrect
    # a key someone deleted in between.
    _RETRYABLE_OPS = frozenset({"G", "T", "L"})
    _READ_RETRIES = 5
    _RETRY_BASE_DELAY = 0.05

    def _reconnect(self) -> None:
        """Drop the (presumed broken) connection and dial again, bounded by
        the client's original connect_timeout."""
        if self._fd >= 0:
            self._lib.kv_close(self._fd)
            self._fd = -1
        retries = _backoff_delays(max(self.connect_timeout, 1.0))
        while True:
            self._fd = self._lib.kv_connect(self.host.encode(), self.port)
            if self._fd >= 0:
                self._hello()
                return
            delay = next(retries, None)
            if delay is None:
                raise ConnectionError(
                    f"kv reconnect {self.host}:{self.port} failed"
                )
            time.sleep(delay)

    def _round_trip(self, op: bytes, key: bytes, val: bytes, out,
                    cap: int) -> int:
        """One request and its response (kv_request's codes). A signal that
        lands while the response is awaited returns -3: by the next
        statement its Python handler has run, and the wait goes on. If the
        handler raises, the connection, which still owes that response, is
        dropped (the next request dials again) before the exception goes
        on."""
        if self._fd < 0:
            self._reconnect()
        try:
            n = self._lib.kv_request(self._fd, op, key, len(key), val,
                                     len(val), out, cap)
            while n == -3:
                n = self._lib.kv_response(self._fd, out, cap)
        except BaseException:
            self._lib.kv_close(self._fd)
            self._fd = -1
            raise
        return n

    def _request(
        self, op: str, key: str, val: bytes = b"", cap: int = 1 << 20
    ) -> bytes | None:
        out = ctypes.create_string_buffer(cap)
        attempts = self._READ_RETRIES if op in self._RETRYABLE_OPS else 1
        with self._mu:
            for attempt in range(attempts):
                n = self._round_trip(op.encode(), key.encode(), val, out,
                                     cap)
                if n == -2:
                    return None  # try-get: key missing
                if n >= 0:
                    return out.raw[:n]
                # n < 0: request failed (dead socket, server restarting).
                # For idempotent reads, back off with jitter and try again
                # on a fresh connection — a leader failover must not kill
                # every agent mid-poll over one dropped packet.
                if attempt + 1 >= attempts:
                    break
                time.sleep(
                    self._RETRY_BASE_DELAY * (2**attempt)
                    * (0.5 + random.random())
                )
                try:
                    self._reconnect()
                except ConnectionError:
                    break  # nothing is listening; fail below
        raise RuntimeError(f"kv {op} {key!r} failed")

    def set(self, key: str, value: bytes | str) -> None:
        if isinstance(value, str):
            value = value.encode()
        self._request("S", key, value)

    def set_ttl(self, key: str, value: bytes | str, ttl: float) -> None:
        """Set with a server-side time-to-live: the key reads as missing
        (and is purged) once ``ttl`` seconds pass. The hygiene primitive
        for claim keys — a crashed generation's shard-done/fault claims
        must not satisfy (or pollute) a later generation forever."""
        if isinstance(value, str):
            value = value.encode()
        if ttl <= 0:
            raise ValueError(f"ttl must be > 0, got {ttl}")
        self._request("X", key, f"{ttl}\n".encode() + value)

    def get(self, key: str) -> bytes:
        """Blocks until the key exists (TCPStore wait-get semantics)."""
        return self._request("G", key)

    def clone(self) -> "KVClient":
        """A fresh connection to the same store. Background users (e.g. a
        Heartbeat) should run on a clone: a blocking ``get`` holds this
        connection's request lock for its whole server-side wait."""
        return KVClient(self.host, self.port, token=self.token)

    def try_get(self, key: str) -> bytes | None:
        """Non-blocking get: ``None`` when the key does not exist (the poll
        primitive failure detection needs — a blocking get can't observe
        'rank never wrote its heartbeat')."""
        return self._request("T", key)

    def add(self, key: str, delta: int = 1) -> int:
        """Atomic fetch-add on a decimal counter; returns the new value."""
        return int(self._request("A", key, str(delta).encode()))

    def delete(self, key: str) -> None:
        self._request("D", key)

    def keys(self, prefix: str = "") -> list[str]:
        """All live keys starting with ``prefix`` (sorted; expired TTL keys
        excluded). Empty prefix lists the whole store."""
        raw = self._request("L", prefix)
        return [k.decode() for k in raw.split(b"\n") if k] if raw else []

    def delete_prefix(self, prefix: str) -> int:
        """Delete every key starting with ``prefix``; returns how many went.
        Refuses the empty prefix — 'wipe the whole store' should never be
        one typo away from 'clean my namespace'."""
        if not prefix:
            raise ValueError("delete_prefix needs a non-empty prefix")
        return int(self._request("P", prefix))

    def barrier(self, world_size: int, key: str = "barrier") -> None:
        """All ``world_size`` callers block until everyone arrived."""
        arrived = self.add(f"{key}/count", 1)
        if arrived == world_size:
            self.set(f"{key}/done", b"1")
        self.get(f"{key}/done")  # blocks until released

    def close(self) -> None:
        if self._fd >= 0:
            self._lib.kv_close(self._fd)
            self._fd = -1

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# Per-job namespacing
# ---------------------------------------------------------------------------

ENV_JOB_ID = "TPU_SANDBOX_JOB_ID"

# The "default job" (empty/absent/"default" job id) maps to the empty
# namespace: its keys are the historical bare forms (leader/*, budget/*,
# gen/*, job/done), so every single-job deployment — and every pre-cluster
# test — keeps its exact KV schema.
DEFAULT_JOB = "default"


def job_namespace(job_id: str | None) -> str:
    """The key prefix a job's runtime keys live under.

    Empty string for the default job (bare-prefix backward-compat alias);
    ``job/<id>/`` otherwise. Job ids may not contain '/' or whitespace —
    namespace sweeps (``delete_prefix("job/<id>/")``) must never be able
    to reach into a sibling job's keys via a crafted id."""
    if not job_id or job_id == DEFAULT_JOB:
        return ""
    if any(c in job_id for c in "/ \t\n\r"):
        raise ValueError(f"invalid job id {job_id!r}: '/' and whitespace "
                         "are reserved (namespace sweeps must stay scoped)")
    return f"job/{job_id}/"


def for_job(kv: "KVClient | NamespacedKV", job_id: str | None):
    """A view of ``kv`` scoped to one job's namespace.

    The default job gets the client back unchanged (bitwise-identical key
    schema to the pre-cluster runtime); any other id gets a
    ``NamespacedKV`` that prepends ``job/<id>/`` to every key. Layering a
    namespace on an already-namespaced view is a programming error."""
    ns = job_namespace(job_id)
    if not ns:
        return kv
    if isinstance(kv, NamespacedKV):
        raise ValueError("refusing to nest job namespaces: "
                         f"{kv.prefix!r} + {ns!r}")
    return NamespacedKV(kv, ns)


class NamespacedKV:
    """A KVClient view that prepends a fixed prefix to every key.

    This is the whole multi-tenant isolation story at the storage layer:
    two jobs sharing one store each hold a view under ``job/<id>/``, so
    their elections, budgets, generations, heartbeats, and fault claims
    land in disjoint key ranges — no coordination code above this layer
    needs to know other jobs exist. ``keys()`` strips the prefix on the
    way out so callers see the same relative names they wrote."""

    def __init__(self, client: KVClient, prefix: str):
        if not prefix:
            raise ValueError("NamespacedKV needs a non-empty prefix "
                             "(use the raw client for the default job)")
        self._kv = client
        self.prefix = prefix

    @property
    def host(self) -> str:
        return self._kv.host

    @property
    def port(self) -> int:
        return self._kv.port

    @property
    def token(self) -> str | None:
        return self._kv.token

    @property
    def raw(self) -> KVClient:
        """The underlying un-namespaced client (cluster-level callers
        only — e.g. the scheduler reading its own sched/* plane while
        holding a job view)."""
        return self._kv

    def set(self, key: str, value: bytes | str) -> None:
        self._kv.set(self.prefix + key, value)

    def set_ttl(self, key: str, value: bytes | str, ttl: float) -> None:
        self._kv.set_ttl(self.prefix + key, value, ttl)

    def get(self, key: str) -> bytes:
        return self._kv.get(self.prefix + key)

    def try_get(self, key: str) -> bytes | None:
        return self._kv.try_get(self.prefix + key)

    def add(self, key: str, delta: int = 1) -> int:
        return self._kv.add(self.prefix + key, delta)

    def delete(self, key: str) -> None:
        self._kv.delete(self.prefix + key)

    def keys(self, prefix: str = "") -> list[str]:
        full = self._kv.keys(self.prefix + prefix)
        return [k[len(self.prefix):] for k in full]

    def delete_prefix(self, prefix: str = "") -> int:
        # Empty relative prefix is legal here — it means "sweep my whole
        # namespace", which is exactly the scoped cleanup the scheduler
        # runs when a job ends; the store-wide wipe stays impossible
        # because self.prefix is never empty.
        return self._kv.delete_prefix(self.prefix + prefix)

    def barrier(self, world_size: int, key: str = "barrier") -> None:
        arrived = self.add(f"{key}/count", 1)
        if arrived == world_size:
            self.set(f"{key}/done", b"1")
        self.get(f"{key}/done")

    def clone(self) -> "NamespacedKV":
        return NamespacedKV(self._kv.clone(), self.prefix)

    def close(self) -> None:
        self._kv.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
