"""Stage transport: activations and cotangents shipped between stages.
Counterpart of ``tpu_sandbox/mpmd/transport.py``: ``pack_views``,
``pack_arrays`` and ``iter_chunks`` (:80-126), ``unpack_arrays`` (:128),
``TransportStats``, ``Transport``, ``LocalTransport`` (:204),
``KVTransport`` (:303), ``DeviceTransport`` (:463) and ``EdgeNames``
(:571), with the same keys, meta and chunking.

Three wires behind one narrow interface (put / get / poll / claim /
release_step / stats):

- :class:`KVTransport` — the KV store (control plane) plus host staging:
  a producer stages its tensor to host bytes, chunks them under the
  store's read cap and publishes a seq-numbered slot; the consumer reads
  each chunk as soon as it lands and reassembles through memoryviews.
- :class:`LocalTransport` — the in-process host wire (dict plus condition
  variable), the same delivery contract without sockets.
- :class:`DeviceTransport` — stages in one process: ``put`` hands the
  producer's tensors (on the card, as they are) straight to the consumer,
  while a durable *journal* transport underneath records the same slot
  bytes for recovery. The journal owns produce-once commits and
  claim-once consumption; the tensors are a cache in front of it.

Delivery discipline, as JAX's:

- **Produce once.** ``put`` claims the slot's commit counter; only the
  first claimant writes. A replaying stage re-puts, loses the claim,
  sees the slot complete and skips; if the first claimant died mid-write
  (commit claimed, meta never landed) the replayer finishes the slot with
  the same deterministic bytes.
- **Claim-once consume.** ``claim`` is a per-generation fetch-add on the
  slot's claim counter: within one generation a slot feeds one consumer
  op; a relaunched generation claims afresh.
- **TTL hygiene.** Claim markers carry a TTL; slot payloads only if asked.
- ``release_step`` drops every slot of an edge at a step the whole
  pipeline has applied.

The wire format is JAX's byte for byte for every dtype numpy has: raw
little-endian bytes, meta ``{"arrays": [{"shape", "dtype"}], ...}`` with
numpy's dtype string. bfloat16, which numpy lacks, is written as
``"bfloat16"`` and read back to a ``torch.bfloat16`` tensor through a
16-bit integer view; JAX's ``unpack_arrays`` reads that spelling as
ml_dtypes' bfloat16. JAX itself writes a bfloat16 array as ``'<V2'``
(its ``dtype.str``), which reads back as raw 2-byte voids: such a slot is
refused here with an error that names it.

``put`` takes torch tensors (CPU or CUDA) or numpy arrays; the host wires
stage a CUDA tensor to host bytes. ``get`` on a host wire returns numpy
arrays (a ``torch.bfloat16`` CPU tensor for bfloat16); the device wire
returns the published tensors.
"""

from __future__ import annotations

import json
import threading
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from tpu_sandbox_torch.obs import get_recorder, get_registry

SLOT_PREFIX = "mpmd/slot"
CLAIM_PREFIX = "mpmd/claim"
#: the wire's name for bfloat16 (numpy has no such dtype)
BF16 = "bfloat16"


def _account(stats: TransportStats) -> None:
    """Mirror per-transport stats into the process metrics registry."""
    reg = get_registry()
    reg.gauge("transport.puts").set(stats.puts)
    reg.gauge("transport.gets").set(stats.gets)
    reg.gauge("transport.bytes_out").set(stats.bytes_out)
    reg.gauge("transport.bytes_in").set(stats.bytes_in)


def _host_array(a) -> tuple[np.ndarray, str]:
    """(contiguous host array, wire dtype string) of a tensor or array."""
    if isinstance(a, torch.Tensor):
        t = a.detach()
        if t.dtype == torch.bfloat16:
            return (t.contiguous().view(torch.int16).cpu().numpy(), BF16)
        a = t.cpu().numpy()
    a = np.asarray(a)
    if a.dtype.kind == "V":
        if a.dtype.name != BF16:
            raise TypeError(f"no wire dtype for {a.dtype!r}")
        a = a.view(np.int16)
        return np.ascontiguousarray(a), BF16
    if not a.flags["C_CONTIGUOUS"]:
        a = np.ascontiguousarray(a)
    return a, a.dtype.str


def pack_views(arrays) -> tuple[dict, list[memoryview]]:
    """[tensors or arrays] -> (meta, per-array memoryviews of their host
    bytes). Raw little-endian bytes, no pickling."""
    meta_arrays = []
    views = []
    for a in arrays:
        shape = list(a.shape)
        host, dtype = _host_array(a)
        meta_arrays.append({"shape": shape, "dtype": dtype})
        views.append(memoryview(host).cast("B") if host.nbytes
                     else memoryview(b""))
    return {"arrays": meta_arrays}, views


def pack_arrays(arrays) -> tuple[dict, bytes]:
    """[tensors or arrays] -> (meta, joined payload)."""
    meta, views = pack_views(arrays)
    return meta, b"".join(views)


def iter_chunks(views: list[memoryview], chunk_bytes: int):
    """Yield ``chunk_bytes``-sized bytes across the concatenation of
    ``views`` without materialising the joined payload."""
    pending: list[memoryview] = []
    size = 0
    for v in views:
        off = 0
        while off < len(v):
            take = min(chunk_bytes - size, len(v) - off)
            pending.append(v[off:off + take])
            size += take
            off += take
            if size == chunk_bytes:
                yield pending[0].tobytes() if len(pending) == 1 \
                    else b"".join(pending)
                pending, size = [], 0
    if size:
        yield pending[0].tobytes() if len(pending) == 1 \
            else b"".join(pending)


def unpack_arrays(meta: dict, payload) -> list:
    """(meta, payload bytes-like) -> [arrays]: numpy arrays aliasing the
    payload, and a ``torch.bfloat16`` CPU tensor for each bfloat16 entry.
    Refuses a slot whose dtype is a raw void (JAX's bfloat16 spelling)."""
    view = memoryview(payload)
    out = []
    off = 0
    for spec in meta["arrays"]:
        name = spec["dtype"]
        bf16 = name == BF16
        dt = np.dtype(np.int16 if bf16 else name)
        if dt.kind == "V":
            raise ValueError(
                f"slot dtype {name!r} is a raw void: JAX's wire writes a "
                "bfloat16 array so (its dtype.str), and the bits cannot be "
                "told from any other 2-byte type; write bfloat16 as "
                f"{BF16!r}")
        n = int(np.prod(spec["shape"], dtype=np.int64)) * dt.itemsize
        if off + n > len(view):
            raise ValueError(
                f"payload is {len(view)} bytes, meta describes more")
        arr = np.frombuffer(view[off:off + n], dt).reshape(spec["shape"])
        out.append(torch.from_numpy(arr.copy()).view(torch.bfloat16)
                   if bf16 else arr)
        off += n
    if off != len(view):
        raise ValueError(
            f"payload is {len(view)} bytes, meta describes {off}")
    return out


def _nbytes(arrays) -> int:
    return sum(a.numel() * a.element_size() if isinstance(a, torch.Tensor)
               else np.asarray(a).nbytes for a in arrays)


@dataclass
class TransportStats:
    """Wire accounting. Latencies are whole-op wall times (staging + chunk
    puts / reassembly; blocking waits apart)."""

    puts: int = 0
    gets: int = 0
    bytes_out: int = 0
    bytes_in: int = 0
    put_seconds: float = 0.0
    get_seconds: float = 0.0       # retrieval work only (wait excluded)
    get_wait_seconds: float = 0.0  # time blocked on a slot not yet produced
    device_hits: int = 0           # gets served from the device buffer
    journal_fallbacks: int = 0     # gets that fell back to the journal

    def snapshot(self) -> dict:
        out = {
            "puts": self.puts, "gets": self.gets,
            "bytes_out": self.bytes_out, "bytes_in": self.bytes_in,
            "put_seconds": round(self.put_seconds, 6),
            "get_seconds": round(self.get_seconds, 6),
            "get_wait_seconds": round(self.get_wait_seconds, 6),
        }
        if self.device_hits or self.journal_fallbacks:
            out["device_hits"] = self.device_hits
            out["journal_fallbacks"] = self.journal_fallbacks
        return out


class Transport:
    """Interface contract; see the module docstring for the semantics."""

    stats: TransportStats

    def put(self, edge: str, step: int, mb: int, arrays) -> bool:
        """Publish a slot. True if this call won the produce claim, False
        when the slot was already complete (idempotent replay)."""
        raise NotImplementedError

    def get(self, edge: str, step: int, mb: int, *,
            timeout: float = 60.0) -> list:
        """Block until the slot exists; TimeoutError past ``timeout``."""
        raise NotImplementedError

    def poll(self, edge: str, step: int, mb: int) -> bool:
        raise NotImplementedError

    def claim(self, edge: str, step: int, mb: int, generation: int) -> bool:
        """Claim-once consume marker; True exactly once per generation."""
        raise NotImplementedError

    def release_step(self, edge: str, step: int) -> None:
        """Drop every slot of ``edge`` at ``step`` (pipeline has applied)."""
        raise NotImplementedError


class LocalTransport(Transport):
    """In-process transport over a dict + condition variable, with the KV
    wire's produce-once/claim-once contract."""

    def __init__(self):
        self._slots: dict[tuple, tuple[dict, bytes]] = {}
        self._commits: dict[tuple, int] = {}
        self._claims: dict[tuple, int] = {}
        self._cond = threading.Condition()
        self.stats = TransportStats()

    def put(self, edge, step, mb, arrays) -> bool:
        t0 = time.perf_counter()
        meta, payload = pack_arrays(arrays)
        key = (edge, step, mb)
        with self._cond:
            self._commits[key] = self._commits.get(key, 0) + 1
            first = self._commits[key] == 1
            if not first and key in self._slots:
                return False
            self._slots[key] = (meta, payload)
            self._cond.notify_all()
        self.stats.puts += 1
        self.stats.bytes_out += len(payload)
        self.stats.put_seconds += time.perf_counter() - t0
        _account(self.stats)
        get_recorder().instant(
            "slot:put", args={"edge": edge, "step": step, "mb": mb,
                              "bytes": len(payload), "first": first})
        return first

    def get(self, edge, step, mb, *, timeout: float = 60.0):
        t0 = time.perf_counter()
        t_mono = time.monotonic()
        key = (edge, step, mb)
        deadline = t0 + timeout
        waited = 0.0
        with self._cond:
            while key not in self._slots:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    raise TimeoutError(f"transport slot {key} never arrived")
                w0 = time.perf_counter()
                self._cond.wait(min(remaining, 0.05))
                waited += time.perf_counter() - w0
            meta, payload = self._slots[key]
        out = unpack_arrays(meta, payload)
        self.stats.gets += 1
        self.stats.bytes_in += len(payload)
        # blocked-on-producer time is the schedule's, not the wire's
        self.stats.get_wait_seconds += waited
        self.stats.get_seconds += time.perf_counter() - t0 - waited
        _account(self.stats)
        get_recorder().complete(
            "slot:get", t_mono + waited,
            args={"edge": edge, "step": step, "mb": mb,
                  "bytes": len(payload), "tier": "local"})
        return out

    def poll(self, edge, step, mb) -> bool:
        with self._cond:
            return (edge, step, mb) in self._slots

    def claim(self, edge, step, mb, generation) -> bool:
        key = (edge, step, mb, generation)
        with self._cond:
            self._claims[key] = self._claims.get(key, 0) + 1
            won = self._claims[key] == 1
        if won:
            get_recorder().instant(
                "slot:claim", args={"edge": edge, "step": step, "mb": mb,
                                    "gen": generation})
        return won

    def release_step(self, edge, step) -> None:
        with self._cond:
            for key in [k for k in self._slots if k[0] == edge
                        and k[1] == step]:
                del self._slots[key]

    def audit(self) -> dict:
        """Commit attempts per slot and claims per (slot, generation)."""
        with self._cond:
            return {
                "commits": {"/".join(map(str, k)): v
                            for k, v in self._commits.items()},
                "claims": {"/".join(map(str, k)): v
                           for k, v in self._claims.items()},
            }


class KVTransport(Transport):
    """The KV-store wire: chunked puts under the client's 1 MiB read cap,
    the meta written LAST (its presence is the slot-complete signal),
    commit/claim counters for produce-once / claim-once. Stages of one
    pipeline share one ``prefix`` on the raw store."""

    def __init__(self, kv, *, prefix: str = "", chunk_bytes: int = 256 << 10,
                 claim_ttl: float = 600.0, slot_ttl: float | None = None,
                 poll_interval: float = 0.005):
        if chunk_bytes < 1 or chunk_bytes > (1 << 20) - 4096:
            raise ValueError(
                f"chunk_bytes {chunk_bytes} must fit the KV read cap (1MiB)")
        self.kv = kv
        self.prefix = prefix.rstrip("/") + "/" if prefix else ""
        self.chunk_bytes = chunk_bytes
        self.claim_ttl = claim_ttl
        self.slot_ttl = slot_ttl
        self.poll_interval = poll_interval
        self.stats = TransportStats()

    def _slot(self, edge: str, step: int, mb: int) -> str:
        return f"{self.prefix}{SLOT_PREFIX}/{edge}/{step}/{mb}"

    def _set(self, key: str, val: bytes) -> None:
        if self.slot_ttl is not None:
            self.kv.set_ttl(key, val, self.slot_ttl)
        else:
            self.kv.set(key, val)

    def put(self, edge, step, mb, arrays) -> bool:
        t0 = time.perf_counter()
        slot = self._slot(edge, step, mb)
        first = self.kv.add(f"{slot}/commit", 1) == 1
        if not first and self.kv.try_get(f"{slot}/meta") is not None:
            return False  # complete slot: replay no-op
        # not first but incomplete: the claimant died mid-write — finish
        # its slot (deterministic replay writes the identical bytes)
        meta, views = pack_views(arrays)
        nbytes = sum(len(v) for v in views)
        nchunks = 0
        for i, chunk in enumerate(iter_chunks(views, self.chunk_bytes)):
            self._set(f"{slot}/chunk/{i}", chunk)
            nchunks = i + 1
        meta = dict(meta, nchunks=nchunks, bytes=nbytes, seq=(step, mb))
        self._set(f"{slot}/meta", json.dumps(meta).encode())
        self.stats.puts += 1
        self.stats.bytes_out += nbytes
        self.stats.put_seconds += time.perf_counter() - t0
        _account(self.stats)
        get_recorder().instant(
            "slot:put", args={"edge": edge, "step": step, "mb": mb,
                              "bytes": nbytes, "first": first})
        return first

    def get(self, edge, step, mb, *, timeout: float = 60.0):
        """Chunk-pipelined read: chunk ``i`` is fetched as soon as it
        appears, overlapping the producer's remaining writes."""
        t0 = time.perf_counter()
        t_mono = time.monotonic()
        slot = self._slot(edge, step, mb)
        deadline = t0 + timeout
        meta = None
        parts = []
        i = 0
        waited = 0.0
        while True:
            chunk = self.kv.try_get(f"{slot}/chunk/{i}")
            if chunk is not None:
                parts.append(chunk)
                i += 1
                continue
            if meta is None:
                raw = self.kv.try_get(f"{slot}/meta")
                if raw is not None:
                    meta = json.loads(raw)
                    # chunk i and the meta may both have landed between
                    # the two probes: re-try the chunk first
                    continue
            if meta is not None:
                if i >= meta["nchunks"]:
                    break
                raise RuntimeError(
                    f"slot {slot} chunk {i} missing under a complete meta "
                    "(released early, or TTL expired mid-read)")
            if time.perf_counter() >= deadline:
                raise TimeoutError(
                    f"transport slot {slot} never arrived ({timeout}s)")
            w0 = time.perf_counter()
            time.sleep(self.poll_interval)
            waited += time.perf_counter() - w0
        payload = parts[0] if len(parts) == 1 else b"".join(parts)
        if len(payload) != meta["bytes"]:
            raise RuntimeError(
                f"slot {slot}: reassembled {len(payload)} bytes, "
                f"meta says {meta['bytes']}")
        out = unpack_arrays(meta, payload)
        self.stats.gets += 1
        self.stats.bytes_in += len(payload)
        self.stats.get_wait_seconds += waited
        self.stats.get_seconds += time.perf_counter() - t0 - waited
        _account(self.stats)
        get_recorder().complete(
            "slot:get", t_mono + waited,
            args={"edge": edge, "step": step, "mb": mb,
                  "bytes": len(payload), "tier": "kv"})
        return out

    def poll(self, edge, step, mb) -> bool:
        return self.kv.try_get(f"{self._slot(edge, step, mb)}/meta") is not None

    def claim(self, edge, step, mb, generation) -> bool:
        key = (f"{self.prefix}{CLAIM_PREFIX}/{generation}/{edge}/{step}/{mb}")
        n = self.kv.add(key, 1)
        if n == 1:
            # re-arm the fresh counter with a TTL so a dead generation's
            # claims expire
            self.kv.set_ttl(key, str(n), self.claim_ttl)
            get_recorder().instant(
                "slot:claim", args={"edge": edge, "step": step, "mb": mb,
                                    "gen": generation})
        return n == 1

    def release_step(self, edge, step) -> None:
        self.kv.delete_prefix(f"{self.prefix}{SLOT_PREFIX}/{edge}/{step}/")

    def audit(self) -> dict:
        """Commit counters per live slot and claim counters per
        generation."""
        commits, claims = {}, {}
        for key in self.kv.keys(f"{self.prefix}{SLOT_PREFIX}/"):
            if key.endswith("/commit"):
                commits[key[len(self.prefix) + len(SLOT_PREFIX) + 1:
                            -len("/commit")]] = int(self.kv.get(key))
        for key in self.kv.keys(f"{self.prefix}{CLAIM_PREFIX}/"):
            raw = self.kv.try_get(key)
            if raw is not None:
                claims[key[len(self.prefix) + len(CLAIM_PREFIX) + 1:]] = (
                    int(raw))
        return {"commits": commits, "claims": claims}


class DeviceTransport(Transport):
    """Stages colocated in one process: ``put`` publishes the producer's
    tensors as they are (no host staging on the data path), and a durable
    *journal* transport underneath records the same slot bytes for
    recovery. The journal is authoritative for produce-once, claim-once
    and the audit. The stages share the card's stream, so a consumer's
    kernels run after the producer's without an event. A ``get`` that
    finds no tensors (a transport rebuilt over a persistent journal) reads
    the journal's bytes, which deterministic replay makes the same bits."""

    def __init__(self, journal: Transport | None = None):
        self.journal = LocalTransport() if journal is None else journal
        self._bufs: dict[tuple, list] = {}
        self._cond = threading.Condition()
        self.stats = TransportStats()

    def put(self, edge, step, mb, arrays) -> bool:
        t0 = time.perf_counter()
        arrays = list(arrays)
        key = (edge, step, mb)
        with self._cond:
            if key not in self._bufs:
                self._bufs[key] = arrays
                self._cond.notify_all()
        # the journal owns the produce-once verdict; a replayed put loses
        # the commit there and leaves the published tensors untouched
        first = self.journal.put(edge, step, mb, arrays)
        self.stats.puts += 1
        self.stats.bytes_out += _nbytes(arrays)
        self.stats.put_seconds += time.perf_counter() - t0
        _account(self.stats)
        return first

    def get(self, edge, step, mb, *, timeout: float = 60.0):
        t0 = time.perf_counter()
        t_mono = time.monotonic()
        key = (edge, step, mb)
        deadline = t0 + timeout
        waited = 0.0
        with self._cond:
            while key not in self._bufs:
                remaining = deadline - time.perf_counter()
                if remaining <= 0:
                    raise TimeoutError(
                        f"transport slot {key} never arrived ({timeout}s)")
                if self.journal.poll(edge, step, mb):
                    break  # journal has it but no tensors: recovery read
                w0 = time.perf_counter()
                self._cond.wait(min(remaining, 0.01))
                waited += time.perf_counter() - w0
            arrays = self._bufs.get(key)
        if arrays is None:
            out = self.journal.get(
                edge, step, mb,
                timeout=max(0.001, deadline - time.perf_counter()))
            self.stats.journal_fallbacks += 1
            tier = "journal"
        else:
            out = list(arrays)
            self.stats.device_hits += 1
            tier = "device"
        nbytes = _nbytes(out)
        self.stats.gets += 1
        self.stats.bytes_in += nbytes
        self.stats.get_wait_seconds += waited
        self.stats.get_seconds += time.perf_counter() - t0 - waited
        _account(self.stats)
        get_recorder().complete(
            "slot:get", t_mono + waited,
            args={"edge": edge, "step": step, "mb": mb,
                  "bytes": nbytes, "tier": tier})
        return out

    def poll(self, edge, step, mb) -> bool:
        with self._cond:
            if (edge, step, mb) in self._bufs:
                return True
        return self.journal.poll(edge, step, mb)

    def claim(self, edge, step, mb, generation) -> bool:
        return self.journal.claim(edge, step, mb, generation)

    def release_step(self, edge, step) -> None:
        with self._cond:
            for key in [k for k in self._bufs if k[0] == edge
                        and k[1] == step]:
                del self._bufs[key]
        self.journal.release_step(edge, step)

    def audit(self) -> dict:
        return self.journal.audit()


@dataclass
class EdgeNames:
    """The two directed edges between adjacent stages s and s+1."""

    stage: int
    act: str = field(init=False)   # activations s -> s+1
    grad: str = field(init=False)  # cotangents  s+1 -> s

    def __post_init__(self):
        self.act = f"act{self.stage}"
        self.grad = f"grad{self.stage}"
