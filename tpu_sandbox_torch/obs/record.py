"""The span/event recorder: per-process append-only JSONL, cheap enough
to leave on. The port's copy of ``tpu_sandbox/obs/record.py``, whole: the
same record forms and fields, so either package's tools read either
package's traces.

One :class:`Recorder` per process, obtained via :func:`get_recorder`. It
is **disabled unless** ``TPU_SANDBOX_TRACE_DIR`` is set in the
environment — every emit on a disabled recorder is a couple of attribute
reads, so instrumentation stays in the hot paths unconditionally.

Record forms (one JSON object per line, all timestamps are THIS
process's ``time.monotonic()`` seconds — never wall clock, never another
host's clock):

    {"ph":"P", ...}   preamble: proc name, pid, a coarse (mono, wall)
                      pair — the fallback clock anchor
    {"ph":"X", ...}   complete span: ts + dur, trace/span/parent ids
    {"ph":"i", ...}   instant event (fault injections, verdicts, job
                      lifecycle); flushed immediately so it survives a
                      SIGKILL issued on the next line
    {"ph":"C", ...}   clock-calibration sample: (kv-sequencer value,
                      mono midpoint, rtt, wall) — the collector derives
                      per-process offsets from these (see
                      ``obs/collect.py::clock_offsets``)
    {"ph":"m", ...}   metric sample: (series name, numeric value) —
                      rendered by the collector as a Chrome/Perfetto
                      counter track (``ph:"C"`` in the Chrome JSON; the
                      recorder's own "C" phase was already taken by
                      calibration) so time-series and spans share one
                      timeline

Causality is carried by :class:`TraceContext` — ``(trace_id, span_id)``
pairs serialized as ``{"t":…,"s":…}`` wherever a request body crosses a
process boundary (gateway wire frames, ``serve/req/<rid>`` bodies). A
disabled recorder *passes contexts through* unchanged, so one dark
process does not sever the chain between two instrumented ones.

Span discipline: ``with rec.span(name) as sp`` is the sanctioned form;
``begin_span`` exists for the rare span that cannot be a ``with`` block
and MUST be closed in a ``try/finally`` (graftlint GL-O401 polices
this — a leaked open span never emits and corrupts the merged timeline).
Spans whose start time predates the call (claim/admit/decode latencies
measured around existing control flow) use :meth:`Recorder.complete`,
which emits retrospectively and cannot leak.
"""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from dataclasses import dataclass

ENV_TRACE_DIR = "TPU_SANDBOX_TRACE_DIR"
ENV_PROC_NAME = "TPU_SANDBOX_OBS_PROC"

#: the KV store's shared sequencer for clock calibration: every
#: ``kv.add`` on this key is serialized by the single-threaded server,
#: so the returned values give a TOTAL order across hosts that the
#: collector can pin each host's monotonic clock against
CLOCK_SEQ_KEY = "obs/clock/seq"


@dataclass(frozen=True)
class TraceContext:
    """One request's position in the causal chain: which trace it
    belongs to and which span is the current parent."""

    trace_id: str
    span_id: str

    def to_wire(self) -> dict:
        return {"t": self.trace_id, "s": self.span_id}

    @classmethod
    def from_wire(cls, obj) -> "TraceContext | None":
        """Tolerant decode: None, a wire dict, or an existing context.
        Anything malformed reads as 'no context' — tracing must never
        fail a request."""
        if obj is None:
            return None
        if isinstance(obj, TraceContext):
            return obj
        if isinstance(obj, dict) and "t" in obj and "s" in obj:
            return cls(trace_id=str(obj["t"]), span_id=str(obj["s"]))
        return None


class Span:
    """A live span handle. ``ctx`` is the context CHILDREN of this span
    should carry; on a disabled recorder it passes the parent through."""

    __slots__ = ("_rec", "name", "ctx", "parent", "args", "_t0", "_closed")

    def __init__(self, rec: "Recorder", name: str,
                 ctx: TraceContext | None, parent: TraceContext | None,
                 args: dict | None, t0: float | None):
        self._rec = rec
        self.name = name
        self.ctx = ctx
        self.parent = parent
        self.args = args if args is not None else {}
        self._t0 = t0
        self._closed = t0 is None  # disabled spans have nothing to emit

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        now = time.monotonic()
        self._rec._emit({
            "ph": "X", "name": self.name, "ts": self._t0,
            "dur": now - self._t0,
            "trace": None if self.ctx is None else self.ctx.trace_id,
            "span": None if self.ctx is None else self.ctx.span_id,
            "parent": None if self.parent is None else self.parent.span_id,
            "args": self.args,
        })


class Recorder:
    """Bounded-buffer JSONL event sink. Thread-safe; one per process.

    ``flush_every`` > 0 flushes the buffer to disk whenever it reaches
    that many records (and on every instant — instants mark faults and
    verdicts, which must survive an immediate SIGKILL). ``flush_every``
    == 0 means fully manual flushing, which is how the backpressure path
    is exercised: once the buffer holds ``max_buffered`` records, new
    ones are DROPPED and counted — the recorder prefers losing its own
    data to growing without bound inside a serving process. The drop
    count rides the engine load reports (satellite: a silently-dropping
    recorder is visible, not invisible)."""

    def __init__(self, path: str | None, *, proc: str | None = None,
                 flush_every: int = 64, max_buffered: int = 4096):
        self.path = path
        self.enabled = path is not None
        self.pid = os.getpid()
        self.proc = proc or os.environ.get(ENV_PROC_NAME) \
            or f"proc-{self.pid}"
        self.flush_every = flush_every
        self.max_buffered = max_buffered
        self.events = 0
        self.dropped = 0
        self._buf: list[dict] = []
        self._lock = threading.Lock()
        self._next_span = 0
        self._fh = None
        if self.enabled:
            d = os.path.dirname(path)
            if d:
                os.makedirs(d, exist_ok=True)
            self._fh = open(path, "a", encoding="utf-8")
            self._emit({"ph": "P", "mono": time.monotonic(),
                        "wall": time.time()}, flush=True)

    # -- emission ------------------------------------------------------------

    def _emit(self, rec: dict, *, flush: bool = False) -> None:
        if not self.enabled:
            return
        rec.setdefault("pid", self.pid)
        rec.setdefault("proc", self.proc)
        rec.setdefault("tid", threading.get_ident())
        with self._lock:
            if len(self._buf) >= self.max_buffered:
                self.dropped += 1
                return
            self._buf.append(rec)
            self.events += 1
            if flush or (self.flush_every
                         and len(self._buf) >= self.flush_every):
                self._flush_locked()

    def _flush_locked(self) -> None:
        if not self._buf or self._fh is None:
            return
        lines = "".join(json.dumps(r) + "\n" for r in self._buf)
        self._buf.clear()
        self._fh.write(lines)
        self._fh.flush()

    def flush(self) -> None:
        with self._lock:
            self._flush_locked()

    def close(self) -> None:
        with self._lock:
            self._flush_locked()
            if self._fh is not None:
                self._fh.close()
                self._fh = None
        self.enabled = False

    def stats(self) -> dict:
        """The load-report rider: emitted vs dropped-on-backpressure."""
        return {"events": self.events, "dropped": self.dropped}

    # -- ids -----------------------------------------------------------------

    def _mint_span_id(self) -> str:
        self._next_span += 1
        return f"{self.pid:x}.{self._next_span}"

    def _mint_trace_id(self) -> str:
        return os.urandom(8).hex()

    def _child_ctx(self, parent: TraceContext | None) -> TraceContext:
        if parent is None:
            return TraceContext(self._mint_trace_id(), self._mint_span_id())
        return TraceContext(parent.trace_id, self._mint_span_id())

    # -- spans / events ------------------------------------------------------

    def begin_span(self, name: str, parent=None,
                   args: dict | None = None) -> Span:
        """Open a span the caller MUST close in a try/finally (GL-O401).
        Prefer ``with rec.span(...)``; use this only when the span's
        lifetime cannot be a lexical block."""
        parent = TraceContext.from_wire(parent)
        if not self.enabled:
            return Span(self, name, parent, parent, args, None)
        ctx = self._child_ctx(parent)
        return Span(self, name, ctx, parent, args, time.monotonic())

    @contextlib.contextmanager
    def span(self, name: str, parent=None, args: dict | None = None):
        """The sanctioned span form: closes on every path."""
        sp = self.begin_span(name, parent=parent, args=args)
        try:
            yield sp
        finally:
            sp.close()

    def complete(self, name: str, start_mono: float, parent=None,
                 args: dict | None = None, *, end: float | None = None,
                 dur: float | None = None) -> TraceContext | None:
        """Emit a span retrospectively: started at ``start_mono`` (this
        process's monotonic clock), ended at ``end`` on that clock, or
        ``dur`` seconds later, or now. A caller that timed the work itself
        passes its own reading, so the span carries exactly that duration.
        Returns the context children should parent to (parent pass-through
        when disabled)."""
        parent = TraceContext.from_wire(parent)
        if not self.enabled:
            return parent
        if dur is None:
            dur = (time.monotonic() if end is None else end) - start_mono
        ctx = self._child_ctx(parent)
        self._emit({
            "ph": "X", "name": name, "ts": start_mono,
            "dur": dur,
            "trace": ctx.trace_id, "span": ctx.span_id,
            "parent": None if parent is None else parent.span_id,
            "args": args or {},
        })
        return ctx

    def instant(self, name: str, parent=None,
                args: dict | None = None) -> TraceContext | None:
        """Point event — flushed immediately (auto-flush mode) so a
        fault injection's record survives the SIGKILL it announces."""
        parent = TraceContext.from_wire(parent)
        if not self.enabled:
            return parent
        ctx = self._child_ctx(parent)
        self._emit({
            "ph": "i", "name": name, "ts": time.monotonic(),
            "trace": ctx.trace_id, "span": ctx.span_id,
            "parent": None if parent is None else parent.span_id,
            "args": args or {},
        }, flush=bool(self.flush_every))
        return ctx

    def metric(self, name: str, value: float) -> None:
        """Sample a metric series onto the timeline. Buffered like spans
        (metrics are periodic, not fault markers — losing the tail on
        SIGKILL is acceptable); the collector turns these into Perfetto
        counter tracks."""
        if not self.enabled:
            return
        self._emit({"ph": "m", "name": name, "ts": time.monotonic(),
                    "value": float(value)})

    # -- clock calibration ---------------------------------------------------

    def calibrate(self, kv, rounds: int = 5) -> int:
        """Pin this process's monotonic clock against the KV server's
        shared sequencer. Each round brackets one ``kv.add`` round trip
        with monotonic reads; the sequencer value is a server-serialized
        total order, so the collector can (a) offset each process by its
        own (wall - mono) median and (b) enforce that calibration points
        appear in sequencer order on the merged timeline — no raw
        cross-host wall-clock arithmetic anywhere (GL-R302). Returns the
        last sequencer value observed (0 when disabled)."""
        if not self.enabled:
            return 0
        seq = 0
        for _ in range(rounds):
            m0 = time.monotonic()
            seq = kv.add(CLOCK_SEQ_KEY)
            m1 = time.monotonic()
            self._emit({
                "ph": "C", "seq": int(seq), "mono": (m0 + m1) / 2.0,
                "rtt": m1 - m0, "wall": time.time(),
            })
        self.flush()
        return int(seq)


# -- process-global recorder --------------------------------------------------

_RECORDER: Recorder | None = None
_RECORDER_LOCK = threading.Lock()


def get_recorder() -> Recorder:
    """The process-wide recorder, built once from the environment:
    enabled iff ``TPU_SANDBOX_TRACE_DIR`` is set (log file
    ``<dir>/<proc>-<pid>.jsonl``)."""
    global _RECORDER
    rec = _RECORDER
    if rec is not None:
        return rec
    with _RECORDER_LOCK:
        if _RECORDER is None:
            trace_dir = os.environ.get(ENV_TRACE_DIR)
            if trace_dir:
                proc = os.environ.get(ENV_PROC_NAME) \
                    or f"proc-{os.getpid()}"
                path = os.path.join(trace_dir, f"{proc}-{os.getpid()}.jsonl")
                _RECORDER = Recorder(path, proc=proc)
            else:
                _RECORDER = Recorder(None)
        return _RECORDER


def reset_recorder() -> None:
    """Close and forget the global recorder so the next
    :func:`get_recorder` re-reads the environment (tests / the obs
    bench flipping tracing on and off inside one process)."""
    global _RECORDER
    with _RECORDER_LOCK:
        if _RECORDER is not None:
            _RECORDER.close()
        _RECORDER = None
