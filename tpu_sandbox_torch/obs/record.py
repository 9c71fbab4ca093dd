"""The event recorder: per-process append-only JSONL. The port's copy
of ``tpu_sandbox/obs/record.py``, cut to what ``get_recorder`` and its
caller here need: instants (``instant``, which ``runtime/faults.py``
announces each fault with), without spans, metrics or clock
calibration.

The recorder is **disabled unless** ``TPU_SANDBOX_TRACE_DIR`` is set in the
environment; every emit on a disabled recorder is a couple of attribute
reads. Record forms (one JSON object per line, timestamps are this
process's ``time.monotonic()`` seconds):

    {"ph":"P", ...}   preamble: proc name, pid, a coarse (mono, wall) pair
    {"ph":"i", ...}   instant event (fault injections), flushed at once so
                      it survives a SIGKILL issued on the next line
"""

from __future__ import annotations

import json
import os
import threading
import time
from dataclasses import dataclass

ENV_TRACE_DIR = "TPU_SANDBOX_TRACE_DIR"
ENV_PROC_NAME = "TPU_SANDBOX_OBS_PROC"


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


class Recorder:
    """Bounded-buffer JSONL event sink. Thread-safe; one per process.

    ``flush_every`` > 0 flushes the buffer to disk whenever it reaches
    that many records (and on every instant — instants mark faults and
    verdicts, which must survive an immediate SIGKILL). ``flush_every``
    == 0 means fully manual flushing, which is how the backpressure path
    is exercised: once the buffer holds ``max_buffered`` records, new
    ones are DROPPED and counted — the recorder prefers losing its own
    data to growing without bound (``dropped`` counts them)."""

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
