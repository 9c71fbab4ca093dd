"""The offline collector: merge per-process recorder logs onto one
clock, then render. The port's copy of ``tpu_sandbox/obs/collect.py``:
the same merge, the same records and renderings, so it reads either
package's traces.

Input is a directory of ``*.jsonl`` files written by
:class:`tpu_sandbox_torch.obs.record.Recorder` — one per process, each
timestamped with that process's OWN ``time.monotonic()``. Raw monotonic
clocks from different processes are mutually meaningless, so the merge
runs in two steps:

1. **Wall anchor** — each process's offset starts as the median
   ``wall - mono`` over its ``"C"`` calibration records (falling back to
   the ``"P"`` preamble pair when a process never calibrated).
2. **Sequencer repair** — calibration records carry the KV server's
   shared counter value (``kv.add`` is serialized by the single-threaded
   server, so sequencer order IS happened-before order). Walking the
   calibration points in sequencer order, any point whose unified time
   runs *backwards* relative to an earlier point bumps its process's
   offset forward by the deficit. NTP-grade skew that the wall anchor
   misses cannot reorder causally-related events after this pass.

Everything downstream — Chrome trace-event export, per-request
waterfalls, trace-chain validation, last-N-seconds postmortems — works
on the merged record list (each record gains ``"uts"``, the unified
timestamp in seconds).
"""

from __future__ import annotations

import json
import os
import statistics


# -- loading ------------------------------------------------------------------

def read_log(path: str, stats: dict | None = None) -> list[dict]:
    """Parse one recorder JSONL file. A torn final line (the process was
    SIGKILLed mid-write) is dropped, not fatal — postmortems read logs
    from processes that died badly. Pass a ``stats`` dict to have every
    skipped line counted under ``dropped_records``: a postmortem that
    silently loses records reads as "nothing happened here", which is
    exactly the wrong story to tell about a process that died mid-write."""
    records = []
    dropped = 0
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except ValueError:
                dropped += 1
                continue
            if isinstance(rec, dict):
                records.append(rec)
            else:
                dropped += 1
    if stats is not None:
        stats["dropped_records"] = stats.get("dropped_records", 0) + dropped
    return records


def load_dir(logdir: str,
             stats: dict | None = None) -> dict[str, list[dict]]:
    """Read every ``*.jsonl`` under ``logdir``, keyed by process key
    (``proc/pid`` — distinct even when two processes share a name).
    ``stats`` (optional) accumulates ``files`` and ``dropped_records``
    across the whole directory."""
    logs: dict[str, list[dict]] = {}
    for name in sorted(os.listdir(logdir)):
        if not name.endswith(".jsonl"):
            continue
        if stats is not None:
            stats["files"] = stats.get("files", 0) + 1
        for rec in read_log(os.path.join(logdir, name), stats):
            key = f"{rec.get('proc', '?')}/{rec.get('pid', 0)}"
            logs.setdefault(key, []).append(rec)
    return logs


# -- clock calibration --------------------------------------------------------

def clock_offsets(logs: dict[str, list[dict]]) -> dict[str, float]:
    """Per-process ``offset`` such that ``mono + offset`` is comparable
    across processes. Wall-anchored, then repaired against the KV
    sequencer's total order (see module docstring)."""
    offsets: dict[str, float] = {}
    for key, records in logs.items():
        deltas = [r["wall"] - r["mono"] for r in records
                  if r.get("ph") == "C"]
        if not deltas:
            deltas = [r["wall"] - r["mono"] for r in records
                      if r.get("ph") == "P"]
        offsets[key] = statistics.median(deltas) if deltas else 0.0

    # sequencer repair: unified time must be non-decreasing in seq order
    points = []
    for key, records in logs.items():
        for r in records:
            if r.get("ph") == "C":
                points.append((int(r["seq"]), key, float(r["mono"])))
    points.sort()
    high = None
    for _seq, key, mono in points:
        unified = mono + offsets[key]
        if high is not None and unified < high:
            offsets[key] += high - unified
            unified = high
        high = unified if high is None else max(high, unified)
    return offsets


# -- merging ------------------------------------------------------------------

def merge(logs: dict[str, list[dict]],
          offsets: dict[str, float] | None = None) -> list[dict]:
    """Flatten per-process logs into one list ordered by unified time.
    Each span/instant record gains ``uts`` (unified seconds) and
    ``pkey`` (its process key)."""
    if offsets is None:
        offsets = clock_offsets(logs)
    merged = []
    for key, records in logs.items():
        off = offsets.get(key, 0.0)
        for r in records:
            if r.get("ph") not in ("X", "i", "m"):
                continue
            out = dict(r)
            out["uts"] = float(r["ts"]) + off
            out["pkey"] = key
            merged.append(out)
    merged.sort(key=lambda r: (r["uts"], r.get("pkey", ""),
                               r.get("span") or ""))
    return merged


def load_merged(logdir: str, stats: dict | None = None) -> list[dict]:
    logs = load_dir(logdir, stats)
    return merge(logs, clock_offsets(logs))


# -- chrome trace-event export ------------------------------------------------

def to_chrome_trace(merged: list[dict]) -> dict:
    """Render merged records as Chrome/Perfetto trace-event JSON: one
    track (pid) per process, spans as ``"X"`` complete events, fault
    injections and other point records as ``"i"`` instants, metric
    samples (recorder phase ``"m"``) as ``"C"`` counter events — so
    Perfetto draws the time-series as counter tracks on the same
    timeline as the spans. Times are microseconds from the earliest
    record."""
    if not merged:
        return {"traceEvents": [], "displayTimeUnit": "ms"}
    base = min(r["uts"] for r in merged)
    pids: dict[str, int] = {}
    events = []
    for r in merged:
        pkey = r.get("pkey", "?")
        if pkey not in pids:
            pids[pkey] = len(pids) + 1
            events.append({"ph": "M", "name": "process_name",
                           "pid": pids[pkey], "tid": 0,
                           "args": {"name": pkey}})
        if r["ph"] == "m":
            events.append({
                "name": r.get("name", "?"), "ph": "C",
                "ts": (r["uts"] - base) * 1e6,
                "pid": pids[pkey], "tid": 0,
                "args": {"value": float(r.get("value", 0.0))},
            })
            continue
        ev = {
            "name": r.get("name", "?"),
            "ph": "X" if r["ph"] == "X" else "i",
            "ts": (r["uts"] - base) * 1e6,
            "pid": pids[pkey],
            "tid": r.get("tid", 0),
            "args": dict(r.get("args") or {}),
        }
        if r["ph"] == "X":
            ev["dur"] = float(r.get("dur", 0.0)) * 1e6
        else:
            ev["s"] = "p"  # process-scoped instant
        if r.get("trace"):
            ev["args"]["trace"] = r["trace"]
            ev["args"]["span"] = r.get("span")
            ev["args"]["parent"] = r.get("parent")
        events.append(ev)
    return {"traceEvents": events, "displayTimeUnit": "ms"}


# -- trace chains -------------------------------------------------------------

def trace_chains(merged: list[dict]) -> dict[str, list[dict]]:
    """Group span/instant records by trace id (records without a trace
    id — untraced internal activity — are excluded)."""
    chains: dict[str, list[dict]] = {}
    for r in merged:
        t = r.get("trace")
        if t:
            chains.setdefault(t, []).append(r)
    return chains


def chain_check(records: list[dict]) -> dict:
    """Validate one trace's causal integrity: how many roots it has and
    whether every non-root record's parent resolves to a span inside the
    same trace. A healthy request chain has exactly one root and no
    dangling parents."""
    span_ids = {r.get("span") for r in records if r.get("span")}
    roots = [r for r in records if not r.get("parent")]
    dangling = [r for r in records
                if r.get("parent") and r["parent"] not in span_ids]
    return {
        "roots": len(roots),
        "root_names": sorted(r.get("name", "?") for r in roots),
        "dangling": len(dangling),
        "names": sorted({r.get("name", "?") for r in records}),
        "connected": len(roots) == 1 and not dangling,
    }


# -- waterfalls ---------------------------------------------------------------

def _chain_depths(records: list[dict]) -> dict[str, int]:
    parent_of = {r.get("span"): r.get("parent") for r in records
                 if r.get("span")}
    depths: dict[str, int] = {}

    def depth(span_id, guard=0):
        if span_id in depths:
            return depths[span_id]
        p = parent_of.get(span_id)
        d = 0 if (p is None or p not in parent_of or guard > 64) \
            else depth(p, guard + 1) + 1
        depths[span_id] = d
        return d

    for sid in parent_of:
        depth(sid)
    return depths


def request_waterfall(merged: list[dict], *, rid: str | None = None,
                      trace: str | None = None) -> list[dict]:
    """One request's life as ordered rows: relative start, duration,
    depth in the causal chain, process, span name. Select by explicit
    trace id or by the ``rid`` stamped into span args at submit time."""
    if trace is None:
        if rid is None:
            raise ValueError("need rid or trace")
        for r in merged:
            if (r.get("args") or {}).get("rid") == rid and r.get("trace"):
                trace = r["trace"]
                break
        if trace is None:
            return []
    records = [r for r in merged if r.get("trace") == trace]
    if not records:
        return []
    depths = _chain_depths(records)
    span_ids = {r.get("span") for r in records if r.get("span")}
    base = min(r["uts"] for r in records)
    rows = []
    for r in records:
        rows.append({
            "t": r["uts"] - base,
            "dur": float(r.get("dur", 0.0)) if r["ph"] == "X" else 0.0,
            "depth": depths.get(r.get("span"), 0),
            "proc": r.get("pkey", "?"),
            "name": r.get("name", "?"),
            "ph": r["ph"],
            "span": r.get("span"),
            # a parent that never landed in the trace (the parent span
            # leaked, or its log tail was torn off with the process):
            # the row renders at depth 0 but says WHY, instead of
            # impersonating a root
            "orphan": bool(r.get("parent")) and r.get("parent")
            not in span_ids,
            "args": {k: v for k, v in (r.get("args") or {}).items()
                     if k != "rid"},
            "trace": trace,
        })
    rows.sort(key=lambda row: (row["t"], row["depth"]))
    return rows


def format_waterfall(rows: list[dict],
                     crit: set[str] | None = None) -> str:
    """Render waterfall rows; spans whose id is in ``crit`` (the
    critical-path span set from ``obs/critpath.py``) get a ``*`` prefix,
    orphaned rows an explicit ``[orphan]`` tag."""
    lines = []
    if rows:
        lines.append(f"trace {rows[0]['trace']}")
    for row in rows:
        mark = "·" if row["ph"] == "i" else \
            f"{row['dur'] * 1e3:8.3f}ms"
        indent = "  " * row["depth"]
        star = "*" if crit and row.get("span") in crit else " "
        orphan = "  [orphan]" if row.get("orphan") else ""
        lines.append(f"  +{row['t'] * 1e3:9.3f}ms {mark:>10} "
                     f"{star}{indent}{row['name']}  [{row['proc']}]"
                     f"{orphan}")
    return "\n".join(lines)


# -- postmortem ---------------------------------------------------------------

def last_window(merged: list[dict], seconds: float) -> list[dict]:
    """The final ``seconds`` of the merged timeline — measured back from
    the LAST record, not from now: the logs may be hours old by the time
    someone runs the postmortem."""
    if not merged:
        return []
    end = max(r["uts"] for r in merged)
    return [r for r in merged if r["uts"] >= end - seconds]


def format_timeline(records: list[dict]) -> str:
    """Causally-ordered text timeline for postmortems: one line per
    record, relative seconds, process, name, interesting args."""
    if not records:
        return "(no records in window)"
    base = min(r["uts"] for r in records)
    lines = []
    for r in records:
        args = r.get("args") or {}
        arg_s = " ".join(f"{k}={v}" for k, v in sorted(args.items()))
        kind = "|" if r["ph"] == "X" else "!"
        lines.append(f"+{r['uts'] - base:8.3f}s {kind} "
                     f"[{r.get('pkey', '?')}] {r.get('name', '?')}"
                     + (f"  {arg_s}" if arg_s else ""))
    return "\n".join(lines)
