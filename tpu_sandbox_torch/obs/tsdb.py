"""Durable KV-backed time series: the health plane's memory. The port's
copy of ``tpu_sandbox/obs/tsdb.py``, writing the same keys and bodies.

The metrics registry (:mod:`tpu_sandbox_torch.obs.metrics`) is a point-in-time
scrape — ask it twice and you get two unrelated snapshots, and when the
process dies the history dies with it. The :class:`TimeSeriesFlusher`
gives every process a cheap way to leave a durable trail: each flush
diffs the registry against the previous flush and writes the touched
series into bucketed KV windows

    obs/ts/<proc>/<series>/<slot>     fine buckets (``bucket_s`` wide)
    obs/tsd/<proc>/<series>/<slot>    downsampled (``ds_factor`` × wider)

where ``slot = bucket % retention`` — a true ring: the key count per
series is bounded by the retention window and old slots are overwritten
on wrap. Every write also carries a TTL of one full retention window,
so a dead process's trail ages out instead of lingering forever. The
payload records the ABSOLUTE bucket index, so readers never confuse a
wrapped slot with a fresh one.

Per-kind semantics inside one bucket:

* **counters** flush as deltas (this bucket's increments, accumulated
  locally across flushes — the flusher is the sole writer of its own
  ``<proc>`` namespace, so overwriting the bucket with the running
  per-bucket total is safe);
* **gauges** are last-write-wins;
* **histograms** store the registry's cumulative digest
  (count/sum/min/max/mean/p50/p90/p99) — readers treat the latest
  bucket as "the distribution so far".

The flusher also publishes two synthetic series so the health plane can
watch the observability layer itself: ``obs.recorder.dropped`` (a
silently-dropping recorder is the observability layer lying) and
``obs.recorder.events``. When the process recorder is enabled, each
flush additionally emits ``"m"`` metric samples onto the trace log, so
``collect.to_chrome_trace`` renders the same series as Perfetto counter
tracks next to the spans.

Readers (:func:`read_series`, :func:`list_series`) work fleet-wide off
prefix scans; any process holding a ``KVClient`` can reconstruct any
other process's recent metric history — that is what the leader-elected
``HealthMonitor`` (:mod:`tpu_sandbox_torch.obs.health`) and the ``fleetop``
console are built on.
"""

from __future__ import annotations

import json
import time

from .metrics import get_registry
from .record import get_recorder

#: fine-grained ring root (bucket_s-wide windows)
TS_PREFIX = "obs/ts/"
#: downsampled ring root (ds_factor * bucket_s-wide windows)
TSD_PREFIX = "obs/tsd/"


def series_base(series: str) -> str:
    """Strip the ``{k=v,...}`` label suffix: the aggregation name."""
    return series.split("{", 1)[0]


def _k(prefix: str, proc: str, series: str, slot: int) -> str:
    return f"{prefix}{proc}/{series}/{slot}"


class TimeSeriesFlusher:
    """Flush one process's registry into the durable ring.

    Call :meth:`flush` on whatever cadence the process already has (the
    replica worker rides its load-report interval; the bench rides the
    step loop). ``clock`` is injectable so tests can drive bucket
    boundaries with a stub clock.
    """

    def __init__(self, kv, proc: str, *, bucket_s: float = 1.0,
                 retention_buckets: int = 120, ds_factor: int = 10,
                 ds_retention_buckets: int | None = None,
                 registry=None, recorder=None, clock=time.time):
        proc = str(proc)
        if "/" in proc or not proc:
            raise ValueError(f"need a slash-free proc name, got {proc!r}")
        if ds_factor < 2:
            raise ValueError("ds_factor must be >= 2")
        self.kv = kv
        self.proc = proc
        self.bucket_s = float(bucket_s)
        self.retention_buckets = int(retention_buckets)
        self.ds_factor = int(ds_factor)
        self.ds_retention_buckets = int(
            ds_retention_buckets or retention_buckets)
        self.registry = registry if registry is not None else get_registry()
        self.recorder = recorder
        self.clock = clock
        self.flushes = 0
        self._prev_counters: dict[str, int] = {}
        # per-bucket local accumulation of counter deltas; pruned to the
        # current bucket after every flush
        self._acc: dict[int, dict[str, float]] = {}
        self._acc_ds: dict[int, dict[str, float]] = {}

    # -- flushing ------------------------------------------------------------

    def flush(self) -> int:
        """Diff the registry against the previous flush and write every
        live series into the current fine + coarse buckets. Returns the
        number of KV keys written."""
        snap = self.registry.snapshot()
        rec = self.recorder if self.recorder is not None else get_recorder()
        now = float(self.clock())
        bucket = int(now // self.bucket_s)
        dsb = bucket // self.ds_factor
        ttl = self.retention_buckets * self.bucket_s
        ds_ttl = self.ds_retention_buckets * self.ds_factor * self.bucket_s
        writes = 0

        # counters: accumulate this flush's deltas into the open buckets
        acc = self._acc.setdefault(bucket, {})
        acc_ds = self._acc_ds.setdefault(dsb, {})
        for name, val in snap["counters"].items():
            delta = val - self._prev_counters.get(name, 0)
            self._prev_counters[name] = val
            acc[name] = acc.get(name, 0) + delta
            acc_ds[name] = acc_ds.get(name, 0) + delta
        for name, total in acc.items():
            writes += self._write(TS_PREFIX, name, bucket,
                                  self.retention_buckets,
                                  {"kind": "counter", "v": total,
                                   "bucket": bucket, "wall": now}, ttl)
        for name, total in acc_ds.items():
            writes += self._write(TSD_PREFIX, name, dsb,
                                  self.ds_retention_buckets,
                                  {"kind": "counter", "v": total,
                                   "bucket": dsb, "wall": now}, ds_ttl)
        self._acc = {bucket: acc}
        self._acc_ds = {dsb: acc_ds}

        # gauges + synthetic recorder-health series: last write wins
        gauges = dict(snap["gauges"])
        stats = rec.stats()
        gauges["obs.recorder.dropped"] = float(stats["dropped"])
        gauges["obs.recorder.events"] = float(stats["events"])
        for name, val in gauges.items():
            body = {"kind": "gauge", "v": val, "bucket": bucket, "wall": now}
            writes += self._write(TS_PREFIX, name, bucket,
                                  self.retention_buckets, body, ttl)
            writes += self._write(
                TSD_PREFIX, name, dsb, self.ds_retention_buckets,
                {"kind": "gauge", "v": val, "bucket": dsb, "wall": now},
                ds_ttl)

        # histograms: cumulative digest, last write wins
        for name, digest in snap["histograms"].items():
            body = {"kind": "histogram", "v": digest,
                    "bucket": bucket, "wall": now}
            writes += self._write(TS_PREFIX, name, bucket,
                                  self.retention_buckets, body, ttl)
            writes += self._write(
                TSD_PREFIX, name, dsb, self.ds_retention_buckets,
                {"kind": "histogram", "v": digest, "bucket": dsb,
                 "wall": now}, ds_ttl)

        # mirror onto the trace timeline as Perfetto counter tracks
        if rec.enabled:
            for name, val in snap["counters"].items():
                rec.metric(name, val)
            for name, val in gauges.items():
                rec.metric(name, val)
            for name, digest in snap["histograms"].items():
                if digest.get("p99") is not None:
                    rec.metric(f"{name}.p99", digest["p99"])

        self.flushes += 1
        return writes

    def _write(self, prefix: str, series: str, bucket: int,
               retention: int, body: dict, ttl: float) -> int:
        slot = bucket % retention
        self.kv.set_ttl(_k(prefix, self.proc, series, slot),
                        json.dumps(body), ttl)
        return 1


# -- fleet-wide readers -------------------------------------------------------

def _parse(key: str, prefix: str):
    """``obs/ts/<proc>/<series>/<slot>`` → (proc, series, slot). The
    series may contain label braces but never slashes; proc and slot are
    the outermost segments."""
    parts = key[len(prefix):].split("/")
    if len(parts) < 3:
        return None
    try:
        slot = int(parts[-1])
    except ValueError:
        return None
    return parts[0], "/".join(parts[1:-1]), slot


def read_series(kv, name: str, *, proc: str | None = None,
                coarse: bool = False) -> list[dict]:
    """Every live point of every series whose base name is ``name``
    (label variants included), fleet-wide or for one process. Rows are
    ``{"proc", "series", "bucket", "kind", "v", "wall"}`` sorted by
    (bucket, proc, series); wrapped/expired slots never appear because
    the payload's absolute bucket is authoritative."""
    prefix = TSD_PREFIX if coarse else TS_PREFIX
    scan = prefix + (f"{proc}/" if proc else "")
    rows = []
    for key in kv.keys(scan):
        parsed = _parse(key, prefix)
        if parsed is None:
            continue
        kproc, series, _slot = parsed
        if series_base(series) != name:
            continue
        raw = kv.try_get(key)
        if raw is None:
            continue
        try:
            body = json.loads(raw)
        except ValueError:
            continue
        rows.append({"proc": kproc, "series": series, **body})
    rows.sort(key=lambda r: (r["bucket"], r["proc"], r["series"]))
    return rows


def list_series(kv, *, coarse: bool = False) -> list[tuple[str, str]]:
    """Sorted (proc, base-name) pairs currently live in the store."""
    prefix = TSD_PREFIX if coarse else TS_PREFIX
    seen = set()
    for key in kv.keys(prefix):
        parsed = _parse(key, prefix)
        if parsed is not None:
            seen.add((parsed[0], series_base(parsed[1])))
    return sorted(seen)


def window_sum(rows: list[dict], *, since_bucket: int,
               per_proc: bool = False):
    """Sum counter deltas from ``since_bucket`` onward: one float, or a
    per-proc dict. Gauge/histogram rows are ignored."""
    if per_proc:
        out: dict[str, float] = {}
        for r in rows:
            if r["kind"] == "counter" and r["bucket"] >= since_bucket:
                out[r["proc"]] = out.get(r["proc"], 0.0) + float(r["v"])
        return out
    return sum(float(r["v"]) for r in rows
               if r["kind"] == "counter" and r["bucket"] >= since_bucket)


def latest_value(rows: list[dict], *, proc: str | None = None,
                 field: str | None = None):
    """The newest gauge value or histogram-digest field across the
    rows (optionally restricted to one proc); None when absent."""
    best = None
    for r in rows:
        if proc is not None and r["proc"] != proc:
            continue
        if r["kind"] == "counter":
            continue
        if best is None or r["bucket"] >= best["bucket"]:
            best = r
    if best is None:
        return None
    if best["kind"] == "histogram":
        return (best["v"] or {}).get(field or "p99")
    return best["v"]
