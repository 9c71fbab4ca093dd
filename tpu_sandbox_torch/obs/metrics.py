"""The fleet metrics registry: counters, gauges, streaming-quantile
histograms. The port's copy of ``tpu_sandbox/obs/metrics.py``.

Unlike the recorder (:mod:`tpu_sandbox_torch.obs.record`), the registry is
ALWAYS on — an increment is a lock-guarded integer add, nanoseconds —
and absorbs the stats that used to live as ad-hoc attributes scattered
across the codebase: engine shed reasons, client retry/hedge counts,
transport put/claim audit, scheduler virtual-time per tenant. It is
scraped live through the gateway's ``OP_METRICS`` wire op
(``GatewayClient.metrics()``), which folds in the per-replica recorder
stats from the TTL'd load reports so one scrape sees the whole fleet.

Histograms keep exact count/sum/min/max plus a fixed-size reservoir
sample (deterministic seed — reproducible quantile estimates) so
``quantile(0.99)`` stays O(reservoir) regardless of observation count.

Metric NAMES are static ``snake.dotted`` literals — graftlint GL-O402
rejects f-strings and concatenation at registry call sites, because a
dynamic name mints a new series per distinct value and the time-series
store downstream would grow without bound. Bounded dimensions (shed
reason, tenant, replica tag) travel in ``labels=``, which become part
of the series key as ``name{k=v,...}`` with sorted label keys.
"""

from __future__ import annotations

import random
import threading


def series_key(name: str, labels: dict | None) -> str:
    """The registry/tsdb series key: ``name`` alone, or
    ``name{k=v,...}`` with label keys sorted so the same label set
    always produces the same series."""
    if not labels:
        return name
    inner = ",".join(f"{k}={labels[k]}" for k in sorted(labels))
    return f"{name}{{{inner}}}"


class Counter:
    """Monotonically increasing integer."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self.value += n

    def snapshot(self):
        return self.value


class Gauge:
    """Last-write-wins scalar."""

    __slots__ = ("name", "value", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0
        self._lock = threading.Lock()

    def set(self, v: float) -> None:
        with self._lock:
            self.value = float(v)

    def snapshot(self):
        return self.value


class Histogram:
    """Streaming distribution: exact count/sum/min/max, quantiles from a
    bounded reservoir (Vitter's algorithm R with a fixed seed)."""

    __slots__ = ("name", "count", "total", "min", "max",
                 "_reservoir", "_cap", "_rng", "_lock")

    def __init__(self, name: str, reservoir: int = 512):
        self.name = name
        self.count = 0
        self.total = 0.0
        self.min = None
        self.max = None
        self._reservoir: list[float] = []
        self._cap = reservoir
        self._rng = random.Random(0xB0B)
        self._lock = threading.Lock()

    def observe(self, v: float) -> None:
        v = float(v)
        with self._lock:
            self.count += 1
            self.total += v
            if self.min is None or v < self.min:
                self.min = v
            if self.max is None or v > self.max:
                self.max = v
            if len(self._reservoir) < self._cap:
                self._reservoir.append(v)
            else:
                j = self._rng.randrange(self.count)
                if j < self._cap:
                    self._reservoir[j] = v

    def quantile(self, q: float) -> float | None:
        with self._lock:
            if not self._reservoir:
                return None
            s = sorted(self._reservoir)
        idx = min(len(s) - 1, max(0, int(q * (len(s) - 1) + 0.5)))
        return s[idx]

    def snapshot(self):
        with self._lock:
            mean = self.total / self.count if self.count else None
        return {"count": self.count, "sum": self.total,
                "min": self.min, "max": self.max, "mean": mean,
                "p50": self.quantile(0.5), "p90": self.quantile(0.9),
                "p99": self.quantile(0.99)}


class MetricsRegistry:
    """Get-or-create home for every metric in the process. ``snapshot()``
    is the scrape body: plain JSON-serializable dict keyed by kind."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def counter(self, name: str, labels: dict | None = None) -> Counter:
        key = series_key(name, labels)
        with self._lock:
            c = self._counters.get(key)
            if c is None:
                c = self._counters[key] = Counter(key)
            return c

    def gauge(self, name: str, labels: dict | None = None) -> Gauge:
        key = series_key(name, labels)
        with self._lock:
            g = self._gauges.get(key)
            if g is None:
                g = self._gauges[key] = Gauge(key)
            return g

    def histogram(self, name: str, reservoir: int = 512,
                  labels: dict | None = None) -> Histogram:
        key = series_key(name, labels)
        with self._lock:
            h = self._histograms.get(key)
            if h is None:
                h = self._histograms[key] = Histogram(key, reservoir)
            return h

    def snapshot(self) -> dict:
        with self._lock:
            counters = dict(self._counters)
            gauges = dict(self._gauges)
            histograms = dict(self._histograms)
        return {
            "counters": {k: c.snapshot() for k, c in sorted(counters.items())},
            "gauges": {k: g.snapshot() for k, g in sorted(gauges.items())},
            "histograms": {k: h.snapshot()
                           for k, h in sorted(histograms.items())},
        }

    def reset(self) -> None:
        """Drop every metric (tests / bench arm isolation)."""
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    return REGISTRY
