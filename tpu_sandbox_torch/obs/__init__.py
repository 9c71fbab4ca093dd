"""Observability of the port: the recorder (``record.py``), the metrics
registry (``metrics.py``) and the durable time series (``tsdb.py``),
copies of ``tpu_sandbox/obs/``'s, exported as its ``__init__`` exports
them. The collector, the critical-path analysis, the health monitor and
the workload export are not ported yet (ROADMAP item 6b)."""

from tpu_sandbox_torch.obs.record import (  # noqa: F401
    ENV_TRACE_DIR,
    Recorder,
    TraceContext,
    get_recorder,
    reset_recorder,
)
from tpu_sandbox_torch.obs.metrics import (  # noqa: F401
    MetricsRegistry,
    get_registry,
)
from tpu_sandbox_torch.obs.tsdb import (  # noqa: F401
    TimeSeriesFlusher,
    list_series,
    read_series,
)

__all__ = [
    "ENV_TRACE_DIR",
    "MetricsRegistry",
    "Recorder",
    "TimeSeriesFlusher",
    "TraceContext",
    "get_recorder",
    "get_registry",
    "list_series",
    "read_series",
    "reset_recorder",
]
