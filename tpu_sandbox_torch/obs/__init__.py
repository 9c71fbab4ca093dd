"""Observability of the port: the recorder (``record.py``), the metrics
registry (``metrics.py``), the durable time series (``tsdb.py``), the
leader-elected health monitor with its alert rules and detectors
(``health.py``), the offline collector that merges per-process logs onto
one clock (``collect.py``), the critical-path attribution over the merged
timeline (``critpath.py``) and the canonical replayable workload export
(``workload.py``): copies of ``tpu_sandbox/obs/``'s, exported as its
``__init__`` exports them. The command-line tools over them are in
``tpu_sandbox_torch/tools/`` (``tracecat``, ``tracediff``, ``fleetop``)."""

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
