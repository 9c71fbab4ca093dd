"""The recorder of the port's elastic plane: the part of
``tpu_sandbox/obs/`` it needs (``record.py``'s ``get_recorder``)."""

from tpu_sandbox_torch.obs.record import (  # noqa: F401
    ENV_TRACE_DIR,
    Recorder,
    TraceContext,
    get_recorder,
    reset_recorder,
)
