"""Tracing utilities, counterpart of ``tpu_sandbox/utils/profiling.py``
(``trace`` :21, ``annotate`` :34) on ``torch.profiler``.

``trace(logdir)`` records the enclosed block (host activity, and the
card's kernels when ``cuda``) and writes a Chrome/Perfetto trace into
``logdir``; ``annotate(name)`` names a region on its timeline.
"""

from __future__ import annotations

import contextlib
import os
import time

from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def trace(logdir: str, *, cuda: bool = False):
    """Profile the enclosed block and write
    ``<logdir>/trace-<pid>-<time>.json``; the profiler stops and the
    trace is written even when the body raises."""
    os.makedirs(logdir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield
    finally:
        prof.stop()
        prof.export_chrome_trace(os.path.join(
            logdir, f"trace-{os.getpid()}-{time.time_ns()}.json"))


def annotate(name: str):
    """Name a region so it shows on the trace's timeline."""
    return record_function(name)

