"""The port's tracing (tpu_sandbox_torch/utils/profiling.py) on the CPU,
the checks of tests/test_profiling.py for ``trace`` and ``annotate``: a
Chrome trace written into the log directory with the annotated region in
it, the profiler stopped and the trace written when the body raises, and
``mnist_onegpu --profile DIR``."""

import json

import pytest
import torch

from tpu_sandbox_torch import mnist_onegpu
from tpu_sandbox_torch.utils import profiling


def _events(logdir):
    files = sorted(logdir.glob("trace-*.json"))
    assert len(files) == 1, files
    return json.loads(files[0].read_text())["traceEvents"]


def test_trace_writes_a_chrome_trace_with_the_annotated_region(tmp_path):
    with profiling.trace(str(tmp_path / "t")):
        with profiling.annotate("outer"):
            with profiling.annotate("inner"):
                torch.ones(64, 64).matmul(torch.ones(64, 64))
    names = {e.get("name") for e in _events(tmp_path / "t")}
    assert {"outer", "inner"} <= names
    assert any("mm" in str(n) for n in names)


def test_trace_stops_the_profiler_on_body_exception(tmp_path):
    with pytest.raises(RuntimeError, match="boom"):
        with profiling.trace(str(tmp_path)):
            assert torch._C._autograd._profiler_enabled()
            torch.ones(3).sum()
            raise RuntimeError("boom")
    assert not torch._C._autograd._profiler_enabled()
    assert any(e.get("name") == "aten::ones" for e in _events(tmp_path))


def test_entry_script_profile_writes_a_trace(tmp_path, capsys):
    logdir = tmp_path / "prof"
    trainer, state = mnist_onegpu.main([
        "--force-cpu", "--image-size", "32", "--limit-steps", "2",
        "--epochs", "1", "--synthetic-n", "10", "--log-every", "1",
        "--data-dir", "no-such-mnist-dir", "--profile", str(logdir)])
    assert state.step == 2
    out = capsys.readouterr().out.strip().splitlines()
    assert out[-1] == f"profiler trace written to {logdir}"
    assert any(e.get("name") == "aten::convolution" for e in _events(logdir))
