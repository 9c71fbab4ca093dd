"""The port's command-line tools (tpu_sandbox_torch/tools/: tracecat,
tracediff, fleetop) through the CLI cases of JAX's
tests/test_trace_tools.py, each run as a user runs it (``python -m
tpu_sandbox_torch.tools.<tool>`` in a subprocess, with a timeout), and
each held to JAX's tool (the repo's ``tools/<tool>.py``, its ``main``
called in this process on the same argv): the same standard output and
the same exit code. Then the three CLIs' flag sets against JAX's, and
``fleetop.render`` against JAX's on one KV state that fills every panel.
The collector's own cases of tests/test_trace_tools.py are in
tests/test_torch_collect.py."""

import ast
import contextlib
import importlib.util
import io
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

from tpu_sandbox.obs import critpath as jcritpath
from tpu_sandbox_torch.obs import critpath
from tpu_sandbox_torch.obs.collect import load_merged
from torch_threads import one_torch_thread  # noqa: F401
from torch_trace_sets import ROOT, TRACE_SLOW, TRACE_SMALL

TOOLS = ("tracecat", "tracediff", "fleetop")


def _jax_tool(name):
    """The repo's ``tools/<name>.py`` (the JAX package's CLI) as a module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}_under_test", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def jax_tools():
    return {name: _jax_tool(name) for name in TOOLS}


def _run(tool, *argv):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    return subprocess.run(
        [sys.executable, "-m", f"tpu_sandbox_torch.tools.{tool}", *argv],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)


def _jax_run(jax_tools, tool, *argv):
    """JAX's tool on ``argv`` in this process: (exit code, stdout)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = jax_tools[tool].main(list(argv))
    return rc, out.getvalue()


def _same_as_jax(jax_tools, tool, *argv):
    """Run the port's tool, require JAX's stdout and exit code; return the
    port's completed process."""
    got = _run(tool, *argv)
    rc, stdout = _jax_run(jax_tools, tool, *argv)
    assert (got.returncode, got.stdout) == (rc, stdout), got.stderr
    return got


# -- tracecat -----------------------------------------------------------------


def test_tracecat_summary(jax_tools):
    out = _same_as_jax(jax_tools, "tracecat", TRACE_SMALL)
    assert out.returncode == 0, out.stderr
    assert "3 process logs" in out.stdout
    assert "0 dropped lines" in out.stdout
    assert "7 traces, 7 fully connected" in out.stdout


def test_tracecat_waterfall_marks_critical_path(jax_tools):
    out = _same_as_jax(jax_tools, "tracecat", TRACE_SMALL, "--rid", "r01")
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    decode = next(ln for ln in lines if " decode " in ln or
                  ln.rstrip().endswith("decode  [serve-rep0/300]"))
    prefill = next(ln for ln in lines if "prefill" in ln)
    assert "*" in decode
    assert "*" not in prefill  # refines admit, not on the causal spine
    crit = next(ln for ln in lines if "critical path (ok" in ln)
    assert "decode=" in crit and "coverage 100" in crit


def test_tracecat_waterfall_blames_shed_request(jax_tools):
    out = _same_as_jax(jax_tools, "tracecat", TRACE_SMALL, "--rid", "r06")
    assert out.returncode == 0, out.stderr
    assert "critical path (shed:capacity" in out.stdout
    assert "blame: queue_wait" in out.stdout


def test_tracecat_unknown_rid_exits_nonzero(jax_tools):
    out = _same_as_jax(jax_tools, "tracecat", TRACE_SMALL, "--rid", "nope")
    assert out.returncode == 1
    assert "no matching trace" in out.stderr


def test_tracecat_critpath_profile_export(jax_tools, tmp_path):
    prof_path = str(tmp_path / "prof.json")
    out = _same_as_jax(jax_tools, "tracecat", TRACE_SMALL, "--critpath",
                       prof_path)
    assert out.returncode == 0, out.stderr
    assert "critpath profile: 7 requests (6 ok)" in out.stdout
    prof = critpath.load_profile(prof_path)
    assert prof["schema"] == critpath.PROFILE_SCHEMA


def test_tracecat_chrome_trace_and_last_window(jax_tools, tmp_path):
    # each writes its own file (the printed line names it)
    mine, theirs = tmp_path / "port.json", tmp_path / "jax.json"
    got = _run("tracecat", TRACE_SMALL, "--out", str(mine))
    assert got.returncode == 0, got.stderr
    assert _jax_run(jax_tools, "tracecat", TRACE_SMALL, "--out",
                    str(theirs))[0] == 0
    assert json.loads(mine.read_text()) == json.loads(theirs.read_text())
    out = _same_as_jax(jax_tools, "tracecat", TRACE_SLOW, "--last", "0.1s",
                       "--critpath")
    assert out.returncode == 0 and "critpath profile" in out.stdout


def test_tracecat_torn_tail_marks_the_orphan(jax_tools, tmp_path):
    # tear the gateway log inside r06's route record (see
    # test_torch_collect.py): the waterfall says why the claim floats free
    torn = tmp_path / "torn"
    shutil.copytree(TRACE_SMALL, torn)
    path = torn / "gateway-200.jsonl"
    lines = path.read_text(encoding="utf-8").splitlines(keepends=True)
    path.write_text("".join(lines[:13]) + lines[13][:len(lines[13]) // 2],
                    encoding="utf-8")
    out = _same_as_jax(jax_tools, "tracecat", str(torn), "--rid", "r06")
    assert out.returncode == 0, out.stderr
    assert "[orphan]" in out.stdout
    out = _same_as_jax(jax_tools, "tracecat", str(torn))
    assert "1 dropped lines" in out.stdout


def test_tracecat_empty_dir_exits_1(jax_tools, tmp_path):
    out = _same_as_jax(jax_tools, "tracecat", str(tmp_path))
    assert out.returncode == 1
    assert "no recorder logs" in out.stderr


# -- tracediff ----------------------------------------------------------------


def test_tracediff_gates_decode_slowdown(jax_tools):
    out = _same_as_jax(jax_tools, "tracediff", TRACE_SMALL, TRACE_SLOW)
    assert out.returncode == 1, out.stdout
    assert "REGRESSED" in out.stdout
    assert "1 regression(s): decode" in out.stdout


def test_tracediff_identical_run_is_clean(jax_tools):
    out = _same_as_jax(jax_tools, "tracediff", TRACE_SMALL, TRACE_SMALL)
    assert out.returncode == 0, out.stdout
    assert "0 regression(s)" in out.stdout


def test_tracediff_json_mode(jax_tools):
    out = _same_as_jax(jax_tools, "tracediff", TRACE_SMALL, TRACE_SLOW,
                       "--json")
    assert out.returncode == 1
    cmp = json.loads(out.stdout)
    assert cmp["regressions"] == ["decode"]


def test_tracediff_thresholds_and_saved_profiles(jax_tools, tmp_path):
    # profiles saved by either package (b by JAX's) gate as the trace dirs
    a, b = tmp_path / "a.json", tmp_path / "b.json"
    critpath.save_profile(critpath.analyze(load_merged(TRACE_SMALL))[
        "profile"], str(a))
    jcritpath.save_profile(jcritpath.analyze(load_merged(TRACE_SLOW))[
        "profile"], str(b))
    out = _same_as_jax(jax_tools, "tracediff", str(a), str(b))
    assert out.returncode == 1
    out = _same_as_jax(jax_tools, "tracediff", str(a), str(b),
                       "--threshold", "0.5")
    assert out.returncode == 0 and "0 regression(s)" in out.stdout
    out = _same_as_jax(jax_tools, "tracediff", str(b), str(a),
                       "--min-ms", "0", "--min-share", "0")
    assert out.returncode == 0 and "improved" in out.stdout


def test_tracediff_bad_input_exits_2(jax_tools, tmp_path):
    missing = str(tmp_path / "nope.json")
    out = _same_as_jax(jax_tools, "tracediff", TRACE_SMALL, missing)
    assert out.returncode == 2
    bad = tmp_path / "bad_schema.json"
    bad.write_text('{"schema": "not-a-profile"}\n', encoding="utf-8")
    out = _same_as_jax(jax_tools, "tracediff", TRACE_SMALL, str(bad))
    assert out.returncode == 2
    assert "schema" in out.stderr


# -- the CLIs' flags ----------------------------------------------------------


def _flags(path: Path) -> list[tuple]:
    """Every ``add_argument`` call of a CLI source: its names and its
    keywords (constant values, or the keyword's name when computed)."""
    out = []
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if (isinstance(node, ast.Call)
                and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            names = tuple(a.value for a in node.args)
            kws = tuple(sorted(
                (k.arg, k.value.value if isinstance(k.value, ast.Constant)
                 else ast.dump(k.value) if k.arg != "help" else "")
                for k in node.keywords if k.arg != "help"))
            out.append((names, kws))
    return sorted(out)


@pytest.mark.parametrize("tool", TOOLS)
def test_cli_flags_equal_jax(tool):
    mine = _flags(ROOT / "tpu_sandbox_torch" / "tools" / f"{tool}.py")
    assert mine and mine == _flags(ROOT / "tools" / f"{tool}.py")


def test_fleetop_cli_renders_a_store():
    from tpu_sandbox_torch.runtime.kvstore import KVServer

    with KVServer() as srv:
        out = _run("fleetop", "--port", str(srv.port))
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("fleetop @ ")
    assert "no time series published yet" in out.stdout


# -- fleetop ------------------------------------------------------------------


@pytest.fixture
def kv():
    from tpu_sandbox_torch.runtime.kvstore import KVClient, KVServer

    server = KVServer()
    client = KVClient(port=server.port)
    yield client
    client.close()
    server.stop()


def test_fleetop_where_time_goes_panel(kv):
    from tpu_sandbox_torch.obs.metrics import MetricsRegistry
    from tpu_sandbox_torch.obs.record import Recorder
    from tpu_sandbox_torch.obs.tsdb import TimeSeriesFlusher
    from tpu_sandbox_torch.tools import fleetop

    # nothing published yet -> no panel
    assert "where time goes:" not in fleetop.render(kv)

    prof = critpath.analyze(load_merged(TRACE_SMALL))["profile"]
    critpath.publish_profile(kv, prof)
    reg = MetricsRegistry()
    reg.gauge("mpmd.bubble_fraction", labels={"stage": "0"}).set(0.21)
    reg.gauge("mpmd.bubble_fraction", labels={"stage": "1"}).set(0.19)
    TimeSeriesFlusher(kv, proc="mpmd-test", registry=reg,
                      recorder=Recorder(None)).flush()

    out = fleetop.render(kv)
    assert "where time goes:" in out
    assert "decode" in out
    assert "attribution coverage 100.0%" in out
    assert "mpmd bubble: stage0=0.210  stage1=0.190" in out


def _fill_every_panel(kv, now):
    """One KV state that fills every panel of fleetop: fleet gauges, two
    replicas (one burning and excluded), the where-time-goes panel, an
    idle and a canarying fleet with verdicts and a rollback, active and
    recorded alerts."""
    from tpu_sandbox_torch.deploy import registry
    from tpu_sandbox_torch.obs.health import raise_alert
    from tpu_sandbox_torch.obs.metrics import MetricsRegistry
    from tpu_sandbox_torch.obs.record import Recorder
    from tpu_sandbox_torch.obs.tsdb import TimeSeriesFlusher
    from tpu_sandbox_torch.serve.replica import k_load

    def flush(proc, fill):
        reg = MetricsRegistry()
        fill(reg)
        TimeSeriesFlusher(kv, proc=proc, registry=reg,
                          recorder=Recorder(None)).flush()

    flush("sched", lambda r: (r.gauge("sched.queue.depth").set(4),
                              r.gauge("sched.running").set(2)))
    flush("gw", lambda r: r.gauge("serve.goodput").set(12.5))
    flush("w0", lambda r: (r.counter("engine.shed").inc(30),
                           r.counter("engine.done").inc(10)))
    flush("w1", lambda r: r.counter("engine.done").inc(40))
    flush("stage", lambda r: r.gauge("mpmd.bubble_fraction",
                                     labels={"stage": "0"}).set(0.25))
    for tag, q, ver in (("w0", 2, 1), ("w1", 0, 2)):
        kv.set_ttl(k_load(tag), json.dumps({
            "queue_depth": q, "active": 1, "max_batch": 2, "ver": ver,
            "free_block_frac": 1.0, "prefix_digest": []}), 30.0)
    critpath.publish_profile(kv, critpath.analyze(load_merged(TRACE_SLOW))[
        "profile"])
    for fleet in ("", "blue"):
        for _ in range(2):
            registry.publish_version(kv, "/nonexistent/step", fleet=fleet)
    kv.set(registry.k_target(""), "1")
    kv.set(registry.k_ro("blue", 2, "rec"), json.dumps({"ver": 2}))
    kv.set(registry.k_ro("blue", 1, "rec"), json.dumps({"ver": 1}))
    kv.set(registry.k_ro("blue", 1, "verdict"),
           json.dumps({"outcome": "fail"}))
    kv.set(registry.k_ro("blue", 1, "done"), json.dumps({}))
    kv.set(registry.k_shares("blue"), json.dumps({"shares": {"0": 0.9,
                                                             "2": 0.1}}))
    for ev in ({"action": "canary_fail", "fleet": "blue", "ver": 1,
                "wall": now - 40.0},
               {"action": "rolled_back", "fleet": "blue", "ver": 1,
                "target": 0, "wall": now - 30.0},
               {"action": "promoted", "fleet": "default", "ver": 1,
                "wall": now - 12.0}):
        registry.append_event(kv, ev)
    raise_alert(kv, "replica_burn", "w0", 1,
                {"rule": "replica_burn", "subject": "w0", "window_idx": 1,
                 "wall": now - 8.0}, active_ttl=30.0)
    raise_alert(kv, "shed_burn", "fleet", 2,
                {"rule": "shed_burn", "subject": "fleet", "window_idx": 2,
                 "wall": now - 3.5}, active_ttl=30.0)


def test_fleetop_render_equal_jax(kv, jax_tools, monkeypatch):
    from tpu_sandbox_torch.tools import fleetop

    now = time.time()
    monkeypatch.delenv("TPU_SANDBOX_TRACE_DIR", raising=False)
    empty = fleetop.render(kv, now=now)
    assert empty == jax_tools["fleetop"].render(kv, now=now)
    assert "no time series published yet" in empty
    _fill_every_panel(kv, now)
    for max_alerts in (1, 8):
        got = fleetop.render(kv, now=now, max_alerts=max_alerts)
        assert got == jax_tools["fleetop"].render(kv, now=now,
                                                  max_alerts=max_alerts)
    for needle in ("sched.queue.depth", "serve.goodput", "EXCLUDED",
                   "where time goes:", "mpmd bubble: stage0=0.250",
                   "fleet blue: target v0, 2 registered, rollout v2 canary",
                   "canary shares: v0=90%, v2=10%", "last rollback: v1 -> v0",
                   "last canary verdict: promoted v1 (12s ago)",
                   "active alerts (2)", "recent alert records (last 2)",
                   "postmortem: set TPU_SANDBOX_TRACE_DIR"):
        assert needle in got, needle
    # with tracing on, the postmortem pointer names the port's tracecat
    monkeypatch.setenv("TPU_SANDBOX_TRACE_DIR", "/traces")
    got = fleetop.render(kv, now=now).splitlines()
    want = jax_tools["fleetop"].render(kv, now=now).splitlines()
    assert got[:-1] == want[:-1]
    assert got[-1] == ("postmortem: python -m tpu_sandbox_torch.tools."
                       "tracecat /traces --last 13s")
    assert want[-1] == "postmortem: python tools/tracecat.py /traces --last 13s"
