"""The port's offline collector (tpu_sandbox_torch/obs/collect.py) against
JAX's (tpu_sandbox/obs/collect.py): JAX's collector tests of
tests/test_trace_tools.py (torn log tails, the directory stats) on the
port, then every function of the collector equal to JAX's, exactly, on the
same inputs: the committed fixtures ``trace_small`` and ``trace_slow``, a
log set skewed so that the sequencer repair fires, and a trace recorded
from the port's own gateway process and stub-step replicas on the CPU
(tests/torch_trace_sets.py). No tensor arithmetic is involved, so nothing
is compared within a tolerance."""

import os
import shutil
import statistics

import pytest

from tpu_sandbox.obs import collect as jcollect
from tpu_sandbox_torch.obs import collect
from tpu_sandbox_torch.obs import critpath
from torch_threads import one_torch_thread  # noqa: F401
from torch_trace_sets import TRACE_SMALL, trace_sets

SETS = ("small", "slow", "skewed", "recorded")


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    return trace_sets(tmp_path_factory.mktemp("trace_sets"))


# -- JAX's collector scenarios on the port ------------------------------------


def _torn_copy(tmp_path, victim="gateway-200.jsonl", keep_lines=None):
    """Copy the fixture dir, then truncate ``victim`` mid-way through a
    record line: what a SIGKILLed process leaves behind."""
    torn = tmp_path / "torn"
    shutil.copytree(TRACE_SMALL, torn)
    path = torn / victim
    lines = path.read_text(encoding="utf-8").splitlines(keepends=True)
    if keep_lines is None:
        keep_lines = len(lines) - 1
    partial = lines[keep_lines][:len(lines[keep_lines]) // 2]
    path.write_text("".join(lines[:keep_lines]) + partial,
                    encoding="utf-8")
    return str(torn)


def test_read_log_counts_torn_tail_as_dropped(tmp_path):
    torn = _torn_copy(tmp_path, victim="serve-rep0-300.jsonl")
    stats = {}
    path = os.path.join(torn, "serve-rep0-300.jsonl")
    full = os.path.join(TRACE_SMALL, "serve-rep0-300.jsonl")
    recs = collect.read_log(path, stats)
    assert stats["dropped_records"] == 1
    assert len(recs) == len(collect.read_log(full, {})) - 1
    jstats = {}
    assert jcollect.read_log(path, jstats) == recs and jstats == stats


def test_torn_gateway_tail_leaves_dangling_chain_without_crash(tmp_path):
    # tear the gateway log inside r06's route record: r06 keeps its client
    # submit and replica claim/shed, but claim's parent (the enqueue span)
    # never made it to disk
    torn = _torn_copy(tmp_path, victim="gateway-200.jsonl", keep_lines=13)
    stats = {}
    merged = collect.load_merged(torn, stats)
    assert stats["dropped_records"] == 1
    chains = collect.trace_chains(merged)
    check = collect.chain_check(chains["t06"])
    assert not check["connected"]
    assert check["dangling"] >= 1
    # attribution still works on the torn chain (truncated walk), and the
    # waterfall says why the row floated free
    req = critpath.attribute_request(chains["t06"])
    assert req is not None and req["outcome"] == "shed:capacity"
    rows = collect.request_waterfall(merged, rid="r06")
    assert any(r["orphan"] for r in rows)
    assert "[orphan]" in collect.format_waterfall(rows)
    jstats = {}
    assert jcollect.load_merged(torn, jstats) == merged and jstats == stats
    assert jcollect.request_waterfall(merged, rid="r06") == rows


def test_load_dir_stats_shape():
    stats = {}
    logs = collect.load_dir(TRACE_SMALL, stats)
    assert stats["files"] == 3
    assert stats.get("dropped_records", 0) == 0
    assert set(logs) == {"client/100", "gateway/200", "serve-rep0/300"}


def test_request_waterfall_needs_rid_or_trace():
    with pytest.raises(ValueError, match="need rid or trace"):
        collect.request_waterfall([])
    assert collect.request_waterfall([], rid="nope") == []
    assert collect.to_chrome_trace([]) == {"traceEvents": [],
                                           "displayTimeUnit": "ms"}
    assert collect.format_timeline([]) == "(no records in window)"
    assert collect.last_window([], 1.0) == []


# -- the trace sets themselves ------------------------------------------------


def test_sequencer_repair_fires_on_the_skewed_set(sets):
    logs = collect.load_dir(sets["skewed"])
    anchors = {key: statistics.median(r["wall"] - r["mono"] for r in recs
                                      if r.get("ph") == "C")
               for key, recs in logs.items()}
    offsets = collect.clock_offsets(logs)
    # the wall anchor puts the gateway 5 ms early; the repair moves it
    # forward to just after the client's first calibration point
    assert offsets["gateway/200"] - anchors["gateway/200"] == \
        pytest.approx(0.0049, abs=1e-9)
    assert offsets["client/100"] == anchors["client/100"]
    merged = collect.merge(logs, offsets)
    first = next(r for r in merged if r.get("trace") == "t00")
    assert first["name"] == "submit"  # not the gateway's route
    # without the repair the route would land before its submit
    bare = collect.merge(logs, anchors)
    assert next(r for r in bare if r.get("trace") == "t00")["name"] == \
        "route"


def test_recorded_trace_holds_every_request_connected(sets):
    from torch_trace_sets import RECORDED

    stats = {}
    merged = collect.load_merged(sets["recorded"], stats)
    assert stats == {"files": 2, "dropped_records": 0}
    procs = {r["pkey"].split("/")[0] for r in merged}
    assert procs == {"gateway", "serve-stub"}
    names = {r["name"] for r in merged}
    # the gateway process flushed its route and enqueue spans on SIGTERM
    assert {"submit", "route", "enqueue", "claim", "admit", "prefill",
            "decode", "publish", "verdict"} <= names
    chains = collect.trace_chains(merged)
    assert len(chains) == len(RECORDED)
    assert all(collect.chain_check(recs)["connected"]
               for recs in chains.values())


# -- the port against JAX, on every set ---------------------------------------


@pytest.mark.parametrize("name", SETS)
def test_load_and_merge_equal_jax(sets, name):
    stats, jstats = {}, {}
    logs = collect.load_dir(sets[name], stats)
    assert logs == jcollect.load_dir(sets[name], jstats) and stats == jstats
    offsets = collect.clock_offsets(logs)
    assert offsets == jcollect.clock_offsets(logs)
    merged = collect.merge(logs, offsets)
    assert merged == jcollect.merge(logs, offsets)
    assert collect.load_merged(sets[name]) == merged
    assert jcollect.load_merged(sets[name]) == merged


@pytest.mark.parametrize("name", SETS)
def test_chrome_trace_equal_jax(sets, name):
    merged = collect.load_merged(sets[name])
    out = collect.to_chrome_trace(merged)
    assert out == jcollect.to_chrome_trace(merged)
    kinds = {e["ph"] for e in out["traceEvents"]}
    assert {"M", "X", "i"} <= kinds


@pytest.mark.parametrize("name", SETS)
def test_chains_equal_jax(sets, name):
    merged = collect.load_merged(sets[name])
    chains = collect.trace_chains(merged)
    assert chains == jcollect.trace_chains(merged)
    for trace, recs in sorted(chains.items()):
        assert collect.chain_check(recs) == jcollect.chain_check(recs), trace


@pytest.mark.parametrize("name", SETS)
def test_waterfalls_equal_jax(sets, name):
    merged = collect.load_merged(sets[name])
    rids = sorted(critpath.request_traces(merged))
    assert rids
    for rid in rids:
        rows = collect.request_waterfall(merged, rid=rid)
        assert rows and rows == jcollect.request_waterfall(merged, rid=rid)
        trace = rows[0]["trace"]
        assert collect.request_waterfall(merged, trace=trace) == rows
        recs = [r for r in merged if r.get("trace") == trace]
        crit = {r.get("span") for r in critpath.critical_path(recs)
                if r.get("span")}
        text = collect.format_waterfall(rows, crit=crit)
        assert text == jcollect.format_waterfall(rows, crit=crit)
        assert "*" in text


@pytest.mark.parametrize("name", SETS)
def test_timelines_equal_jax(sets, name):
    merged = collect.load_merged(sets[name])
    for seconds in (0.0, 0.01, 0.1, 1e9):
        window = collect.last_window(merged, seconds)
        assert window == jcollect.last_window(merged, seconds)
        text = collect.format_timeline(window)
        assert text == jcollect.format_timeline(window)
    assert len(collect.last_window(merged, 1e9)) == len(merged)
