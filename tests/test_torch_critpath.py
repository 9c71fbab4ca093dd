"""The port's trace analytics (tpu_sandbox_torch/obs/{critpath,workload}.py)
through JAX's tests/test_critpath.py, then against JAX's modules on the
same inputs: ``analyze``, ``aggregate``, ``compare_profiles``,
``bubble_fractions`` and the profile files equal JAX's exactly, a profile
saved by either package loads in the other, and ``workload.synthesize``
and ``dumps(from_trace(...))`` give JAX's bytes. The traces are the
committed fixtures (whose hand-placed timestamps make the segment math
exact), a log set on which the clock repair fires and a trace recorded
from the port's own gateway and stub replicas (tests/torch_trace_sets.py).
"""

import json

import pytest

from tpu_sandbox.obs import critpath as jcritpath
from tpu_sandbox.obs import workload as jworkload
from tpu_sandbox_torch.obs import critpath, workload
from tpu_sandbox_torch.obs.collect import load_merged, trace_chains
from torch_threads import one_torch_thread  # noqa: F401
from torch_trace_sets import TRACE_SLOW, TRACE_SMALL, trace_sets

SETS = ("small", "slow", "skewed", "recorded")


@pytest.fixture
def kv_pair():
    from tpu_sandbox_torch.runtime.kvstore import KVClient, KVServer

    server = KVServer()
    kv = KVClient(port=server.port)
    yield server, kv, None
    kv.close()
    server.stop()


@pytest.fixture(scope="module")
def sets(tmp_path_factory):
    return trace_sets(tmp_path_factory.mktemp("trace_sets"))


@pytest.fixture(scope="module")
def small_merged():
    return load_merged(TRACE_SMALL)


@pytest.fixture(scope="module")
def small_analysis(small_merged):
    return critpath.analyze(small_merged)


# -- critical path walk -------------------------------------------------------


def test_critical_path_is_root_first_causal_chain(small_merged):
    recs = trace_chains(small_merged)["t00"]
    names = [r["name"] for r in critpath.critical_path(recs)]
    assert names == ["submit", "route", "enqueue", "claim", "admit",
                     "decode", "publish", "verdict"]
    # prefill refines admit but is not on the causal spine
    assert "prefill" not in names


def test_terminal_prefers_verdict_over_later_noise():
    recs = [
        {"ph": "X", "name": "decode", "uts": 0.0, "dur": 0.01,
         "span": "a.1", "parent": None, "trace": "t", "pkey": "p/1"},
        {"ph": "i", "name": "verdict", "uts": 0.011, "span": "a.2",
         "parent": "a.1", "trace": "t", "pkey": "p/1",
         "args": {"verdict": "ok"}},
        # a scavenger instant landing after the verdict must not steal the
        # terminal slot
        {"ph": "i", "name": "lease:expired", "uts": 0.02, "span": "a.3",
         "parent": None, "trace": "t", "pkey": "p/1"},
    ]
    assert critpath._terminal(recs)["name"] == "verdict"
    assert jcritpath._terminal(recs) is critpath._terminal(recs)


# -- attribution --------------------------------------------------------------


def test_attribution_exact_segments_on_fixture(small_analysis):
    req = next(r for r in small_analysis["requests"] if r["rid"] == "r00")
    assert req["outcome"] == "ok"
    assert req["coverage"] == pytest.approx(1.0)
    ms = {k: v * 1e3 for k, v in req["segments"].items()}
    # hand-placed fixture timestamps -> exact segment durations
    assert ms["submit"] == pytest.approx(0.2, abs=1e-6)
    assert ms["route"] == pytest.approx(0.8, abs=1e-6)
    assert ms["enqueue"] == pytest.approx(0.2, abs=1e-6)
    assert ms["queue_wait"] == pytest.approx(1.8, abs=1e-6)
    assert ms["claim"] == pytest.approx(0.5, abs=1e-6)
    assert ms["engine_queue"] == pytest.approx(0.1, abs=1e-6)
    assert ms["prefill"] == pytest.approx(3.8, abs=1e-6)
    assert ms["decode"] == pytest.approx(20.0, abs=1e-6)
    assert ms["publish"] == pytest.approx(0.6, abs=1e-6)
    assert ms["publish_wait"] == pytest.approx(0.3, abs=1e-6)
    # attribution sums to the wall exactly
    assert sum(req["segments"].values()) == pytest.approx(req["wall_s"])


def test_blame_names_the_segment_that_ate_the_shed_request(small_analysis):
    shed = next(r for r in small_analysis["requests"] if r["rid"] == "r06")
    assert shed["outcome"] == "shed:capacity"
    assert shed["blame"] == "queue_wait"
    prof = small_analysis["profile"]
    assert prof["blame"] == {"queue_wait": 1}
    assert prof["requests"] == 7 and prof["ok"] == 6
    assert prof["coverage_min"] == pytest.approx(1.0)


def _swap_case():
    recs = [
        {"ph": "X", "name": "submit", "uts": 0.0, "dur": 0.001,
         "span": "a.1", "parent": None, "trace": "t", "pkey": "client/1",
         "args": {"rid": "r0"}},
        {"ph": "X", "name": "enqueue", "uts": 0.001, "dur": 0.0002,
         "span": "a.2", "parent": "a.1", "trace": "t", "pkey": "gw/1"},
        {"ph": "X", "name": "claim", "uts": 0.010, "dur": 0.0005,
         "span": "b.1", "parent": "a.2", "trace": "t", "pkey": "serve/1"},
        {"ph": "i", "name": "verdict", "uts": 0.0105, "span": "b.2",
         "parent": "b.1", "trace": "t", "pkey": "serve/1",
         "args": {"verdict": "ok"}},
    ]
    stall = {"ph": "X", "name": "swap:pause", "uts": 0.002, "dur": 0.004,
             "span": "b.9", "parent": None, "trace": None,
             "pkey": "serve/1"}
    return recs, stall


def test_swap_stall_carved_out_of_queue_gap():
    recs, stall = _swap_case()
    req = critpath.attribute_request(recs, [stall])
    ms = {k: v * 1e3 for k, v in req["segments"].items()}
    # the 8.8 ms enqueue->claim gap: 4 ms explained by the overlapping
    # weight swap, the 0.8 ms before and 4 ms after stay queue_wait
    assert ms["swap_pause"] == pytest.approx(4.0, abs=1e-6)
    assert ms["queue_wait"] == pytest.approx(4.8, abs=1e-6)
    assert req["coverage"] == pytest.approx(1.0)
    assert sum(req["segments"].values()) == pytest.approx(req["wall_s"])
    assert req == jcritpath.attribute_request(recs, [stall])

    # a swap on some other engine does not explain this request's wait
    other = dict(stall, pkey="serve/other")
    req2 = critpath.attribute_request(recs, [other])
    assert "swap_pause" not in req2["segments"]
    assert req2["segments"]["queue_wait"] * 1e3 == pytest.approx(8.8,
                                                                 abs=1e-6)
    assert req2 == jcritpath.attribute_request(recs, [other])


def test_aggregate_shape_and_samples(small_analysis):
    prof = small_analysis["profile"]
    assert prof["schema"] == critpath.PROFILE_SCHEMA
    dec = prof["segments"]["decode"]
    assert dec["n"] == 6
    assert dec["samples"] == sorted(dec["samples"])
    assert dec["median_s"] == pytest.approx(0.021, abs=1e-6)
    shares = sum(s["share"] for s in prof["segments"].values())
    assert shares == pytest.approx(1.0, abs=1e-3)
    # the serving replica carries the request segments in the proc view
    assert any(p.startswith("serve-rep0") for p in prof["by_proc"])


# -- compare / tracediff engine -----------------------------------------------


def test_compare_flags_decode_slowdown_and_only_decode(small_analysis):
    prof_a = small_analysis["profile"]
    prof_b = critpath.analyze(load_merged(TRACE_SLOW))["profile"]
    cmp = critpath.compare_profiles(prof_a, prof_b)
    assert cmp["regressions"] == ["decode"]
    dec = next(r for r in cmp["segments"] if r["segment"] == "decode")
    assert dec["ratio"] == pytest.approx(1.3, abs=0.01)


def test_compare_identical_profiles_is_clean(small_analysis):
    prof = small_analysis["profile"]
    cmp = critpath.compare_profiles(prof, prof)
    assert cmp["regressions"] == []
    assert cmp["wall_ratio"] == pytest.approx(1.0)


def test_profile_save_load_roundtrip_and_schema_gate(small_analysis,
                                                     tmp_path):
    prof = small_analysis["profile"]
    path = str(tmp_path / "prof.json")
    critpath.save_profile(prof, path)
    assert critpath.load_profile(path) == prof
    # a trace dir analyzes on the fly to the same profile
    assert critpath.load_profile(TRACE_SMALL) == prof
    bad = dict(prof, schema="tpu-sandbox.critpath/999")
    critpath.save_profile(bad, path)
    with pytest.raises(ValueError, match="schema"):
        critpath.load_profile(path)


# -- MPMD bubble accounting ---------------------------------------------------


def _stage_spans():
    def rec(name, dur, stage, step):
        return {"ph": "X", "name": name, "uts": 0.0, "dur": dur,
                "span": None, "parent": None,
                "args": {"stage": stage, "step": step}}

    return [
        rec("stage:step", 0.010, 0, 0),
        rec("stage:op", 0.004, 0, 0), rec("stage:op", 0.004, 0, 0),
        rec("stage:step", 0.010, 1, 0),
        rec("stage:op", 0.010, 1, 0),
        rec("stage:step", 0.020, 0, 1),
        rec("stage:op", 0.015, 0, 1),
        rec("stage:step", 0.0, 1, 1),
    ]


def test_bubble_fractions_from_stage_spans():
    out = critpath.bubble_fractions(_stage_spans()[:5])
    assert out["per_stage"] == {0: pytest.approx(0.2), 1: pytest.approx(0.0)}
    assert out["mean"] == pytest.approx(0.1)
    assert {(r["stage"], r["step"]) for r in out["per_step"]} == {(0, 0),
                                                                  (1, 0)}


# -- tsdb publication (the fleetop feed) --------------------------------------


def test_publish_profile_lands_in_tsdb(small_analysis, kv_pair):
    from tpu_sandbox_torch.obs import tsdb

    _, kv, _ = kv_pair
    wrote = critpath.publish_profile(kv, small_analysis["profile"])
    assert wrote > 0
    shares = tsdb.read_series(kv, "critpath.segment.share")
    segs = {row["series"].split("seg=")[1].rstrip("}") for row in shares}
    assert "decode" in segs and "queue_wait" in segs
    cov = tsdb.latest_value(tsdb.read_series(kv, "critpath.coverage"))
    assert cov == pytest.approx(small_analysis["profile"]["coverage_mean"])


# -- workload trace -----------------------------------------------------------


def test_workload_from_trace_fields(small_merged):
    wl = workload.from_trace(small_merged, source="fixture")
    assert wl["schema"] == workload.SCHEMA
    rows = {r["rid"]: r for r in wl["requests"]}
    assert len(rows) == 7
    assert rows["r00"]["t_s"] == 0.0
    assert rows["r03"]["t_s"] == pytest.approx(0.150)
    assert rows["r02"]["prompt_tokens"] == 22
    assert rows["r02"]["decode_tokens"] == 10
    assert rows["r02"]["chain"] == "aa11"
    assert rows["r05"]["outcome"] == "ok"
    assert rows["r06"]["outcome"] == "shed:capacity"
    assert rows["r06"]["decode_tokens"] == 0
    # replay order is arrival order
    assert [r["rid"] for r in workload.replay_order(wl)] == \
        [f"r{i:02d}" for i in range(7)]


def test_workload_roundtrip_byte_identical(small_merged, tmp_path):
    wl = workload.from_trace(small_merged, source="fixture")
    text = workload.dumps(wl)
    assert text.endswith("\n")
    assert workload.dumps(workload.loads(text)) == text
    path = str(tmp_path / "wl.json")
    workload.save(wl, path)
    with open(path, "r", encoding="utf-8") as fh:
        assert fh.read() == text
    assert workload.load(path) == wl


def test_workload_validation_rejects_bad_traces(small_merged):
    wl = workload.from_trace(small_merged)
    with pytest.raises(ValueError, match="schema"):
        workload.loads(json.dumps(dict(wl, schema="workload/0")))
    broken = json.loads(workload.dumps(wl))
    del broken["requests"][0]["chain"]
    with pytest.raises(ValueError, match="missing fields"):
        workload.loads(json.dumps(broken))
    neg = json.loads(workload.dumps(wl))
    neg["requests"][0]["t_s"] = -1.0
    with pytest.raises(ValueError, match="bad arrival"):
        workload.loads(json.dumps(neg))


# -- the port against JAX -----------------------------------------------------


def test_constants_equal_jax():
    for name in ("PROFILE_SCHEMA", "SEGMENT_OF_SPAN", "GAP_SEGMENTS",
                 "STALL_SPANS", "COVERAGE_TARGET"):
        assert getattr(critpath, name) == getattr(jcritpath, name), name
    assert workload.SCHEMA == jworkload.SCHEMA == "tpu-sandbox.workload/1"
    assert workload._FIELDS == jworkload._FIELDS
    assert critpath.PROFILE_SCHEMA == "tpu-sandbox.critpath/1"


@pytest.mark.parametrize("name", SETS)
def test_analyze_equal_jax(sets, name):
    merged = load_merged(sets[name])
    got = critpath.analyze(merged)
    assert got == jcritpath.analyze(merged)
    assert got["requests"]
    assert got["profile"]["coverage_mean"] >= critpath.COVERAGE_TARGET
    assert critpath.aggregate(got["requests"]) == \
        jcritpath.aggregate(got["requests"])
    assert critpath.format_profile(got["profile"]) == \
        jcritpath.format_profile(got["profile"])
    for trace, recs in sorted(trace_chains(merged).items()):
        assert critpath.critical_path(recs) == jcritpath.critical_path(recs)


def test_recorded_trace_attributes_the_serving_segments(sets):
    prof = critpath.analyze(load_merged(sets["recorded"]))["profile"]
    assert prof["requests"] == prof["ok"] == 6
    assert {"submit", "route", "enqueue", "claim", "admit", "prefill",
            "decode", "publish"} <= set(prof["segments"])
    # the stub replicas ran in the recording process
    assert [p.split("/")[0] for p in prof["by_proc"]] == ["serve-stub"]


@pytest.mark.parametrize("pair", [("small", "slow"), ("slow", "small"),
                                  ("small", "small"), ("small", "recorded"),
                                  ("recorded", "skewed")])
def test_compare_profiles_equal_jax(sets, pair):
    a, b = (critpath.analyze(load_merged(sets[n]))["profile"] for n in pair)
    for kw in ({}, {"threshold": 0.05, "min_ms": 0.0, "min_share": 0.0}):
        got = critpath.compare_profiles(a, b, **kw)
        assert got == jcritpath.compare_profiles(a, b, **kw)
        assert critpath.format_compare(got) == jcritpath.format_compare(got)


def test_bubble_fractions_equal_jax():
    spans = _stage_spans()
    assert critpath.bubble_fractions(spans) == \
        jcritpath.bubble_fractions(spans)
    assert critpath.bubble_fractions([]) == jcritpath.bubble_fractions([])


@pytest.mark.parametrize("name", SETS)
def test_profiles_cross_load(sets, name, tmp_path):
    prof = critpath.analyze(load_merged(sets[name]))["profile"]
    mine, theirs = tmp_path / "port.json", tmp_path / "jax.json"
    critpath.save_profile(prof, str(mine))
    jcritpath.save_profile(prof, str(theirs))
    assert mine.read_bytes() == theirs.read_bytes()
    assert critpath.load_profile(str(theirs)) == prof
    assert jcritpath.load_profile(str(mine)) == prof
    assert critpath.load_profile(sets[name]) == \
        jcritpath.load_profile(sets[name])


@pytest.mark.parametrize("kw", [
    dict(seed=0, n=1), dict(seed=7, n=24, duration_s=4.0,
                            prompt_tokens=(32, 512), decode_tokens=(16, 64)),
    dict(seed=1013, n=10, duration_s=0.5, prompt_tokens=(4, 10),
         decode_tokens=(2, 4)),
    dict(seed=3, n=40, fleet="blue", n_chains=9, deadline_s=2.5),
    dict(seed=5, n=0)])
def test_synthesize_bytes_equal_jax(kw):
    kw = dict(kw)
    seed, n = kw.pop("seed"), kw.pop("n")
    text = workload.dumps(workload.synthesize(seed, n, **kw))
    assert text == jworkload.dumps(jworkload.synthesize(seed, n, **kw))
    assert workload.dumps(jworkload.loads(text)) == text
    assert jworkload.dumps(workload.loads(text)) == text


@pytest.mark.parametrize("name", SETS)
def test_from_trace_bytes_equal_jax(sets, name):
    merged = load_merged(sets[name])
    text = workload.dumps(workload.from_trace(merged, source=name))
    assert text == jworkload.dumps(jworkload.from_trace(merged, source=name))
    wl = workload.loads(text)
    assert workload.replay_order(wl) == jworkload.replay_order(wl)
    assert all(r["outcome"] in ("ok", "shed:capacity")
               for r in wl["requests"])
