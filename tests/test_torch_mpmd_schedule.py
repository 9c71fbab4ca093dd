"""The port's schedules (tpu_sandbox_torch/mpmd/schedule.py) through JAX's
schedule tests (tests/test_mpmd_transport.py and
tests/test_mpmd_fastfabric.py), then against JAX's module: the op lists
of ``one_f_one_b``, ``zb_h1`` and ``ops_for``, ``max_in_flight``,
``simulate_step``, ``autotune_plan`` and the published plan equal JAX's
exactly over JAX's (S, M) grid (tests/test_mpmd_fastfabric.py:64)."""

import json

import pytest

from tpu_sandbox.mpmd import schedule as jschedule
from tpu_sandbox_torch.mpmd.schedule import (
    SCHEDULE_KINDS,
    autotune_plan,
    bubble_fraction,
    fetch_plan,
    max_in_flight,
    one_f_one_b,
    ops_for,
    plan_key,
    publish_plan,
    simulate_step,
    zb_h1,
)
from torch_threads import one_torch_thread  # noqa: F401

GRID = [(2, 4), (3, 4), (3, 8), (4, 2), (4, 16)]


@pytest.fixture
def kv():
    from tpu_sandbox_torch.runtime.kvstore import KVClient, KVServer

    server = KVServer()
    client = KVClient(port=server.port)
    yield client
    client.close()
    server.stop()


# -- JAX's schedule cases on the port ------------------------------------------


@pytest.mark.parametrize("n_stages,microbatches", GRID)
def test_zb_h1_op_list_is_complete_and_ordered(n_stages, microbatches):
    for s in range(n_stages):
        ops = zb_h1(s, n_stages, microbatches)
        by_op = {}
        for op, m in ops:
            by_op.setdefault(op, []).append(m)
        for op in ("F", "B", "W"):
            assert sorted(by_op[op]) == list(range(microbatches)), (s, op)
        for m in range(microbatches):
            assert (ops.index(("F", m)) < ops.index(("B", m))
                    < ops.index(("W", m))), (s, m)


def _activation_stash_peak(ops):
    live = peak = 0
    for op, _m in ops:
        if op == "F":
            live += 1
        elif op == "B":
            live -= 1
        peak = max(peak, live)
    return peak


@pytest.mark.parametrize("n_stages,microbatches", [(2, 4), (3, 4), (3, 8),
                                                   (4, 16)])
def test_zb_h1_stash_bounds_match_1f1b(n_stages, microbatches):
    for s in range(n_stages):
        zb = zb_h1(s, n_stages, microbatches)
        fused = one_f_one_b(s, n_stages, microbatches)
        assert _activation_stash_peak(zb) == _activation_stash_peak(fused)
        warmup = min(microbatches, n_stages - 1 - s)
        assert (max_in_flight(zb) - max_in_flight(fused)) <= warmup + 1


def test_ops_for_rejects_unknown_kind():
    with pytest.raises(ValueError, match="unknown schedule kind"):
        ops_for("gpipe", 0, 2, 4)


def test_simulate_step_reproduces_analytic_1f1b_bubble():
    S, M = 3, 4
    ops = {s: one_f_one_b(s, S, M) for s in range(S)}
    costs = {s: {"F": 1.0, "B": 1.0} for s in range(S)}
    sim = simulate_step(ops, costs)
    assert sim["bubble_max"] == pytest.approx(bubble_fraction(S, M), abs=1e-9)


def test_simulate_step_zb_h1_beats_1f1b_on_split_costs():
    S, M = 3, 4
    fused = simulate_step({s: one_f_one_b(s, S, M) for s in range(S)},
                          {s: {"F": 1.0, "B": 1.0} for s in range(S)})
    split = simulate_step({s: zb_h1(s, S, M) for s in range(S)},
                          {s: {"F": 1.0, "B": 0.5, "W": 0.5}
                           for s in range(S)})
    assert split["step_seconds"] < fused["step_seconds"]
    assert split["bubble_mean"] < fused["bubble_mean"]


def test_simulate_step_detects_deadlock():
    ops = {0: [("B", 0)], 1: [("F", 0)]}
    costs = {0: {"B": 1.0}, 1: {"F": 1.0}}
    with pytest.raises(RuntimeError, match="deadlock"):
        simulate_step(ops, costs)


def test_autotune_plan_prefers_zb_and_reports_frontier():
    S = 3
    measured = {s: {"F": 0.01, "B": 0.005, "W": 0.005, "A": 0.002}
                for s in range(S)}
    plan = autotune_plan(measured, n_stages=S, measured_microbatches=4,
                         candidates=(2, 4))
    assert plan["kind"] == "zb_h1"
    assert len(plan["candidates"]) == 2 * 2
    assert all({"kind", "microbatches", "predicted_step_s",
                "predicted_bubble"} <= set(r) for r in plan["candidates"])
    best = plan["predicted"]
    assert all(best["predicted_step_s"] <= r["predicted_step_s"]
               for r in plan["candidates"])


def test_one_f_one_b_op_counts_and_order():
    S, M = 4, 8
    for s in range(S):
        ops = one_f_one_b(s, S, M)
        assert [m for op, m in ops if op == "F"] == list(range(M))
        assert [m for op, m in ops if op == "B"] == list(range(M))
        seen_f = set()
        for op, m in ops:
            if op == "F":
                seen_f.add(m)
            else:
                assert m in seen_f


def test_one_f_one_b_stash_bound():
    S = 4
    for M in (1, 2, 4, 16):
        for s in range(S):
            assert max_in_flight(one_f_one_b(s, S, M)) == min(M, S - s)


def test_one_f_one_b_validates_args():
    with pytest.raises(ValueError):
        one_f_one_b(4, 4, 2)
    with pytest.raises(ValueError):
        one_f_one_b(0, 2, 0)


def test_bubble_fraction_formula():
    assert bubble_fraction(1, 4) == 0.0
    assert bubble_fraction(4, 4) == pytest.approx(3 / 7)
    assert bubble_fraction(4, 32) < bubble_fraction(4, 4)


def test_publish_fetch_plan_roundtrip(kv):
    publish_plan(kv, n_stages=2, microbatches=4, steps=10, seed=7,
                 prefix="mpmd/pipe0", extra={"model": {"d_model": 32}})
    plan = fetch_plan(kv, prefix="mpmd/pipe0")
    assert plan["steps"] == 10 and plan["seed"] == 7
    assert plan["model"] == {"d_model": 32}
    assert plan["ops"][0] == one_f_one_b(0, 2, 4)
    assert plan["ops"][1] == one_f_one_b(1, 2, 4)
    with pytest.raises(TimeoutError):
        fetch_plan(kv, prefix="mpmd/other", timeout=0.05)


# -- against JAX's module ------------------------------------------------------


@pytest.mark.parametrize("n_stages,microbatches", GRID)
def test_op_lists_equal_jaxs(n_stages, microbatches):
    for s in range(n_stages):
        for kind in SCHEDULE_KINDS:
            ours = ops_for(kind, s, n_stages, microbatches)
            assert ours == jschedule.ops_for(kind, s, n_stages, microbatches)
            assert max_in_flight(ours) == jschedule.max_in_flight(ours)
        assert one_f_one_b(s, n_stages, microbatches) == \
            jschedule.one_f_one_b(s, n_stages, microbatches)
        assert zb_h1(s, n_stages, microbatches) == \
            jschedule.zb_h1(s, n_stages, microbatches)
    assert bubble_fraction(n_stages, microbatches) == \
        jschedule.bubble_fraction(n_stages, microbatches)


@pytest.mark.parametrize("n_stages,microbatches", GRID)
def test_simulate_and_autotune_equal_jaxs(n_stages, microbatches):
    costs = {s: {"F": 0.011 + 0.002 * s, "B": 0.007 + 0.001 * s,
                 "W": 0.006 - 0.001 * (s % 2), "A": 0.003}
             for s in range(n_stages)}
    for kind in SCHEDULE_KINDS:
        ops = {s: ops_for(kind, s, n_stages, microbatches)
               for s in range(n_stages)}
        for ship_s in (0.0, 0.002):
            assert simulate_step(ops, costs, ship_s=ship_s) == \
                jschedule.simulate_step(ops, costs, ship_s=ship_s)
    kw = dict(n_stages=n_stages, measured_microbatches=microbatches,
              candidates=(2, 4, 8, 16), ship_s=0.001)
    assert autotune_plan(costs, **kw) == jschedule.autotune_plan(costs, **kw)


def test_published_plan_is_jaxs(kv):
    """The port's plan under the same key and JSON as JAX's, and each
    package reads the other's."""
    kw = dict(n_stages=3, microbatches=4, steps=5, seed=2,
              kind="zb_h1", layer_split=[2, 1, 1],
              extra={"model": {"d_model": 32}, "batch": [8, 16]})
    publish_plan(kv, prefix="mpmd/a", **kw)
    jschedule.publish_plan(kv, prefix="mpmd/b", **kw)
    assert plan_key("mpmd/a") == jschedule.plan_key("mpmd/a")
    assert json.loads(kv.get("mpmd/a/plan")) == json.loads(
        kv.get("mpmd/b/plan"))
    assert fetch_plan(kv, prefix="mpmd/b") == jschedule.fetch_plan(
        kv, prefix="mpmd/a")
