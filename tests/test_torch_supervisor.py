"""The port's copies of the jax-free elastic plane (runtime/{kvstore,
watchdog,faults,supervisor}.py, obs/record.py) through the scenarios of
tests/test_{supervisor,faults,watchdog,kv_retry}.py.

Each scenario is written once. The in-process ones (KV store, heartbeats
and watchdog, fault plans and claims) run against both packages'
modules (``impl``: ``jax`` is ``tpu_sandbox.runtime``, ``torch`` the
port's copy over its own C++ build) and must come out the same. The
supervisor's run its workers as ``python -c`` scripts that import the
port's package. The sanitizers run on tensors.
"""

import importlib
import os
import signal
import sys
import textwrap
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from tpu_sandbox_torch.runtime import supervisor as tsup
from tpu_sandbox_torch.runtime.kvstore import KVClient, KVServer
from tpu_sandbox_torch.runtime.watchdog import (
    NonFiniteError,
    assert_finite,
    guarded_step,
)
from torch_threads import one_torch_thread  # noqa: F401

ROOT = str(Path(__file__).resolve().parent.parent)
EXTRA_ENV = {"PYTHONPATH": ROOT + os.pathsep + os.environ.get("PYTHONPATH",
                                                              "")}
PACKAGES = {"jax": "tpu_sandbox", "torch": "tpu_sandbox_torch"}


@pytest.fixture(params=sorted(PACKAGES))
def impl(request):
    """One package's runtime modules: kvstore, watchdog, faults."""
    pkg = PACKAGES[request.param]
    mods = {m: importlib.import_module(f"{pkg}.runtime.{m}")
            for m in ("kvstore", "watchdog", "faults", "bootstrap")}
    return SimpleNamespace(**mods)


# -- constants shared across the packages and layers -------------------------

def test_constants_mirror_the_jax_package_and_the_trainer():
    """supervisor.py and trainer.py do not import each other, and the
    port's elastic plane must speak the JAX package's environment names,
    KV keys and exit code, so that either supervisor can drive the other's
    ranks."""
    from tpu_sandbox.runtime import faults as jfaults
    from tpu_sandbox.runtime import supervisor as jsup
    from tpu_sandbox.train import trainer as jtrainer
    from tpu_sandbox_torch.runtime import faults
    from tpu_sandbox_torch.train import trainer

    assert trainer.PREEMPTED_EXIT_CODE == tsup.PREEMPTED_EXIT_CODE == 75
    assert trainer.PREEMPT_KEY == tsup.PREEMPT_KEY == jsup.PREEMPT_KEY
    for name in ("ENV_KV_PORT", "ENV_GENERATION", "PREEMPTED_EXIT_CODE"):
        assert getattr(tsup, name) == getattr(jsup, name), name
    for name in ("ENV_GENERATION", "ENV_AGENT_ID", "ENV_JOB_ID"):
        assert getattr(trainer, name) == getattr(jtrainer, name), name
    assert faults.ENV_PLAN == jfaults.ENV_PLAN == "TPU_SANDBOX_FAULT_PLAN"
    assert faults.ACTIONS == jfaults.ACTIONS
    assert faults.agent_cmd_key(3) == jfaults.agent_cmd_key(3)


# -- the supervisor ----------------------------------------------------------

def _worker(body: str) -> list[str]:
    return [sys.executable, "-c", textwrap.dedent(body)]


def _exit_with(code: int) -> list[str]:
    return _worker(f"import sys; sys.exit({code})")


def _beating_worker(rank: int, body: str) -> list[str]:
    return _worker(f"""
        import os, sys, time
        from tpu_sandbox_torch.runtime.kvstore import KVClient
        from tpu_sandbox_torch.runtime.watchdog import Heartbeat
        kv = KVClient(port=int(os.environ["TPU_SANDBOX_KV_PORT"]))
        hb = Heartbeat(kv, {rank}, interval=0.05).start()
        {body}
    """)


def _sup(world, build, **kw):
    kw = {"backoff": 0.05, "poll": 0.02, "verbose": False,
          "extra_env": EXTRA_ENV, **kw}
    return tsup.Supervisor(world, build, **kw)


def _clean():
    result = _sup(2, lambda g, p: [_exit_with(0), _exit_with(0)]).run()
    assert result.ok
    assert result.restarts_charged == 0 and result.preemptions == 0
    assert [g.outcome for g in result.generations] == ["ok"]


def _crash():
    """Rank 1 dies; the survivor is torn down, one restart is charged."""
    def build(gen, port):
        if gen == 1:
            return [_worker("import time; time.sleep(30)"), _exit_with(1)]
        return [_exit_with(0), _exit_with(0)]

    result = _sup(2, build, term_timeout=5.0).run()
    assert result.ok and result.restarts_charged == 1
    assert [g.outcome for g in result.generations] == ["failure", "ok"]
    assert result.generations[0].culprits == [1]
    assert result.generations[0].exit_codes[1] == 1


def _budget():
    with pytest.raises(tsup.RestartBudgetExceeded, match="restart budget") \
            as exc:
        _sup(1, lambda g, p: [_exit_with(3)], max_restarts=1).run()
    res = exc.value.result
    assert len(res.generations) == 2 and res.restarts_charged == 2
    assert all(g.outcome == "failure" for g in res.generations)


def _preemption():
    """Exit 75 restarts for free: max_restarts=0 would raise on a charge."""
    def build(gen, port):
        code = tsup.PREEMPTED_EXIT_CODE if gen == 1 else 0
        return [_exit_with(code), _exit_with(code)]

    result = _sup(2, build, max_restarts=0).run()
    assert result.ok
    assert result.preemptions == 1 and result.restarts_charged == 0
    assert [g.outcome for g in result.generations] == ["preemption", "ok"]


def _initiator_only():
    """The peer killed by the teardown does not turn a preemption into a
    charged failure."""
    def build(gen, port):
        if gen == 1:
            return [_exit_with(tsup.PREEMPTED_EXIT_CODE),
                    _worker("import time\ntime.sleep(60)")]
        return [_exit_with(0), _exit_with(0)]

    result = _sup(2, build, max_restarts=0, term_timeout=5.0).run()
    assert result.ok and result.preemptions == 1
    assert result.generations[0].culprits == [0]


def _wedged():
    """A rank that stops beating but never exits: only the watchdog sees
    it."""
    def build(gen, port):
        if gen == 1:
            return [_beating_worker(0, "hb.stop(); time.sleep(60)")]
        return [_exit_with(0)]

    result = _sup(1, build, heartbeat_timeout=0.6, grace=10.0, poll=0.05,
                  term_timeout=5.0).run()
    assert result.ok and result.restarts_charged == 1
    assert [g.outcome for g in result.generations] == ["wedged", "ok"]


def _health_reset():
    """A new generation inherits no frozen heartbeat, rendezvous counter or
    preemption flag."""
    with KVServer() as srv:
        kv = KVClient(port=srv.port)
        kv.set("hb/0", b"123.0")
        kv.set("rendezvous/gen/0", b"1")
        kv.set(tsup.PREEMPT_KEY, b"1")
        result = _sup(1, lambda g, p: [_exit_with(0)], kv_server=srv,
                      heartbeat_timeout=0.5, grace=5.0).run()
        assert result.ok
        assert kv.try_get(tsup.PREEMPT_KEY) is None
        assert kv.try_get("rendezvous/gen/0") is None
        kv.close()


def _worker_env():
    probe = _worker("""
        import os, sys
        from tpu_sandbox_torch.runtime.kvstore import KVClient
        kv = KVClient(port=int(os.environ["TPU_SANDBOX_KV_PORT"]))
        kv.set("probe/gen", os.environ["TPU_SANDBOX_GENERATION"].encode())
    """)
    with KVServer() as srv:
        assert _sup(1, lambda g, p: [probe], kv_server=srv).run().ok
        kv = KVClient(port=srv.port)
        assert kv.try_get("probe/gen") == b"1"
        kv.close()


SUPERVISOR = {"clean": _clean, "crash": _crash, "budget": _budget,
              "preemption": _preemption, "initiator_only": _initiator_only,
              "wedged": _wedged, "health_reset": _health_reset,
              "worker_env": _worker_env}


@pytest.mark.parametrize("scenario", sorted(SUPERVISOR))
def test_supervisor(scenario):
    SUPERVISOR[scenario]()


def test_rank_group_teardown_escalates_to_sigkill(tmp_path):
    """A rank that ignores SIGTERM is killed after ``term_timeout``."""
    armed = tmp_path / "armed"
    group = tsup.RankGroup(term_timeout=0.5)
    group.spawn([_worker(f"""
        import signal, time
        signal.signal(signal.SIGTERM, signal.SIG_IGN)
        open({str(armed)!r}, "w").close()
        time.sleep(60)
    """)])
    deadline = time.monotonic() + 30.0
    while not armed.exists() and time.monotonic() < deadline:
        time.sleep(0.02)
    assert armed.exists()
    t0 = time.monotonic()
    assert group.teardown() == [-signal.SIGKILL]
    assert time.monotonic() - t0 < 5.0


# -- the KV store ------------------------------------------------------------

def _kv_basic(impl):
    with impl.kvstore.KVServer() as srv:
        c = impl.kvstore.KVClient(port=srv.port)
        assert c.try_get("nope") is None
        c.set("yes", b"v")
        assert c.try_get("yes") == b"v"
        assert c.add("n", 2) == 2 and c.add("n", 3) == 5
        for k in ("ckpt/g1/5/shard_done/0", "ckpt/g1/5/shard_done/1",
                  "ckpt/g2/5/shard_done/0"):
            c.set(k, b"1")
        assert c.keys("ckpt/g1/") == ["ckpt/g1/5/shard_done/0",
                                      "ckpt/g1/5/shard_done/1"]
        assert c.delete_prefix("ckpt/g1/") == 2
        assert c.keys("ckpt/") == ["ckpt/g2/5/shard_done/0"]
        with pytest.raises(ValueError):
            c.delete_prefix("")
        c.close()


def _kv_ttl(impl):
    with impl.kvstore.KVServer() as srv:
        kv = impl.kvstore.KVClient(port=srv.port)
        kv.set_ttl("claim/a", b"x", ttl=0.2)
        kv.set_ttl("claim/b", b"y", ttl=0.2)
        kv.set("claim/b", b"y2")           # plain set: the TTL is dropped
        time.sleep(0.35)
        assert kv.try_get("claim/a") is None
        assert kv.keys("claim/") == ["claim/b"]
        with pytest.raises(ValueError):
            kv.set_ttl("claim/c", b"z", ttl=0)
        kv.close()


def _kv_backoff(impl):
    delays = list(impl.kvstore._backoff_delays(0.2, base=0.02, cap=10.0))
    assert delays and all(d > 0 for d in delays)
    for i, d in enumerate(delays[:5]):
        envelope = 0.02 * 2 ** i
        assert 0.5 * envelope <= d < 1.5 * envelope or d <= envelope
    assert list(impl.kvstore._backoff_delays(0.0)) == []


def _kv_connect_retry(impl):
    port = int(impl.bootstrap.find_free_port())
    box = {}

    def late():
        time.sleep(0.4)
        box["srv"] = impl.kvstore.KVServer(port=port)

    t = threading.Thread(target=late)
    t.start()
    try:
        c = impl.kvstore.KVClient(port=port, connect_timeout=10.0)
        c.set("k", b"v")
        assert c.try_get("k") == b"v"
        c.close()
    finally:
        t.join()
        box["srv"].stop()
    t0 = time.monotonic()
    with pytest.raises(ConnectionError, match="retried"):
        impl.kvstore.KVClient(port=int(impl.bootstrap.find_free_port()),
                              connect_timeout=0.4)
    assert time.monotonic() - t0 < 5.0


def _kv_server_death(impl):
    """Reads redial a restarted server; writes fail loud on a dead one."""
    port = int(impl.bootstrap.find_free_port())
    first = impl.kvstore.KVServer(port=port)
    kv = impl.kvstore.KVClient(port=port, connect_timeout=2.0)
    kv.set("elastic/generation", b"3")
    first.stop()
    second = impl.kvstore.KVServer(port=port)
    try:
        c = impl.kvstore.KVClient(port=port)
        c.set("elastic/generation", b"4")
        c.close()
        deadline = time.monotonic() + 10.0
        got = kv.try_get("elastic/generation")
        while got != b"4" and time.monotonic() < deadline:
            time.sleep(0.05)
            got = kv.try_get("elastic/generation")
        assert got == b"4"
    finally:
        second.stop()
    with pytest.raises(RuntimeError):
        for _ in range(3):
            kv.add("budget/claim/1", 1)
            time.sleep(0.05)
    kv.close()


def _kv_namespace(impl):
    with impl.kvstore.KVServer() as srv:
        raw = impl.kvstore.KVClient(port=srv.port)
        assert impl.kvstore.for_job(raw, "") is raw
        job = impl.kvstore.for_job(raw, "a")
        job.set("hb/0", b"1")
        assert raw.keys() == ["job/a/hb/0"] and job.keys() == ["hb/0"]
        with pytest.raises(ValueError):
            impl.kvstore.for_job(raw, "a/b")
        raw.close()


# -- heartbeats, the watchdog and the rendezvous ---------------------------------

def _hb_watchdog(impl):
    w = impl.watchdog
    with impl.kvstore.KVServer() as srv:
        c = lambda: impl.kvstore.KVClient(port=srv.port)  # noqa: E731
        hb0 = w.Heartbeat(c(), 0, interval=0.05).start()
        hb1 = w.Heartbeat(c(), 1, interval=0.05).start()
        wd = w.Watchdog(c(), world_size=2, timeout=0.3)
        wd.assert_all_alive()
        hb1.stop()
        wd.check()
        time.sleep(0.5)
        assert wd.dead_ranks() == [1]
        with pytest.raises(w.DeadRankError, match=r"\[1\]"):
            wd.assert_all_alive()
        assert wd.check()[1].age > 0.3
        hb0.stop(deregister=True)
        late = w.Watchdog(c(), world_size=1, timeout=5.0, grace=0.2)
        time.sleep(0.3)
        assert late.dead_ranks() == [0]     # never appeared, grace spent
        hb = w.Heartbeat(c(), 0, interval=0.05).start()
        assert late.dead_ranks() == []      # a late joiner is alive again
        hb.stop(deregister=True)


def _rendezvous(impl):
    w = impl.watchdog
    with impl.kvstore.KVServer() as srv:
        clients = [impl.kvstore.KVClient(port=srv.port) for _ in range(2)]
        ts = [threading.Thread(target=w.wait_for_world,
                               args=(clients[r], 2, r),
                               kwargs={"timeout": 5.0}) for r in range(2)]
        [t.start() for t in ts]
        [t.join(timeout=10) for t in ts]
        # the next generation is not satisfied by this round's keys
        with pytest.raises(w.RendezvousTimeout, match=r"missing ranks: \[1\]"):
            w.wait_for_world(clients[0], 2, 0, timeout=0.3)
        for c in clients:
            c.close()


# -- fault plans and claims ----------------------------------------------------

def _fault_plan(impl, tmp_path):
    f = impl.faults
    with pytest.raises(ValueError, match="unknown fault action"):
        f.Fault(0, 1, "explode")
    with pytest.raises(ValueError, match="needs target"):
        f.Fault(0, 1, "corrupt_shard")
    plan = (f.FaultPlan().add(1, 7, "kill").add(0, 4, "sigterm")
            .add(0, 9, "corrupt_ckpt", target="/tmp/ck"))
    assert f.FaultPlan.from_json(plan.to_json()).faults == plan.faults
    assert f.FaultPlan.from_env(plan.to_env({})).faults == plan.faults
    assert f.FaultPlan.from_env({}).faults == []


def _fault_claims(impl, tmp_path):
    """A fault fires on its rank and step only, once across injectors that
    share the store, and commit-window faults only from the commit hook."""
    f = impl.faults
    plan = (f.FaultPlan().add(0, 5, "kill_during_commit")
            .add(0, 5, "hang_heartbeat"))
    fired = []
    with impl.kvstore.KVServer() as srv:
        kv = impl.kvstore.KVClient(port=srv.port)
        other = f.FaultInjector(plan, 1, kv)
        assert other.maybe_fire(5) == []
        inj = f.FaultInjector(plan, 0, kv,
                              on_hang_heartbeat=lambda: fired.append(1))
        assert inj.maybe_fire(4) == []
        assert [x.action for x in inj.maybe_fire(5)] == ["hang_heartbeat"]
        replay = f.FaultInjector(plan, 0, kv,
                                 on_hang_heartbeat=lambda: fired.append(2))
        assert replay.maybe_fire(5) == []    # claimed in the store
        assert replay.maybe_fire_commit(4) == []
        assert kv.add("fault/0/claimed", 1) == 1
        assert replay.maybe_fire_commit(5) == []
        assert fired == [1]
        kv.close()


def _fault_sigterm(impl, tmp_path):
    got = []
    prev = signal.signal(signal.SIGTERM, lambda s, fr: got.append(s))
    try:
        impl.faults.FaultInjector(
            impl.faults.FaultPlan().add(0, 1, "sigterm"), 0).maybe_fire(1)
        assert got == [signal.SIGTERM]
    finally:
        signal.signal(signal.SIGTERM, prev)


def _fault_corruptors(impl, tmp_path):
    f = impl.faults

    def sealed(step):
        sd = tmp_path / f"step-{step:08d}"
        sd.mkdir()
        for r in range(2):
            (sd / f"shard-{r:05d}.npz").write_bytes(b"shard%d" % r)
        (sd / "MANIFEST.json").write_text("{}")
        return sd

    old, new = sealed(3), sealed(9)
    torn = tmp_path / "step-00000012"
    torn.mkdir()
    assert f.corrupt_latest_shard(tmp_path, rank=1) == new / "shard-00001.npz"
    assert (new / "shard-00000.npz").read_bytes() == b"shard0"
    assert (old / "shard-00001.npz").read_bytes() == b"shard1"
    assert f.corrupt_latest_step(tmp_path) == new
    npz = tmp_path / "npz"
    npz.mkdir()
    (npz / "step-2.npz").write_bytes(b"aaaa")
    (npz / "step-10.npz").write_bytes(b"bbbb")
    assert f.corrupt_latest_step(npz) == npz / "step-10.npz"
    assert (npz / "step-2.npz").read_bytes() == b"aaaa"


def _fault_announced(impl, tmp_path, monkeypatch):
    """Each fault is announced through the recorder, which stays off until
    TPU_SANDBOX_TRACE_DIR is set."""
    pkg = PACKAGES["torch" if impl.faults.__name__.startswith(
        "tpu_sandbox_torch") else "jax"]
    record = importlib.import_module(f"{pkg}.obs.record")
    record.reset_recorder()
    assert not record.get_recorder().enabled
    monkeypatch.setenv("TPU_SANDBOX_TRACE_DIR", str(tmp_path / "trace"))
    record.reset_recorder()
    try:
        impl.faults.FaultInjector(
            impl.faults.FaultPlan().add(2, 3, "hang_heartbeat"), 2
        ).maybe_fire(3)
        record.get_recorder().flush()
        (log,) = (tmp_path / "trace").glob("*.jsonl")
        assert '"name": "fault:hang_heartbeat"' in log.read_text()
    finally:
        monkeypatch.delenv("TPU_SANDBOX_TRACE_DIR")
        record.reset_recorder()


PLANE = {"kv_basic": _kv_basic, "kv_ttl": _kv_ttl, "kv_backoff": _kv_backoff,
         "kv_connect_retry": _kv_connect_retry,
         "kv_server_death": _kv_server_death, "kv_namespace": _kv_namespace,
         "heartbeat_watchdog": _hb_watchdog, "rendezvous": _rendezvous}
FAULTS = {"plan": _fault_plan, "claims": _fault_claims,
          "sigterm": _fault_sigterm, "corruptors": _fault_corruptors}


@pytest.mark.parametrize("scenario", sorted(PLANE))
def test_plane(impl, scenario):
    PLANE[scenario](impl)


@pytest.mark.parametrize("scenario", sorted(FAULTS))
def test_faults(impl, scenario, tmp_path):
    FAULTS[scenario](impl, tmp_path)


def test_fault_announced_through_the_recorder(impl, tmp_path, monkeypatch):
    _fault_announced(impl, tmp_path, monkeypatch)


# -- the sanitizers on tensors -------------------------------------------------

def test_assert_finite_names_bad_leaves():
    assert_finite({"a": torch.ones(3), "b": {"c": torch.zeros(2)}}, "good")
    with pytest.raises(NonFiniteError, match="b/c"):
        assert_finite({"a": torch.ones(3),
                       "b": {"c": torch.tensor([1.0, float("nan")])}})
    with pytest.raises(NonFiniteError, match="p"):
        assert_finite({"p": torch.tensor([1.0, float("inf")],
                                         dtype=torch.bfloat16)})
    assert_finite({"p": torch.ones(3, dtype=torch.bfloat16),
                   "i": torch.arange(3), "n": np.ones(2)}, "good16")
    lin = torch.nn.Linear(2, 2)
    with torch.no_grad():
        lin.weight[0, 0] = float("nan")
    with pytest.raises(NonFiniteError, match="weight"):
        assert_finite(lin, "module")


def test_guarded_step_catches_blowup():
    state = {"w": torch.zeros(2)}

    def step(x):
        state["w"] = state["w"] + x
        return state["w"].sum()

    g = guarded_step(step, state)
    assert float(g(torch.ones(2))) == 2.0
    with pytest.raises(NonFiniteError, match="step 1") as exc:
        g(torch.tensor([float("inf"), 0.0]))
    assert exc.value.bad_paths == ["w (1/2 non-finite)"]
