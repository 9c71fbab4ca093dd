"""The port's host agents (tpu_sandbox_torch/runtime/host_agent.py)
through the fast scenarios of tests/test_host_agent.py, run against both
packages (``impl``: ``jax`` is ``tpu_sandbox.runtime``, ``torch`` the
port's copy): the rank assignment, ``RankGroup``, the agent fault mailbox,
the agent/leader state machine (agents as threads over one KV server,
ranks as ``python -c`` subprocesses: election, launch, report, resolve,
relaunch, verdict) and the ``AgentLauncher``. Then agents of the two
packages run one job together, which either package's leader drives.
"""

import importlib
import json
import os
import sys
import threading
import time
from types import SimpleNamespace

import pytest

from torch_threads import one_torch_thread  # noqa: F401

PY = sys.executable
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = {"jax": "tpu_sandbox", "torch": "tpu_sandbox_torch"}


def _modules(pkg: str) -> SimpleNamespace:
    return SimpleNamespace(**{m: importlib.import_module(f"{pkg}.runtime.{m}")
                              for m in ("host_agent", "faults", "kvstore",
                                        "supervisor")})


@pytest.fixture(params=sorted(PACKAGES))
def impl(request):
    return _modules(PACKAGES[request.param])


# -- pure helpers ----------------------------------------------------------

def test_ranks_for_agent_contiguous_blocks(impl):
    ranks_for_agent = impl.host_agent.ranks_for_agent
    assert ranks_for_agent(0, 2, 4) == [0, 1]
    assert ranks_for_agent(1, 2, 4) == [2, 3]
    assert ranks_for_agent(2, 3, 3) == [2]


def test_assign_ranks_heterogeneous(impl):
    assign_ranks = impl.host_agent.assign_ranks
    assert assign_ranks(3, 2) == [[0, 1], [2]]
    assert assign_ranks(7, 3) == [[0, 1, 2], [3, 4], [5, 6]]
    assert assign_ranks(4, 4) == [[0], [1], [2], [3]]
    for world in range(1, 12):
        for agents in range(1, world + 1):
            flat = [r for b in assign_ranks(world, agents) for r in b]
            assert flat == list(range(world))
    with pytest.raises(ValueError, match="at least one rank"):
        assign_ranks(2, 3)
    with pytest.raises(ValueError, match="num_agents"):
        assign_ranks(4, 0)


def test_schema_and_constants_match_the_jax_package():
    """The KV keys, environment name and exit code an agent speaks are the
    JAX package's, so either package's plane drives the other's ranks."""
    j, t = _modules("tpu_sandbox"), _modules("tpu_sandbox_torch")
    for name in ("ENV_AGENT_ID", "K_GENERATION", "K_JOB_DONE", "K_RESTARTS",
                 "K_PREEMPTIONS"):
        assert getattr(t.host_agent, name) == getattr(j.host_agent, name)
    for fn in ("k_launch", "k_coordinator", "k_teardown", "k_charge_claim"):
        assert getattr(t.host_agent, fn)(7) == getattr(j.host_agent, fn)(7)
    for fn in ("k_launch_ack", "k_teardown_ack", "k_report"):
        assert getattr(t.host_agent, fn)(7, 2) == \
            getattr(j.host_agent, fn)(7, 2)
    assert t.host_agent._agent_hb_key(3) == j.host_agent._agent_hb_key(3)
    assert t.host_agent.ENV_AGENT_ID == t.faults.ENV_AGENT_ID
    assert t.supervisor.PREEMPTED_EXIT_CODE == 75
    assert t.supervisor.main_argv_for_rank(["x"], 3) == \
        j.supervisor.main_argv_for_rank(["x"], 3) == ["x", "--rank", "3"]
    jcfg = j.host_agent.AgentConfig(0, 2, 2, 1)
    tcfg = t.host_agent.AgentConfig(0, 2, 2, 1)
    assert vars(jcfg) == vars(tcfg)


# -- RankGroup -------------------------------------------------------------

def test_rank_group_spawn_poll_teardown(impl):
    g = impl.supervisor.RankGroup(term_timeout=5.0)
    g.spawn([[PY, "-c", "import sys; sys.exit(3)"],
             [PY, "-c", "import sys; sys.exit(0)"]], None)
    assert len(g) == 2
    deadline = time.monotonic() + 10
    while g.running and time.monotonic() < deadline:
        time.sleep(0.02)
    assert g.poll() == [3, 0]
    assert g.teardown() == [3, 0]  # idempotent on dead groups


def test_rank_group_refuses_overlapping_spawn(impl):
    g = impl.supervisor.RankGroup(term_timeout=5.0)
    g.spawn([[PY, "-c", "import time; time.sleep(60)"]], None)
    with pytest.raises(RuntimeError, match="previous group"):
        g.spawn([[PY, "-c", "pass"]], None)
    codes = g.teardown()
    assert codes[0] is not None  # SIGTERM'd, not still running
    g.spawn([[PY, "-c", "pass"]], None)  # after teardown: allowed
    g.teardown()


# -- fault routing to the agent mailbox ------------------------------------

def test_agent_fault_posts_to_mailbox(impl):
    F = impl.faults
    with impl.kvstore.KVServer() as srv:
        kv = impl.kvstore.KVClient(port=srv.port)
        plan = F.FaultPlan([F.Fault(rank=1, step=2, action="kill_agent")])
        inj = F.FaultInjector(plan, rank=1, kv=kv, agent_id=7)
        assert inj.maybe_fire(step=1) == []
        fired = inj.maybe_fire(step=2)
        assert [f.action for f in fired] == ["kill_agent"]
        cmd = json.loads(kv.get(F.agent_cmd_key(7)))
        assert cmd == {"action": "kill_agent", "arg": None}
        # claimed globally: a relaunched rank replaying step 2 won't re-fire
        inj2 = F.FaultInjector(plan, rank=1, kv=kv, agent_id=7)
        assert inj2.maybe_fire(step=2) == []
        kv.close()


def test_agent_fault_without_agent_context_fails_loud(impl):
    F = impl.faults
    plan = F.FaultPlan([F.Fault(rank=0, step=1, action="partition_host",
                                target="2.5")])
    inj = F.FaultInjector(plan, rank=0, kv=None, agent_id=None)
    with pytest.raises(RuntimeError, match="agent-mode"):
        inj.maybe_fire(step=1)


def test_partition_duration_validated(impl):
    with pytest.raises(ValueError, match="duration"):
        impl.faults.Fault(rank=0, step=1, action="partition_host",
                          target="soon")


# -- the agent/leader state machine (threads + subprocess ranks) -----------

def _cfg(impl, aid, *, num_agents=2, world=2, port=0, **kw):
    kw.setdefault("heartbeat_interval", 0.1)
    kw.setdefault("agent_timeout", 3.0)
    kw.setdefault("grace", 20.0)
    kw.setdefault("lease_ttl", 0.8)
    kw.setdefault("poll", 0.02)
    kw.setdefault("term_timeout", 5.0)
    kw.setdefault("ack_timeout", 10.0)
    kw.setdefault("agent_wait", 20.0)
    kw.setdefault("backoff", 0.05)
    kw.setdefault("verbose", False)
    return impl.host_agent.AgentConfig(agent_id=aid, num_agents=num_agents,
                                       world_size=world, kv_port=port, **kw)


def _run_agents(impls, srv, rank_cmd, *, world=2, timeout=40.0,
                cfg_kw=None):
    """Run one HostAgent a simulated host in threads (agent ``a`` from
    ``impls[a]``'s package); return their exit codes."""
    results = {}

    def one(aid):
        m = impls[aid]
        cfg = _cfg(m, aid, num_agents=len(impls), world=world,
                   port=srv.port, **(cfg_kw or {}))
        results[aid] = m.host_agent.HostAgent(cfg, rank_cmd).run()

    threads = [threading.Thread(target=one, args=(a,))
               for a in range(len(impls))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=timeout)
    assert not any(t.is_alive() for t in threads), "agents never terminated"
    return [results[a] for a in range(len(impls))]


def test_clean_generation_reaches_ok_verdict(impl):
    H = impl.host_agent
    with impl.kvstore.KVServer() as srv:
        codes = _run_agents(
            [impl, impl], srv,
            lambda gen, rank, port: [PY, "-c", "import sys; sys.exit(0)"])
        assert codes == [0, 0]
        kv = impl.kvstore.KVClient(port=srv.port)
        verdict = json.loads(kv.get(H.K_JOB_DONE))
        assert verdict["ok"] and verdict["generations"] == 1
        assert verdict["restarts"] == 0
        kv.close()


def test_failure_charges_one_restart_then_recovers(impl):
    """Gen 1 has a crashing rank; the leader tears the world down, charges
    exactly one restart (across two agents racing to resolve), and gen 2
    completes."""
    H = impl.host_agent

    def rank_cmd(gen, rank, port):
        code = 1 if (gen == 1 and rank == 1) else 0
        return [PY, "-c", f"import sys; sys.exit({code})"]

    with impl.kvstore.KVServer() as srv:
        assert _run_agents([impl, impl], srv, rank_cmd) == [0, 0]
        kv = impl.kvstore.KVClient(port=srv.port)
        assert json.loads(kv.get(H.K_JOB_DONE))["ok"]
        assert int(kv.get(H.K_RESTARTS)) == 1
        assert int(kv.get(H.K_GENERATION)) == 2
        assert int(kv.try_get(H.K_PREEMPTIONS) or 0) == 0
        kv.close()


def test_preemption_is_not_charged_as_restart(impl):
    H = impl.host_agent
    code75 = impl.supervisor.PREEMPTED_EXIT_CODE

    def rank_cmd(gen, rank, port):
        code = code75 if (gen == 1 and rank == 0) else 0
        return [PY, "-c", f"import sys; sys.exit({code})"]

    with impl.kvstore.KVServer() as srv:
        assert _run_agents([impl, impl], srv, rank_cmd) == [0, 0]
        kv = impl.kvstore.KVClient(port=srv.port)
        assert json.loads(kv.get(H.K_JOB_DONE))["ok"]
        assert int(kv.get(H.K_PREEMPTIONS)) == 1
        assert int(kv.try_get(H.K_RESTARTS) or 0) == 0
        kv.close()


def test_restart_budget_exhaustion_fails_the_job(impl):
    H = impl.host_agent
    with impl.kvstore.KVServer() as srv:
        codes = _run_agents(
            [impl, impl], srv,
            lambda gen, rank, port: [PY, "-c", "import sys; sys.exit(1)"],
            cfg_kw={"max_restarts": 1})
        assert codes == [1, 1]
        kv = impl.kvstore.KVClient(port=srv.port)
        verdict = json.loads(kv.get(H.K_JOB_DONE))
        assert not verdict["ok"] and not verdict["preempted"]
        assert "budget" in verdict["reason"]
        assert int(kv.get(H.K_RESTARTS)) == 2  # gen1 charge + over-budget
        kv.close()


@pytest.mark.parametrize("order", ["jax_leads", "torch_leads"])
def test_agents_of_both_packages_run_one_job(order):
    """Agent 0 (the first elected) from one package, agent 1 from the
    other, one job with a crashing rank in gen 1: either package's leader
    charges one restart and relaunches, and the other package's agent
    follows its launch records."""
    j, t = _modules("tpu_sandbox"), _modules("tpu_sandbox_torch")
    impls = [j, t] if order == "jax_leads" else [t, j]

    def rank_cmd(gen, rank, port):
        code = 1 if (gen == 1 and rank == 1) else 0
        return [PY, "-c", f"import sys; sys.exit({code})"]

    with t.kvstore.KVServer() as srv:
        assert _run_agents(impls, srv, rank_cmd) == [0, 0]
        kv = t.kvstore.KVClient(port=srv.port)
        verdict = json.loads(kv.get(t.host_agent.K_JOB_DONE))
        assert verdict["ok"] and verdict["generations"] == 2
        assert verdict["restarts"] == 1
        kv.close()


# -- AgentLauncher (the scheduler stand-in) --------------------------------

_FAKE_AGENT = """
import importlib.util, json, os, sys
# the port's KV client from its file: no torch, no jax at startup
_spec = importlib.util.spec_from_file_location(
    "_kv", os.path.join({root!r}, "tpu_sandbox_torch", "runtime",
                        "kvstore.py"))
_kv = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_kv)
kv = _kv.KVClient(port=int(sys.argv[1]))
incarnation = kv.add("test/incarnation", 1)
if incarnation == 1:
    sys.exit(9)  # first life dies before any verdict
kv.set("job/done", json.dumps(
    {{"ok": True, "reason": "fake agent finished", "summary": "",
      "restarts": 0, "preemptions": 0, "generations": 1}}))
kv.close()
sys.exit(0)
"""


def test_launcher_respawns_dead_agent_until_verdict(impl, tmp_path):
    script = tmp_path / "fake_agent.py"
    script.write_text(_FAKE_AGENT.format(root=ROOT))
    with impl.kvstore.KVServer() as srv:
        launcher = impl.host_agent.AgentLauncher(
            1, lambda aid, port: [PY, str(script), str(port)],
            kv_server=srv, poll=0.05, drain_timeout=10, verbose=False,
            extra_env={"PYTHONPATH": ROOT})
        assert launcher.run() == 0
        assert launcher.respawns == 1


def test_launcher_respawn_limit_bounds_crash_loops(impl, tmp_path):
    script = tmp_path / "dying_agent.py"
    script.write_text("import sys; sys.exit(9)\n")
    with impl.kvstore.KVServer() as srv:
        launcher = impl.host_agent.AgentLauncher(
            1, lambda aid, port: [PY, str(script), str(port)],
            kv_server=srv, respawn_limit=2, poll=0.05, drain_timeout=5,
            verbose=False)
        assert launcher.run() == 1
        assert launcher.respawns == 3  # 2 allowed + the one over the limit


# -- the port's KV client under signals ----------------------------------------

_SIGNALLED_CLIENT = """
import importlib.util, os, signal, sys
_spec = importlib.util.spec_from_file_location(
    "_kv", os.path.join({root!r}, "tpu_sandbox_torch", "runtime",
                        "kvstore.py"))
_kv = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_kv)
kv = _kv.KVClient(port=int(sys.argv[1]))
seen = []
signal.signal(signal.SIGUSR1, lambda s, f: seen.append(1))

def interrupt(signum, frame):
    raise InterruptedError("handler raised")

signal.signal(signal.SIGUSR2, interrupt)
print("storm", flush=True)
for i in range(300):
    kv.set_ttl("hb", str(i), 5.0)
    kv.add("n", 1)
try:
    print("blocking", len(seen), flush=True)
    kv.get("never")
except InterruptedError:
    pass
kv.set("after", b"1")
print("done", kv.get("n").decode(), flush=True)
"""


def test_kv_round_trips_survive_signals():
    """A host agent is signalled (SIGTERM, when its job is preempted) while
    its KV client may be waiting on a response. Under a storm of signals
    whose handler returns, every request of the port's client completes
    (a signal used to fail it: ``kv X ... failed``); a handler that raises
    during a blocking get drops the connection, and the next request
    dials again."""
    import signal
    import subprocess

    t = _modules("tpu_sandbox_torch")
    with t.kvstore.KVServer() as srv:
        p = subprocess.Popen(
            [PY, "-c", _SIGNALLED_CLIENT.format(root=ROOT), str(srv.port)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        try:
            assert p.stdout.readline().strip() == "storm"
            stop = threading.Event()

            def storm():
                while not stop.is_set() and p.poll() is None:
                    p.send_signal(signal.SIGUSR1)
                    time.sleep(0.0002)

            sender = threading.Thread(target=storm)
            sender.start()
            line = p.stdout.readline().split()
            stop.set()
            sender.join(timeout=10)
            assert line[0] == "blocking" and int(line[1]) > 0, line
            time.sleep(0.2)   # into its blocking get (before it, it passes too)
            p.send_signal(signal.SIGUSR2)
            out, err = p.communicate(timeout=30)
            assert p.returncode == 0, err[-2000:]
            assert out.split() == ["done", "300"]
            kv = t.kvstore.KVClient(port=srv.port)
            assert kv.try_get("after") == b"1"
            kv.close()
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
