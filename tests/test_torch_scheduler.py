"""The port's cluster scheduler (tpu_sandbox_torch/runtime/scheduler.py)
through the fast scenarios of tests/test_scheduler.py, run against both
packages (``impl``: ``jax`` is ``tpu_sandbox``, ``torch`` the port): the
durable queue API, per-job KV namespacing, gang and cogroup admission,
priority preemption, backfill, admission timeouts with namespace sweeps,
weighted fair share, the autoscaler driving the pool, and scheduler death
with adoption.

The agents are fake: small subprocesses speaking the job-namespaced
protocol the scheduler watches (heartbeat under ``agent_hb/<id>``, verdict
to ``job/done``), over the port's KV client loaded from its file (no torch,
no jax: ~0.1 s a process). Where the JAX cases wait on a sleep or on the
first of a gang's agents, these wait on KV events: every agent of a gang
has installed its SIGTERM handler before anything preempts it. Then a
``JobSpec`` written by either package is served by the other's scheduler.
"""

import importlib
import json
import os
import signal
import subprocess
import sys
import time
from types import SimpleNamespace

import pytest

from torch_threads import one_torch_thread  # noqa: F401

PY = sys.executable
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ENV = {"PYTHONPATH": ROOT}
PACKAGES = {"jax": "tpu_sandbox", "torch": "tpu_sandbox_torch"}
#: every wait on the store gives up (and fails the test) after this long
WAIT = 120.0


def _modules(pkg: str) -> SimpleNamespace:
    names = {"kvstore": "runtime.kvstore", "scheduler": "runtime.scheduler",
             "autoscale": "serve.autoscale", "replica": "serve.replica"}
    return SimpleNamespace(**{k: importlib.import_module(f"{pkg}.{m}")
                              for k, m in names.items()})


@pytest.fixture(params=sorted(PACKAGES))
def impl(request):
    return _modules(PACKAGES[request.param])


def _sched(impl, pool, **kw):
    kw.setdefault("poll", 0.02)
    kw.setdefault("verbose", False)
    return impl.scheduler.ClusterScheduler(pool, **kw)


def _spec(impl, job_id, hosts, world, argv, **kw):
    return impl.scheduler.JobSpec(job_id=job_id, hosts=hosts,
                                  world_size=world, agent_argv=argv, **kw)


def _state(impl, sched, job_id) -> bytes | None:
    return sched.kv.try_get(impl.scheduler.k_state(job_id))


# -- per-job namespacing (kvstore layer) -----------------------------------


def test_job_namespace_spelling(impl):
    job_namespace = impl.kvstore.job_namespace
    assert job_namespace("") == ""
    assert job_namespace("default") == ""  # bare-prefix default-job alias
    assert job_namespace("alpha") == "job/alpha/"
    for bad in ("a/b", "a b", "a\tb", "a\nb"):
        with pytest.raises(ValueError):
            job_namespace(bad)


def test_for_job_default_is_identity_and_jobs_are_isolated(impl):
    K = impl.kvstore
    with K.KVServer() as srv:
        kv = K.KVClient(port=srv.port)
        assert K.for_job(kv, "") is kv
        assert K.for_job(kv, "default") is kv
        a = K.for_job(kv, "a")
        b = K.for_job(kv, "b")
        assert isinstance(a, K.NamespacedKV)
        a.set("leader/term", b"3")
        b.set("leader/term", b"7")
        kv.set("leader/term", b"1")  # the default job's view
        assert a.get("leader/term") == b"3"
        assert b.get("leader/term") == b"7"
        assert kv.get("leader/term") == b"1"
        assert kv.get("job/a/leader/term") == b"3"  # where it really lives
        assert a.keys("leader/") == ["leader/term"]
        a.set("budget/restarts", b"1")
        assert a.delete_prefix("") == 2  # whole-job sweep, nobody else's
        assert kv.get("job/b/leader/term") == b"7"
        assert kv.get("leader/term") == b"1"
        with pytest.raises(ValueError, match="nest"):
            K.for_job(a, "c")
        kv.close()


def test_namespaced_add_and_barrier(impl):
    K = impl.kvstore
    with K.KVServer() as srv:
        kv = K.KVClient(port=srv.port)
        a = K.for_job(kv, "a")
        assert a.add("budget/claim/1", 1) == 1
        assert a.add("budget/claim/1", 1) == 2
        assert kv.add("budget/claim/1", 1) == 1  # default job unaffected
        a.barrier(1, key="sync")  # single-member barrier completes
        kv.close()


# -- JobSpec validation ----------------------------------------------------


def test_job_spec_validation(impl):
    JobSpec = impl.scheduler.JobSpec
    ok = dict(hosts=1, world_size=1, agent_argv=["true"])
    JobSpec(job_id="fine", **ok)
    with pytest.raises(ValueError, match="real job id"):
        JobSpec(job_id="", **ok)
    with pytest.raises(ValueError, match="real job id"):
        JobSpec(job_id="default", **ok)
    with pytest.raises(ValueError):
        JobSpec(job_id="has/slash", **ok)
    with pytest.raises(ValueError, match="hosts"):
        JobSpec(job_id="j", hosts=0, world_size=1, agent_argv=["true"])
    with pytest.raises(ValueError, match="at least one rank"):
        JobSpec(job_id="j", hosts=3, world_size=2, agent_argv=["true"])
    with pytest.raises(ValueError, match="template"):
        JobSpec(job_id="j", hosts=1, world_size=1,
                agent_argv=["run", "--x", "{unknown_placeholder}"])
    spec = JobSpec(job_id="j", hosts=2, world_size=3,
                   agent_argv=["run", "{agent_id}", "{kv_port}", "{job_id}",
                               "{num_agents}", "{world_size}"])
    assert spec.format_argv(agent_id=1, kv_port=99) == \
        ["run", "1", "99", "j", "2", "3"]
    assert JobSpec.from_json(spec.to_json()) == spec


# -- durable queue API -----------------------------------------------------


def test_submit_list_cancel_roundtrip(impl):
    S, K = impl.scheduler, impl.kvstore
    with K.KVServer() as srv:
        kv = K.KVClient(port=srv.port)
        s1 = S.submit_job(kv, S.JobSpec(job_id="a", hosts=1, world_size=1,
                                        agent_argv=["true"], priority=2))
        s2 = S.submit_job(kv, S.JobSpec(job_id="b", hosts=2, world_size=2,
                                        agent_argv=["true"]))
        assert s2 == s1 + 1
        jobs = S.list_jobs(kv)
        assert [j["job_id"] for j in jobs] == ["a", "b"]
        assert jobs[0] == {"job_id": "a", "state": "queued", "seq": s1,
                           "priority": 2, "hosts": 1, "world_size": 1,
                           "tenant": "", "share": 1.0, "cogroup": ""}
        with pytest.raises(ValueError, match="already exists"):
            S.submit_job(kv, S.JobSpec(job_id="a", hosts=1, world_size=1,
                                       agent_argv=["true"]))
        assert "submitted" in S.job_events(kv, "a")
        S.cancel_job(kv, "a")
        assert kv.try_get("sched/jobs/a/cancel") == b"1"
        kv.close()


@pytest.mark.parametrize("writer", sorted(PACKAGES))
@pytest.mark.parametrize("reader", sorted(PACKAGES))
def test_job_specs_cross_the_packages(writer, reader, agent_script):
    """A job submitted through one package's queue API is read back,
    format-ed identically and served to ``done`` by the other's
    scheduler."""
    w, r = _modules(PACKAGES[writer]), _modules(PACKAGES[reader])
    with w.kvstore.KVServer() as srv:
        kv = r.kvstore.KVClient(port=srv.port)
        spec = w.scheduler.JobSpec(
            job_id="x", hosts=2, world_size=3, priority=4, tenant="t",
            share=2.0, cogroup="g", env={"A": "1"}, admission_timeout=9.0,
            agent_argv=_agent_argv(agent_script, "work", 0.1))
        w.scheduler.submit_job(kv, spec)
        raw = kv.get(r.scheduler.k_spec("x")).decode()
        back = r.scheduler.JobSpec.from_json(raw)
        assert back.to_json() == spec.to_json()
        assert back.format_argv(agent_id=1, kv_port=7) == \
            spec.format_argv(agent_id=1, kv_port=7)
        (entry,) = r.scheduler.list_jobs(kv)
        assert entry["state"] == "queued" and entry["cogroup"] == "g"
        with r.scheduler.ClusterScheduler(2, kv_port=srv.port, poll=0.02,
                                          extra_env=ENV,
                                          verbose=False) as sched:
            assert sched.serve(timeout=WAIT) == {"x": "done"}
        assert len(kv.keys("sched/jobs/x/event/")) >= 3
        kv.close()


# -- fake agents -----------------------------------------------------------

_AGENT = """
import importlib.util, json, os, signal, sys, time
# the port's KV client from its file: no torch, no jax at startup
_spec = importlib.util.spec_from_file_location(
    "_kv", os.path.join({root!r}, "tpu_sandbox_torch", "runtime",
                        "kvstore.py"))
_kv = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_kv)
KVClient, for_job = _kv.KVClient, _kv.for_job
aid = int(sys.argv[1]); port = int(sys.argv[2]); job = sys.argv[3]
mode = sys.argv[4]; arg = float(sys.argv[5]) if len(sys.argv) > 5 else 0.0
kv = for_job(KVClient(port=port), job)
stop = []
signal.signal(signal.SIGTERM, lambda s, f: stop.append(1))
# published only after the handler is in place: tests that wait on this
# key may then SIGTERM us without racing the default (kill) disposition
kv.set(f"test/ran/{{aid}}", str(os.getpid()))

def beat():
    kv.set_ttl(f"agent_hb/{{aid}}", repr(time.time()), 5.0)

def done(ok, preempted=False):
    if aid == 0:
        kv.set("job/done", json.dumps(
            {{"ok": ok, "preempted": preempted, "reason": "fake agent",
              "summary": "", "restarts": int(kv.try_get("budget/restarts")
                                             or 0),
              "preemptions": 0, "generations": 1}}))

if mode == "work":        # heartbeat for `arg` seconds, then succeed
    t0 = time.monotonic()
    while time.monotonic() - t0 < arg and not stop:
        beat(); time.sleep(0.03)
    if stop:
        done(False, preempted=True); sys.exit(75)
    done(True); time.sleep(0.1); sys.exit(0)
elif mode == "mortal":      # first life runs long; respawned lives crash
    lives = kv.add(f"test/lives/{{aid}}", 1)
    if lives >= 2:
        sys.exit(9)
    t0 = time.monotonic()
    while time.monotonic() - t0 < 60 and not stop:
        beat(); time.sleep(0.03)
    sys.exit(75 if stop else 0)
elif mode == "preemptible":
    # first life: run until SIGTERM, checkpoint-through-preemption;
    # second life: note the resume and finish clean, uncharged.
    lives = kv.add(f"test/lives/{{aid}}", 1)
    if lives >= 2:
        kv.set("test/resumed", b"1")
        done(True); time.sleep(0.1); sys.exit(0)
    t0 = time.monotonic()
    while time.monotonic() - t0 < 60 and not stop:
        beat(); time.sleep(0.03)
    done(False, preempted=True)
    sys.exit(75)
"""


def _agent_argv(script, mode, arg=0.0):
    return [PY, str(script), "{agent_id}", "{kv_port}", "{job_id}",
            mode, str(arg)]


@pytest.fixture()
def agent_script(tmp_path):
    script = tmp_path / "fake_sched_agent.py"
    script.write_text(_AGENT.format(root=ROOT))
    return script


def _tick_until(sched, pred, timeout=WAIT):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        sched._tick()
        if pred():
            return True
        time.sleep(0.02)
    return False


def _all_up(sched, job_id, hosts):
    """Every agent of the gang has its SIGTERM handler installed."""
    return len(sched.kv.keys(f"job/{job_id}/test/ran/")) == hosts


# -- gang admission --------------------------------------------------------


def test_gang_is_all_or_nothing(impl, agent_script):
    """Pool of 3, two 2-host jobs: the second launches no agent (not even
    on the one free slot) until the first gang's slots free."""
    with _sched(impl, 3, extra_env=ENV) as sched:
        sched.submit(_spec(impl, "first", 2, 3,
                           _agent_argv(agent_script, "work", 0.5)))
        sched.submit(_spec(impl, "second", 2, 2,
                           _agent_argv(agent_script, "work", 0.1)))
        saw_partial = []
        deadline = time.monotonic() + WAIT
        while time.monotonic() < deadline:
            states = {j["job_id"]: j["state"]
                      for j in impl.scheduler.list_jobs(sched.kv)}
            second_agents = sched.kv.keys("job/second/test/ran/")
            if states.get("first") == "running" \
                    and states.get("second") == "queued" and second_agents:
                saw_partial.append(second_agents)
            if states.get("second") != "queued":
                break
            sched._tick()
            time.sleep(0.02)
        states = sched.serve(timeout=WAIT)
        assert saw_partial == [], "gang launched while still queued"
        assert states == {"first": "done", "second": "done"}, states
        ev = impl.scheduler.job_events(sched.kv, "second")
        assert ev["admitted"] >= ev["submitted"]


def test_heterogeneous_world_sizes_share_the_pool(impl, agent_script):
    with _sched(impl, 3, extra_env=ENV) as sched:
        sched.submit(_spec(impl, "train", 2, 3,
                           _agent_argv(agent_script, "work", 0.3)))
        sched.submit(_spec(impl, "bench", 1, 1,
                           _agent_argv(agent_script, "work", 0.3)))
        states = sched.serve(timeout=WAIT)
        assert states == {"train": "done", "bench": "done"}, states
        assert sched.kv.keys("job/train/") == []
        assert sched.kv.keys("job/bench/") == []


# -- MPMD co-gangs ---------------------------------------------------------


def test_cogroup_admitted_all_or_nothing(impl, agent_script):
    """Pool 3, a 2-host occupant running: a 2-member cogroup does not take
    the single free slot piecemeal; both members admit together once the
    occupant drains."""
    with _sched(impl, 3, extra_env=ENV) as sched:
        sched.submit(_spec(impl, "occupant", 2, 2,
                           _agent_argv(agent_script, "work", 0.6),
                           priority=5))
        assert _tick_until(sched, lambda: (
            _state(impl, sched, "occupant") == b"running"))
        for s in (0, 1):
            sched.submit(_spec(impl, f"stage{s}", 1, 1,
                               _agent_argv(agent_script, "work", 0.2),
                               priority=5, cogroup="pipe0"))
        for _ in range(10):
            sched._tick()
            time.sleep(0.02)
        assert _state(impl, sched, "stage0") == b"queued"
        assert _state(impl, sched, "stage1") == b"queued"
        assert sched.kv.keys("job/stage0/test/ran/") == []
        assert sched.kv.keys("job/stage1/test/ran/") == []
        states = sched.serve(timeout=WAIT)
        assert states == {"occupant": "done", "stage0": "done",
                          "stage1": "done"}, states
        a0 = impl.scheduler.job_events(sched.kv, "stage0")["admitted"]
        a1 = impl.scheduler.job_events(sched.kv, "stage1")["admitted"]
        assert abs(a0 - a1) < 0.5, (a0, a1)


def test_cogroup_preempts_room_for_whole_group(impl, agent_script):
    """A high-priority co-gang carves out its TOTAL host need: the
    occupant is preempted and both stages run. The cogroup is submitted
    only once BOTH occupant agents are up (a KV event, where the JAX case
    waits on the first, and an agent SIGTERMed before its handler is in
    place dies without a checkpoint)."""
    with _sched(impl, 2, extra_env=ENV) as sched:
        sched.submit(_spec(impl, "occupant", 2, 2,
                           _agent_argv(agent_script, "preemptible"),
                           priority=0))
        assert _tick_until(sched, lambda: (
            _state(impl, sched, "occupant") == b"running"
            and _all_up(sched, "occupant", 2)))
        for s in (0, 1):
            sched.submit(_spec(impl, f"stage{s}", 1, 1,
                               _agent_argv(agent_script, "work", 0.2),
                               priority=5, cogroup="pipe0"))
        states = sched.serve(timeout=WAIT)
        assert states == {"occupant": "done", "stage0": "done",
                          "stage1": "done"}, states
        ev = impl.scheduler.job_events(sched.kv, "occupant")
        assert "preempt_sent" in ev and "readmitted" in ev
        assert impl.scheduler.job_events(sched.kv, "stage0")["admitted"] \
            >= ev["preempt_sent"]


def test_cogroup_never_backfills_its_own_members(impl, agent_script):
    with _sched(impl, 3, extra_env=ENV) as sched:
        sched.submit(_spec(impl, "occupant", 2, 2,
                           _agent_argv(agent_script, "work", 0.6),
                           priority=5))
        assert _tick_until(sched, lambda: (
            _state(impl, sched, "occupant") == b"running"))
        sched.submit(_spec(impl, "stage0", 1, 1,
                           _agent_argv(agent_script, "work", 0.2),
                           priority=5, cogroup="pipe0"))
        sched.submit(_spec(impl, "stage1", 1, 1,
                           _agent_argv(agent_script, "work", 0.2),
                           priority=0, cogroup="pipe0"))
        for _ in range(10):
            sched._tick()
            time.sleep(0.02)
        assert _state(impl, sched, "stage1") == b"queued"
        assert "backfilled" not in impl.scheduler.job_events(sched.kv,
                                                             "stage1")
        states = sched.serve(timeout=WAIT)
        assert all(s == "done" for s in states.values()), states


# -- priority preemption ---------------------------------------------------


def test_priority_preemption_checkpoints_and_resumes(impl, agent_script):
    """Full pool, high-priority arrival: the low-priority job is SIGTERMed,
    posts a preempted (uncharged) verdict, re-queues at its original seq,
    and resumes after the high-priority job drains."""
    S = impl.scheduler
    with _sched(impl, 1, extra_env=ENV) as sched:
        low_seq = sched.submit(_spec(impl, "low", 1, 1,
                                     _agent_argv(agent_script, "preemptible"),
                                     priority=0))
        assert _tick_until(sched, lambda: (
            _state(impl, sched, "low") == b"running"
            and _all_up(sched, "low", 1)))
        sched.submit(_spec(impl, "high", 1, 1,
                           _agent_argv(agent_script, "work", 0.3),
                           priority=5))
        states = sched.serve(timeout=WAIT)
        assert states == {"low": "done", "high": "done"}, states
        jobs = {j["job_id"]: j for j in S.list_jobs(sched.kv)}
        assert jobs["low"]["seq"] == low_seq
        ev_low = S.job_events(sched.kv, "low")
        ev_high = S.job_events(sched.kv, "high")
        assert ev_low["admitted"] <= ev_low["preempt_sent"] \
            <= ev_low["preempted"] <= ev_low["readmitted"]
        assert ev_high["admitted"] >= ev_low["preempt_sent"]
        verdict = json.loads(sched.kv.get(S.k_verdict("low")))
        assert verdict["ok"] and verdict["restarts"] == 0


# -- backfill --------------------------------------------------------------


def test_backfill_runs_small_job_behind_blocked_head(impl, agent_script):
    with _sched(impl, 3, extra_env=ENV) as sched:
        sched.submit(_spec(impl, "occupant", 2, 2,
                           _agent_argv(agent_script, "work", 0.6),
                           priority=5))
        assert _tick_until(sched, lambda: (
            _state(impl, sched, "occupant") == b"running"))
        sched.submit(_spec(impl, "head", 2, 2,
                           _agent_argv(agent_script, "work", 0.2),
                           priority=5))
        sched.submit(_spec(impl, "small", 1, 1,
                           _agent_argv(agent_script, "work", 0.2),
                           priority=0))
        assert _tick_until(sched, lambda: (
            _state(impl, sched, "small") == b"running"))
        assert _state(impl, sched, "head") == b"queued"
        assert "backfilled" in impl.scheduler.job_events(sched.kv, "small")
        states = sched.serve(timeout=WAIT)
        assert states == {"occupant": "done", "head": "done",
                          "small": "done"}, states


# -- admission deadline + sweep --------------------------------------------


def test_unsatisfiable_job_times_out_with_clean_namespace(impl,
                                                           agent_script):
    with _sched(impl, 1, extra_env=ENV) as sched:
        sched.start()
        ghost = impl.kvstore.for_job(sched.kv, "huge")
        ghost.set("leader/term", b"9")
        ghost.set("budget/claim/3", b"2")
        sched.submit(_spec(impl, "huge", 4, 4,
                           _agent_argv(agent_script, "work"),
                           admission_timeout=0.3))
        states = sched.serve(timeout=WAIT)
        assert states == {"huge": "timeout"}, states
        assert sched.kv.keys(impl.kvstore.job_namespace("huge")) == []
        assert "timeout" in impl.scheduler.job_events(sched.kv, "huge")


# -- weighted fair share ---------------------------------------------------


def test_weighted_fair_share_converges_to_tenant_weights(impl,
                                                         agent_script):
    """Two equal-priority tenants on a pool of 1, shares 2:1, jobs of
    equal length submitted interleaved: at every admission the normalised
    service |served_a/2 - served_b| stays within one job of balanced. The
    jobs work 1 s, so that what the scheduler charges (admission to reap)
    is mostly that second, and a loaded machine's start-up jitter cannot
    tip the vtime order."""
    alpha = [f"a{i}" for i in range(6)]
    beta = [f"b{i}" for i in range(3)]
    with _sched(impl, 1, extra_env=ENV) as sched:
        order = [j for pair in zip(alpha, beta) for j in pair] + alpha[3:]
        for jid in order:
            tenant = "alpha" if jid.startswith("a") else "beta"
            sched.submit(_spec(impl, jid, 1, 1,
                               _agent_argv(agent_script, "work", 1.0),
                               tenant=tenant,
                               share=2.0 if tenant == "alpha" else 1.0))
        states = sched.serve(timeout=2 * WAIT)
        assert all(s == "done" for s in states.values()), states
        admitted = sorted(alpha + beta, key=lambda j: impl.scheduler
                          .job_events(sched.kv, j)["admitted"])
        na = nb = 0
        for jid in admitted:
            if jid.startswith("a"):
                na += 1
            else:
                nb += 1
            assert abs(na / 2.0 - nb / 1.0) <= 1.0, \
                f"service drifted from 2:1 weights at {admitted}"
        va, vb = sched.tenant_vtime("alpha"), sched.tenant_vtime("beta")
        assert va > 0 and vb > 0
        assert 0.4 < va / vb < 2.5, (va, vb)


# -- serve/train colocation (the autoscaler drives the scheduler) ----------


def test_autoscaler_preempts_training_and_returns_slots(impl, agent_script):
    """A queue-depth spike makes the autoscaler grow the serve gang at high
    priority, which preempts the low-priority 2-host training gang; once
    load subsides the gang shrinks newest-first and training resumes on
    the returned slots and finishes clean. Every step waits on a KV event
    (both training agents up before the first scale-up, each replica's
    agent up before it is cancelled)."""
    S, A = impl.scheduler, impl.autoscale
    with _sched(impl, 2, extra_env=ENV) as sched:
        sched.submit(_spec(impl, "train", 2, 2,
                           _agent_argv(agent_script, "preemptible"),
                           priority=0, tenant="train"))
        assert _tick_until(sched, lambda: (
            _state(impl, sched, "train") == b"running"
            and _all_up(sched, "train", 2)))
        asc = A.ReplicaAutoscaler(
            sched.kv, _agent_argv(agent_script, "work", 60.0),
            cfg=A.AutoscaleConfig(min_replicas=0, max_replicas=2,
                                  scale_up_depth=4.0, scale_down_depth=0.5,
                                  hysteresis_ticks=1, cooldown_s=0.0,
                                  priority=10))

        def report(depth):
            sched.kv.set_ttl(impl.replica.k_load("stub"),
                             json.dumps({"queue_depth": depth}), 60.0)

        report(9.0)
        up1 = asc.tick()
        assert up1 and up1["action"] == "scale_up" \
            and up1["reason"] == "queue_depth"
        rep1 = up1["job_id"]
        assert _tick_until(sched, lambda: (
            _all_up(sched, rep1, 1)
            and _state(impl, sched, "train") == b"queued"))
        up2 = asc.tick()
        assert up2 and up2["action"] == "scale_up" and up2["n_after"] == 2
        rep2 = up2["job_id"]
        assert _tick_until(sched, lambda: _all_up(sched, rep2, 1))
        assert _state(impl, sched, "train") == b"queued"
        report(0.0)
        down1 = asc.tick()
        assert down1 and down1["action"] == "scale_down" \
            and down1["job_id"] == rep2
        assert _tick_until(sched, lambda: (
            _state(impl, sched, rep2) == b"cancelled"))
        assert _state(impl, sched, "train") == b"queued"
        down2 = asc.tick()
        assert down2 and down2["action"] == "scale_down" \
            and down2["job_id"] == rep1
        states = sched.serve(timeout=WAIT)
        assert states["train"] == "done", states
        assert states[rep1] == "cancelled" and states[rep2] == "cancelled"
        verdict = json.loads(sched.kv.get(S.k_verdict("train")))
        assert verdict["ok"] and verdict["restarts"] == 0
        ev = S.job_events(sched.kv, "train")
        assert ev["admitted"] <= ev["preempt_sent"] <= ev["preempted"] \
            <= ev["readmitted"]
        actions = [(e["action"], e["job_id"])
                   for e in A.autoscale_events(sched.kv)]
        assert actions == [("scale_up", rep1), ("scale_up", rep2),
                           ("scale_down", rep2), ("scale_down", rep1)]


# -- scheduler death / adoption ----------------------------------------------


def _spawn_scheduler_proc(impl, port, pool):
    pkg = impl.scheduler.__name__.split(".")[0]
    code = (
        f"from {pkg}.runtime.scheduler import ClusterScheduler\n"
        f"ClusterScheduler({pool}, kv_port={port}, poll=0.02,\n"
        "                 verbose=False).serve(timeout=120)\n")
    return subprocess.Popen([PY, "-c", code],
                            env={**os.environ, "PYTHONPATH": ROOT})


def _wait_store(pred, what):
    deadline = time.monotonic() + WAIT
    while time.monotonic() < deadline:
        if pred():
            return
        time.sleep(0.02)
    pytest.fail(what)


@pytest.mark.parametrize("kill_order", [
    ("scheduler", "victim_agent"),
    ("victim_agent", "scheduler"),
])
def test_scheduler_death_leaves_survivor_unharmed(impl, agent_script,
                                                  kill_order):
    """Kill the scheduler process and one job's agent in both orders: the
    other job finishes clean with zero restarts charged, reaped by a
    successor scheduler that adopts what the dead one left running."""
    S, K = impl.scheduler, impl.kvstore
    with K.KVServer() as srv:
        kv = K.KVClient(port=srv.port)
        S.submit_job(kv, S.JobSpec(
            job_id="victim", hosts=1, world_size=1,
            agent_argv=_agent_argv(agent_script, "mortal")))
        S.submit_job(kv, S.JobSpec(
            job_id="survivor", hosts=1, world_size=1,
            agent_argv=_agent_argv(agent_script, "work", 2.0)))
        sched1 = _spawn_scheduler_proc(impl, srv.port, pool=2)
        try:
            _wait_store(lambda: kv.keys("job/victim/test/ran/")
                        and kv.keys("job/survivor/test/ran/"),
                        "jobs never started under the scheduler")
            victim_pid = int(kv.get("job/victim/test/ran/0"))
            for target in kill_order:
                if target == "scheduler":
                    sched1.kill()
                    sched1.wait()
                else:
                    os.kill(victim_pid, signal.SIGKILL)
                time.sleep(0.1)  # a live scheduler may respawn the victim
            _wait_store(lambda: kv.try_get("job/survivor/job/done")
                        is not None, "survivor deadlocked after the kills")
            with S.ClusterScheduler(2, kv_port=srv.port, poll=0.02,
                                    adopt_timeout=1.0, verbose=False) as s2:
                states = s2.serve(timeout=120)
            assert states["survivor"] == "done", states
            assert states["victim"] == "failed", states
            verdict = json.loads(kv.get(S.k_verdict("survivor")))
            assert verdict["ok"] and verdict["restarts"] == 0
            assert kv.keys("job/survivor/") == []
            assert kv.keys("job/victim/") == []
        finally:
            if sched1.poll() is None:
                sched1.kill()
                sched1.wait()
            kv.close()
