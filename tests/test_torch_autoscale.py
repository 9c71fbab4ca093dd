"""The port's replica autoscaler (tpu_sandbox_torch/serve/autoscale.py) and
fleets (tpu_sandbox_torch/gateway/fleet.py): the autoscaler cases of
tests/test_serve_slo.py:351-456 and the fleet checks of
tests/test_gateway.py:465-484 that need no gateway server, run against
both packages (``m``: ``jax`` is ``tpu_sandbox``, ``torch`` the port).

The compile-cache field: either package writes the directory into a
replica job's environment under JAX's key, so either autoscaler can drive
either replica (the port's replica runs eager PyTorch and ignores it).
"""

import importlib
import json
from types import SimpleNamespace

import pytest

from torch_threads import one_torch_thread  # noqa: F401

PACKAGES = {"jax": "tpu_sandbox", "torch": "tpu_sandbox_torch"}


@pytest.fixture(params=sorted(PACKAGES))
def m(request):
    pkg = PACKAGES[request.param]
    return SimpleNamespace(**{k: importlib.import_module(f"{pkg}.{mod}")
                              for k, mod in (
                                  ("kvstore", "runtime.kvstore"),
                                  ("scheduler", "runtime.scheduler"),
                                  ("autoscale", "serve.autoscale"),
                                  ("replica", "serve.replica"),
                                  ("fleet", "gateway.fleet"))})


@pytest.fixture()
def kv(m):
    server = m.kvstore.KVServer()
    client = m.kvstore.KVClient(port=server.port)
    yield client
    client.close()
    server.stop()


def _argv(m):
    pkg = m.autoscale.__name__.split(".")[0]
    return ["python", "-m", f"{pkg}.serve.replica", "--config", "{job_id}"]


def _reports(m, kv, depths, ttl=10.0):
    for tag, depth in depths.items():
        kv.set_ttl(m.replica.k_load(tag), json.dumps({"queue_depth": depth}),
                   ttl)


def test_autoscaler_bootstrap_grow_shrink(m, kv):
    A = m.autoscale
    cfg = A.AutoscaleConfig(min_replicas=1, max_replicas=2,
                            hysteresis_ticks=2, cooldown_s=0.0)
    a = A.ReplicaAutoscaler(kv, _argv(m), cfg=cfg)
    # bootstrap to the floor, no hysteresis needed
    ev = a.tick()
    assert ev and ev["action"] == "scale_up" and ev["reason"] == "min_replicas"
    assert len(a.replica_jobs()) == 1
    # sustained overload: needs hysteresis_ticks consecutive signals
    _reports(m, kv, {"w0": 10.0})
    assert a.tick() is None
    ev = a.tick()
    assert ev and ev["action"] == "scale_up" and ev["reason"] == "queue_depth"
    assert len(a.replica_jobs()) == 2
    # capped at max_replicas even under continued overload
    assert a.tick() is None and a.tick() is None
    assert len(a.replica_jobs()) == 2
    # drained queues: scale back down to the floor, never below
    _reports(m, kv, {"w0": 0.0})
    assert a.tick() is None
    ev = a.tick()
    assert ev and ev["action"] == "scale_down"
    assert kv.try_get(m.scheduler.k_cancel(ev["job_id"])) is not None
    assert [e["action"] for e in A.autoscale_events(kv)] == \
        ["scale_up", "scale_up", "scale_down"]
    for j in m.scheduler.list_jobs(kv):
        if j["state"] == "queued":
            assert j["tenant"] == "serve" and j["priority"] == cfg.priority


def test_autoscaler_only_leader_acts(m, kv):
    A = m.autoscale
    cfg = A.AutoscaleConfig(min_replicas=1, cooldown_s=0.0)
    leader = A.ReplicaAutoscaler(kv, _argv(m), cfg=cfg, member_id="m0")
    follower = A.ReplicaAutoscaler(kv, _argv(m), cfg=cfg, member_id="m1")
    assert leader.tick() is not None       # m0 wins the first election
    assert follower.tick() is None         # m1 observes, never acts
    assert len(leader.replica_jobs()) == 1


def test_autoscaler_hysteresis_resets_on_mixed_signal(m, kv):
    A = m.autoscale
    cfg = A.AutoscaleConfig(min_replicas=1, max_replicas=3,
                            hysteresis_ticks=2, cooldown_s=0.0)
    a = A.ReplicaAutoscaler(kv, _argv(m), cfg=cfg)
    a.tick()  # bootstrap
    _reports(m, kv, {"w0": 10.0})
    assert a.tick() is None
    _reports(m, kv, {"w0": 2.0})  # back inside the band: streak resets
    assert a.tick() is None
    _reports(m, kv, {"w0": 10.0})
    assert a.tick() is None    # streak restarted from zero
    ev = a.tick()
    assert ev and ev["action"] == "scale_up"


def test_autoscaler_prewarms_compile_cache(m, kv, tmp_path):
    """Scale-ups point every replica at one shared compile cache under
    JAX's key, and each event records whether the new replica finds it
    warm or cold."""
    A, S = m.autoscale, m.scheduler
    cache = tmp_path / "xla-cache"
    cfg = A.AutoscaleConfig(min_replicas=1, max_replicas=2,
                            hysteresis_ticks=1, cooldown_s=0.0,
                            compile_cache_dir=str(cache))
    a = A.ReplicaAutoscaler(kv, _argv(m), cfg=cfg)
    ev = a.tick()  # bootstrap replica: nothing cached yet
    assert ev and ev["compile_cache"] == "cold"
    spec = S.JobSpec.from_json(kv.try_get(S.k_spec(ev["job_id"])).decode())
    assert spec.env["JAX_COMPILATION_CACHE_DIR"] == str(cache)
    (cache / "xla_dump").write_bytes(b"cached executable")
    _reports(m, kv, {"w0": 10.0})
    ev = a.tick()  # load-driven scale-up reacts to a WARM cache
    assert ev and ev["action"] == "scale_up"
    assert ev["compile_cache"] == "warm"
    spec = S.JobSpec.from_json(kv.try_get(S.k_spec(ev["job_id"])).decode())
    assert spec.env["JAX_COMPILATION_CACHE_DIR"] == str(cache)
    assert A.ReplicaAutoscaler(
        kv, _argv(m), cfg=A.AutoscaleConfig(), member_id="m9",
    ).compile_cache_state() == "disabled"


def test_fleet_namespace_and_spec_validation(m, kv):
    F = m.fleet
    assert F.fleet_namespace("") == ""
    assert F.fleet_namespace("chat") == "fleet/chat/"
    for bad in ("a/b", "a b", "a\tb", "a\nb"):
        with pytest.raises(ValueError):
            F.fleet_namespace(bad)
    assert F.fleet_kv(kv, "") is kv
    with pytest.raises(ValueError, match="nest"):
        F.fleet_kv(F.fleet_kv(kv, "a"), "b")
    with pytest.raises(ValueError):
        F.FleetSpec(name="a/b")
    specs = F.FleetSpec(name="chat", share=2.0, priority=1,
                        replica_args=["--config", "cfg.json"]
                        ).replica_job_specs(replicas=2, base_priority=10)
    assert [s.job_id for s in specs] == ["serve-chat-0", "serve-chat-1"]
    assert all(s.tenant == "fleet-chat" and s.share == 2.0 and
               s.priority == 11 and
               s.env["TPU_SANDBOX_FLEET"] == "chat" for s in specs)
    pkg = m.fleet.__name__.split(".")[0]
    assert specs[0].agent_argv[:3] == ["python", "-m", f"{pkg}.serve.replica"]
    # a fleet view writes every serve key under fleet/<name>/
    chat = F.fleet_kv(kv, "chat")
    m.replica.submit_request(chat, "r0", [1, 2, 3], 2)
    assert kv.try_get("fleet/chat/serve/req/r0") is not None
    assert kv.try_get("serve/req/r0") is None


def test_fleet_specs_match_across_the_packages():
    """The fleet's replica jobs are JAX's, but for the module each job's
    agent runs."""
    jf = importlib.import_module("tpu_sandbox.gateway.fleet")
    tf = importlib.import_module("tpu_sandbox_torch.gateway.fleet")
    kw = dict(name="chat", share=2.0, priority=1, replica_args=["--x", "1"])
    js = jf.FleetSpec(**kw).replica_job_specs(replicas=2, base_priority=3)
    ts = tf.FleetSpec(**kw).replica_job_specs(replicas=2, base_priority=3)
    for a, b in zip(js, ts):
        da, db = json.loads(a.to_json()), json.loads(b.to_json())
        assert da.pop("agent_argv")[3:] == db.pop("agent_argv")[3:]
        assert da == db
    assert tf.DEFAULT_FLEET == jf.DEFAULT_FLEET == ""
