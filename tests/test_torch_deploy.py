"""The port's deploy plane (tpu_sandbox_torch/deploy/: the registry and
the leader-elected controller; trainer.publish_checkpoint; the replica's
swap; the client's canary shares) through the scenarios of
tests/test_deploy.py, with stub-step engines (tests/torch_serve_stub.py):
the registry round trip, versioned weights and pins, the swap mailbox
with verify-before-touch, the controller's fault matrix (corrupt and
unsealed artifacts, a controller killed between record and claim, a
canary regression rolled back with its alert, an artifact rotting after
verify, a replica killed mid-swap), the gateway's dead-fleet door and the
canary pick persisted across failover.

Then the port against JAX's package: a published artifact that one
package writes and the other's ``load_step_params`` reads, bitwise both
ways; JAX's ``DeployController`` rolling a JAX-published LM out to a port
replica; the port's ``ServeClient`` pinning submits by share with JAX's
draws for the same ``share_seed``. And JAX's slow mid-swap case
(tests/test_deploy_integration.py:141) at small width on the CPU: the
controller and the replica both killed mid-rollout, a successor and a
respawn finishing it, the orphaned requests replayed bitwise on their
pinned version (within the port).

No test waits on a timing margin: a kill is waited out on the store (the
load report and the leader lease gone).
"""

import json
import time
from pathlib import Path

import numpy as np
import pytest

from tpu_sandbox_torch.deploy.controller import (DeployConfig,
                                                 DeployController)
from tpu_sandbox_torch.deploy.registry import (audit_registry,
                                               current_target, deploy_events,
                                               k_ro, load_step_params,
                                               read_shares,
                                               registry_versions,
                                               rollout_phase)
from tpu_sandbox_torch.gateway.client import GatewayClient, RetriesExhausted
from tpu_sandbox_torch.gateway.fleet import FleetSpec
from tpu_sandbox_torch.gateway.server import Gateway
from tpu_sandbox_torch.models.transformer import TransformerConfig
from tpu_sandbox_torch.obs.health import active_subjects
from tpu_sandbox_torch.serve.cache import CacheConfig
from tpu_sandbox_torch.serve.engine import (ContinuousEngine, Request,
                                            ServeConfig)
from tpu_sandbox_torch.serve.replica import (ReplicaWorker, k_cmd, k_done,
                                             k_lease, k_load, k_pin,
                                             k_result,
                                             read_load_reports, read_result,
                                             submit_request)
from tpu_sandbox_torch.train.checkpoint import export_params, verify_step_dir
from tpu_sandbox_torch.train.trainer import publish_checkpoint
from torch_serve_stub import StubStep
from torch_threads import one_torch_thread  # noqa: F401

MCFG = TransformerConfig(vocab_size=64, d_model=32, n_heads=4, n_layers=2,
                         d_ff=64, max_len=128)
CCFG = CacheConfig(num_blocks=24, block_size=4, max_blocks_per_seq=8)
BLOCK = CCFG.block_size


def _engine(**over):
    cfg = ServeConfig(model=MCFG, cache=CCFG, max_batch=2, buckets=(8, 16),
                      **over)
    return ContinuousEngine(None, cfg, step=StubStep(), clock=time.monotonic,
                            device="cpu")


@pytest.fixture
def kv_pair():
    from tpu_sandbox_torch.runtime.kvstore import KVClient, KVServer

    server = KVServer()
    kv = KVClient(port=server.port)
    clones = []

    def clone():
        c = kv.clone()
        clones.append(c)
        return c

    yield server, kv, clone
    for c in clones:
        c.close()
    kv.close()
    server.stop()


_SENTINEL_LOADER = object()


def _worker(kv, tag, **over):
    over.setdefault("lease_ttl", 0.3)
    over.setdefault("load_interval", 0.02)
    over.setdefault("publish_ts", False)
    # stub weights for swap commands: any version loads instantly (tests
    # that want the artifact path pass swap_loader=None explicitly)
    if over.get("swap_loader", _SENTINEL_LOADER) is _SENTINEL_LOADER:
        over["swap_loader"] = lambda cmd: ("stub", int(cmd["ver"]))
    return ReplicaWorker(kv, _engine(), tag=tag, **over)


def _controller(kv, **over):
    over.setdefault("cfg", DeployConfig(swap_resend_s=0.05, canary_evals=2))
    over.setdefault("election_ttl", 1.0)
    return DeployController(kv, **over)


def _publish(kv, directory, *, step=100, params=None, **kw):
    params = params if params is not None \
        else {"w": np.arange(8, dtype=np.float32)}
    return publish_checkpoint(kv, params, export_dir=directory, step=step,
                              **kw)


def _corrupt(step_dir):
    """Flip trailing bytes of one shard: size unchanged, digest broken."""
    shard = next(Path(step_dir).glob("shard-*.npz"))
    data = shard.read_bytes()
    shard.write_bytes(data[:-4] + b"XXXX")


def _drive(until, *actors, timeout=20.0, poll=0.01):
    """Tick every actor (workers + controllers) until the condition
    holds. Single-threaded on purpose: every interleaving is explicit."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        for a in actors:
            a.tick()
        if until():
            return
        time.sleep(poll)
    raise AssertionError("drive condition not reached in time")


def _actions(kv):
    return [e["action"] for e in deploy_events(kv)]


def _wait_store(cond, limit=30.0):
    """Until the store shows ``cond`` (a TTL ran out, a key landed)."""
    deadline = time.monotonic() + limit
    while not cond():
        assert time.monotonic() < deadline, "the store never got there"
        time.sleep(0.01)


def _seed_hist(kv, proc, series, *, p99=0.0, mean=0.0):
    """One synthetic tsdb histogram point — the deterministic stand-in
    for a TimeSeriesFlusher flush (the global metrics registry is shared
    in-process, so real flushes can't separate canary from baseline)."""
    bucket = int(time.time())
    kv.set_ttl(f"obs/ts/{proc}/{series}/{bucket % 120}", json.dumps(
        {"kind": "histogram",
         "v": {"count": 1, "p50": p99, "p90": p99, "p99": p99, "mean": mean},
         "bucket": bucket, "wall": time.time()}), 60.0)


# -- registry / trainer handoff ----------------------------------------------


def test_publish_checkpoint_round_trip(kv_pair, tmp_path):
    _, kv, _ = kv_pair
    params = {"w": np.arange(6, dtype=np.float32),
              "b": np.ones((2, 3), np.float32)}
    ver = publish_checkpoint(kv, params, export_dir=tmp_path, step=42,
                             extra={"note": "gen1"})
    assert ver == 1
    rec = registry_versions(kv)[1]
    assert rec["step"] == 42 and rec["note"] == "gen1"
    assert verify_step_dir(rec["step_dir"]) == []  # sealed on disk
    got = load_step_params(rec["step_dir"], params)
    np.testing.assert_array_equal(got["w"], params["w"])
    np.testing.assert_array_equal(got["b"], params["b"])
    # publication is registration, never promotion
    assert current_target(kv) == 0
    assert _actions(kv) == ["published"]
    assert publish_checkpoint(kv, params, export_dir=tmp_path, step=43) == 2


# -- engine: versioned weights, pins, grouped decode -------------------------


def test_engine_swap_keeps_inflight_on_pinned_version():
    eng = _engine()
    eng.submit(Request(rid="a", prompt=[1, 2, 3], max_new_tokens=4))
    eng.step()  # admit "a" on the boot version
    assert eng.active_requests == 1
    eng.swap_params(("stub", 1), 1)
    eng.submit(Request(rid="b", prompt=[1, 2, 3], max_new_tokens=4))
    eng.run_until_idle()
    # both decode the same tokens; each carries the version it pinned
    assert eng.results["a"].tokens == eng.results["b"].tokens == [4, 5, 6, 7]
    assert eng.results["a"].ver == 0 and eng.results["b"].ver == 1
    assert eng.has_version(0)  # boot weights retained as rollback target


def test_engine_swap_flushes_prefix_cache():
    eng = _engine()
    eng.submit(Request(rid="r", prompt=list(range(1, 9)), max_new_tokens=2))
    eng.run_until_idle()
    assert eng.load_report()["prefix_digest"]
    assert eng.swap_params(("stub", 1), 1) >= 1
    # the resident prefix K/V was computed under the old weights: gone
    assert eng.load_report()["prefix_digest"] == []


def test_engine_stale_pin_sheds_explicitly():
    eng = _engine()
    eng.submit(Request(rid="r", prompt=[1, 2, 3], max_new_tokens=2, ver=7))
    eng.step()
    # pinned weights not resident and no loader: an explicit verdict, so
    # the client restarts a fresh lifecycle — never a silent re-pin
    assert eng.shed["r"].reason == "stale_version"
    loaded = _engine()
    loaded.loader = lambda ver: ("stub", ver) if ver == 7 else None
    loaded.submit(Request(rid="r", prompt=[1, 2, 3], max_new_tokens=2, ver=7))
    loaded.run_until_idle()
    assert loaded.results["r"].ver == 7


# -- replica: the swap mailbox ------------------------------------------------


def test_replica_swap_acks_and_is_idempotent(kv_pair):
    _, kv, clone = kv_pair
    w = _worker(clone(), "w0")
    kv.set(k_cmd("w0"), json.dumps({"action": "swap", "ver": 2}))
    w.tick()
    assert w.engine.version == 2 and w.stats.swaps == 1
    assert json.loads(kv.get(k_load("w0")))["ver"] == 2  # the ack
    # a re-sent command for the version already running is consumed, not
    # re-applied (the controller re-sends until the ack lands)
    kv.set(k_cmd("w0"), json.dumps({"action": "swap", "ver": 2}))
    w.tick()
    assert w.stats.swaps == 1 and kv.try_get(k_cmd("w0")) is None


def test_replica_swap_verifies_before_touching_engine(kv_pair, tmp_path):
    _, kv, clone = kv_pair
    w = _worker(clone(), "w0")
    step_dir = export_params(tmp_path, {"w": np.arange(4.)}, 1)
    _corrupt(step_dir)
    kv.set(k_cmd("w0"), json.dumps(
        {"action": "swap", "ver": 3, "step_dir": str(step_dir)}))
    w.tick()
    # verify-before-touch: the engine is exactly as it was, and the load
    # report carries the error the controller rolls back on
    assert w.engine.version == 0 and w.stats.swap_errors == 1
    rep = json.loads(kv.get(k_load("w0")))
    assert rep["ver"] == 0
    assert rep["swap_error"]["ver"] == 3
    assert rep["swap_error"]["error"] == "verify"
    assert rep["swap_error"]["problems"]


# -- controller: the fault matrix ---------------------------------------------


def test_corrupt_artifact_rejected_before_any_swap_command(kv_pair, tmp_path):
    _, kv, clone = kv_pair
    ver = _publish(kv, tmp_path)
    _corrupt(registry_versions(kv)[ver]["step_dir"])
    ctrl = _controller(clone())
    _drive(lambda: rollout_phase(kv, "", ver)["reject"] is not None, ctrl)
    phase = rollout_phase(kv, "", ver)
    assert phase["reject_claimed"]
    assert phase["reject"]["problems"]
    assert phase["rec"] is None  # never began
    # the hard gate: no replica was ever told about this version
    assert kv.keys("serve/cmd/") == []
    assert _actions(kv) == ["published", "rejected"]
    # rejected forever: further ticks re-decide nothing
    for _ in range(5):
        assert ctrl.tick() is None
    assert _actions(kv) == ["published", "rejected"]
    row = audit_registry(kv)["versions"][0]
    assert row["status"] == "rejected" and not row["sealed"]
    ctrl.resign()


def test_unsealed_artifact_rejected(kv_pair, tmp_path):
    _, kv, clone = kv_pair
    ver = _publish(kv, tmp_path)
    # simulate a kill inside the export commit window: manifest gone
    step_dir = Path(registry_versions(kv)[ver]["step_dir"])
    (step_dir / "MANIFEST.json").unlink()
    ctrl = _controller(clone())
    _drive(lambda: rollout_phase(kv, "", ver)["reject"] is not None, ctrl)
    assert "torn" in rollout_phase(kv, "", ver)["reject"]["problems"][0]
    assert kv.keys("serve/cmd/") == []
    ctrl.resign()


def test_single_replica_rollout_promotes_without_baseline(kv_pair, tmp_path):
    _, kv, clone = kv_pair
    w = _worker(clone(), "w0")
    ctrl = _controller(clone())
    ver = _publish(kv, tmp_path)
    _drive(lambda: current_target(kv) == ver, w, ctrl)
    assert json.loads(kv.get(k_load("w0")))["ver"] == ver
    assert _actions(kv) == ["published", "promote_begin", "canary_pass",
                            "promoted"]
    verdict = rollout_phase(kv, "", ver)["verdict"]
    assert verdict["reason"] == "no_baseline"
    assert read_shares(kv) is None  # no split ever went up for one replica
    assert audit_registry(kv)["versions"][0]["status"] == "current"
    ctrl.resign()


def test_controller_killed_between_record_and_claim_exactly_once(
        kv_pair, tmp_path):
    _, kv, clone = kv_pair
    ver = _publish(kv, tmp_path)
    step_dir = registry_versions(kv)[ver]["step_dir"]
    # the predecessor died between the rec record and its claim: the
    # record exists, the claim does not, no event was ever emitted
    kv.set(k_ro("", ver, "rec"), json.dumps(
        {"ver": ver, "step_dir": step_dir, "prev": 0, "wall": time.time()}))
    assert _actions(kv) == ["published"]
    w = _worker(clone(), "w0")
    a, b = _controller(clone(), member_id="a"), \
        _controller(clone(), member_id="b")
    _drive(lambda: current_target(kv) == ver, w, a, b)
    # two candidate controllers raced the whole rollout; the claim-once
    # phase records kept every decision single
    acts = _actions(kv)
    assert acts == ["published", "promote_begin", "canary_pass", "promoted"]
    # a fresh successor reconstructs "nothing to do" from the store alone
    a.resign()
    b.resign()
    c = _controller(clone(), member_id="c")
    for _ in range(5):
        c.tick()
    assert _actions(kv) == acts
    c.resign()


def test_canary_regression_rolls_back_and_alerts(kv_pair, tmp_path):
    _, kv, clone = kv_pair
    w0, w1 = _worker(clone(), "w0"), _worker(clone(), "w1")
    ctrl = _controller(clone())
    ver = _publish(kv, tmp_path)
    # phase 1: the canary (first tag) swaps and the traffic split goes up
    _drive(lambda: read_shares(kv) is not None, w0, w1, ctrl)
    assert json.loads(kv.get(k_load("w0")))["ver"] == ver
    assert json.loads(kv.get(k_load("w1")))["ver"] == 0
    assert read_shares(kv) == {ver: 0.25, 0: 0.75}
    # phase 2: the canary's p99 TTFT degrades 10x against the incumbent —
    # the BaselineDeltaRule fires regress_streak consecutive evaluations
    _seed_hist(kv, "w0", "engine.ttft", p99=10.0)
    _seed_hist(kv, "w1", "engine.ttft", p99=1.0)
    _drive(lambda: current_target(kv) == 0
           and rollout_phase(kv, "", ver)["done"] is not None, w0, w1, ctrl)
    phase = rollout_phase(kv, "", ver)
    assert phase["verdict"]["outcome"] == "fail"
    assert phase["verdict"]["evidence"][0]["series"] == "engine.ttft"
    assert phase["done"]["outcome"] == "rolled_back"
    # both replicas converged back; the split is gone; target never moved
    assert json.loads(kv.get(k_load("w0")))["ver"] == 0
    assert read_shares(kv) is None
    assert _actions(kv) == ["published", "promote_begin", "canary_fail",
                            "rolled_back"]
    # the regression is a first-class health alert while the TTL lasts
    assert "default" in active_subjects(kv, "canary_regression")
    assert audit_registry(kv)["versions"][0]["status"] == "rolled_back"
    ctrl.resign()


def test_artifact_rotting_after_verify_rolls_back(kv_pair, tmp_path):
    """The race the replica-side re-verify exists for: the artifact was
    sealed when the controller checked it, and rots before the replica
    loads it. The failed swap is evidence; the rollout fails closed."""
    _, kv, clone = kv_pair
    w = _worker(clone(), "w0", swap_loader=None)  # real artifact path
    ctrl = _controller(clone())
    ver = _publish(kv, tmp_path)
    _drive(lambda: "promote_begin" in _actions(kv), ctrl)
    _corrupt(registry_versions(kv)[ver]["step_dir"])
    _drive(lambda: rollout_phase(kv, "", ver)["done"] is not None, w, ctrl)
    phase = rollout_phase(kv, "", ver)
    assert phase["verdict"]["outcome"] == "fail"
    assert phase["verdict"]["evidence"][0]["swap_error"]["error"] == "verify"
    assert phase["done"]["outcome"] == "rolled_back"
    assert w.engine.version == 0 and current_target(kv) == 0
    ctrl.resign()


def test_replica_killed_mid_swap_respawns_and_replays_bitwise(
        kv_pair, tmp_path):
    _, kv, clone = kv_pair
    dead = _worker(clone(), "w0")
    ctrl = _controller(clone())
    # the replica claims a request on the boot version (pin = 0)...
    submit_request(kv, "r0", [1, 2, 3], 3)
    dead.tick()
    assert dead.stats.claimed == 1 and kv.get(k_pin("r0")) == b"0"
    # ...then a rollout starts and the swap command lands in its mailbox
    ver = _publish(kv, tmp_path)
    _drive(lambda: kv.try_get(k_cmd("w0")) is not None, ctrl)
    # SIGKILL mid-swap: the worker never ticks again. Its load report and
    # leases expire; the mailbox still holds the unconsumed command.
    _wait_store(lambda: read_load_reports(kv) == {}
                and kv.try_get(k_lease("r0")) is None)
    respawn = _worker(clone(), "w0")
    _drive(lambda: current_target(kv) == ver
           and kv.try_get(k_result("r0")) is not None,
           respawn, ctrl)
    # the respawn landed on the target version (mailbox command, then the
    # controller's re-send patience covers a consumed-but-unapplied one)
    assert respawn.engine.version == ver
    assert json.loads(kv.get(k_load("w0")))["ver"] == ver
    # the orphaned request was scavenged, re-claimed, and replayed on its
    # PINNED version — bitwise the tokens of the unfaulted run
    got = read_result(kv, "r0")
    assert got["verdict"] == "ok" and got["tokens"] == [4, 5, 6]
    assert got["ver"] == 0 and kv.get(k_pin("r0")) == b"0"
    assert respawn.stats.scavenged == 1
    # exactly-once held through the replica fault too
    assert _actions(kv) == ["published", "promote_begin", "canary_pass",
                            "promoted"]
    ctrl.resign()
    dead.engine.drain_to_requests()  # release the abandoned engine


# -- gateway door: dead-fleet fast-fail (satellite wire test) -----------------


def test_door_no_replicas_fast_fail_over_wire(kv_pair):
    _, kv, _ = kv_pair
    gw = Gateway(kv, [FleetSpec(block_size=BLOCK)],
                 refresh_min_s=0.005).start()
    try:
        with GatewayClient(gw.port, deadline_s=1.0, max_retries=0) as client:
            # zero fresh load reports + a deadline: fast-fail at the door
            # instead of letting the rid rot against a dead fleet
            assert client.submit("r0", [1, 2, 3], 2) is False
            with pytest.raises(RetriesExhausted) as ei:
                client.result("r0", timeout=10.0)
    finally:
        gw.close()
    assert ei.value.last_reason == "door:no_replicas"
    got = ei.value.verdict
    assert got["verdict"] == "SHED" and got["reason"] == "door:no_replicas"
    assert got["replica"] == "gateway"
    # same claim-once verdict slot as door:infeasible
    assert kv.get(k_done("r0")) is not None
    assert json.loads(kv.get(k_result("r0")))["reason"] == "door:no_replicas"
    assert gw.stats.shed_door == 1 and gw.stats.admitted == 0


# -- canary choice: least-loaded, pinned across ticks and failover ------------


def test_pick_canary_least_loaded_persisted_across_failover(kv_pair):
    _, kv, _ = kv_pair
    ctrl = _controller(kv)
    reports = {"a": {"queue_depth": 3, "active": 1},
               "b": {"queue_depth": 0, "active": 1},
               "c": {"queue_depth": 1, "active": 0}}
    tags = ["a", "b", "c"]
    # least queued+active work wins; the b/c tie (load 1) breaks on tag
    assert ctrl._pick_canary(7, reports, tags) == "b"
    # persisted: the choice must not flap as load shifts between ticks
    reports["b"]["queue_depth"] = 9
    assert ctrl._pick_canary(7, reports, tags) == "b"
    # a successor controller (leader failover mid-canary) swaps and
    # measures the SAME replica it inherited
    ctrl2 = _controller(kv)
    assert ctrl2._pick_canary(7, reports, tags) == "b"
    # the persisted canary died (report gone): re-chosen least-loaded
    del reports["b"]
    assert ctrl._pick_canary(7, reports, ["a", "c"]) == "c"
    assert ctrl2._pick_canary(7, reports, ["a", "c"]) == "c"
    # a different rollout seq is a fresh choice, not the inherited one
    assert ctrl._pick_canary(8, {"a": {"queue_depth": 0, "active": 0},
                                 "c": reports["c"]}, ["a", "c"]) == "a"


# -- the port against JAX's package -------------------------------------------

WIDTH = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             max_len=128)


def _jax_lm_params(seed):
    """JAX's LM at WIDTH (fp32) from ``jax.random.key(seed)``, as numpy."""
    import jax
    import jax.numpy as jnp

    from tpu_sandbox.models.transformer import TransformerConfig as JaxConfig
    from tpu_sandbox.models.transformer import TransformerLM as JaxLM

    tree = JaxLM(JaxConfig(**WIDTH, dtype=jnp.float32)).init(
        jax.random.key(seed), jnp.zeros((1, 8), jnp.int32))["params"]
    return jax.tree.map(np.asarray, tree)


def _port_lm_params(seed):
    from tpu_sandbox_torch.models.transformer import TransformerLM

    return TransformerLM(TransformerConfig(**WIDTH), seed=seed,
                         device="cpu").state_dict()


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def test_published_artifact_crosses_the_packages_bitwise(kv_pair, tmp_path):
    """An artifact JAX's publish_checkpoint writes (a Flax tree) loads
    into the port's engine weights (a state dict) through the port's
    load_step_params, and one the port writes from a state dict loads into
    JAX's Flax tree through JAX's: every leaf bitwise, both ways, and each
    registry reads the other's version record."""
    from tpu_sandbox.deploy import registry as jreg
    from tpu_sandbox.train.trainer import publish_checkpoint as jax_publish

    _, kv, _ = kv_pair
    jtree = _jax_lm_params(1)
    ver = jax_publish(kv, jtree, export_dir=tmp_path / "jax", step=5)
    template = _port_lm_params(0)
    got = load_step_params(registry_versions(kv)[ver]["step_dir"], template)
    want = _flat(jtree)
    assert sorted(got) == sorted(template) == sorted(want)
    for name, t in got.items():
        assert t.dtype == template[name].dtype
        assert t.device == template[name].device
        np.testing.assert_array_equal(t.numpy(), want[name])
    mine = _port_lm_params(2)
    ver2 = publish_checkpoint(kv, mine, export_dir=tmp_path / "port", step=6)
    assert ver2 == ver + 1
    rec = jreg.registry_versions(kv)[ver2]
    assert rec["step"] == 6
    back = _flat(jreg.load_step_params(rec["step_dir"], jtree))
    for name, t in mine.items():
        np.testing.assert_array_equal(np.asarray(back[name]), t.numpy())
    assert [r["status"] for r in jreg.audit_registry(kv)["versions"]] == \
        [r["status"] for r in audit_registry(kv)["versions"]] == \
        ["candidate", "candidate"]


def _lm_engine(params, step):
    return ContinuousEngine(params, ServeConfig(
        model=TransformerConfig(**WIDTH), cache=CCFG, max_batch=2,
        buckets=(8, 16)), step=step, device="cpu")


@pytest.fixture(scope="module")
def lm_step():
    from tpu_sandbox_torch.serve.decode import build_decode_step

    return build_decode_step(TransformerConfig(**WIDTH), CCFG, max_batch=2,
                             buckets=(8, 16))


def _reference(params, step, reqs):
    """The tokens of one uninterrupted port engine run on ``params``."""
    eng = _lm_engine(params, step)
    for rid, prompt, n in reqs:
        eng.submit(Request(rid=rid, prompt=list(prompt), max_new_tokens=n))
    eng.run_until_idle()
    return {rid: r.tokens for rid, r in eng.results.items()}


def test_jax_controller_rolls_out_to_a_port_replica(kv_pair, tmp_path,
                                                    lm_step):
    """JAX's DeployController (on a JAX client of the port's store) rolls
    a JAX-published LM out to a port replica serving the bridged boot
    weights: the replica verifies and loads the artifact through the
    port's load_step_params, acks it, and fresh traffic decodes on it, the
    tokens of a port engine built on the same weights."""
    from tpu_sandbox.deploy.controller import (DeployConfig as JaxConfig,
                                               DeployController as JaxCtrl)
    from tpu_sandbox.runtime.kvstore import KVClient as JaxKV
    from tpu_sandbox.train.trainer import publish_checkpoint as jax_publish
    from tpu_sandbox_torch.utils.bridge import params_from_flax

    server, kv, clone = kv_pair
    jkv = JaxKV(port=server.port)
    w = ReplicaWorker(clone(), _lm_engine(_port_lm_params(0), lm_step),
                      tag="w0", lease_ttl=1.0, load_interval=0.02,
                      publish_ts=False)
    ctrl = JaxCtrl(jkv, member_id="jax", election_ttl=1.0,
                   cfg=JaxConfig(swap_resend_s=0.05, canary_evals=2))
    v1 = _jax_lm_params(1)
    try:
        ver = jax_publish(jkv, v1, export_dir=tmp_path, step=3)
        _drive(lambda: current_target(kv) == ver, w, ctrl, timeout=60.0)
        assert json.loads(kv.get(k_load("w0")))["ver"] == ver
        assert w.engine.version == ver and w.stats.swaps == 1
        assert _actions(kv) == ["published", "promote_begin", "canary_pass",
                                "promoted"]
        reqs = [("f0", [9, 8, 7], 4), ("f1", [3, 1, 4, 1, 5], 3)]
        for rid, prompt, n in reqs:
            submit_request(kv, rid, prompt, n)
        _drive(lambda: all(kv.try_get(k_result(r)) is not None
                           for r, _, _ in reqs), w, timeout=60.0)
    finally:
        ctrl.resign()
        jkv.close()
    want = _reference(params_from_flax({"params": v1}), lm_step, reqs)
    for rid, _, _ in reqs:
        got = read_result(kv, rid)
        assert got["ver"] == ver and got["tokens"] == want[rid]


def test_share_pins_follow_jaxs_draws(kv_pair):
    """The port's ServeClient and JAX's, seeded alike, pin the same
    version to each submit under live canary shares (both draw with
    random.Random(share_seed) and pick_by_share), on a bare and on a
    fleet view."""
    from tpu_sandbox.runtime.kvstore import KVClient as JaxKV
    from tpu_sandbox.runtime.kvstore import NamespacedKV as JaxNamespaced
    from tpu_sandbox.serve.client import ServeClient as JaxServeClient
    from tpu_sandbox_torch.gateway.fleet import fleet_kv
    from tpu_sandbox_torch.serve.client import ServeClient

    server, kv, _ = kv_pair
    jkv = JaxKV(port=server.port)
    try:
        for fleet in ("", "chat"):
            kv.set(f"deploy/shares/{fleet or 'default'}", json.dumps(
                {"seq": 4, "shares": {"4": 0.25, "3": 0.7, "1": 0.05}}))
            pkv = fleet_kv(kv, fleet)
            jview = JaxNamespaced(jkv, f"fleet/{fleet}/") if fleet else jkv
            port_c = ServeClient(pkv, share_seed=11)
            jax_c = JaxServeClient(jview, share_seed=11)
            for i in range(40):
                port_c.submit(f"p{i}", [1, 2, 3], 2)
                jax_c.submit(f"j{i}", [1, 2, 3], 2)
            pins = [int(pkv.get(k_pin(f"p{i}"))) for i in range(40)]
            assert pins == [int(pkv.get(k_pin(f"j{i}"))) for i in range(40)]
            assert set(pins) == {1, 3, 4}
    finally:
        jkv.close()


def test_rollout_survives_controller_and_replica_kills_bitwise(
        kv_pair, tmp_path, lm_step):
    """JAX's slow mid-swap case at small width on the CPU with the port's
    LM: the replica claims three requests on the boot weights (pins 0), a
    controller begins the rollout and lands the swap command, then both
    die unreleased. A successor controller and a respawned replica finish
    it with one event per decision; the orphaned requests replay on their
    pinned version, bitwise the tokens of an uninterrupted run on it, and
    fresh traffic decodes on the promoted artifact, bitwise its own."""
    _, kv, clone = kv_pair
    v0, v1 = _port_lm_params(0), _port_lm_params(1)
    prompts = {f"r{i}": [1 + i, 2, 3, 4, 5] for i in range(3)}

    def worker():
        return ReplicaWorker(clone(), _lm_engine(_port_lm_params(0),
                                                 lm_step),
                             tag="w0", lease_ttl=0.4, load_interval=0.02,
                             publish_ts=False)

    def controller(member):
        return DeployController(clone(), member_id=member,
                                election_ttl=0.6,
                                cfg=DeployConfig(swap_resend_s=0.05))

    dead = worker()
    for rid, prompt in prompts.items():
        submit_request(kv, rid, prompt, 4)
    _drive(lambda: dead.stats.claimed == 3, dead, timeout=60.0)
    assert all(kv.get(k_pin(r)) == b"0" for r in prompts)
    ver = publish_checkpoint(kv, v1, export_dir=tmp_path, step=1)
    a = controller("a")
    _drive(lambda: kv.try_get(k_cmd("w0")) is not None, a, timeout=60.0)
    assert _actions(kv) == ["published", "promote_begin"]
    # both die: the lease, the load report and the request leases lapse
    del a
    _wait_store(lambda: read_load_reports(kv) == {}
                and kv.keys("deploy/leader/default/lease/") == []
                and all(kv.try_get(k_lease(r)) is None for r in prompts))
    respawn = worker()
    b = controller("b")
    _drive(lambda: current_target(kv) == ver
           and all(kv.try_get(k_result(r)) is not None for r in prompts),
           respawn, b, timeout=120.0)
    assert _actions(kv) == ["published", "promote_begin", "canary_pass",
                            "promoted"]
    assert respawn.engine.version == ver
    want = _reference(v0, lm_step, [(r, p, 4) for r, p in prompts.items()])
    for rid in prompts:
        got = read_result(kv, rid)
        assert got["verdict"] == "ok" and got["ver"] == 0
        assert got["tokens"] == want[rid]
    submit_request(kv, "fresh", [9, 8, 7], 4)
    _drive(lambda: kv.try_get(k_result("fresh")) is not None,
           respawn, b, timeout=60.0)
    got = read_result(kv, "fresh")
    assert got["ver"] == ver
    assert got["tokens"] == _reference(v1, lm_step,
                                       [("fresh", [9, 8, 7], 4)])["fresh"]
    b.resign()
    dead.engine.drain_to_requests()


def test_prefix_cache_holds_only_the_current_versions_kv(lm_step):
    """After a swap, a request still pinned to the old weights neither
    reuses the prefix cache (the new weights' K/V) nor adds its own blocks
    to it: the same prompt on each version decodes that version's tokens,
    in either order. (JAX's engine shares across versions: the fault this
    guards against, seen when a rollout's promoted replica answered a
    prompt with blocks a pre-swap pin had cached.)"""
    v0, v1 = _port_lm_params(0), _port_lm_params(1)
    prompt = list(range(1, 14))                  # three full blocks
    want0 = _reference(v0, lm_step, [("a", prompt, 5)])["a"]
    want1 = _reference(v1, lm_step, [("b", prompt, 5)])["b"]
    assert want0 != want1
    for order in ((0, 1), (1, 0)):
        eng = _lm_engine(v0, lm_step)
        eng.swap_params(v1, 1)
        for i, ver in enumerate(order):
            eng.submit(Request(rid=f"r{i}", prompt=prompt, max_new_tokens=5,
                               ver=ver))
            eng.run_until_idle()
        got = {eng.results[f"r{i}"].ver: eng.results[f"r{i}"].tokens
               for i in range(2)}
        assert got == {0: want0, 1: want1}, order
        # only the current version's prompt blocks stay cached
        assert len(eng.load_report()["prefix_digest"]) == 3
