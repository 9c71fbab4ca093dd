"""The port's request plane (tpu_sandbox_torch/serve/replica.py and
client.py) on the port's KV store, one server a module, each test in its
own namespace of it:

- drain and scavenge with the small LM (tests/test_serve.py:321-384), and
  a sampled request interrupted mid-decode (:387), replaying bitwise;
- the stub-step verdict, load-report, shed-storm, retry, retries-exhausted
  and hedging cases of tests/test_serve_slo.py:181-350;
- the refusals: a ``swap`` command, ``--fleet``, live canary shares;
- one ``python -m tpu_sandbox_torch.serve.replica --force-cpu`` process
  answering 4 requests through the store with JAX's greedy tokens, from
  JAX's weights through the bridge, and the replica refusing to start
  without a card unless asked for the CPU.

No test waits on a timing margin: leases are waited out on the store,
processes by their exit.
"""

import itertools
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_sandbox.models.transformer import TransformerConfig as JaxConfig
from tpu_sandbox.models.transformer import TransformerLM as JaxLM
from tpu_sandbox.serve import CacheConfig as JaxCacheConfig
from tpu_sandbox.serve import ContinuousEngine as JaxContinuous
from tpu_sandbox.serve import Request as JaxRequest
from tpu_sandbox.serve import ServeConfig as JaxServeConfig
from tpu_sandbox_torch.models.transformer import TransformerConfig
from tpu_sandbox_torch.runtime.faults import serve_cmd_key
from tpu_sandbox_torch.runtime.kvstore import KVClient, KVServer, NamespacedKV
from tpu_sandbox_torch.runtime.supervisor import ENV_KV_PORT
from tpu_sandbox_torch.serve import (CacheConfig, ContinuousEngine, Request,
                                     ServeConfig)
from tpu_sandbox_torch.serve import replica as R
from tpu_sandbox_torch.serve.client import (RetriesExhausted, ServeClient,
                                            k_shares)
from tpu_sandbox_torch.serve.decode import build_decode_step
from tpu_sandbox_torch.utils.bridge import params_from_flax
from torch_serve_stub import StubStep
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
WIDTH = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             max_len=128)
MCFG = TransformerConfig(**WIDTH)
CCFG = CacheConfig(num_blocks=24, block_size=4, max_blocks_per_seq=8)
_names = itertools.count()


@pytest.fixture(scope="module")
def server():
    srv = KVServer()
    client = KVClient(port=srv.port)
    yield srv, client
    client.close()
    srv.stop()


@pytest.fixture
def kv(server):
    """A namespace of the module's store of this test's own."""
    return NamespacedKV(server[1], f"t{next(_names)}/")


@pytest.fixture(scope="module")
def jax_params():
    return JaxLM(JaxConfig(**WIDTH, dtype=jnp.float32)).init(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]


@pytest.fixture(scope="module")
def params(jax_params):
    return params_from_flax({"params": jax.tree.map(np.asarray, jax_params)})


@pytest.fixture(scope="module")
def step():
    return build_decode_step(MCFG, CCFG, max_batch=3, buckets=(8, 16))


def _scfg():
    return ServeConfig(model=MCFG, cache=CCFG, max_batch=3, buckets=(8, 16))


def _requests(rng, n):
    return [(f"r{i}", [int(t) for t in rng.integers(
        1, 64, size=int(rng.integers(3, 13)))], int(rng.integers(4, 10)))
        for i in range(n)]


def _reference(params, step, reqs, **kw):
    """The tokens of one uninterrupted engine run."""
    eng = ContinuousEngine(params, _scfg(), step=step, device="cpu")
    for rid, prompt, n in reqs:
        eng.submit(Request(rid=rid, prompt=list(prompt), max_new_tokens=n,
                           **kw))
    eng.run_until_idle()
    return {rid: r.tokens for rid, r in eng.results.items()}


def _submit_all(kv, reqs):
    for rid, prompt, n in reqs:
        R.submit_request(kv, rid, prompt, n)
    R.announce_total(kv, len(reqs))


def _wait_leases_gone(kv, rids, limit=30.0):
    """Until the store has dropped every lease of ``rids`` (their TTL ran
    out unheartbeaten)."""
    deadline = time.monotonic() + limit
    while any(kv.try_get(R.k_lease(r)) is not None for r in rids):
        assert time.monotonic() < deadline, "leases never expired"
        time.sleep(0.01)


# -- the real model -----------------------------------------------------------


def test_replica_drain_requeues_and_peer_finishes(kv, params, step):
    reqs = _requests(np.random.default_rng(4), 6)
    want = _reference(params, step, reqs)
    _submit_all(kv, reqs)
    w1 = R.ReplicaWorker(kv, ContinuousEngine(params, _scfg(), step=step,
                                              device="cpu"),
                         tag="w1", lease_ttl=0.5)
    for _ in range(3):
        w1.tick()
    assert w1.stats.claimed >= 1
    w1.request_drain()           # the SIGTERM path
    assert not w1.tick()
    assert w1.stats.requeued >= 1
    assert w1.stats.requeued + w1.stats.completed >= w1.stats.claimed
    w2 = R.ReplicaWorker(kv, ContinuousEngine(params, _scfg(), step=step,
                                              device="cpu"),
                         tag="w2", lease_ttl=0.5)
    w2.run(timeout=60)
    for rid, _, _ in reqs:
        assert R.read_result(kv, rid, timeout=5)["tokens"] == want[rid], rid
        assert int(kv.get(R.k_done(rid))) == 1


def test_replica_scavenge_rescues_orphaned_claims(kv, params, step):
    """A claimant that vanishes without draining (SIGKILL) leaves claims
    whose leases expire; a peer's scavenge pass requeues them exactly once
    and the job still completes with the uninterrupted tokens."""
    reqs = _requests(np.random.default_rng(5), 4)
    want = _reference(params, step, reqs)
    _submit_all(kv, reqs)
    dead = R.ReplicaWorker(kv, ContinuousEngine(params, _scfg(), step=step,
                                                device="cpu"),
                           tag="dead", lease_ttl=0.3)
    dead.tick()                  # claims + leases, then goes silent
    assert dead.stats.claimed >= 1
    orphans = [r.rid for r in dead.engine.drain_to_requests()]
    _wait_leases_gone(kv, orphans)
    w = R.ReplicaWorker(kv, ContinuousEngine(params, _scfg(), step=step,
                                             device="cpu"),
                        tag="rescuer", lease_ttl=0.5, scavenge_interval=0.1)
    w.run(timeout=60)
    assert w.stats.scavenged >= 1
    for rid, _, _ in reqs:
        assert R.read_result(kv, rid, timeout=5)["tokens"] == want[rid], rid


def test_sampled_request_interrupted_mid_decode_replays_bitwise(kv, params,
                                                               step):
    """A temperature/top-k request claimed, decoded partway, drained (the
    SIGTERM path) and re-executed from scratch by a peer: the published
    tokens are bitwise those of an uninterrupted run."""
    prompt = [int(t) for t in np.random.default_rng(6).integers(1, 64,
                                                                size=9)]
    kw = dict(temperature=3.0, top_k=8, seed=7)
    want = _reference(params, step, [("s", prompt, 12)], **kw)["s"]
    R.submit_request(kv, "s", prompt, 12, **kw)
    R.announce_total(kv, 1)
    w1 = R.ReplicaWorker(kv, ContinuousEngine(params, _scfg(), step=step,
                                              device="cpu"),
                         tag="w1", lease_ttl=0.5)
    slots = []
    for _ in range(20):
        w1.tick()
        slots = [s for s in w1.engine.slots
                 if s is not None and s.request.rid == "s"]
        if slots and len(slots[0].generated) >= 3:
            break
    assert slots and 3 <= len(slots[0].generated) < 12, "no mid-decode window"
    w1.request_drain()
    w1.tick()
    assert w1.stats.requeued == 1
    w2 = R.ReplicaWorker(kv, ContinuousEngine(params, _scfg(), step=step,
                                              device="cpu"),
                         tag="w2", lease_ttl=0.5)
    w2.run(timeout=60)
    assert R.read_result(kv, "s", timeout=5)["tokens"] == want


# -- stub-step SLO plane (tests/test_serve_slo.py:181-350) -------------------


def _worker(kv, max_waiting=0, **over):
    over.setdefault("lease_ttl", 1.0)
    eng = ContinuousEngine(None, ServeConfig(
        model=MCFG, cache=CCFG, max_batch=2, buckets=(8, 16),
        max_waiting=max_waiting), step=StubStep(), device="cpu")
    return R.ReplicaWorker(kv, eng, **over)


def test_replica_publishes_shed_verdicts_and_results(kv):
    w = _worker(kv, tag="w0")
    R.submit_request(kv, "ok0", [1, 2, 3], 3)
    # already expired at claim time: must still terminate with a verdict
    R.submit_request(kv, "late0", [1, 2, 3], 3,
                     deadline_unix=time.time() - 5.0)
    R.announce_total(kv, 2)
    w.run(timeout=30.0)
    ok = json.loads(kv.get(R.k_result("ok0")))
    late = json.loads(kv.get(R.k_result("late0")))
    assert ok["verdict"] == "ok" and ok["tokens"] == [4, 5, 6]
    assert late["verdict"] == "SHED" and late["reason"] == "deadline"
    assert R.results_done(kv)
    assert w.stats.completed == 1 and w.stats.shed == 1


def test_verdict_is_claim_once(kv):
    a, b = _worker(kv, tag="wa"), _worker(kv, tag="wb")
    # same rid executed by both (scavenged-duplicate shape): one verdict
    R.submit_request(kv, "dup", [1, 2, 3], 2)
    R.enqueue(kv, "dup")  # duplicate queue entry
    a._publish_verdict("dup", {"rid": "dup", "verdict": "SHED",
                               "reason": "test", "replica": "wa"})
    b._publish_verdict("dup", {"rid": "dup", "verdict": "ok",
                               "tokens": [4, 5], "replica": "wb"})
    got = json.loads(kv.get(R.k_result("dup")))
    assert got["verdict"] == "SHED" and got["replica"] == "wa"
    assert int(kv.get(R.k_done("dup"))) == 2  # two publishers, one winner


def test_replica_load_report_published(kv):
    w = _worker(kv, tag="w0", load_interval=0.01)
    R.submit_request(kv, "r0", [1, 2, 3], 2)
    R.announce_total(kv, 1)
    w.run(timeout=30.0)
    reports = R.read_load_reports(kv)
    assert "w0" in reports
    assert {"queue_depth", "active", "free_block_frac", "step_age",
            "ver", "tag", "dropped_events"} <= set(reports["w0"])
    # the durable time-series trail rides the load-report cadence
    assert kv.keys("obs/ts/w0/")


def test_shed_storm_fault_sheds_local_queue(kv):
    w = _worker(kv, tag="w0")
    for i in range(4):
        R.submit_request(kv, f"r{i}", [1, 2, 3], 2)
    R.announce_total(kv, 4)
    w.tick()  # claims land: max_batch in slots, the rest waiting locally
    assert len(w.engine.waiting) >= 1
    kv.set(serve_cmd_key("w0"), json.dumps({"action": "shed_storm"}))
    w.run(timeout=30.0)
    verdicts = [json.loads(kv.get(R.k_result(f"r{i}")))["verdict"]
                for i in range(4)]
    assert verdicts.count("SHED") >= 1
    assert set(verdicts) <= {"ok", "SHED"}
    assert R.results_done(kv)


def test_client_retries_shed_then_succeeds(kv):
    client = ServeClient(kv, deadline_s=30.0, max_retries=2)
    client.submit("r0", [1, 2, 3], 3)
    # one replica sheds it (storm verdict), a second serves the retry
    storm = _worker(kv, tag="storm")
    storm._publish_verdict("r0", {"rid": "r0", "verdict": "SHED",
                                  "reason": "fault:shed_storm",
                                  "replica": "storm"})
    w = _worker(kv, tag="w0")
    got = None
    for _ in range(200):
        try:
            got = client.result("r0", timeout=0.05)
            break
        except TimeoutError:
            w.tick()
    assert got is not None and got["verdict"] == "ok"
    assert got["tokens"] == [4, 5, 6]
    assert client.stats.retries == 1


def test_client_raises_retries_exhausted_after_budget(kv):
    client = ServeClient(kv, max_retries=1)
    # deadline already burnt: every execution sheds
    client.submit("r0", [1, 2, 3], 3, deadline_s=-1.0)
    w = _worker(kv, tag="w0")
    err = None
    for _ in range(200):
        try:
            client.result("r0", timeout=0.05)
            raise AssertionError("terminal shed must raise, not return")
        except TimeoutError:
            w.tick()
        except RetriesExhausted as e:
            err = e
            break
    assert err is not None
    assert err.rid == "r0" and err.last_reason == "deadline"
    assert err.verdict["verdict"] == "SHED"
    assert len(err.attempts) == 2
    assert all("submitted_at" in a for a in err.attempts)
    assert [a["shed_reason"] for a in err.attempts] == ["deadline"] * 2
    assert client.stats.retries == 1 and client.stats.shed == 1


def test_client_hedges_lost_claim(kv):
    """Entry 0 claimed by a replica that died before leasing: no lease, no
    result. With scavenging parked, the client's hedge (due at once)
    appends the duplicate entry a live replica serves."""
    client = ServeClient(kv, deadline_s=30.0, hedge_after=0.0)
    client.submit("r0", [1, 2, 3], 3)
    assert kv.add(R.k_claim(0)) == 1
    w = _worker(kv, tag="w1", lease_ttl=0.2, scavenge_interval=60.0)
    got = None
    for _ in range(200):
        try:
            got = client.result("r0", timeout=0.05)
            break
        except TimeoutError:
            w.tick()
    assert got is not None and got["verdict"] == "ok"
    assert got["tokens"] == [4, 5, 6]
    assert client.stats.hedges == 1


def test_unported_routes_refuse(kv):
    """The deploy controller's swap command and the canary-share route
    (ROADMAP item 11) and fleets (item 6b) raise, naming their item; an
    empty share body is no split, as JAX reads it."""
    w = _worker(kv, tag="w0")
    kv.set(serve_cmd_key("w0"), json.dumps({"action": "swap", "ver": 3}))
    with pytest.raises(NotImplementedError, match="item 11"):
        w.tick()
    client = ServeClient(kv)
    kv.set(k_shares(""), json.dumps({"seq": 1, "shares": {}}))
    client.submit("r0", [1, 2, 3], 2)
    kv.set(k_shares(""), json.dumps({"seq": 7, "shares": {"7": 1.0}}))
    with pytest.raises(NotImplementedError, match="item 11"):
        client.submit("r1", [1, 2, 3], 2)
    assert kv.try_get(R.k_req("r1")) is None
    with pytest.raises(NotImplementedError, match="item 6b"):
        R.main(["--config", "{}", "--fleet", "chat", "--force-cpu"])


# -- the replica process ------------------------------------------------------


def _replica(port, config, *flags, timeout=240):
    env = {k: v for k, v in os.environ.items() if k != ENV_KV_PORT}
    env[ENV_KV_PORT] = str(port)
    env["OMP_NUM_THREADS"] = "1"
    return subprocess.run(
        [sys.executable, "-m", "tpu_sandbox_torch.serve.replica",
         "--config", json.dumps(config), *flags],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=timeout)


def test_replica_process_serves_jax_greedy_tokens(server, jax_params,
                                                  tmp_path):
    """python -m tpu_sandbox_torch.serve.replica --force-cpu with JAX's
    weights (an npz of the Flax tree, through the bridge) answers 4
    requests queued in the store with the tokens of JAX's engine."""
    srv, kv = server            # the process speaks the store's root keys
    leaves = {"/".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
              for path, v in jax.tree_util.tree_flatten_with_path(
                  jax_params)[0]}
    npz = tmp_path / "params.npz"
    np.savez(npz, **leaves)
    reqs = _requests(np.random.default_rng(9), 4)
    jeng = JaxContinuous(jax_params, JaxServeConfig(
        model=JaxConfig(**WIDTH, dtype=jnp.float32),
        cache=JaxCacheConfig(24, 4, 8), max_batch=3, buckets=(8, 16)))
    for rid, prompt, n in reqs:
        jeng.submit(JaxRequest(rid=rid, prompt=list(prompt),
                               max_new_tokens=n))
    jeng.run_until_idle()
    _submit_all(kv, reqs)
    config = {"model": WIDTH, "cache": {"num_blocks": 24, "block_size": 4,
                                        "max_blocks_per_seq": 8},
              "max_batch": 3, "buckets": [8, 16], "params_npz": str(npz)}
    proc = _replica(srv.port, config, "--force-cpu", "--tag", "p0")
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "[p0] done" in proc.stdout
    for rid, _, _ in reqs:
        verdict = R.read_result(kv, rid, timeout=5)
        assert verdict["verdict"] == "ok" and verdict["replica"] == "p0"
        assert verdict["tokens"] == jeng.results[rid].tokens, rid
    assert kv.delete_prefix("serve/") > 0


def test_replica_process_needs_the_card_unless_forced(server):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the refusal is for machines "
                    "without one")
    proc = _replica(server[0].port, {}, timeout=120)
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
