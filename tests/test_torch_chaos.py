"""The port's chaos campaigns (tpu_sandbox_torch/runtime/chaos.py) through
the fast cases of JAX's tests/test_chaos.py, then against JAX's module on
the same inputs.

The smoke campaign runs in process: 2 port gateways and 2 stub-step
replicas (next token = last + 1 mod vocab; tests/torch_serve_stub.py),
10 requests replayed from a seeded workload, a replica shed storm and a
gateway kill mid-load. It ends with zero loss and one ok verdict per
request, and its audit bytes equal those built from the schedule and the
stub's tokens, which are known without a fleet: the determinism receipt
of JAX's slow same-seed twin campaign, without the second fleet.

Against JAX: ``build_schedule`` element by element over seeds and target
sets, with the same refusals; ``CampaignResult.audit_bytes``,
``_token_digest``, ``prompt_for`` and ``check_alert_claims`` on the same
inputs. No JAX fleet is started (JAX's in-process ``Gateway.kill()`` can
hang its event loop's close); the comparisons are of outputs."""

import contextlib
import json
import threading
import time

import pytest

from tpu_sandbox.runtime import chaos as jchaos
from tpu_sandbox_torch.gateway.client import GatewayClient
from tpu_sandbox_torch.gateway.fleet import FleetSpec
from tpu_sandbox_torch.gateway.server import Gateway
from tpu_sandbox_torch.models.transformer import TransformerConfig
from tpu_sandbox_torch.obs import workload
from tpu_sandbox_torch.runtime.chaos import (CHAOS_ACTIONS, CampaignResult,
                                             ChaosCampaign, ChaosFault,
                                             build_schedule,
                                             check_alert_claims)
from tpu_sandbox_torch.runtime import chaos
from tpu_sandbox_torch.serve.cache import CacheConfig
from tpu_sandbox_torch.serve.engine import ContinuousEngine, ServeConfig
from torch_serve_stub import StubStep
from torch_threads import one_torch_thread  # noqa: F401

MCFG = TransformerConfig(vocab_size=64, d_model=32, n_heads=4, n_layers=2,
                         d_ff=64, max_len=128)
CCFG = CacheConfig(num_blocks=24, block_size=4, max_blocks_per_seq=8)
BLOCK = CCFG.block_size


def _engine():
    cfg = ServeConfig(model=MCFG, cache=CCFG, max_batch=2, buckets=(8, 16))
    return ContinuousEngine(None, cfg, step=StubStep(), clock=time.monotonic,
                            device="cpu")


def _worker(kv, tag):
    from tpu_sandbox_torch.serve.replica import ReplicaWorker

    return ReplicaWorker(kv, _engine(), tag=tag, lease_ttl=1.0,
                         load_interval=0.02)


@contextlib.contextmanager
def _pumping(*workers):
    stop = threading.Event()

    def run():
        while not stop.is_set():
            for w in workers:
                w.tick()
            time.sleep(0.001)

    t = threading.Thread(target=run, name="chaos-pump", daemon=True)
    t.start()
    try:
        yield stop
    finally:
        stop.set()
        t.join(timeout=10.0)


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


# -- schedule expansion: pure + seeded ----------------------------------------

TARGETS = {"kill_gateway": ["gw0", "gw1"], "shed_storm": ["w0"],
           "stall_replica": ["w0:0.1", "w1:0.2"]}


def test_build_schedule_same_seed_same_faults():
    a = build_schedule(7, duration_s=2.0, targets=TARGETS, n_faults=6)
    b = build_schedule(7, duration_s=2.0, targets=TARGETS, n_faults=6)
    assert a == b
    assert len(a) == 6
    assert all(f.action in CHAOS_ACTIONS for f in a)
    assert [f.at_s for f in a] == sorted(f.at_s for f in a)
    c = build_schedule(8, duration_s=2.0, targets=TARGETS, n_faults=6)
    assert a != c  # a different seed draws a different campaign


def test_build_schedule_rejects_bad_inputs():
    with pytest.raises(ValueError, match="no action"):
        build_schedule(1, duration_s=1.0, targets={})
    with pytest.raises(ValueError, match="unknown chaos actions"):
        build_schedule(1, duration_s=1.0,
                       targets={"kill_everything": ["x"]})


def test_campaign_refuses_hookless_actions(kv_pair):
    _, kv, _ = kv_pair
    trace = workload.synthesize(3, 1)
    sched = [ChaosFault(at_s=0.1, action="kill_gateway", target="gw0")]
    with pytest.raises(ValueError, match="has no hook"):
        ChaosCampaign(kv, trace, lambda *a: True, seed=3, schedule=sched)
    with pytest.raises(ValueError, match="unknown action"):
        ChaosCampaign(kv, trace, lambda *a: True, seed=3, schedule=[
            ChaosFault(at_s=0.1, action="kill_everything", target="x")])


# -- the smoke campaign -------------------------------------------------------

SMOKE_SEED = 1013
SMOKE_SCHEDULE = [
    ChaosFault(at_s=0.18, action="shed_storm", target="w0"),
    ChaosFault(at_s=0.30, action="kill_gateway", target="gw0"),
]


def _smoke_trace():
    return workload.synthesize(SMOKE_SEED, 10, duration_s=0.5,
                               prompt_tokens=(4, 10), decode_tokens=(2, 4))


def _run_smoke_campaign(kv, clone):
    """One seeded campaign: 2 gateways, 2 stub replicas, 10 requests, a
    replica shed_storm then a gateway kill mid-load."""
    fleets = [FleetSpec(block_size=BLOCK)]
    gws = {
        gid: Gateway(kv, fleets, gateway_id=gid, hb_ttl=0.5,
                     refresh_min_s=0.005).start()
        for gid in ("gw0", "gw1")
    }
    w0, w1 = _worker(clone(), "w0"), _worker(clone(), "w1")
    client = campaign = None
    try:
        with _pumping(w0, w1):
            client = GatewayClient(
                endpoints=[("127.0.0.1", gws["gw0"].port),
                           ("127.0.0.1", gws["gw1"].port)],
                backoff_base=0.01)
            campaign = ChaosCampaign(
                clone(), _smoke_trace(), client.submit, seed=SMOKE_SEED,
                schedule=SMOKE_SCHEDULE,
                hooks={"kill_gateway": lambda gid: gws[gid].kill()},
                block_size=BLOCK, verdict_timeout=60.0)
            res = campaign.run()
            failovers = client.stats.failovers
        alert_failures = check_alert_claims(kv)
    finally:
        if client is not None:
            client.close()
        for g in gws.values():
            g.close()
    return res, alert_failures, campaign, failovers


def _stub_tokens(prompt, n):
    """What StubStep answers: each token the last one plus 1, mod vocab."""
    out, last = [], prompt[-1]
    for _ in range(n):
        last = (last + 1) % MCFG.vocab_size
        out.append(last)
    return out


def test_smoke_campaign_zero_loss_exactly_once(kv_pair):
    from tpu_sandbox_torch.serve.replica import k_done, k_result

    _, kv, clone = kv_pair
    res, alert_failures, campaign, failovers = _run_smoke_campaign(kv,
                                                                   clone)
    assert res.ok, res.failures
    assert res.lost == []
    assert res.submitted == 10
    # every rid converged to a terminal "ok" verdict with real tokens: the
    # shed_storm cost retries, never answers
    assert len(res.verdicts) == 10
    assert all(v["verdict"] == "ok" and v["tokens"]
               for v in res.verdicts.values())
    assert [f["action"] for f in res.fired] == ["shed_storm",
                                                "kill_gateway"]
    assert alert_failures == []
    assert failovers >= 1
    rows = workload.replay_order(campaign.trace)
    for row in rows:
        rid = row["rid"]
        assert kv.get(k_done(rid)) == b"1", rid  # answered once
        want = _stub_tokens(campaign.prompt_for(row), row["decode_tokens"])
        assert json.loads(kv.get(k_result(rid)))["tokens"] == want, rid
    # the determinism receipt: the audit is the schedule and the stub's
    # tokens, whatever the interleaving was
    expect = CampaignResult(
        seed=SMOKE_SEED, fired=[f.as_dict() for f in SMOKE_SCHEDULE],
        verdicts={row["rid"]: {"verdict": "ok",
                               "tokens": chaos._token_digest({
                                   "tokens": _stub_tokens(
                                       campaign.prompt_for(row),
                                       row["decode_tokens"])})}
                  for row in rows})
    assert res.audit_bytes() == expect.audit_bytes()
    assert res.audit_bytes() == jchaos.CampaignResult(
        seed=res.seed, fired=res.fired, verdicts=res.verdicts,
        lost=res.lost).audit_bytes()


# -- the port against JAX -----------------------------------------------------


def test_constants_equal_jax():
    assert chaos.AUDIT_SCHEMA == jchaos.AUDIT_SCHEMA == \
        "tpu-sandbox.chaos-audit/1"
    assert chaos.CHAOS_ACTIONS == jchaos.CHAOS_ACTIONS
    assert chaos.MAILBOX_ACTIONS == jchaos.MAILBOX_ACTIONS


@pytest.mark.parametrize("seed", [0, 1, 7, 1013, 2 ** 31 - 1])
@pytest.mark.parametrize("targets", [
    TARGETS,
    {"shed_storm": ["r0", "r1"], "stall_replica": ["r0:0.5", "r1:0.5"]},
    {a: [f"{a}-{i}" for i in range(3)] for a in jchaos.CHAOS_ACTIONS},
    {"kill_leader": ["autoscaler"], "partition_host": [],
     "kill_agent": ["a0"]},
], ids=["mixed", "mailbox", "every", "sparse"])
def test_build_schedule_equal_jax(seed, targets):
    for n, dur in ((1, 0.5), (3, 4.0), (12, 10.0), (0, 1.0)):
        got = build_schedule(seed, duration_s=dur, targets=targets,
                             n_faults=n)
        want = jchaos.build_schedule(seed, duration_s=dur, targets=targets,
                                     n_faults=n)
        assert [f.as_dict() for f in got] == [f.as_dict() for f in want]


@pytest.mark.parametrize("targets, match", [
    ({}, "no action"),
    ({"shed_storm": []}, "no action"),
    ({"kill_everything": ["x"]}, "unknown chaos actions"),
    ({"shed_storm": ["w0"], "zap": ["x"], "boom": ["y"]},
     "unknown chaos actions"),
])
def test_build_schedule_refusals_equal_jax(targets, match):
    with pytest.raises(ValueError, match=match) as got:
        build_schedule(1, duration_s=1.0, targets=targets)
    with pytest.raises(ValueError, match=match) as want:
        jchaos.build_schedule(1, duration_s=1.0, targets=targets)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("fields", [
    dict(seed=0),
    dict(seed=1013, fired=[{"at_s": 0.18, "action": "shed_storm",
                            "target": "w0"},
                           {"at_s": 0.3, "action": "kill_gateway",
                            "target": "gw0"}],
         verdicts={"c1013-r0002": {"verdict": "ok", "tokens": "ab12"},
                   "c1013-r0001": {"verdict": "SHED", "tokens": ""}},
         lost=["z", "a"], submitted=3, admitted=2, door_shed=1, retried=4,
         failures=["x"]),
    dict(seed=-5, verdicts={f"r{i}": {"verdict": "ok", "tokens": str(i)}
                            for i in range(30, 0, -3)}),
], ids=["empty", "mixed", "many"])
def test_audit_bytes_equal_jax(fields):
    got = CampaignResult(**fields)
    want = jchaos.CampaignResult(**fields)
    assert got.audit_bytes() == want.audit_bytes()
    assert got.ok == want.ok
    assert got.audit_bytes().endswith("\n")


@pytest.mark.parametrize("tokens", [[], [0], [1, 2, 3], list(range(300)),
                                    [32767] * 64])
def test_token_digest_equal_jax(tokens):
    body = {"rid": "r", "verdict": "ok", "tokens": tokens}
    assert chaos._token_digest(body) == jchaos._token_digest(body)
    assert chaos._token_digest({}) == jchaos._token_digest({})


def test_prompt_for_equal_jax():
    trace = workload.synthesize(7, 24, duration_s=4.0,
                                prompt_tokens=(32, 512),
                                decode_tokens=(16, 64))
    for vocab, block in ((64, 8), (32768, 16), (5, 1)):
        mine = ChaosCampaign(None, trace, None, seed=7, schedule=[],
                             vocab=vocab, block_size=block)
        theirs = jchaos.ChaosCampaign(None, trace, None, seed=7,
                                      schedule=[], vocab=vocab,
                                      block_size=block)
        for row in trace["requests"] + [dict(trace["requests"][0],
                                             prompt_tokens=0)]:
            got = mine.prompt_for(row)
            assert got == theirs.prompt_for(row)
            assert all(0 <= t < vocab for t in got)
        # rows sharing a chain label share their first block
        by_chain = {}
        for row in trace["requests"]:
            by_chain.setdefault(row["chain"], []).append(
                mine.prompt_for(row)[:block])
        assert all(len({tuple(p) for p in ps}) == 1
                   for ps in by_chain.values())


def test_check_alert_claims_equal_jax(kv_pair):
    from tpu_sandbox_torch.obs.health import (K_ALERT_PREFIX,
                                              k_alert_record, raise_alert)

    _, kv, _ = kv_pair
    assert check_alert_claims(kv) == jchaos.check_alert_claims(kv) == []
    raise_alert(kv, "replica_burn", "w0", 3,
                {"rule": "replica_burn", "subject": "w0"}, active_ttl=30.0)
    assert check_alert_claims(kv) == []
    # a record whose claim never landed (a monitor died between the two
    # writes), and a malformed record key
    kv.set(k_alert_record("shed_burn", "fleet", 9), json.dumps({}))
    kv.set(f"{K_ALERT_PREFIX}bad/key", "{}")
    got = check_alert_claims(kv)
    assert got == jchaos.check_alert_claims(kv)
    assert sorted(got) == sorted([
        f"malformed alert record key '{K_ALERT_PREFIX}bad/key'",
        "alert shed_burn/fleet/9 recorded but unclaimed"])
