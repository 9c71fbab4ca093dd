"""The port's front door (tpu_sandbox_torch/gateway/: wire, routing,
server, client) through the scenarios of tests/test_gateway.py, in
process, over real localhost sockets, with stub-step replicas (next token
= last + 1 mod vocab; tests/torch_serve_stub.py):

- routing and admission as pure functions, and the resident-prefix
  digest under eviction;
- the wire protocol, adversarially: truncated, oversized and malformed
  frames and auth failures close the one connection without wedging the
  accept loop or leaking a request;
- the gateway end to end: prefix routing, door sheds with claim-once
  verdicts, retry and hedge through the socket, multi-fleet isolation,
  the targeted-queue ownership rules, heartbeat leases, failover and TLS.

Then the port against JAX's package: ``choose``, ``admit``, ``feasible``,
``match_depth`` and ``pick_by_share`` on the same seeded views, shares and
draws; frames byte-equal; JAX's client against the port's gateway and the
port's client against JAX's, on one KV store; and a port replica at small
width behind the port's gateway giving JAX's greedy tokens from JAX's
weights. (JAX's ``test_bench_gateway_quick_smoke`` drives ``bench.py``,
which the port's benchmark will carry.)

No test waits on a timing margin: the failover cases kill a gateway only
once it has taken the client's connection, and leases are waited out on
the store.
"""

import contextlib
import json
import os
import socket
import struct
import threading
import time

import pytest

from tpu_sandbox_torch.gateway import routing, wire
from tpu_sandbox_torch.gateway.client import (GatewayAuthError,
                                              GatewayClient, GatewayError,
                                              RetriesExhausted)
from tpu_sandbox_torch.gateway.fleet import (FleetSpec, fleet_kv,
                                             fleet_namespace)
from tpu_sandbox_torch.gateway.server import (Gateway, k_gateway_hb,
                                              live_gateway_endpoints,
                                              live_gateways)
from tpu_sandbox_torch.models.transformer import TransformerConfig
from tpu_sandbox_torch.serve.cache import (CacheConfig, PagedKVCache,
                                           chain_digest)
from tpu_sandbox_torch.serve.engine import (ContinuousEngine, Request,
                                            ServeConfig)
from torch_serve_stub import StubStep
from torch_threads import one_torch_thread  # noqa: F401

MCFG = TransformerConfig(vocab_size=64, d_model=32, n_heads=4, n_layers=2,
                         d_ff=64, max_len=128)
CCFG = CacheConfig(num_blocks=24, block_size=4, max_blocks_per_seq=8)
BLOCK = CCFG.block_size


def _view(tag, *, depth_chain=(), **kw):
    kw.setdefault("digest", frozenset(depth_chain))
    return routing.ReplicaView(tag=tag, **kw)


# -- routing + admission: pure functions --------------------------------------


def test_match_depth_deepest_hash_alone_decides():
    chain = chain_digest(list(range(1, 13)), BLOCK)  # 3 full blocks
    assert len(chain) == 3
    assert routing.match_depth(chain, _view("a", depth_chain=chain)) == 3
    # deepest member decides even when shallower links were evicted
    assert routing.match_depth(chain, _view("a", depth_chain=[chain[2]])) == 3
    assert routing.match_depth(chain, _view("a", depth_chain=[chain[0]])) == 1
    assert routing.match_depth(chain, _view("a")) == 0
    assert routing.match_depth([], _view("a", depth_chain=chain)) == 0


def test_choose_prefers_depth_then_load_then_tag():
    chain = chain_digest(list(range(1, 13)), BLOCK)
    shallow_idle = _view("a", depth_chain=[chain[0]], queue_depth=0)
    deep_busy = _view("b", depth_chain=chain, queue_depth=5)
    v, d = routing.choose(chain, [shallow_idle, deep_busy])
    assert (v.tag, d) == ("b", 3)  # depth beats load
    # equal depth: less load wins
    deep_idle = _view("c", depth_chain=chain, queue_depth=1)
    v, d = routing.choose(chain, [deep_busy, deep_idle])
    assert (v.tag, d) == ("c", 3)
    # no residency anywhere: least-loaded fallback at depth 0
    v, d = routing.choose(chain, [_view("x", queue_depth=3),
                                  _view("y", queue_depth=1)])
    assert (v.tag, d) == ("y", 0)
    # exclusion removes the winner (the hedge path's contract)
    v, d = routing.choose(chain, [shallow_idle, deep_busy],
                          exclude=frozenset({"b"}))
    assert (v.tag, d) == ("a", 1)
    assert routing.choose(chain, [deep_busy],
                          exclude=frozenset({"b"})) is None
    assert routing.choose(chain, []) is None


def test_fresh_drops_stale_reports():
    views = [_view("a", age_s=0.1), _view("b", age_s=9.0)]
    assert [v.tag for v in routing.fresh(views, 5.0)] == ["a"]
    assert routing.fresh(views, 0.01) == []


def test_admission_modes():
    v = _view("a", queue_depth=4, active=1, pending_local=2)  # load 7
    # feasible: (load+1)/rate vs deadline
    ok, reason, est = routing.admit(v, mode="feasible", service_rate_rps=2.0,
                                    deadline_s=10.0, occupancy_bound=8)
    assert ok and reason == "" and est == pytest.approx(4.0)
    ok, reason, _ = routing.admit(v, mode="feasible", service_rate_rps=2.0,
                                  deadline_s=1.0, occupancy_bound=8)
    assert not ok and reason == "infeasible"
    # no deadline: nothing to miss
    ok, _, _ = routing.admit(v, mode="feasible", service_rate_rps=0.001,
                             deadline_s=None, occupancy_bound=8)
    assert ok
    # occupancy: queue_depth + pending_local vs bound, deadline ignored
    ok, reason, _ = routing.admit(v, mode="occupancy", service_rate_rps=2.0,
                                  deadline_s=0.0, occupancy_bound=7)
    assert ok
    ok, reason, _ = routing.admit(v, mode="occupancy", service_rate_rps=2.0,
                                  deadline_s=None, occupancy_bound=6)
    assert not ok and reason == "queue_full"
    ok, _, _ = routing.admit(v, mode="none", service_rate_rps=2.0,
                             deadline_s=-1.0, occupancy_bound=0)
    assert ok
    with pytest.raises(ValueError):
        routing.admit(v, mode="lottery", service_rate_rps=2.0,
                      deadline_s=None, occupancy_bound=8)
    with pytest.raises(ValueError):
        routing.estimate_completion_s(v, 0.0)


def test_parse_report_degrades_missing_fields():
    v = routing.parse_report("w0", {}, age_s=1.5)
    assert v.tag == "w0" and v.load == 0 and v.digest == frozenset()
    assert v.age_s == 1.5 and v.max_batch == 1
    full = routing.parse_report(
        "w1", {"queue_depth": 2, "active": 1, "prefix_digest": ["ab", "cd"]},
        age_s=0.0, pending_local=3)
    assert full.load == 6 and full.digest == frozenset({"ab", "cd"})


# -- resident-prefix digest under eviction (satellite) ------------------------


def test_resident_digest_drops_with_eviction_and_stays_bounded():
    cache = PagedKVCache(CacheConfig(num_blocks=6, block_size=4,
                                     max_blocks_per_seq=4))
    old = list(range(1, 9))       # 2 full blocks
    a = cache.alloc(old, 0)
    cache.free(a, cache_prefix=True)
    assert cache.resident_prefix_digest() == chain_digest(old, 4)
    # allocating a disjoint prompt under block pressure evicts FIFO: the
    # old chain's entries leave the digest the moment they leave the cache
    new = list(range(100, 108))
    b = cache.alloc(new, 8)       # needs 4 blocks; only 3 remain free
    cache.free(b, cache_prefix=True)
    evicted = cache.stats["evicted_cache_blocks"]
    assert evicted >= 1
    resident = cache.resident_prefix_digest()
    assert len(resident) == len(cache._prefix)
    gone = [h for h in chain_digest(old, 4) if h not in resident]
    assert len(gone) == evicted  # no stale advertisements
    # bounded: top_k keeps the NEWEST entries (the ones surviving longest)
    top1 = cache.resident_prefix_digest(top_k=1)
    assert len(top1) == 1 and top1[0] == resident[-1]


def test_engine_load_report_carries_digest():
    eng = ContinuousEngine(
        None, ServeConfig(model=MCFG, cache=CCFG, max_batch=2,
                          buckets=(8, 16)),
        step=StubStep(), clock=time.monotonic, device="cpu")
    prompt = list(range(1, 9))
    eng.submit(Request(rid="r0", prompt=prompt, max_new_tokens=2))
    eng.run_until_idle()
    rep = eng.load_report()
    assert set(chain_digest(prompt, BLOCK)) <= set(rep["prefix_digest"])


# -- wire protocol units ------------------------------------------------------


def test_frame_roundtrip_and_hostile_lengths():
    frame = wire.pack_frame(wire.OP_SUBMIT, wire.encode_body({"rid": "r"}))
    op, length = wire.parse_header(frame[:5])
    assert op == wire.OP_SUBMIT and length == len(frame) - 5
    assert wire.decode_body(frame[5:]) == {"rid": "r"}
    with pytest.raises(wire.ProtocolError):
        wire.pack_frame(wire.OP_SUBMIT, b"x" * (wire.MAX_FRAME + 1))
    # a hostile 4 GB length prefix dies at the header, before allocation
    with pytest.raises(wire.ProtocolError):
        wire.parse_header(struct.pack("!BI", wire.OP_SUBMIT, 1 << 31))
    with pytest.raises(wire.ProtocolError):
        wire.parse_header(b"\x01\x02")  # short header
    with pytest.raises(wire.ProtocolError):
        wire.decode_body(b"not json")
    with pytest.raises(wire.ProtocolError):
        wire.decode_body(b"[1, 2]")  # JSON but not an object


# -- gateway end to end (stub replicas, real sockets) -------------------------


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


def _worker(kv, **over):
    from tpu_sandbox_torch.serve.replica import ReplicaWorker

    over.setdefault("lease_ttl", 1.0)
    over.setdefault("load_interval", 0.02)
    return ReplicaWorker(kv, _engine(), **over)


@contextlib.contextmanager
def _pumping(*workers):
    """Tick workers from one background thread (each worker was built on
    its own KV clone, so the main thread's client stays unshared)."""
    stop = threading.Event()

    def run():
        while not stop.is_set():
            for w in workers:
                w.tick()
            time.sleep(0.001)

    t = threading.Thread(target=run, name="pump", daemon=True)
    t.start()
    try:
        yield stop
    finally:
        stop.set()
        t.join(timeout=10.0)


def _gateway(kv, **over):
    over.setdefault("fleets", [FleetSpec(block_size=BLOCK)])
    over.setdefault("refresh_min_s", 0.005)
    return Gateway(kv, over.pop("fleets"), **over).start()


def _fake_report(kv, tag, *, digest=(), queue_depth=0, ttl=30.0):
    from tpu_sandbox_torch.serve.replica import k_load

    kv.set_ttl(k_load(tag), json.dumps({
        "queue_depth": queue_depth, "active": 0, "max_batch": 2,
        "free_block_frac": 1.0, "prefix_digest": list(digest)}), ttl)


def _wait_for_report(kv, tag, timeout=10.0):
    from tpu_sandbox_torch.serve.replica import read_load_reports

    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if tag in read_load_reports(kv):
            return
        time.sleep(0.005)
    raise AssertionError(f"no load report from {tag}")


def test_gateway_serves_end_to_end_over_socket(kv_pair):
    _, kv, clone = kv_pair
    w = _worker(clone(), tag="w0")
    with _gateway(kv) as gw, _pumping(w):
        _wait_for_report(kv, "w0")
        with GatewayClient(gw.port) as client:
            assert client.submit("r0", [1, 2, 3], 3) is True
            got = client.result("r0", timeout=30.0)
            assert got["verdict"] == "ok" and got["tokens"] == [4, 5, 6]
            assert client.try_result("r0")["tokens"] == [4, 5, 6]
            stats = client.gateway_stats()
    assert stats["stats"]["requests"] == 1
    assert stats["stats"]["admitted"] == 1
    assert gw.stats.shed_door == 0
    assert client.stats.completed == 1


def test_routes_to_deepest_prefix_replica(kv_pair):
    from tpu_sandbox_torch.serve.replica import k_tq

    _, kv, _ = kv_pair
    prompt = list(range(1, 13))
    chain = chain_digest(prompt, BLOCK)
    _fake_report(kv, "shallow", digest=chain[:1])
    _fake_report(kv, "deep", digest=[chain[2]], queue_depth=3)
    with _gateway(kv) as gw:
        s = socket.create_connection(("127.0.0.1", gw.port), timeout=5)
        try:
            wire.send_frame(s, wire.OP_SUBMIT, {
                "rid": "r0", "prompt": prompt, "max_new_tokens": 2})
            status, resp = wire.recv_response(s)
            assert status == wire.ST_OK
            # busier but deeper wins; the targeted queue got the entry
            assert resp == {"admitted": True, "replica": "deep", "depth": 3,
                            "estimate_s": resp["estimate_s"],
                            "routed": "prefix"}
            assert kv.get(k_tq("deep", 0)) == b"r0"
            # nothing resident: least-loaded fallback ("shallow" is idle)
            wire.send_frame(s, wire.OP_SUBMIT, {
                "rid": "r1", "prompt": [50, 51, 52, 53, 54],
                "max_new_tokens": 2})
            status, resp = wire.recv_response(s)
            assert resp["replica"] == "shallow" and resp["routed"] == "balance"
        finally:
            s.close()
        assert gw.stats.routed_prefix == 1 and gw.stats.routed_balance == 1


def test_door_shed_writes_claim_once_verdict(kv_pair):
    from tpu_sandbox_torch.serve.replica import k_done, k_result

    _, kv, _ = kv_pair
    # a fleet calibrated at 1 rps with 100 queued: ~101 s to completion
    _fake_report(kv, "busy", queue_depth=100)
    fleets = [FleetSpec(block_size=BLOCK, service_rate_rps=1.0)]
    with _gateway(kv, fleets=fleets) as gw:
        with GatewayClient(gw.port, deadline_s=1.0, max_retries=0) as client:
            assert client.submit("r0", [1, 2, 3], 2) is False
            with pytest.raises(RetriesExhausted) as ei:
                client.result("r0", timeout=10.0)
    got = ei.value.verdict
    assert got["verdict"] == "SHED" and got["reason"] == "door:infeasible"
    assert got["replica"] == "gateway"
    assert ei.value.last_reason == "door:infeasible"
    assert len(ei.value.attempts) == 1
    assert ei.value.attempts[0]["shed_reason"] == "door:infeasible"
    assert kv.get(k_done("r0")) is not None
    assert json.loads(kv.get(k_result("r0")))["verdict"] == "SHED"
    assert gw.stats.shed_door == 1 and gw.stats.admitted == 0
    assert client.stats.shed == 1


def test_no_fresh_reports_falls_back_to_shared_queue(kv_pair):
    from tpu_sandbox_torch.serve.replica import k_queue

    _, kv, clone = kv_pair
    with _gateway(kv) as gw:
        with GatewayClient(gw.port) as client:
            # fleet warming up: nobody has reported, yet the door admits
            assert client.submit("r0", [1, 2, 3], 3) is True
            assert kv.get(k_queue(0)) == b"r0"
            assert gw.stats.routed_shared == 1
            w = _worker(clone(), tag="late")
            with _pumping(w):
                got = client.result("r0", timeout=30.0)
    assert got["verdict"] == "ok" and got["tokens"] == [4, 5, 6]


def test_client_retries_shed_through_gateway(kv_pair):
    _, kv, clone = kv_pair
    w = _worker(clone(), tag="w0")
    storm = _worker(clone(), tag="storm")
    # a deadline-carrying submit against zero fresh reports would now
    # fast-fail at the door (door:no_replicas); this test is about the
    # retry path, so give routing a live view of w0 up front
    _fake_report(kv, "w0")
    with _gateway(kv) as gw:
        with GatewayClient(gw.port, deadline_s=30.0,
                           max_retries=2) as client:
            assert client.submit("r0", [1, 2, 3], 3) is True
            # one replica sheds it; the retry reroutes and succeeds
            storm._publish_verdict("r0", {
                "rid": "r0", "verdict": "SHED", "reason": "fault:shed_storm",
                "replica": "storm"})
            with _pumping(w):
                got = client.result("r0", timeout=30.0)
    assert got["verdict"] == "ok" and got["tokens"] == [4, 5, 6]
    assert client.stats.retries == 1
    assert gw.stats.clears == 1
    storm.engine.drain_to_requests()


def test_hedge_reroutes_away_from_first_replica(kv_pair):
    _, kv, clone = kv_pair
    prompt = list(range(1, 9))
    chain = chain_digest(prompt, BLOCK)
    # "ghost" advertises the whole chain but will never claim anything
    _fake_report(kv, "ghost", digest=chain)
    w = _worker(clone(), tag="w1")
    with _gateway(kv) as gw, _pumping(w):
        _wait_for_report(kv, "w1")
        with GatewayClient(gw.port, hedge_after=0.05) as client:
            assert client.submit("r0", prompt, 3) is True
            got = client.result("r0", timeout=30.0)
    assert got["verdict"] == "ok" and got["replica"] == "w1"
    assert client.stats.hedges == 1
    assert gw.stats.hedges == 1


def test_multi_fleet_isolation(kv_pair):
    _, kv, clone = kv_pair
    fleets = [FleetSpec(name="chat", block_size=BLOCK),
              FleetSpec(name="code", block_size=BLOCK)]
    wa = _worker(fleet_kv(clone(), "chat"), tag="wa")
    wb = _worker(fleet_kv(clone(), "code"), tag="wb")
    with _gateway(kv, fleets=fleets) as gw, _pumping(wa, wb):
        _wait_for_report(fleet_kv(kv, "chat"), "wa")
        _wait_for_report(fleet_kv(kv, "code"), "wb")
        with GatewayClient(gw.port, fleet="chat") as ca, \
                GatewayClient(gw.port, fleet="code") as cb:
            # the SAME rid lives independently in each fleet's namespace
            assert ca.submit("r0", [1, 2, 3], 2)
            assert cb.submit("r0", [1, 2, 3], 4)
            got_a = ca.result("r0", timeout=30.0)
            got_b = cb.result("r0", timeout=30.0)
            with pytest.raises(GatewayError, match="unknown fleet"), \
                    GatewayClient(gw.port, fleet="nope") as cx:
                cx.submit("r0", [1], 1)
    assert got_a["tokens"] == [4, 5]
    assert got_b["tokens"] == [4, 5, 6, 7]
    assert kv.try_get("fleet/chat/serve/result/r0") is not None
    assert kv.try_get("fleet/code/serve/result/r0") is not None
    assert kv.try_get("serve/result/r0") is None  # nothing leaked to bare


def test_fleet_namespace_and_spec_validation(kv_pair):
    _, kv, _ = kv_pair
    assert fleet_namespace("") == ""
    assert fleet_namespace("chat") == "fleet/chat/"
    for bad in ("a/b", "a b", "a\tb", "a\nb"):
        with pytest.raises(ValueError):
            fleet_namespace(bad)
    assert fleet_kv(kv, "") is kv
    with pytest.raises(ValueError, match="nest"):
        fleet_kv(fleet_kv(kv, "a"), "b")
    with pytest.raises(ValueError):
        FleetSpec(name="a/b")
    specs = FleetSpec(name="chat", share=2.0, priority=1,
                      replica_args=["--config", "cfg.json"]).replica_job_specs(
        replicas=2, base_priority=10)
    assert [s.job_id for s in specs] == ["serve-chat-0", "serve-chat-1"]
    assert all(s.tenant == "fleet-chat" and s.share == 2.0 and
               s.priority == 11 and
               s.env["TPU_SANDBOX_FLEET"] == "chat" for s in specs)
    with pytest.raises(ValueError, match="duplicate fleet"):
        Gateway(kv, [FleetSpec(name="x"), FleetSpec(name="x")])
    with pytest.raises(ValueError, match="admission"):
        Gateway(kv, None, admission="vibes")


# -- adversarial wire behavior against a live gateway -------------------------


@pytest.fixture
def gw(kv_pair):
    _, kv, _ = kv_pair
    g = _gateway(kv)
    yield g
    g.close()


def _raw(gw_):
    return socket.create_connection(("127.0.0.1", gw_.port), timeout=5)


def _closed_by_peer(s, timeout=5.0):
    s.settimeout(timeout)
    try:
        return s.recv(1) == b""
    except (ConnectionError, OSError):
        return True


def _wait_stat(gw_, attr, want, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if getattr(gw_.stats, attr) >= want:
            return
        time.sleep(0.005)
    raise AssertionError(f"{attr} stuck at {getattr(gw_.stats, attr)}")


def test_oversized_length_prefix_closes_connection(gw):
    s = _raw(gw)
    s.sendall(struct.pack("!BI", wire.OP_SUBMIT, 1 << 31))
    assert _closed_by_peer(s)
    s.close()
    _wait_stat(gw, "protocol_errors", 1)
    # the accept loop survived: a well-behaved client still gets served
    with GatewayClient(gw.port) as c:
        assert c.gateway_stats()["stats"]["protocol_errors"] == 1


def test_truncated_frame_is_protocol_error_not_wedge(gw):
    s = _raw(gw)
    s.sendall(struct.pack("!BI", wire.OP_SUBMIT, 100) + b"x" * 10)
    s.shutdown(socket.SHUT_WR)  # EOF mid-frame
    assert _closed_by_peer(s)
    s.close()
    _wait_stat(gw, "protocol_errors", 1)
    with GatewayClient(gw.port) as c:
        assert c.gateway_stats()["stats"]["connections"] >= 2


def test_malformed_json_and_unknown_op_close_connection(gw):
    s = _raw(gw)
    s.sendall(wire.pack_frame(wire.OP_SUBMIT, b"not json"))
    assert _closed_by_peer(s)
    s.close()
    s = _raw(gw)
    s.sendall(wire.pack_frame(ord("Z"), wire.encode_body({})))
    assert _closed_by_peer(s)
    s.close()
    _wait_stat(gw, "protocol_errors", 2)


def test_clean_eof_between_frames_is_not_an_error(gw):
    s = _raw(gw)
    wire.send_frame(s, wire.OP_STATS, {})
    status, _ = wire.recv_response(s)
    assert status == wire.ST_OK
    s.close()  # mid-conversation hangup, but between frames
    _wait_stat(gw, "connections", 1)
    deadline = time.monotonic() + 1.0
    while time.monotonic() < deadline and gw.stats.protocol_errors == 0:
        time.sleep(0.01)
    assert gw.stats.protocol_errors == 0


def test_malformed_body_fails_request_not_connection(gw):
    s = _raw(gw)
    wire.send_frame(s, wire.OP_SUBMIT, {"prompt": [1]})  # no rid
    status, resp = wire.recv_response(s)
    assert status == wire.ST_ERR and "KeyError" in resp["error"]
    # the framing was fine, so the conversation continues
    wire.send_frame(s, wire.OP_STATS, {})
    status, _ = wire.recv_response(s)
    assert status == wire.ST_OK
    s.close()


def test_auth_gate(kv_pair):
    _, kv, _ = kv_pair
    with _gateway(kv, token="sesame") as g:
        with GatewayClient(g.port, token="sesame") as c:
            assert c.gateway_stats()["stats"]["auth_failures"] == 0
        with pytest.raises(GatewayAuthError):
            GatewayClient(g.port, token="wrong")
        # any op before hello is an auth failure, even a well-formed one
        s = _raw(g)
        wire.send_frame(s, wire.OP_STATS, {})
        status, _ = wire.recv_response(s)
        assert status == wire.ST_AUTH
        assert _closed_by_peer(s)
        s.close()
        assert g.stats.auth_failures == 2


def test_mid_request_disconnect_strands_nothing(kv_pair):
    _, kv, clone = kv_pair
    w = _worker(clone(), tag="w0")
    with _gateway(kv) as gw, _pumping(w):
        _wait_for_report(kv, "w0")
        c = GatewayClient(gw.port)
        assert c.submit("r0", [1, 2, 3], 3) is True
        c.close()  # caller dies right after the door admitted
        # the request still runs to a verdict; a new caller can fetch it
        with GatewayClient(gw.port) as c2:
            got = c2.result("r0", timeout=30.0)
    assert got["verdict"] == "ok" and got["tokens"] == [4, 5, 6]


def test_live_gateways_tracks_open_and_closed(kv_pair):
    _, kv, _ = kv_pair
    before = set(live_gateways())
    g = _gateway(kv)
    assert g in live_gateways()
    g.close()
    g.close()  # idempotent
    assert g not in live_gateways() and set(live_gateways()) == before


# -- targeted queues: ownership and the tail-bump/set race --------------------


def test_targeted_entry_claimed_by_owner_only(kv_pair):
    from tpu_sandbox_torch.serve import replica as R

    _, kv, clone = kv_pair
    owner = _worker(clone(), tag="owner")
    other = _worker(clone(), tag="other", scavenge_interval=60.0)
    R.write_request(kv, "r0", [1, 2, 3], 2)
    R.enqueue_to(kv, "owner", "r0")
    _fake_report(kv, "owner")  # owner is alive: peers keep hands off
    for _ in range(20):
        other.tick()
    assert other.stats.claimed == 0
    deadline = time.monotonic() + 10.0
    while kv.try_get(R.k_result("r0")) is None:
        assert time.monotonic() < deadline
        owner.tick()
    assert owner.stats.claimed == 1
    assert json.loads(kv.get(R.k_result("r0")))["replica"] == "owner"


def test_targeted_entry_visible_late_is_not_lost(kv_pair):
    """The tail-bump/set race: the producer bumps serve/tq/<tag>/tail and
    THEN writes the entry body. An owner whose scan lands in that window
    must hold its cursor and retry — skipping would strand the request
    forever (peers defer to a live owner)."""
    from tpu_sandbox_torch.serve import replica as R

    _, kv, clone = kv_pair
    w = _worker(clone(), tag="w0")
    R.write_request(kv, "r0", [1, 2, 3], 2)
    kv.add(R.k_tq_tail("w0"))  # tail bumped, body not yet visible
    for _ in range(5):
        w.tick()
    assert w._tq_scanned == 0 and w.stats.claimed == 0  # cursor held
    kv.set(R.k_tq("w0", 0), "r0")  # the producer's write lands
    deadline = time.monotonic() + 10.0
    while kv.try_get(R.k_result("r0")) is None:
        assert time.monotonic() < deadline
        w.tick()
    assert w.stats.claimed == 1
    assert json.loads(kv.get(R.k_result("r0")))["verdict"] == "ok"


def test_targeted_permanent_hole_advances_after_patience(kv_pair):
    """A producer that died between bump and set leaves a hole with no
    entry behind it: after lease_ttl of patience the cursor moves on, and
    later entries still get claimed."""
    from tpu_sandbox_torch.serve import replica as R

    _, kv, clone = kv_pair
    w = _worker(clone(), tag="w0", lease_ttl=0.05)
    kv.add(R.k_tq_tail("w0"))  # permanent hole at slot 0
    w.tick()
    time.sleep(0.1)
    w.tick()
    w.tick()
    assert w._tq_scanned == 1  # gave up on the hole, nothing was lost
    R.write_request(kv, "r1", [1, 2, 3], 2)
    R.enqueue_to(kv, "w0", "r1")
    deadline = time.monotonic() + 10.0
    while kv.try_get(R.k_result("r1")) is None:
        assert time.monotonic() < deadline
        w.tick()
    assert json.loads(kv.get(R.k_result("r1")))["verdict"] == "ok"


def test_dead_owner_targeted_entry_scavenged_to_shared(kv_pair):
    """A request routed to a replica that died before claiming it: the
    owner's load report expires, a peer's scavenge moves the entry to the
    shared queue (marking it, so a drain can't double-requeue), and the
    peer serves it — routing is a hint, never a trap."""
    from tpu_sandbox_torch.serve import replica as R

    _, kv, clone = kv_pair
    R.write_request(kv, "r0", [1, 2, 3], 3)
    R.enqueue_to(kv, "ghost", "r0")  # no such worker, no load report
    w = _worker(clone(), tag="w1", scavenge_interval=0.05, lease_ttl=0.2)
    deadline = time.monotonic() + 15.0
    while kv.try_get(R.k_result("r0")) is None:
        assert time.monotonic() < deadline
        w.tick()
        time.sleep(0.002)
    got = json.loads(kv.get(R.k_result("r0")))
    assert got["verdict"] == "ok" and got["replica"] == "w1"
    assert kv.try_get(R.k_tq_scavenged("ghost", 0)) is not None


# -- HA front door: heartbeat leases, failover, TLS ---------------------------

TLSDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "fixtures", "tls")


def _server_ctx():
    return wire.make_server_ssl_context(
        os.path.join(TLSDIR, "server.pem"), os.path.join(TLSDIR, "server.key"))


def _client_ctx(ca="ca.pem"):
    return wire.make_client_ssl_context(os.path.join(TLSDIR, ca))


def _wait_endpoints(kv, want_ids, timeout=5.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        ids = [e[0] for e in live_gateway_endpoints(kv)]
        if ids == want_ids:
            return ids
        time.sleep(0.02)
    raise AssertionError(
        f"endpoints {[e[0] for e in live_gateway_endpoints(kv)]}, "
        f"wanted {want_ids}")


def test_hb_lease_discovery_close_vs_kill(kv_pair):
    """Every gateway registers a TTL'd gateway/hb/<id> lease. A clean
    close retires it immediately; a kill() (the SIGKILL stand-in) leaves
    it to lapse — discovery degrades on its own, nothing cleans up. (A
    TTL of 3 s, refreshed every 1.5 s: the lease outlives the kill by far
    more than the read after it takes, under any load.)"""
    _, kv, _ = kv_pair
    g0 = _gateway(kv, gateway_id="gw0", hb_ttl=3.0)
    g1 = _gateway(kv, gateway_id="gw1", hb_ttl=3.0)
    try:
        eps = _wait_endpoints(kv, ["gw0", "gw1"])
        by_id = {e[0]: e for e in live_gateway_endpoints(kv)}
        assert by_id["gw0"][2] == g0.port and by_id["gw1"][2] == g1.port
        g1.close()  # clean: lease deleted right now
        assert [e[0] for e in live_gateway_endpoints(kv)] == ["gw0"]
        g0.kill()   # abrupt: lease still there until the TTL lapses
        assert kv.try_get(k_gateway_hb("gw0")) is not None
        _wait_endpoints(kv, [], timeout=15.0)
    finally:
        g0.close()
        g1.close()


def test_client_fails_over_when_gateway_killed(kv_pair):
    """Kill the connected gateway mid-session: the next op fails over to
    the survivor and completes against the same store state."""
    _, kv, clone = kv_pair
    w = _worker(clone(), tag="w0")
    g0 = _gateway(kv, gateway_id="gw0", hb_ttl=0.4)
    g1 = _gateway(kv, gateway_id="gw1", hb_ttl=0.4)
    client = None
    try:
        with _pumping(w):
            _wait_for_report(kv, "w0")
            client = GatewayClient(
                endpoints=[("127.0.0.1", g0.port), ("127.0.0.1", g1.port)],
                backoff_base=0.01)
            assert client.submit("r0", [1, 2, 3], 3) is True
            assert client.result("r0", timeout=30.0)["verdict"] == "ok"
            assert client.stats.failovers == 0
            assert client.endpoint == ("127.0.0.1", g0.port)
            g0.kill()
            assert client.submit("r1", [1, 2, 3], 3) is True
            got = client.result("r1", timeout=30.0)
            assert got["verdict"] == "ok" and got["tokens"] == [4, 5, 6]
            assert client.stats.failovers >= 1
            assert client.endpoint == ("127.0.0.1", g1.port)
    finally:
        if client is not None:
            client.close()
        g0.close()
        g1.close()


def test_failover_submit_repolls_verdict_never_reexecutes(kv_pair):
    """The one op that is not blindly reissued: a submit that dies with
    the gateway first polls the verdict slot on the survivor — a request
    whose verdict already landed is returned, never re-enqueued."""
    from tpu_sandbox_torch.serve.replica import k_done, k_req, k_result

    _, kv, _ = kv_pair
    g0 = _gateway(kv, gateway_id="gw0", hb_ttl=0.4)
    g1 = _gateway(kv, gateway_id="gw1", hb_ttl=0.4)
    client = None
    try:
        client = GatewayClient(
            endpoints=[("127.0.0.1", g0.port), ("127.0.0.1", g1.port)],
            backoff_base=0.01)
        # the request's verdict landed (elsewhere) before this submit
        kv.set(k_result("done-rid"), json.dumps(
            {"rid": "done-rid", "verdict": "ok", "tokens": [9, 9],
             "replica": "w9"}))
        assert kv.add(k_done("done-rid")) == 1
        # the killed gateway's state, not a timing margin: kill only once
        # g0 has taken the client's connection, so the kill drops it
        _wait_stat(g0, "connections", 1)
        g0.kill()  # the client's socket dies with it
        assert client.submit("done-rid", [1, 2, 3], 2) is True
        assert client.stats.failovers >= 1
        got = client.result("done-rid", timeout=10.0)
        assert got["tokens"] == [9, 9] and got["replica"] == "w9"
        # never re-executed: no request body, no queue entry was written
        assert kv.try_get(k_req("done-rid")) is None
    finally:
        if client is not None:
            client.close()
        g0.close()
        g1.close()


def test_tls_round_trip_and_plaintext_refused(kv_pair):
    """With a TLS listener every byte on the external wire is encrypted:
    a TLS client (hello inside the channel) round-trips; a plaintext
    frame dies in the handshake — counted, connection closed, accept
    loop untouched."""
    _, kv, clone = kv_pair
    w = _worker(clone(), tag="w0")
    with _gateway(kv, tls=_server_ctx(), token="s3cr3t") as g, _pumping(w):
        _wait_for_report(kv, "w0")
        with GatewayClient(g.port, token="s3cr3t",
                           tls=_client_ctx()) as client:
            assert client.submit("r0", [1, 2, 3], 3) is True
            assert client.result("r0", timeout=30.0)["tokens"] == [4, 5, 6]
        # plaintext probe: the gateway refuses during the handshake
        s = _raw(g)
        with contextlib.suppress(ConnectionError, OSError):
            wire.send_frame(s, wire.OP_STATS, {})
            s.settimeout(5.0)
            assert s.recv(1) == b""  # closed, never answered
        s.close()
        _wait_stat(g, "tls_handshake_failures", 1)
        # the accept loop survived: TLS clients still served
        with GatewayClient(g.port, token="s3cr3t",
                           tls=_client_ctx()) as client:
            assert client.gateway_stats()["stats"]["connections"] >= 1


def test_tls_wrong_ca_never_connects(kv_pair):
    _, kv, _ = kv_pair
    with _gateway(kv, tls=_server_ctx(), token="s3cr3t") as g:
        with pytest.raises(GatewayError):
            GatewayClient(g.port, token="s3cr3t",
                          tls=_client_ctx("wrong_ca.pem"),
                          failover_cycles=1, backoff_base=0.0)
        _wait_stat(g, "tls_handshake_failures", 1)
        with GatewayClient(g.port, token="s3cr3t",
                           tls=_client_ctx()) as client:
            assert client.gateway_stats()["stats"]["requests"] == 0


def test_tls_mid_handshake_disconnect_and_oversized_frame(kv_pair):
    """Two adversaries inside the TLS path: a peer that connects and
    hangs up mid-handshake, and an authenticated TLS peer that sends an
    oversized length prefix inside the encrypted channel. Both end their
    own connection; neither wedges the accept loop."""
    _, kv, _ = kv_pair
    with _gateway(kv, tls=_server_ctx()) as g:
        # mid-handshake disconnect: TCP connect, then silence and close
        s = _raw(g)
        s.close()
        # oversized frame INSIDE an established TLS channel
        tls = _client_ctx().wrap_socket(_raw(g), server_hostname="127.0.0.1")
        tls.sendall(struct.pack("!BI", wire.OP_SUBMIT, 1 << 31))
        assert _closed_by_peer(tls)
        tls.close()
        _wait_stat(g, "protocol_errors", 1)
        with GatewayClient(g.port, tls=_client_ctx()) as client:
            assert client.gateway_stats()["stats"]["protocol_errors"] == 1


def test_requests_stamped_with_gateway_id(kv_pair):
    """Every routed request carries the gateway's id; replicas count
    claims per gateway in their load report — the chaos claim audit's
    attribution evidence."""
    from tpu_sandbox_torch.serve.replica import read_load_reports

    _, kv, clone = kv_pair
    w = _worker(clone(), tag="w0")
    with _gateway(kv, gateway_id="gw-stamp") as g, _pumping(w):
        _wait_for_report(kv, "w0")
        with GatewayClient(g.port) as client:
            assert client.submit("r0", [1, 2, 3], 3) is True
            assert client.result("r0", timeout=30.0)["verdict"] == "ok"
        deadline = time.monotonic() + 10.0
        while time.monotonic() < deadline:
            rep = read_load_reports(kv).get("w0", {})
            if rep.get("gw_claims"):
                break
            time.sleep(0.02)
        assert rep["gw_claims"] == {"gw-stamp": 1}


# -- the port against JAX's package -------------------------------------------

PROMPT_LEN = (1, 17)


def _seeded_views(rng, mod, chain):
    """Up to six views of ``mod.ReplicaView`` from ``rng``: random loads,
    ages, versions and digests holding random members of ``chain`` (and
    of a foreign chain), tags drawn so that ties happen."""
    foreign = chain_digest([int(t) for t in rng.integers(100, 200, 12)],
                           BLOCK)
    views = []
    for tag in rng.choice(list("abcdefgh"), size=int(rng.integers(0, 7)),
                          replace=False):
        held = [h for h in chain + foreign if rng.random() < 0.3]
        views.append(mod.ReplicaView(
            tag=str(tag), queue_depth=int(rng.integers(0, 4)),
            active=int(rng.integers(0, 3)),
            max_batch=int(rng.integers(1, 5)),
            free_block_frac=float(rng.random()),
            digest=frozenset(held), age_s=float(rng.random() * 10),
            pending_local=int(rng.integers(0, 3)),
            ver=int(rng.integers(0, 3))))
    return views


def _decisions(mod, rng_seed):
    """Every routing decision of ``mod`` on the views, shares and draws of
    one seed, as plain data."""
    import numpy as np

    rng = np.random.default_rng(rng_seed)
    out = []
    for _ in range(20):
        prompt = [int(t) for t in rng.integers(1, 64, int(rng.integers(
            *PROMPT_LEN)))]
        chain = chain_digest(prompt, BLOCK)
        views = _seeded_views(rng, mod, chain)
        exclude = frozenset(v.tag for v in views if rng.random() < 0.2)
        pick = mod.choose(chain, views, exclude=exclude)
        out.append(("choose", None if pick is None
                    else (pick[0].tag, pick[1])))
        out.append(("fresh", [v.tag for v in mod.fresh(views, 5.0)]))
        out.append(("pin", [v.tag for v in mod.pin_version(views, 1)]))
        for v in views:
            out.append(("depth", v.tag, mod.match_depth(chain, v)))
            rate = float(rng.random() * 4 + 0.1)
            deadline = None if rng.random() < 0.3 else float(rng.random() * 5)
            out.append(("feasible", mod.feasible(v, rate, deadline)))
            for mode in ("feasible", "occupancy", "none"):
                out.append(("admit", mode, mod.admit(
                    v, mode=mode, service_rate_rps=rate,
                    deadline_s=deadline,
                    occupancy_bound=int(rng.integers(0, 6)))))
        shares = {int(ver): float(rng.random()) * (rng.random() < 0.8)
                  for ver in rng.integers(0, 5, int(rng.integers(0, 4)))}
        out.append(("share", [mod.pick_by_share(shares, float(d))
                              for d in rng.random(8)]))
    return out


@pytest.mark.parametrize("seed", range(6))
def test_routing_decisions_are_jaxs(seed):
    """choose, fresh, pin_version, match_depth, feasible, admit and
    pick_by_share give JAX's answers on the same seeded views, shares and
    draws (exact: the same float arithmetic in the same order)."""
    from tpu_sandbox.gateway import routing as jax_routing

    assert _decisions(routing, seed) == _decisions(jax_routing, seed)


BODIES = ({}, {"rid": "r0", "prompt": [1, 2, 3], "max_new_tokens": 4},
          {"rid": "r1", "prompt": list(range(500)), "max_new_tokens": 9,
           "deadline_s": 0.25, "temperature": 0.7, "top_k": 5, "seed": 3,
           "fleet": "chat", "tc": {"t": "abc", "s": "def"}},
          {"token": "s3cr3t"}, {"rid": "é", "timeout": 5.0})


@pytest.mark.parametrize("body", BODIES, ids=range(len(BODIES)))
def test_frames_are_byte_equal_to_jaxs(body):
    """The same body packs to the same bytes under every op and status,
    and each package parses the other's frames."""
    from tpu_sandbox.gateway import wire as jw

    for name in ("MAX_FRAME", "OP_HELLO", "OP_SUBMIT", "OP_WAIT", "OP_TRY",
                 "OP_HEDGE", "OP_CLEAR", "OP_STATS", "OP_METRICS",
                 "KNOWN_OPS", "ST_OK", "ST_ERR", "ST_MISSING", "ST_TIMEOUT",
                 "ST_AUTH"):
        assert getattr(wire, name) == getattr(jw, name), name
    for op in sorted(wire.KNOWN_OPS | {wire.ST_OK, wire.ST_AUTH}):
        frame = wire.pack_frame(op, wire.encode_body(body))
        assert frame == jw.pack_frame(op, jw.encode_body(body))
        assert jw.parse_header(frame[:5]) == wire.parse_header(frame[:5])
        assert jw.decode_body(frame[5:]) == wire.decode_body(frame[5:]) \
            == body


def test_jax_client_against_the_ports_gateway(kv_pair):
    """JAX's GatewayClient submits, waits, polls and scrapes stats through
    the port's gateway, in front of a port replica."""
    from tpu_sandbox.gateway.client import GatewayClient as JaxClient

    _, kv, clone = kv_pair
    w = _worker(clone(), tag="w0")
    with _gateway(kv, token="sesame") as gw, _pumping(w):
        _wait_for_report(kv, "w0")
        with JaxClient(gw.port, token="sesame") as client:
            assert client.submit("r0", [1, 2, 3], 3) is True
            got = client.result("r0", timeout=30.0)
            assert client.try_result("r0")["tokens"] == [4, 5, 6]
            stats = client.gateway_stats()
    assert got["verdict"] == "ok" and got["tokens"] == [4, 5, 6]
    assert got["replica"] == "w0"
    assert stats["stats"]["admitted"] == 1
    assert stats["stats"]["routed_balance"] == 1


def test_ports_client_against_jax_gateway(kv_pair):
    """The port's GatewayClient through JAX's gateway (on a JAX client of
    the port's KV server), in front of a port replica: admit, verdict, a
    door shed with its claim-once SHED body, and a retry that clears it."""
    from tpu_sandbox.gateway.fleet import FleetSpec as JaxFleetSpec
    from tpu_sandbox.gateway.server import Gateway as JaxGateway
    from tpu_sandbox.runtime.kvstore import KVClient as JaxKV

    server, kv, clone = kv_pair
    jkv = JaxKV(port=server.port)
    w = _worker(clone(), tag="w0")
    gw = JaxGateway(jkv, [JaxFleetSpec(block_size=BLOCK)],
                    refresh_min_s=0.005).start()
    try:
        with _pumping(w):
            _wait_for_report(kv, "w0")
            with GatewayClient(gw.port, max_retries=0) as client:
                assert client.submit("r0", [1, 2, 3], 3) is True
                got = client.result("r0", timeout=30.0)
                assert client.submit("r1", [5, 6], 2, deadline_s=0.0) \
                    is False
                with pytest.raises(RetriesExhausted) as ei:
                    client.result("r1", timeout=10.0)
    finally:
        gw.close()
        jkv.close()
    assert got["verdict"] == "ok" and got["tokens"] == [4, 5, 6]
    assert ei.value.last_reason == "door:infeasible"
    assert json.loads(kv.get("serve/result/r1"))["replica"] == "gateway"
    assert gw.stats.admitted == 1 and gw.stats.shed_door == 1


def test_port_replica_behind_gateway_gives_jax_greedy_tokens(kv_pair):
    """A port replica on the CPU at small width (JAX's weights through the
    bridge, the port's real prefill and decode), behind the port's
    gateway, answers each request with JAX's greedy tokens: a one-shot
    forward of JAX's LM on the same weights, argmax a token at a time."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from tpu_sandbox.models.transformer import TransformerConfig as JaxConfig
    from tpu_sandbox.models.transformer import TransformerLM as JaxLM
    from tpu_sandbox_torch.serve.decode import build_decode_step
    from tpu_sandbox_torch.serve.replica import ReplicaWorker
    from tpu_sandbox_torch.utils.bridge import params_from_flax

    width = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
                 max_len=128)
    lm = JaxLM(JaxConfig(**width, dtype=jnp.float32))
    jparams = lm.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32))[
        "params"]
    fwd = jax.jit(lambda toks: lm.apply({"params": jparams}, toks))
    ctx = CCFG.max_context

    def greedy(prompt, n):
        toks, out = list(prompt), []
        for _ in range(n):
            padded = np.zeros((1, ctx), np.int32)
            padded[0, :len(toks)] = toks
            out.append(int(np.asarray(fwd(padded))[0, len(toks) - 1]
                           .argmax()))
            toks.append(out[-1])
        return out

    rng = np.random.default_rng(5)
    reqs = [(f"g{i}", [int(t) for t in rng.integers(1, 64, int(
        rng.integers(3, 13)))], int(rng.integers(3, 8))) for i in range(4)]
    reqs.append(("g4", reqs[0][1], reqs[0][2]))   # a resident-prefix twin
    mcfg = TransformerConfig(**width)
    params = params_from_flax({"params": jax.tree.map(np.asarray, jparams)})
    eng = ContinuousEngine(
        params, ServeConfig(model=mcfg, cache=CCFG, max_batch=3,
                            buckets=(8, 16)),
        step=build_decode_step(mcfg, CCFG, max_batch=3, buckets=(8, 16)),
        device="cpu")
    _, kv, clone = kv_pair
    w = ReplicaWorker(clone(), eng, tag="w0", lease_ttl=1.0,
                      load_interval=0.02)
    with _gateway(kv) as gw, _pumping(w):
        _wait_for_report(kv, "w0")
        with GatewayClient(gw.port) as client:
            got = {}
            for rid, prompt, n in reqs:
                assert client.submit(rid, prompt, n) is True
                got[rid] = client.result(rid, timeout=60.0)
    for rid, prompt, n in reqs:
        assert got[rid]["verdict"] == "ok", got[rid]
        assert got[rid]["tokens"] == greedy(prompt, n), rid
    assert gw.stats.routed_prefix >= 1   # the twin found its prefix


def test_close_drops_open_connections(kv_pair):
    """close() with a client still connected ends that connection and the
    gateway's thread at once (Python 3.12's Server.wait_closed waits for
    every connection: JAX's gateway, which leaves them to asyncio.run's
    shutdown, keeps its loop and heartbeat running past close() until
    the client hangs up)."""
    _, kv, _ = kv_pair
    g = _gateway(kv)
    s = _raw(g)
    wire.send_frame(s, wire.OP_STATS, {})
    assert wire.recv_response(s)[0] == wire.ST_OK
    t0 = time.monotonic()
    g.close()
    assert time.monotonic() - t0 < 4.0
    assert not g._thread.is_alive()
    assert _closed_by_peer(s)
    s.close()


def test_connection_handled_after_kill_is_dropped(kv_pair):
    """A connection the listener accepted before kill() but whose handler
    runs after it was never among kill()'s connections: the handler
    drops it at once, as SIGKILL would, and serves nothing."""
    import asyncio

    _, kv, _ = kv_pair
    g = _gateway(kv)
    g.kill()
    aborted = []

    class _Transport:
        def abort(self):
            aborted.append(True)

    class _Writer:
        transport = _Transport()

    asyncio.run(g._handle(None, _Writer()))
    assert aborted == [True] and g.stats.connections == 0
