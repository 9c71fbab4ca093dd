"""The port's health plane (tpu_sandbox_torch/obs/health.py over the
port's tsdb, metrics and recorder) through the scenarios of
tests/test_health.py, run against both packages (``m``: ``jax`` is
``tpu_sandbox``, ``torch`` the port): the durable time-series ring,
burn-rate and threshold rules, the three seeded pathologies (each with a
clean twin that must stay silent), exactly-once alerting through monitor
failover, and the alert-to-control loops of the gateway (a burning
replica off the routing table until its alert lapses), the autoscaler and
the scheduler, and the ``fleetop`` console (JAX's ``tools/fleetop.py``,
the port's ``tpu_sandbox_torch/tools/fleetop.py``).

Windows run on stub clocks; the only real-time waits are short TTL
expiries (recovery IS the TTL), each bounded by a deadline.
"""

import importlib
import importlib.util
import json
import socket
import time
from pathlib import Path
from types import SimpleNamespace

import pytest

from torch_threads import one_torch_thread  # noqa: F401

PACKAGES = {"jax": "tpu_sandbox", "torch": "tpu_sandbox_torch"}


@pytest.fixture(params=sorted(PACKAGES))
def m(request):
    pkg = PACKAGES[request.param]

    def mod(name):
        return importlib.import_module(f"{pkg}.{name}")

    health, metrics = mod("obs.health"), mod("obs.metrics")
    ns = {n: getattr(health, n) for n in (
        "BurnRateRule", "CascadeDetector", "HealthMonitor",
        "OscillationDetector", "StarvationDetector", "ThresholdRule",
        "active_alerts", "active_subjects", "alerts", "default_rules",
        "k_active", "k_alert_claim", "k_alert_record", "raise_alert")}
    ns.update(MetricsRegistry=metrics.MetricsRegistry,
              get_registry=metrics.get_registry,
              series_key=metrics.series_key,
              Recorder=mod("obs.record").Recorder,
              TimeSeriesFlusher=mod("obs.tsdb").TimeSeriesFlusher,
              tsdb=mod("obs.tsdb"), kvstore=mod("runtime.kvstore"),
              scheduler=mod("runtime.scheduler"),
              autoscale=mod("serve.autoscale"), replica=mod("serve.replica"),
              wire=mod("gateway.wire"), server=mod("gateway.server"),
              fleet=mod("gateway.fleet"), cache=mod("serve.cache"),
              pkg=request.param)
    return SimpleNamespace(**ns)


@pytest.fixture()
def kv_pair(m):
    server = m.kvstore.KVServer()
    kv = m.kvstore.KVClient(port=server.port)
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


def _fake_report(m, kv, tag, *, digest=(), queue_depth=0, ttl=30.0):
    kv.set_ttl(m.replica.k_load(tag), json.dumps({
        "queue_depth": queue_depth, "active": 0, "max_batch": 2,
        "free_block_frac": 1.0, "prefix_digest": list(digest)}), ttl)


class _Clock:
    def __init__(self, t=1000.0):
        self.t = float(t)

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt


def _flusher(m, kv, proc, clock, **kw):
    """A flusher on its OWN registry and a disabled recorder, so tests
    seed per-process series without touching the process-global state."""
    reg = m.MetricsRegistry()
    f = m.TimeSeriesFlusher(kv, proc, registry=reg, recorder=m.Recorder(None),
                            clock=clock, **kw)
    return f, reg


def _seed_burn(m, kv, proc, *, shed, done, clock=time.time):
    f, reg = _flusher(m, kv, proc, clock)
    reg.counter("engine.shed").inc(shed)
    reg.counter("engine.done").inc(done)
    f.flush()


# -- tsdb ring ----------------------------------------------------------------


def test_flusher_counter_deltas_accumulate_per_bucket(m, kv_pair):
    _, kv, _ = kv_pair
    clock = _Clock(1000.0)
    f, reg = _flusher(m, kv, "p0", clock)
    reg.counter("a.b").inc(5)
    assert f.flush() > 0
    rows = m.tsdb.read_series(kv, "a.b")
    assert [(r["kind"], r["v"], r["bucket"], r["proc"]) for r in rows] == \
        [("counter", 5, 1000, "p0")]
    # second flush in the SAME bucket: the bucket accumulates the delta
    reg.counter("a.b").inc(3)
    f.flush()
    rows = m.tsdb.read_series(kv, "a.b")
    assert [(r["v"], r["bucket"]) for r in rows] == [(8, 1000)]
    # next bucket starts from zero deltas
    clock.advance(1.0)
    reg.counter("a.b").inc(2)
    f.flush()
    rows = m.tsdb.read_series(kv, "a.b")
    assert [(r["v"], r["bucket"]) for r in rows] == [(8, 1000), (2, 1001)]
    assert m.tsdb.window_sum(rows, since_bucket=1000) == 10
    assert m.tsdb.window_sum(rows, since_bucket=1001) == 2
    assert m.tsdb.window_sum(rows, since_bucket=0, per_proc=True) == \
        {"p0": 10.0}


def test_flusher_gauges_histograms_and_label_series(m, kv_pair):
    _, kv, _ = kv_pair
    clock = _Clock(2000.0)
    f, reg = _flusher(m, kv, "p1", clock)
    reg.gauge("q.depth").set(3)
    h = reg.histogram("lat.s")
    for v in range(1, 101):
        h.observe(float(v))
    reg.counter("req.total", labels={"tenant": "a"}).inc(2)
    reg.counter("req.total", labels={"tenant": "b"}).inc(7)
    f.flush()
    assert m.tsdb.latest_value(m.tsdb.read_series(kv, "q.depth")) == 3
    # gauges are last-write-wins inside a bucket
    reg.gauge("q.depth").set(9)
    f.flush()
    assert m.tsdb.latest_value(m.tsdb.read_series(kv, "q.depth")) == 9
    # histogram digest: default field is p99
    p99 = m.tsdb.latest_value(m.tsdb.read_series(kv, "lat.s"))
    assert 90.0 <= p99 <= 100.0
    assert m.tsdb.latest_value(m.tsdb.read_series(kv, "lat.s"),
                               field="count") == 100
    # label variants are distinct series under one base name
    assert m.series_key("req.total", {"tenant": "a"}) == "req.total{tenant=a}"
    rows = m.tsdb.read_series(kv, "req.total")
    assert sorted(r["series"] for r in rows) == \
        ["req.total{tenant=a}", "req.total{tenant=b}"]
    assert m.tsdb.window_sum(rows, since_bucket=0) == 9
    # the flusher's synthetic recorder-health series ride along
    assert ("p1", "obs.recorder.dropped") in m.tsdb.list_series(kv)


def test_ring_wraps_bounded_and_ttl_expires(m, kv_pair):
    _, kv, _ = kv_pair
    clock = _Clock(100.0)
    f, reg = _flusher(m, kv, "ring", clock, retention_buckets=4, ds_factor=2)
    for _ in range(6):  # buckets 100..105 through a 4-slot ring
        reg.counter("w.x").inc()
        f.flush()
        clock.advance(1.0)
    rows = m.tsdb.read_series(kv, "w.x", proc="ring")
    # slots wrapped: only the last retention_buckets buckets survive, and
    # the absolute bucket in the payload is authoritative (no confusion
    # between bucket 100 and the bucket 104 that overwrote its slot)
    assert [r["bucket"] for r in rows] == [102, 103, 104, 105]
    keys = [k for k in kv.keys(m.tsdb.TS_PREFIX + "ring/") if "/w.x/" in k]
    assert len(keys) == 4
    # the coarse ring downsampled 2x: buckets 50, 51, 52 with summed deltas
    coarse = m.tsdb.read_series(kv, "w.x", proc="ring", coarse=True)
    assert [(r["bucket"], r["v"]) for r in coarse] == \
        [(50, 2), (51, 2), (52, 2)]


def test_ring_ttl_ages_out_dead_process_trails(m, kv_pair):
    _, kv, _ = kv_pair
    f, reg = _flusher(m, kv, "dead", time.time, bucket_s=0.05,
                      retention_buckets=2)
    reg.counter("t.x").inc()
    f.flush()
    assert m.tsdb.read_series(kv, "t.x", proc="dead")
    time.sleep(0.4)  # > retention_buckets * bucket_s
    assert m.tsdb.read_series(kv, "t.x", proc="dead") == []


def test_flusher_validates_inputs(m, kv_pair):
    _, kv, _ = kv_pair
    with pytest.raises(ValueError):
        m.TimeSeriesFlusher(kv, "a/b")
    with pytest.raises(ValueError):
        m.TimeSeriesFlusher(kv, "ok", ds_factor=1)


# -- rules --------------------------------------------------------------------


def test_burn_rate_rule_fires_on_both_windows_only(m, kv_pair):
    _, kv, _ = kv_pair
    clock = _Clock(5000.0)
    rule = m.BurnRateRule(name="shed_burn", bad="engine.shed",
                          good="engine.done", budget=0.05)
    # no traffic at all: no verdict, not a fire
    assert rule.evaluate(kv, 5000) == []
    _seed_burn(m, kv, "w0", shed=30, done=70, clock=clock)  # rate 0.3 > 0.2
    fired = rule.evaluate(kv, 5000)
    assert [s for s, _ in fired] == ["fleet"]
    assert fired[0][1]["short_rate"] == pytest.approx(0.3)
    # healthy traffic: under 4x budget, silent
    kv.delete_prefix(m.tsdb.TS_PREFIX)
    _seed_burn(m, kv, "w0", shed=1, done=99, clock=clock)
    assert rule.evaluate(kv, 5000) == []


def test_burn_rate_rule_per_proc_isolates_the_burning_replica(m, kv_pair):
    _, kv, _ = kv_pair
    clock = _Clock(5000.0)
    _seed_burn(m, kv, "good", shed=0, done=100, clock=clock)
    _seed_burn(m, kv, "bad", shed=50, done=50, clock=clock)
    rule = m.BurnRateRule(name="replica_burn", bad="engine.shed",
                          good="engine.done", budget=0.05, per_proc=True)
    fired = rule.evaluate(kv, 5000)
    assert [s for s, _ in fired] == ["bad"]


def test_threshold_rule_gauge_and_histogram_field(m, kv_pair):
    _, kv, _ = kv_pair
    clock = _Clock(3000.0)
    f, reg = _flusher(m, kv, "p0", clock)
    reg.gauge("serve.goodput").set(12.0)
    h = reg.histogram("engine.ttft")
    for v in (0.1, 0.2, 0.9):
        h.observe(v)
    f.flush()
    below = m.ThresholdRule(name="goodput_floor", series="serve.goodput",
                            threshold=20.0, op="<")
    fired = below.evaluate(kv, 3000)
    assert fired and fired[0][0] == "fleet" and fired[0][1]["value"] == 12.0
    assert m.ThresholdRule(name="x", series="serve.goodput",
                           threshold=5.0, op="<").evaluate(kv, 3000) == []
    ttft = m.ThresholdRule(name="ttft_slo", series="engine.ttft",
                           threshold=0.5, op=">", field="p99")
    assert ttft.evaluate(kv, 3000)
    # the stock rule set alerts on recorder drops: the flusher publishes
    # the synthetic obs.recorder.dropped gauge from recorder.stats()
    drops = [r for r in m.default_rules() if r.name == "recorder_drops"][0]
    assert drops.evaluate(kv, 3000) == []  # healthy recorder: 0 drops

    class _DroppingRec:
        enabled = False

        def stats(self):
            return {"events": 10, "dropped": 4}

    f2 = m.TimeSeriesFlusher(kv, "p0", registry=m.MetricsRegistry(),
                             recorder=_DroppingRec(), clock=clock)
    f2.flush()
    fired = drops.evaluate(kv, 3000)
    assert [s for s, _ in fired] == ["p0"]
    assert fired[0][1]["value"] == 4.0


# -- alert protocol: exactly-once through failover ----------------------------


def test_raise_alert_claims_exactly_once_per_window(m, kv_pair):
    _, kv, _ = kv_pair
    body = {"rule": "r", "subject": "s", "window_idx": 7, "wall": 1.0}
    assert m.raise_alert(kv, "r", "s", 7, body, active_ttl=30.0) is True
    # a second monitor evaluating the same window: record is idempotent,
    # claim is lost, active flag refreshed — no double notification
    assert m.raise_alert(kv, "r", "s", 7, body, active_ttl=30.0) is False
    assert json.loads(kv.get(m.k_alert_record("r", "s", 7))) == body
    assert m.active_subjects(kv, "r") == {"s"}
    # a new window is a new claim
    assert m.raise_alert(kv, "r", "s", 8, dict(body, window_idx=8),
                         active_ttl=30.0) is True
    assert len(m.alerts(kv, rule="r")) == 2


def test_monitor_killed_mid_evaluation_never_double_fires(m, kv_pair):
    _, kv, _ = kv_pair
    body = {"rule": "r", "subject": "s", "window_idx": 9, "wall": 2.0}
    # monitor A dies between the record write and the claim: replay its
    # first step only
    kv.set(m.k_alert_record("r", "s", 9), json.dumps(body, sort_keys=True))
    # successor B evaluates the same window and completes the protocol —
    # it wins the claim (A never got there), so the notification happens
    # exactly once
    assert m.raise_alert(kv, "r", "s", 9, body, active_ttl=30.0) is True
    # and a replay of A after resurrection cannot fire again
    assert m.raise_alert(kv, "r", "s", 9, body, active_ttl=30.0) is False
    assert kv.get(m.k_alert_claim("r", "s", 9)) == b"2"
    assert len(m.alerts(kv, rule="r")) == 1


def test_monitor_leader_election_onset_refresh_recovery(m, kv_pair):
    _, kv, _ = kv_pair
    clock = _Clock(7000.0)
    f, reg = _flusher(m, kv, "p0", clock)
    reg.gauge("q.depth").set(10.0)
    f.flush()
    rule = m.ThresholdRule(name="q_high", series="q.depth", threshold=5.0)

    def mon(member):
        # active TTL = 2 windows * 0.5 s = 1 s of real time: long enough
        # that back-to-back steps land inside it, short enough to test
        # recovery-by-expiry below
        return m.HealthMonitor(kv, member, window_s=0.5, bucket_s=1.0,
                               rules=[rule], detectors=[], active_windows=2.0,
                               clock=clock)

    m1, m2 = mon("h0"), mon("h1")
    claimed = m1.step()
    assert [b["rule"] for b in claimed] == ["q_high"]
    assert claimed[0]["subject"] == "fleet"
    # the follower is not evaluating at all
    assert m2.step() is None
    # while the condition holds, the leader refreshes the active flag but
    # raises no new record (onset vs refresh)
    assert m1.step() == []
    assert len(m.alerts(kv, rule="q_high")) == 1
    assert m.active_subjects(kv, "q_high") == {"fleet"}
    # failover: the successor leads and keeps refreshing without re-firing
    m1.resign()
    assert m2.step() == []
    assert len(m.alerts(kv, rule="q_high")) == 1
    # recovery: condition clears, the active flag TTLs out (0.1 s)
    kv.delete_prefix(m.tsdb.TS_PREFIX)
    deadline = time.monotonic() + 5.0
    while m.active_subjects(kv, "q_high") and time.monotonic() < deadline:
        time.sleep(0.02)
    assert m.active_subjects(kv, "q_high") == set()
    assert m2.step() == []  # clear condition: nothing fires
    # relapse in a LATER window: a fresh onset record
    reg.gauge("q.depth").set(11.0)
    f.flush()
    clock.advance(1.0)
    claimed = m2.step()
    assert len(claimed) == 1
    assert len(m.alerts(kv, rule="q_high")) == 2
    # the claimed notification bumped the health.alerts counter
    snap = m.get_registry().snapshot()["counters"]
    assert snap.get('health.alerts{rule=q_high}', 0) >= 2


# -- seeded pathologies + clean twins -----------------------------------------


def _seed_autoscale_events(m, kv, actions, *, reason="queue_depth"):
    K_EVENT_TAIL, k_event = m.autoscale.K_EVENT_TAIL, m.autoscale.k_event
    tail = int(kv.try_get(K_EVENT_TAIL) or b"0")
    for a in actions:
        kv.set(k_event(tail), json.dumps(
            {"action": a, "reason": reason, "wall": 0.0}))
        tail += 1
    kv.set(K_EVENT_TAIL, str(tail))


def test_oscillation_detector_fires_on_flapping(m, kv_pair):
    _, kv, _ = kv_pair
    det = m.OscillationDetector(window_evals=8, flip_threshold=3)
    _seed_autoscale_events(
        m, kv, ["scale_up", "scale_down", "scale_up", "scale_down"])
    fired = det.observe(kv)
    assert [s for s, _ in fired] == ["fleet"]
    assert fired[0][1]["flips"] == 3
    # the window slides: with no new events the flips age out
    for _ in range(10):
        fired = det.observe(kv)
    assert fired == []


def test_oscillation_clean_twins_stay_silent(m, kv_pair):
    _, kv, _ = kv_pair
    # monotonic growth is not oscillation
    det = m.OscillationDetector(window_evals=8, flip_threshold=3)
    _seed_autoscale_events(m, kv, ["scale_up"] * 5)
    assert det.observe(kv) == []
    # bootstrap floor-repair events never count, however many alternate
    kv.delete_prefix("serve/autoscale/")
    det2 = m.OscillationDetector(window_evals=8, flip_threshold=3)
    _seed_autoscale_events(
        m, kv, ["scale_up", "scale_down", "scale_up", "scale_down"],
        reason="min_replicas")
    assert det2.observe(kv) == []


def _seed_tenant(m, kv, tenant, *, vtime, queued):
    K_QUEUED_PREFIX = m.scheduler.K_QUEUED_PREFIX
    K_VTIME_PREFIX = m.scheduler.K_VTIME_PREFIX
    kv.set(f"{K_VTIME_PREFIX}{tenant}", repr(float(vtime)))
    kv.set(f"{K_QUEUED_PREFIX}{tenant}", str(int(queued)))


def test_starvation_detector_fires_on_share_abuse(m, kv_pair):
    _, kv, _ = kv_pair
    det = m.StarvationDetector(ratio=5.0, consecutive=2)
    # tenant "hog" (10:1 share) advances; "mouse" has queued work but its
    # vtime is frozen — the fair-share invariant says both should move
    _seed_tenant(m, kv, "hog", vtime=0.0, queued=0)
    _seed_tenant(m, kv, "mouse", vtime=0.0, queued=2)
    assert det.observe(kv) == []  # first observation only seeds deltas
    _seed_tenant(m, kv, "hog", vtime=10.0, queued=0)
    assert det.observe(kv) == []  # streak 1 of 2: admission churn immunity
    _seed_tenant(m, kv, "hog", vtime=20.0, queued=0)
    fired = det.observe(kv)
    assert [s for s, _ in fired] == ["mouse"]
    assert fired[0][1]["queued"] == 2


def test_starvation_clean_twin_both_tenants_advance(m, kv_pair):
    _, kv, _ = kv_pair
    det = m.StarvationDetector(ratio=5.0, consecutive=2)
    _seed_tenant(m, kv, "a", vtime=0.0, queued=1)
    _seed_tenant(m, kv, "b", vtime=0.0, queued=1)
    det.observe(kv)
    for step in (10.0, 20.0, 30.0):
        # both advance at comparable rates (well inside the 5x ratio)
        _seed_tenant(m, kv, "a", vtime=step, queued=1)
        _seed_tenant(m, kv, "b", vtime=step * 0.5, queued=1)
        assert det.observe(kv) == []


def test_cascade_detector_fires_on_preempt_cycles(m, kv_pair):
    K_PREEMPTS_PREFIX = m.scheduler.K_PREEMPTS_PREFIX
    _, kv, _ = kv_pair
    det = m.CascadeDetector(cycles=3, window_evals=8)
    kv.add(f"{K_PREEMPTS_PREFIX}victim")
    assert det.observe(kv) == []  # one preemption is business as usual
    kv.add(f"{K_PREEMPTS_PREFIX}victim")
    assert det.observe(kv) == []
    kv.add(f"{K_PREEMPTS_PREFIX}victim")
    fired = det.observe(kv)
    assert [s for s, _ in fired] == ["victim"]
    assert fired[0][1]["preemptions"] == 3
    # clean twin: a job preempted once long ago never re-fires; the
    # window slides past the cycles
    for _ in range(10):
        fired = det.observe(kv)
    assert fired == []


# -- the loop closed: alerts drive control ------------------------------------


def test_autoscaler_backs_off_on_its_own_oscillation(m, kv_pair):
    AutoscaleConfig = m.autoscale.AutoscaleConfig
    ReplicaAutoscaler = m.autoscale.ReplicaAutoscaler
    _, kv, _ = kv_pair
    cfg = AutoscaleConfig(min_replicas=0, max_replicas=4,
                          hysteresis_ticks=1, cooldown_s=0.0)
    asc = ReplicaAutoscaler(kv, ["true"], cfg=cfg)
    _fake_report(m, kv, "r0", queue_depth=10)  # loud scale-up signal
    kv.set_ttl(m.k_active("autoscale_oscillation", "fleet"), b"{}", 0.4)
    before = m.get_registry().snapshot()["counters"].get(
        "autoscale.backoff", 0)
    # the health plane says we're flapping: load-driven scaling freezes
    assert asc.tick() is None
    assert asc.tick() is None
    after = m.get_registry().snapshot()["counters"]["autoscale.backoff"]
    assert after == before + 2
    # alert expires -> the same signal scales up again
    deadline = time.monotonic() + 5.0
    while m.active_subjects(kv, "autoscale_oscillation") \
            and time.monotonic() < deadline:
        time.sleep(0.02)
    event = asc.tick()
    assert event is not None and event["action"] == "scale_up"


def test_scheduler_stamps_starved_jobs_once(m, kv_pair):
    S = m.scheduler
    ClusterScheduler, JobSpec = S.ClusterScheduler, S.JobSpec
    job_events, submit_job = S.job_events, S.submit_job
    _, kv, _ = kv_pair
    with ClusterScheduler(1, kv_port=kv.port, poll=0.02,
                          verbose=False) as sched:
        # a 2-host gang on a 1-slot pool: queued forever, zero agents
        submit_job(kv, JobSpec(job_id="wide", hosts=2, world_size=2,
                               agent_argv=["true"], tenant="mouse"))
        sched._tick()
        # queue shape is published durably for the starvation detector
        assert kv.try_get("sched/queued/mouse") == b"1"
        assert "starved" not in job_events(kv, "wide")
        # the health plane flags the tenant: the next tick surfaces it in
        # the job's own durable event stream
        kv.set_ttl(m.k_active("tenant_starvation", "mouse"), b"{}", 5.0)
        sched._tick()
        stamp = job_events(kv, "wide")["starved"]
        # once: later ticks with the alert still active do not re-stamp
        time.sleep(0.01)
        sched._tick()
        assert job_events(kv, "wide")["starved"] == stamp


def test_gateway_excludes_burning_replica_until_recovery(m, kv_pair):
    _, kv, _ = kv_pair
    block = 4
    prompt = list(range(1, 13))
    chain = m.cache.chain_digest(prompt, block)
    # "burned" advertises the deepest prefix residency: absent the health
    # plane, routing would always pick it
    _fake_report(m, kv, "burned", digest=chain)
    _fake_report(m, kv, "healthy", digest=chain[:1])
    _seed_burn(m, kv, "burned", shed=30, done=10)
    mon = m.HealthMonitor(
        kv, "h0", window_s=0.25, active_windows=2.0,
        rules=[m.BurnRateRule(name="replica_burn", bad="engine.shed",
                              good="engine.done", budget=0.05,
                              per_proc=True)],
        detectors=[])
    claimed = mon.step()
    assert [b["subject"] for b in claimed] == ["burned"]
    assert m.active_subjects(kv, "replica_burn") == {"burned"}
    wire = m.wire

    def _route(gw, rid):
        s = socket.create_connection(("127.0.0.1", gw.port), timeout=5)
        try:
            wire.send_frame(s, wire.OP_SUBMIT, {
                "rid": rid, "prompt": prompt, "max_new_tokens": 2})
            status, resp = wire.recv_response(s)
            assert status == wire.ST_OK and resp["admitted"], resp
            return resp["replica"]
        finally:
            s.close()

    gw = m.server.Gateway(kv, [m.fleet.FleetSpec(block_size=block)],
                          refresh_min_s=0.005).start()
    try:
        # burn active: the deepest replica is OFF the table
        assert _route(gw, "r0") == "healthy"
        # recovery: the monitor stops refreshing (condition owner died /
        # condition cleared) and the active flag TTLs out (0.5 s)
        deadline = time.monotonic() + 10.0
        while m.active_subjects(kv, "replica_burn") \
                and time.monotonic() < deadline:
            time.sleep(0.05)
        assert m.active_subjects(kv, "replica_burn") == set()
        time.sleep(0.05)  # next refresh re-reads health state
        assert _route(gw, "r1") == "burned"
    finally:
        gw.close()


def _fleetop(m):
    if m.pkg == "torch":
        return importlib.import_module("tpu_sandbox_torch.tools.fleetop")
    path = Path(__file__).resolve().parent.parent / "tools" / "fleetop.py"
    spec = importlib.util.spec_from_file_location("jax_fleetop_health", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_fleetop_renders_fleet_health(m, kv_pair):
    fleetop = _fleetop(m)
    _, kv, _ = kv_pair
    assert "no time series" in fleetop.render(kv)  # empty store renders
    clock = _Clock(time.time())
    f, reg = _flusher(m, kv, "sched", clock)
    reg.gauge("sched.queue.depth").set(4)
    f.flush()
    _fake_report(m, kv, "w0", queue_depth=2)
    _seed_burn(m, kv, "w0", shed=30, done=10)
    m.raise_alert(kv, "replica_burn", "w0", 1,
                  {"rule": "replica_burn", "subject": "w0",
                   "window_idx": 1, "wall": time.time()}, active_ttl=30.0)
    out = fleetop.render(kv, now=time.time())
    assert "sched.queue.depth" in out
    assert "w0" in out and "EXCLUDED" in out
    assert "active alerts (1)" in out and "replica_burn" in out
    assert "recent alert records" in out
    assert "postmortem" in out
