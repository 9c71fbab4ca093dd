"""The port's gateway and replicas as processes (the scenarios of
tests/test_gateway_integration.py:66 and :146, at small width on the CPU):

- ``python -m tpu_sandbox_torch.gateway`` prints its port, serves a client
  behind the shared-secret hello, keeps its ``gateway/hb/<id>`` lease, and
  on SIGTERM retires the lease, logs its stats and exits 0;
- two ``python -m tpu_sandbox_torch.serve.replica --force-cpu`` processes
  behind the port's gateway, one SIGKILLed mid-load: every request still
  gets exactly one verdict, rescued by a peer's scavenge or the client's
  retry and hedge.

The kill is placed by the store, not by a clock: the replica is stopped
(SIGSTOP) and killed only while it holds the lease of a request without a
verdict, so the kill always strands work.
"""

import json
import os
import signal
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

from tpu_sandbox_torch.gateway.client import GatewayAuthError, GatewayClient
from tpu_sandbox_torch.gateway.fleet import FleetSpec
from tpu_sandbox_torch.gateway.server import Gateway, k_gateway_hb
from tpu_sandbox_torch.runtime.kvstore import KVClient, KVServer
from tpu_sandbox_torch.runtime.supervisor import ENV_KV_PORT
from tpu_sandbox_torch.serve import replica as R
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
REPLICA_CFG = {
    "cache": {"num_blocks": 24, "block_size": 4, "max_blocks_per_seq": 8},
    "max_batch": 3,
    "buckets": [8, 16],
    "param_seed": 0,
    "lease_ttl": 1.0,
    "timeout": 240.0,
}
N_REQUESTS = 30
#: the seconds any one wait of this module may take
LIMIT = 180.0


def _env(kv_port):
    env = {k: v for k, v in os.environ.items() if k != ENV_KV_PORT}
    env[ENV_KV_PORT] = str(kv_port)
    env["OMP_NUM_THREADS"] = "1"
    return env


def _stop(proc):
    if proc.poll() is None:
        proc.kill()
    proc.wait(timeout=30)
    if proc.stdout is not None:
        proc.stdout.close()


def test_gateway_process_entrypoint_serves_and_shuts_down():
    with KVServer() as server:
        kv = KVClient(port=server.port)
        proc = subprocess.Popen(
            [sys.executable, "-m", "tpu_sandbox_torch.gateway",
             "--kv-port", str(server.port), "--token", "sesame",
             "--gateway-id", "gw-entry", "--admission", "occupancy",
             "--fleets", json.dumps([{"name": "chat", "block_size": 4}])],
            env=_env(server.port), cwd=str(ROOT), stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        try:
            line = proc.stdout.readline()
            assert "[gateway] gw-entry listening on" in line, line
            assert "admission=occupancy" in line and "tls=off" in line
            port = int(line.split("listening on ")[1].split()[0]
                       .rsplit(":", 1)[1])
            with GatewayClient(port, token="sesame", fleet="chat") as c:
                stats = c.gateway_stats()
                assert stats["admission"] == "occupancy"
                assert sorted(stats["fleets"]) == ["chat"]
            with pytest.raises(GatewayAuthError):
                GatewayClient(port, token="wrong")
            hb = json.loads(kv.get(k_gateway_hb("gw-entry")))
            assert hb["port"] == port and hb["host"] == "127.0.0.1"
            proc.send_signal(signal.SIGTERM)
            assert proc.wait(timeout=30) == 0
            rest = proc.stdout.read()
            assert "[gateway] closed:" in rest, rest
            assert "'auth_failures': 1" in rest, rest
            # a clean shutdown retires the lease at once
            assert kv.try_get(k_gateway_hb("gw-entry")) is None
        finally:
            _stop(proc)
            kv.close()


def _spawn_replica(kv_port, tag):
    return subprocess.Popen(
        [sys.executable, "-m", "tpu_sandbox_torch.serve.replica",
         "--config", json.dumps(REPLICA_CFG), "--tag", tag, "--force-cpu"],
        env=_env(kv_port), cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)


def _stranded(kv, tag):
    """Requests whose lease ``tag`` holds and that have no verdict."""
    out = []
    for key in kv.keys("serve/lease/"):
        rid = key[len("serve/lease/"):]
        if kv.try_get(key) == tag.encode() \
                and kv.try_get(R.k_result(rid)) is None:
            out.append(rid)
    return out


def test_replica_kill_mid_load_every_request_verdicts_once():
    rng = np.random.default_rng(0)
    with KVServer() as server:
        kv = KVClient(port=server.port)
        procs = [_spawn_replica(server.port, f"p{i}") for i in range(2)]
        gw = client = None
        try:
            gw = Gateway(kv, [FleetSpec(block_size=4, service_rate_rps=50.0)],
                         refresh_min_s=0.01).start()
            client = GatewayClient(gw.port, max_retries=2, hedge_after=2.0)
            deadline = time.monotonic() + LIMIT
            while len(R.read_load_reports(kv)) < 2:
                assert time.monotonic() < deadline, "replicas never reported"
                for p in procs:
                    assert p.poll() is None, p.communicate()[0]
                time.sleep(0.05)
            rids = []
            for i in range(N_REQUESTS):
                prompt = [int(t) for t in
                          rng.integers(1, 64, size=int(rng.integers(4, 13)))]
                assert client.submit(f"r{i}", prompt,
                                     int(rng.integers(4, 9)))
                rids.append(f"r{i}")
            R.announce_total(kv, N_REQUESTS)
            # freeze p1, and kill it only while it holds unfinished work
            victim, stranded = procs[1], []
            while not stranded:
                assert time.monotonic() < deadline, "p1 never held work"
                assert victim.poll() is None, victim.communicate()[0]
                victim.send_signal(signal.SIGSTOP)
                stranded = _stranded(kv, "p1")
                if not stranded:
                    victim.send_signal(signal.SIGCONT)
                    time.sleep(0.005)
            victim.kill()
            victim.wait(timeout=30)
            verdicts = {rid: client.result(rid, timeout=LIMIT)
                        for rid in rids}
            claims = {rid: int(kv.get(R.k_done(rid))) for rid in rids}
            requeued = int(kv.try_get(R.K_TAIL) or b"0")
        finally:
            if client is not None:
                client.close()
            if gw is not None:
                gw.close()
            for p in procs:
                _stop(p)
            kv.close()
    assert set(verdicts) == set(rids)
    assert all(c == 1 for c in claims.values()), claims
    for rid, v in verdicts.items():
        assert v["verdict"] in ("ok", "SHED"), (rid, v)
        if v["verdict"] == "ok":
            assert len(v["tokens"]) >= 1, (rid, v)
    # the stranded requests were finished by the survivor
    for rid in stranded:
        assert verdicts[rid]["verdict"] == "ok", verdicts[rid]
        assert verdicts[rid]["replica"] == "p0", verdicts[rid]
    # the rescue machinery ran: a peer's scavenge requeued them onto the
    # shared queue, or the client retried or hedged them
    assert client.stats.retries + client.stats.hedges + requeued > 0
