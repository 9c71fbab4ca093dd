"""The trace directories the port's trace-analytics tests hold both
packages to (tests/test_torch_{collect,critpath,trace_tools}.py):

- ``trace_small`` and ``trace_slow``, the committed fixtures
  (tests/fixtures/make_trace_fixtures.py);
- ``skewed``: trace_small with clock-calibration records added and the
  gateway's wall clock 5 ms behind the others, so the collector's
  sequencer repair moves the gateway's offset (the fixtures carry no
  calibration record, so the repair never fires on them);
- ``recorded``: a run of the port's own fleet on the CPU: a gateway
  process (``python -m tpu_sandbox_torch.gateway``) and, in this process,
  a GatewayClient and two stub-step replicas, every one recording.

Each function here writes under a directory the caller owns and returns
the trace directory."""

from __future__ import annotations

import contextlib
import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
FIXTURES = ROOT / "tests" / "fixtures"
TRACE_SMALL = str(FIXTURES / "trace_small")
TRACE_SLOW = str(FIXTURES / "trace_slow")

#: the gateway's wall clock against the other processes' in ``skewed``
SKEW_S = -0.005
#: (process file, kv sequencer value, mono) of each calibration record of
#: ``skewed``, in sequencer order: the gateway's first point lands 4.9 ms
#: before the client's on the wall anchor alone
CALIBRATION = (("client-100.jsonl", 1, 0.0000),
               ("gateway-200.jsonl", 2, 0.0001),
               ("serve-rep0-300.jsonl", 3, 0.0002),
               ("client-100.jsonl", 4, 0.2000),
               ("gateway-200.jsonl", 5, 0.2001),
               ("serve-rep0-300.jsonl", 6, 0.2002))


def skewed_copy(dst: Path) -> str:
    """trace_small with calibration records, the gateway skewed by SKEW_S
    (its preamble and its calibration walls alike)."""
    out = Path(dst) / "skewed"
    shutil.copytree(TRACE_SMALL, out)
    for name in sorted(os.listdir(out)):
        path = out / name
        recs = [json.loads(line) for line in
                path.read_text(encoding="utf-8").splitlines() if line]
        skew = SKEW_S if name.startswith("gateway") else 0.0
        pre = recs[0]
        pre["wall"] = pre["wall"] + skew
        for fname, seq, mono in CALIBRATION:
            if fname == name:
                recs.append({"ph": "C", "seq": seq, "mono": mono,
                             "rtt": 0.0001, "wall": 1000.0 + mono + skew,
                             "pid": pre["pid"], "proc": pre["proc"],
                             "tid": 0})
        path.write_text("".join(json.dumps(r, sort_keys=True) + "\n"
                                for r in recs), encoding="utf-8")
    return str(out)


#: the recorded run's requests: (rid, prompt, new tokens); r2 and r3 open
#: with r0's and r1's first block, so the gateway routes them by prefix
RECORDED = (("r0", [1, 2, 3, 4, 5, 6], 3),
            ("r1", [9, 8, 7, 6, 5], 2),
            ("r2", [1, 2, 3, 4, 11, 12, 13], 3),
            ("r3", [9, 8, 7, 6, 30], 2),
            ("r4", [40, 41, 42], 4),
            ("r5", [50, 51, 52, 53, 54, 55, 56, 57, 58], 2))


@contextlib.contextmanager
def _tracing(trace_dir: str, proc: str):
    """This process's recorder writing into ``trace_dir`` as ``proc``."""
    from tpu_sandbox_torch.obs import record

    saved = {k: os.environ.get(k)
             for k in (record.ENV_TRACE_DIR, record.ENV_PROC_NAME)}
    os.environ[record.ENV_TRACE_DIR] = trace_dir
    os.environ[record.ENV_PROC_NAME] = proc
    record.reset_recorder()
    try:
        yield record.get_recorder()
    finally:
        record.get_recorder().flush()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        record.reset_recorder()


def record_port_fleet(dst: Path, timeout: float = 60.0) -> str:
    """Run RECORDED through the port's gateway process and two stub-step
    replicas here, with every process recording into ``dst/recorded``;
    the gateway ends on SIGTERM (exit 0), flushing its spans."""
    from torch_serve_stub import StubStep

    from tpu_sandbox_torch.gateway.client import GatewayClient
    from tpu_sandbox_torch.models.transformer import TransformerConfig
    from tpu_sandbox_torch.obs import record
    from tpu_sandbox_torch.runtime.kvstore import KVClient, KVServer
    from tpu_sandbox_torch.runtime.supervisor import ENV_KV_PORT
    from tpu_sandbox_torch.serve.cache import CacheConfig
    from tpu_sandbox_torch.serve.engine import ContinuousEngine, ServeConfig
    from tpu_sandbox_torch.serve.replica import (ReplicaWorker,
                                                 read_load_reports)

    out = Path(dst) / "recorded"
    out.mkdir(parents=True)
    mcfg = TransformerConfig(vocab_size=64, d_model=32, n_heads=4,
                             n_layers=2, d_ff=64, max_len=128)
    scfg = ServeConfig(model=mcfg, cache=CacheConfig(
        num_blocks=24, block_size=4, max_blocks_per_seq=8), max_batch=2,
        buckets=(8, 16))
    server = KVServer()
    kv = KVClient(port=server.port)
    env = {**os.environ, ENV_KV_PORT: str(server.port),
           record.ENV_TRACE_DIR: str(out), record.ENV_PROC_NAME: "gateway"}
    env.pop("PYTHONSTARTUP", None)
    gw = subprocess.Popen(
        [sys.executable, "-m", "tpu_sandbox_torch.gateway",
         "--gateway-id", "gw-rec", "--admission", "none"],
        cwd=ROOT, env=env, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT)
    clones, stop, pump = [], threading.Event(), None
    try:
        line = gw.stdout.readline()
        assert "listening on" in line, line + gw.stdout.read()
        port = int(line.split("listening on ")[1].split()[0].rsplit(":")[1])
        with _tracing(str(out), "serve-stub") as rec:
            rec.calibrate(kv, rounds=3)
            workers = []
            for tag in ("w0", "w1"):
                clones.append(kv.clone())
                workers.append(ReplicaWorker(
                    clones[-1], ContinuousEngine(
                        None, scfg, step=StubStep(), clock=time.monotonic,
                        device="cpu"),
                    tag=tag, lease_ttl=1.0, load_interval=0.02))

            def run():
                while not stop.is_set():
                    for w in workers:
                        w.tick()
                    time.sleep(0.001)

            pump = threading.Thread(target=run, name="recorded-pump",
                                    daemon=True)
            pump.start()
            deadline = time.monotonic() + timeout
            while set(read_load_reports(kv)) != {"w0", "w1"}:
                assert time.monotonic() < deadline, "no load reports"
                time.sleep(0.005)
            client = GatewayClient(endpoints=[("127.0.0.1", port)])
            try:
                for i, (rid, prompt, n) in enumerate(RECORDED):
                    assert client.submit(rid, prompt, n), rid
                    if i in (1, 3):
                        # the next prompts' first blocks are resident
                        # before they are routed
                        for r, _, _ in RECORDED[:i + 1]:
                            client.result(r, timeout=timeout)
                for rid, _, _ in RECORDED:
                    assert client.result(rid, timeout=timeout)[
                        "verdict"] == "ok", rid
            finally:
                client.close()
            stop.set()
            pump.join(timeout=10)
        gw.send_signal(signal.SIGTERM)
        rest, _ = gw.communicate(timeout=timeout)
        assert gw.returncode == 0, rest
    finally:
        stop.set()
        if gw.poll() is None:
            gw.kill()
            gw.wait()
        for c in clones:
            c.close()
        kv.close()
        server.stop()
    return str(out)


def trace_sets(tmp: Path) -> dict[str, str]:
    """Every trace set by name: the fixtures, ``skewed`` and ``recorded``
    (built under ``tmp``)."""
    return {"small": TRACE_SMALL, "slow": TRACE_SLOW,
            "skewed": skewed_copy(tmp), "recorded": record_port_fleet(tmp)}
