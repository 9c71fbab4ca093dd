"""The port's stage processes (``python -m tpu_sandbox_torch.mpmd.worker
--device cpu``) as scheduler jobs: JAX's tests/test_mpmd_integration.py
scenarios under the port's ``ClusterScheduler``, each stage its own job of
one cogroup, activations and cotangents over the KV-store transport.

The receipts, as JAX's: the final params each stage ships over the
``final`` edge are bitwise its in-process twin's (``MPMDPipeline`` from
the same plan seed), the per-step losses equal, zero duplicate claims in
any generation. Stage 1 SIGKILLed mid-schedule at step 3 (half its slots
shipped) is respawned by the scheduler at generation 2 and replays into
the durable slots; a partition (paused heartbeats, a stalled stage) heals
with no relaunch; the 3-stage uneven ZB-H1 pipeline's middle stage killed
mid-schedule recovers the same way. ``fleetop`` renders the
``mpmd.bubble_fraction`` gauges the workers flushed. Without ``--device``
a worker runs on the card, which this machine lacks: it fails, never
falling back to the CPU."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from tpu_sandbox_torch.mpmd import MPMDPipeline
from tpu_sandbox_torch.mpmd.program import tree_leaves
from tpu_sandbox_torch.mpmd.transport import KVTransport
from tpu_sandbox_torch.mpmd.worker import _build_tx, model_config
from tpu_sandbox_torch.runtime.faults import FaultPlan
from tpu_sandbox_torch.runtime.scheduler import ClusterScheduler, JobSpec
from torch_threads import one_torch_thread  # noqa: F401

PY = sys.executable
ROOT = Path(__file__).resolve().parent.parent
#: one intra-op thread a stage process: the test workers share the cores
ENV = {"PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}

MODEL = {"vocab_size": 64, "d_model": 32, "n_heads": 2, "n_layers": 4,
         "d_ff": 64, "max_len": 64}
OPTIMIZER = {"name": "adam", "lr": 0.01}
BATCH = [8, 16]
STEPS, M, SEED = 8, 4, 0
#: the 3-stage arm: an uneven split under ZB-H1
N3, LAYER_SPLIT, KIND3 = 3, [2, 1, 1], "zb_h1"


def _twin(n_stages, kind="1f1b", layer_split=None):
    """The unfaulted in-process run with the workers' derivation: data
    from the plan seed's rng, the LM's init from the plan seed."""
    cfg = model_config(MODEL)
    rng = np.random.default_rng(SEED)
    tokens = rng.integers(0, cfg.vocab_size, size=tuple(BATCH)).astype(
        np.int32)
    targets = ((tokens + 7) % cfg.vocab_size).astype(np.int32)
    pipe = MPMDPipeline(cfg, _build_tx(OPTIMIZER), n_stages=n_stages,
                        microbatches=M, devices="cpu", kind=kind,
                        layer_split=layer_split)
    pipe.init(SEED)
    losses = pipe.train(STEPS, tokens, targets)
    return {"losses": losses, "stage_leaves": {
        s: tree_leaves(w.host_state()["params"])
        for s, w in enumerate(pipe.workers)}}


@pytest.fixture(scope="module")
def reference():
    return _twin(2)


@pytest.fixture(scope="module")
def reference3():
    return _twin(N3, KIND3, LAYER_SPLIT)


def _json_arg(obj):
    # agent_argv elements are str.format templates: double the braces
    return json.dumps(obj).replace("{", "{{").replace("}", "}}")


def _stage_argv(stage, ckpt_root, n_stages, kind="1f1b", layer_split=None):
    argv = [PY, "-m", "tpu_sandbox_torch.mpmd.worker",
            "{agent_id}", "{kv_port}", "{job_id}",
            "--stage", str(stage), "--ckpt-root", str(ckpt_root),
            "--get-timeout", "120", "--device", "cpu"]
    if stage == 0:  # the leader publishes the plan everyone else fetches
        argv += ["--steps", str(STEPS), "--n-stages", str(n_stages),
                 "--microbatches", str(M), "--seed", str(SEED),
                 "--schedule-kind", kind,
                 "--model", _json_arg(MODEL),
                 "--optimizer", _json_arg(OPTIMIZER),
                 "--batch", _json_arg(BATCH)]
        if layer_split:
            argv += ["--layer-split", _json_arg(layer_split)]
    return argv


def _run(tmp_path, n_stages, fault_env, fault_stage, **plan):
    from tpu_sandbox_torch.tools import fleetop

    with ClusterScheduler(n_stages, poll=0.05, extra_env=ENV,
                          verbose=False) as sched:
        for s in range(n_stages):
            sched.submit(JobSpec(
                job_id=f"stage{s}", hosts=1, world_size=1, cogroup="pipe0",
                agent_argv=_stage_argv(s, tmp_path / "ckpt", n_stages,
                                       **plan),
                admission_timeout=120.0,
                env=fault_env if s == fault_stage else {}))
        states = sched.serve(timeout=300)
        assert states == {f"stage{s}": "done" for s in range(n_stages)}, \
            states
        tr = KVTransport(sched.kv, prefix="mpmd/pipe0/")
        finals = {s: tr.get("final", 0, s, timeout=10.0)
                  for s in range(n_stages)}
        losses = json.loads(sched.kv.get("mpmd/pipe0/losses"))
        gens = {s: int(sched.kv.get(f"mpmd/pipe0/gen/{s}"))
                for s in range(n_stages)}
        # namespaces are swept; the transport plane is not
        assert sched.kv.keys("job/stage0/") == []
        return {"finals": finals, "losses": losses, "gens": gens,
                "audit": tr.audit(), "fleetop": fleetop.render(sched.kv)}


def _check(ref, out, gens):
    for s, want in ref["stage_leaves"].items():
        got = out["finals"][s]
        assert len(got) == len(want)
        for i, (a, b) in enumerate(zip(want, got)):
            assert b.dtype == a.numpy().dtype and b.shape == tuple(a.shape)
            assert b.tobytes() == a.numpy().tobytes(), \
                f"stage {s} leaf {i} differs from the in-process run"
    assert out["losses"] == ref["losses"]
    assert out["gens"] == gens
    dup = {k: v for k, v in out["audit"]["claims"].items() if v != 1}
    assert not dup, f"duplicate deliveries: {dup}"


def _kill(rank, step):
    return {"TPU_SANDBOX_FAULT_PLAN": FaultPlan().add(
        rank=rank, step=step, action="kill_agent").to_json()}


def test_clean_run_matches_inprocess(tmp_path, reference):
    out = _run(tmp_path, 2, {}, None)
    _check(reference, out, {0: 1, 1: 1})
    assert "mpmd bubble: stage0=" in out["fleetop"]
    assert "stage1=" in out["fleetop"]


def test_stage_kill_mid_shipment_recovers_bitwise(tmp_path, reference):
    out = _run(tmp_path, 2, _kill(1, 3), 1)
    _check(reference, out, {0: 1, 1: 2})
    assert any(k.startswith("2/") for k in out["audit"]["claims"])


def test_partition_heals_without_relaunch(tmp_path, reference):
    plan = FaultPlan().add(rank=1, step=2, action="partition_host",
                           target="1.5")
    out = _run(tmp_path, 2, {"TPU_SANDBOX_FAULT_PLAN": plan.to_json()}, 1)
    _check(reference, out, {0: 1, 1: 1})


def test_three_stage_zb_kill_in_the_middle_recovers_bitwise(tmp_path,
                                                           reference3):
    out = _run(tmp_path, N3, _kill(1, 3), 1, kind=KIND3,
               layer_split=LAYER_SPLIT)
    _check(reference3, out, {0: 1, 1: 2, 2: 1})
    assert any(k.startswith("2/") for k in out["audit"]["claims"])


def test_worker_without_device_runs_on_the_card_or_fails(tmp_path):
    """No ``--device``: the worker asks for the card, which this machine
    lacks, and exits with the device error instead of training on the
    CPU."""
    from tpu_sandbox_torch.runtime.kvstore import KVServer

    server = KVServer()
    try:
        argv = [a.format(agent_id=0, kv_port=server.port, job_id="solo")
                for a in _stage_argv(0, tmp_path, 1) if a != "--device"
                and a != "cpu"]
        proc = subprocess.run(argv, cwd=ROOT, env={**os.environ, **ENV},
                              capture_output=True, text=True, timeout=120)
    finally:
        server.stop()
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr
