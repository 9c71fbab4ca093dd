"""The port's MPMD pipeline (tpu_sandbox_torch/mpmd/driver.py) against
JAX's ``MPMDPipeline`` and the port's own SPMD ``PipelineParallel``, and
the contracts of JAX's tests/test_mpmd.py and
tests/test_mpmd_fastfabric.py on the port: bitwise kill-and-recover,
leader GC, ZB-H1 against 1F1B, a bitwise ZB rerun and a 3-stage ZB kill.

JAX's small config (vocab 64, d 32, 2 heads, 4 layers, d_ff 64, fp32), 2
stages, 4 microbatches, 21 Adam steps at 1e-2 from the tree JAX drew, on
one batch [8, 16] (the measured figures: ``tools/mpmd_spread.py``):

- against JAX's ``MPMDPipeline``: losses within LOSS_ATOL (1e-6; measured
  6.0e-7), every parameter within PARAM_ATOL (1e-4; measured 8.3e-6) but
  the key slice of each ``attn.qkv.bias``. That slice's gradient is zero
  in exact arithmetic (a key bias adds q . b_k to every score of a row,
  which the softmax cancels), so what each package computes for it is
  rounding noise, and Adam normalises noise to steps of about lr: the two
  packages' key biases walk apart by up to lr a step (measured 7.3e-3
  after 21 steps). It is held to the walk's bound, lr x steps, on both
  sides instead. JAX's own MPMD and SPMD engines, on this setup, differ
  by up to 2.7e-6 outside the key slices and 6.1e-3 on them.
- against the port's ``PipelineParallel`` on {"data": 1, "pipe": 2}, two
  gloo ranks spawned once for the module: losses and parameters bitwise
  (the MPMD fold of the microbatch grads is the SPMD backward's order).

Recovery and schedule variants are held bitwise against the port's own
unfaulted runs, as JAX holds them against its own.
"""

import os
import time

import jax
import numpy as np
import optax
import pytest
import torch

from torch_dist_workers import mpmd_spmd_worker
from tpu_sandbox.models.transformer import TransformerConfig as JConfig
from tpu_sandbox.models.transformer import TransformerLM as JLM
from tpu_sandbox.mpmd import MPMDPipeline as JPipeline
from tpu_sandbox_torch.models.transformer import TransformerConfig
from tpu_sandbox_torch.mpmd import MPMDPipeline
from tpu_sandbox_torch.mpmd.schedule import autotune_plan
from tpu_sandbox_torch.mpmd.transport import DeviceTransport, LocalTransport
from tpu_sandbox_torch.obs import ENV_TRACE_DIR, get_recorder, reset_recorder
from tpu_sandbox_torch.obs import collect, critpath
from tpu_sandbox_torch.parallel.launch import spawn
from tpu_sandbox_torch.train.optim import SGD, Adam, constant_schedule
from tpu_sandbox_torch.utils.bridge import params_from_flax
from torch_threads import one_torch_thread  # noqa: F401

CFG = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=4, d_ff=64,
           max_len=64)
M, STEPS, LR = 4, 21, 1e-2
LOSS_ATOL, PARAM_ATOL = 1e-6, 1e-4
#: the bubble's bar between the recorded spans and the online gauge
#: (bench.py's bench_mpmd)
BUBBLE_TOL = 0.03


def _batch():
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 64, size=(8, 16)).astype(np.int32)
    return tokens, ((tokens + 7) % 64).astype(np.int32)


def _adam(params):
    return Adam(params, constant_schedule(LR))


def _sgd(params):
    return SGD(params, 0.1, momentum=0.0)


def _pipe(tx=_adam, **kw):
    kw.setdefault("n_stages", 2)
    return MPMDPipeline(TransformerConfig(**CFG), tx, microbatches=M,
                        devices="cpu", **kw)


def _bitwise(ref: dict, got: dict) -> list[str]:
    """Names of the leaves that differ (values, as JAX's array_equal)."""
    assert sorted(ref) == sorted(got)
    return [k for k in sorted(ref) if not torch.equal(ref[k], got[k])]


@pytest.fixture(scope="module")
def flat():
    tokens, _ = _batch()
    return jax.tree.map(np.asarray, JLM(JConfig(**CFG)).init(
        jax.random.key(0), tokens)["params"])


@pytest.fixture(scope="module")
def init(flat):
    return params_from_flax({"params": flat})


@pytest.fixture(scope="module")
def jax_run(flat):
    tokens, targets = _batch()
    pipe = JPipeline(JConfig(**CFG), optax.adam(LR), n_stages=2,
                     microbatches=M, devices=jax.devices()[:2])
    pipe.init_from_flat(flat)
    losses = pipe.train(STEPS, tokens, targets)
    return {"losses": losses, "params": params_from_flax(
        {"params": jax.tree.map(np.asarray, pipe.merged_params())})}


@pytest.fixture(scope="module")
def port_run(init):
    pipe = _pipe()
    pipe.init_from_flat(init)
    losses = pipe.train(STEPS, *_batch())
    return {"pipe": pipe, "losses": losses, "params": pipe.merged_params()}


@pytest.fixture(scope="module")
def spmd_run(tmp_path_factory, init):
    tmp = tmp_path_factory.mktemp("mpmd_spmd")
    torch.save({"cfg": CFG, "lr": LR, "microbatches": M, "steps": STEPS,
                "params": init, "batch": _batch()}, tmp / "inputs.pt")
    spawn(mpmd_spmd_worker, 2, str(tmp), str(tmp / "inputs.pt"),
          init_method=f"file://{tmp}/store", timeout=240)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(2)]


def test_pipeline_matches_jaxs_mpmd_pipeline(port_run, jax_run, init):
    np.testing.assert_allclose(port_run["losses"], jax_run["losses"],
                               rtol=0, atol=LOSS_ATOL)
    ref, got = jax_run["params"], port_run["params"]
    assert sorted(ref) == sorted(got)
    for name in ref:
        a, b = ref[name].numpy(), got[name].numpy()
        if name.endswith("attn.qkv.bias"):
            walk = LR * STEPS
            start = init[name][1].numpy()
            assert np.abs(a[1] - start).max() <= walk, name
            assert np.abs(b[1] - start).max() <= walk, name
            a, b = np.delete(a, 1, 0), np.delete(b, 1, 0)
        np.testing.assert_allclose(b, a, rtol=0, atol=PARAM_ATOL,
                                   err_msg=name)
    # each stage ran its own programs: the wire carried every slot
    s = port_run["pipe"].transport.stats
    assert s.puts == s.gets == STEPS * M * 2 and s.bytes_out == s.bytes_in
    claims = port_run["pipe"].transport.audit()["claims"]
    assert claims and all(v == 1 for v in claims.values())
    assert 0.0 < port_run["pipe"].bubble_fraction() < 1.0


def test_pipeline_matches_the_ports_spmd_pipeline(port_run, spmd_run):
    for r, res in enumerate(spmd_run):
        assert res["losses"] == port_run["losses"], f"rank {r}"
        assert not _bitwise(res["merged"], port_run["params"]), f"rank {r}"


def test_stage_kill_recovers_bitwise(port_run, init, tmp_path):
    """Stage 1 dies mid-step (between two transport ops); the driver
    respawns it at generation 1, it restores its own checkpoint and
    replays from durable slots: bitwise the unfaulted params, no
    microbatch lost or applied twice."""
    pipe = _pipe(ckpt_root=str(tmp_path), get_timeout=30.0)
    pipe.init_from_flat(init)
    pipe.workers[1].fail_at = (7, 3)
    losses = pipe.train(STEPS, *_batch(), recover=True)
    assert not _bitwise(port_run["params"], pipe.merged_params())
    assert losses == port_run["losses"]
    assert pipe.workers[1].generation == 1
    claims = pipe.transport.audit()["claims"]
    assert not {k: v for k, v in claims.items() if v != 1}
    assert any(k.endswith("/1") for k in claims)   # the replay's claims
    for w in pipe.workers:
        assert sorted(set(w.applied_steps)) == sorted(w.applied_steps)


def test_leader_gc_releases_applied_slots(init, tmp_path):
    pipe = _pipe(ckpt_root=str(tmp_path))
    pipe.init_from_flat(init)
    pipe.train(6, *_batch())
    assert pipe._released_through >= 0
    for step in range(pipe._released_through + 1):
        for mb in range(M):
            assert not pipe.transport.poll("act0", step, mb)
            assert not pipe.transport.poll("grad0", step, mb)


# -- ZB-H1 (tests/test_mpmd_fastfabric.py's cases) -----------------------------


def _train3(init, kind, transport, steps=3, **kw):
    pipe = _pipe(tx=kw.pop("tx", _sgd), n_stages=3, transport=transport,
                 kind=kind, layer_split=[2, 1, 1], **kw)
    pipe.init_from_flat(init)
    return pipe, pipe.train(steps, *_batch(), recover="ckpt_root" in kw)


def test_zb_h1_matches_the_fused_backward(init):
    """ZB-H1's split backward on the uneven [2, 1, 1] split is the fused
    1F1B backward's math: JAX's bars (losses 1e-6, parameters rtol 2e-5
    atol 1e-6); the device tier carried the traffic; the measured costs
    make a well-formed plan."""
    fused, fused_losses = _train3(init, "1f1b", LocalTransport())
    zb, zb_losses = _train3(init, "zb_h1", DeviceTransport())
    np.testing.assert_allclose(zb_losses, fused_losses, rtol=0, atol=1e-6)
    ref, got = fused.merged_params(), zb.merged_params()
    for name in ref:
        np.testing.assert_allclose(got[name].numpy(), ref[name].numpy(),
                                   rtol=2e-5, atol=1e-6, err_msg=name)
    assert zb.transport.stats.device_hits > 0
    assert zb.transport.stats.journal_fallbacks == 0
    costs = zb.measured_op_costs()
    assert {"F", "W", "A"} <= set(costs[0]) and "B" not in costs[0]
    assert {"F", "B", "W", "A"} <= set(costs[1])
    assert {"B", "W", "A"} <= set(costs[2]) and "F" not in costs[2]
    plan = autotune_plan(costs, n_stages=3, measured_microbatches=4,
                         candidates=(2, 4, 8))
    assert plan["kind"] in ("1f1b", "zb_h1")
    assert plan["microbatches"] in (2, 4, 8)


def test_zb_h1_rerun_is_bitwise(init):
    a, losses_a = _train3(init, "zb_h1", DeviceTransport())
    b, losses_b = _train3(init, "zb_h1", DeviceTransport())
    assert losses_a == losses_b
    assert not _bitwise(a.merged_params(), b.merged_params())


def test_three_stage_zb_kill_in_the_middle_recovers_bitwise(init, tmp_path):
    """The middle stage of the uneven ZB-H1 pipeline dies mid-schedule
    (its B cotangents half shipped, its W reserve un-run): bitwise its
    unfaulted twin, zero duplicate claims."""
    ref, ref_losses = _train3(init, "zb_h1", DeviceTransport(), steps=5,
                              tx=_adam)
    pipe = _pipe(tx=_adam, n_stages=3, transport=DeviceTransport(),
                 kind="zb_h1", layer_split=[2, 1, 1],
                 ckpt_root=str(tmp_path), get_timeout=30.0)
    pipe.init_from_flat(init)
    pipe.workers[1].fail_at = (3, 4)
    losses = pipe.train(5, *_batch(), recover=True)
    assert losses == ref_losses
    assert not _bitwise(ref.merged_params(), pipe.merged_params())
    assert [w.generation for w in pipe.workers] == [0, 1, 0]
    claims = pipe.transport.audit()["claims"]
    assert not {k: v for k, v in claims.items() if v != 1}


# -- the trace ------------------------------------------------------------------


def test_complete_holds_the_callers_end_and_duration(tmp_path):
    """``Recorder.complete`` writes the span's duration from the caller's
    own end time or duration when given (the stage worker passes the
    readings its gauge is computed from), else from now."""
    import json

    from tpu_sandbox_torch.obs.record import Recorder

    rec = Recorder(str(tmp_path / "spans.jsonl"), proc="t")
    rec.complete("by_end", 10.0, end=10.25)
    rec.complete("by_dur", 5.0, dur=0.5, end=99.0)
    rec.complete("now", time.monotonic())
    rec.close()
    spans = {r["name"]: r for r in map(json.loads, open(
        tmp_path / "spans.jsonl")) if r.get("ph") == "X"}
    assert spans["by_end"]["ts"] == 10.0
    assert spans["by_end"]["dur"] == 0.25
    assert spans["by_dur"]["dur"] == 0.5
    assert 0.0 <= spans["now"]["dur"] < 5.0


def test_recorded_bubble_agrees_with_the_online_gauge(init, tmp_path):
    """``critpath.bubble_fractions`` over the recorded stage spans of a
    run agrees with each worker's ``bubble_by_step`` (the gauge) within
    BUBBLE_TOL, every (stage, step)."""
    prior = os.environ.get(ENV_TRACE_DIR)
    os.environ[ENV_TRACE_DIR] = str(tmp_path)
    reset_recorder()
    try:
        pipe = _pipe()
        pipe.init_from_flat(init)
        pipe.train(4, *_batch())
        get_recorder().flush()
    finally:
        if prior is None:
            os.environ.pop(ENV_TRACE_DIR, None)
        else:
            os.environ[ENV_TRACE_DIR] = prior
        reset_recorder()
    rows = critpath.bubble_fractions(
        collect.load_merged(str(tmp_path)))["per_step"]
    assert len(rows) == 2 * 4
    for row in rows:
        online = pipe.workers[row["stage"]].bubble_by_step[row["step"]]
        assert abs(row["bubble"] - online) <= BUBBLE_TOL, row
