"""The loss-curve protocol of ``parity_run.py`` (:70-130), held against the
port: the JAX package trains from ``jax.random.key(0)``'s plain-ConvNet
tree with ``optax.sgd(1e-4)`` in fp32 on synthetic MNIST resized once on
the host to 128x128, batch 5, in the batch order of
``np.random.default_rng(0).permutation(2000)[:5]`` per step; the port
trains the same bridged tree on the same arrays with its own trainer on
each of its three plans: the plain ``ConvNet``, ``ConvNetS2D`` with its
CPU defaults and ``ConvNetS2DT`` with the card's default options (the
fused tails, the sparse conv1 and the fused conv1+tail backward, here
their plain versions).

Each plan is held against the JAX model that computes the same function:
the plain ``ConvNet`` against JAX's ``ConvNet``, both space-to-depth plans
against JAX's ``ConvNetS2D`` (JAX's ``ConvNetS2DT`` always runs its Pallas
kernels, too slow in interpret mode at this size).

- Teacher-forced, per step: for k = 1..30 the JAX state after step k-1 is
  bridged into the port, which runs step k; its loss, parameters and BN
  statistics must equal JAX's step k within ``TEACHER_TOL``. This is the
  check that the port computes JAX's step.
- Free-running, the curve: each port curve must stay within the committed
  record's own spread over the same window, the summary (max abs, max
  relative, mean abs deviation) of the record's two curves in
  ``parity_curves.jsonl`` over those steps: lines 1-30 for the tier-1
  window, line 401's summary for all 400 steps. Without BN (20 steps)
  every plan is held to line 401's bar against JAX's plain ConvNet.

Tier-1 runs 30 steps a plan (and 20 with ``use_bn=False``); the same
protocol over the record's whole 400 steps is marked slow (about a
minute and a half on the CPU), and prints each plan's summary beside the
JAX package's own ``ConvNetS2D`` against its plain ``ConvNet`` on the
same protocol (the reference's spread between two of its plans):

    JAX_PLATFORMS=cpu python -m pytest -m slow -s tests/test_torch_loss_curve.py
"""

import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpu_sandbox.data.mnist import normalize as jax_normalize
from tpu_sandbox.data.mnist import synthetic_mnist as jax_synthetic_mnist
from tpu_sandbox.models import ConvNet as JaxConvNet
from tpu_sandbox.models import ConvNetS2D as JaxConvNetS2D
from tpu_sandbox.train import TrainState as JaxTrainState
from tpu_sandbox.train import make_train_step as jax_make_train_step
from tpu_sandbox_torch.models import ConvNet, ConvNetS2D, ConvNetS2DT
from tpu_sandbox_torch.train import TrainState, make_train_step
from tpu_sandbox_torch.utils.bridge import params_from_flax, params_to_flax

RECORD = Path(__file__).resolve().parent.parent / "parity_curves.jsonl"
N_DATA, IMAGE, BS, LR = 2000, 128, 5, 1e-4
#: (plan id, model class, options, JAX model of the same function is s2d)
PLANS = [
    ("plain", ConvNet, {}, False),
    ("s2d", ConvNetS2D, {}, True),
    ("s2dt", ConvNetS2DT, dict(fused_tail=True, sparse_conv1=True,
                               fused_conv1_bwd=True), True),
]
BAR_KEYS = ("max_abs_dev", "max_rel_dev", "mean_abs_dev")
#: the teacher-forced step against JAX's: |loss| and every parameter and
#: BN statistic, absolute (the fp32 steps agree to about 1e-6)
TEACHER_TOL = {"loss": 1e-5, "state": 5e-6}


@pytest.fixture(autouse=True, scope="module")
def _two_torch_threads():
    """The port's 128x128 steps on two threads: the test workers share the
    machine's cores, and more threads a worker only contend."""
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=1)
def _data():
    """parity_run.py:70-88: the resized arrays and the batch order."""
    images, labels = jax_synthetic_mnist(n=N_DATA, seed=0)
    images = jax_normalize(images[:N_DATA])
    labels = labels[:N_DATA].astype(np.int64)
    resized = np.asarray(jax.image.resize(
        jnp.asarray(images), (N_DATA, IMAGE, IMAGE, 1), method="bilinear"))
    rng = np.random.default_rng(0)
    order = [rng.permutation(N_DATA)[:BS] for _ in range(400)]
    return resized, labels, order


def _record_summary(steps: int) -> dict:
    """The record's own spread: its summary line (line 401) for the whole
    400 steps, else the summary of its two curves over lines 1..steps."""
    lines = [json.loads(line) for line in RECORD.read_text().splitlines()]
    if steps == len(lines) - 1:
        return {k: lines[-1]["summary"][k] for k in BAR_KEYS}
    rows = lines[:steps]
    got = np.asarray([r["tpu_sandbox"] for r in rows])
    want = np.asarray([r["torch"] for r in rows])
    return {k: curve_summary(got, want)[k] for k in BAR_KEYS}


@functools.lru_cache(maxsize=4)
def _jax_run(steps: int, use_bn: bool, s2d: bool = False,
             keep_states: bool = False):
    """JAX's plain ConvNet (or, with ``s2d``, its ConvNetS2D) trained from
    the plain ConvNet's init: the losses, the initial variables and, with
    ``keep_states``, the variables after every step (numpy; index k is
    the state after k steps)."""
    resized, labels, order = _data()
    x0 = jnp.zeros((1, IMAGE, IMAGE, 1))
    variables = JaxConvNet(use_bn=use_bn).init(jax.random.key(0), x0,
                                              train=False)
    model = JaxConvNetS2D(use_bn=use_bn) if s2d else JaxConvNet(use_bn=use_bn)
    tx = optax.sgd(LR)
    state = JaxTrainState.create(model, jax.random.key(0), x0, tx)
    state = state.replace(params=variables["params"],
                          batch_stats=variables.get("batch_stats", {}))
    step = jax_make_train_step(model, tx, donate=False)
    variables = jax.tree.map(np.asarray, variables)
    losses, states = [], [variables]
    for sel in order[:steps]:
        state, loss = step(state, jnp.asarray(resized[sel]),
                           jnp.asarray(labels[sel].astype(np.int32)))
        losses.append(float(loss))
        if keep_states:
            states.append(jax.tree.map(np.asarray, {
                "params": state.params, "batch_stats": state.batch_stats}))
    return np.asarray(losses), variables, states


def _port_model(plan: str, use_bn: bool = True):
    _, cls, options, _ = next(p for p in PLANS if p[0] == plan)
    return cls((IMAGE, IMAGE), device="cpu", use_bn=use_bn, **options)


def _port_curve(plan, variables, steps: int, use_bn: bool):
    resized, labels, order = _data()
    model = _port_model(plan, use_bn)
    model.load_state_dict(params_from_flax(variables))
    step = make_train_step(TrainState(model, lr=LR))
    return np.asarray([
        float(step(torch.from_numpy(resized[sel]),
                   torch.from_numpy(labels[sel])))
        for sel in order[:steps]])


def curve_summary(got: np.ndarray, want: np.ndarray) -> dict:
    """parity_run.py's summary of two curves, ``want`` the reference."""
    abs_dev = np.abs(got - want)
    rel_dev = abs_dev / np.maximum(np.abs(want), 1e-8)
    return {"max_abs_dev": float(abs_dev.max()),
            "max_rel_dev": float(rel_dev.max()),
            "mean_abs_dev": float(abs_dev.mean()),
            "final_loss": float(got[-1]), "final_loss_jax": float(want[-1])}


def _check(plan, steps, use_bn=True, spread=False, same_function=True,
           window=True):
    """``same_function=False`` holds the plan against JAX's plain ConvNet;
    ``window=False`` takes line 401's bar whatever the steps."""
    s2d = same_function and next(p[3] for p in PLANS if p[0] == plan)
    # the 30-step BN runs share the teacher-forced test's cached run
    want, variables, _ = _jax_run(steps, use_bn, s2d,
                                  keep_states=use_bn and steps == 30)
    got = _port_curve(plan, variables, steps, use_bn)
    summary = curve_summary(got, want)
    bar = _record_summary(steps if window else 400)
    print(f"{plan} use_bn={use_bn} steps={steps} against JAX's "
          f"{'ConvNetS2D' if s2d else 'ConvNet'}: {summary}; bar {bar}")
    if spread:
        jax_plain, _, _ = _jax_run(steps, use_bn)
        jax_s2d, _, _ = _jax_run(steps, use_bn, s2d=True)
        print(f"JAX ConvNetS2D against JAX ConvNet, steps={steps}: "
              f"{curve_summary(jax_s2d, jax_plain)}")
    assert np.isfinite(got).all() and len(got) == steps
    for key, limit in bar.items():
        assert summary[key] <= limit, (key, summary, bar)


@pytest.mark.parametrize("first", [1, 11, 21])
@pytest.mark.parametrize("plan", [p[0] for p in PLANS])
def test_each_step_is_jaxs_step_from_jaxs_state(plan, first):
    """Teacher-forced: from JAX's state after step k-1 the port's step k
    gives JAX's loss, parameters and BN statistics of step k (steps
    ``first`` to ``first + 9``; the JAX run is shared)."""
    s2d = next(p[3] for p in PLANS if p[0] == plan)
    want, _, states = _jax_run(30, True, s2d, keep_states=True)
    resized, labels, order = _data()
    model = _port_model(plan)
    step = make_train_step(TrainState(model, lr=LR))
    for k in range(first, first + 10):
        sel = order[k - 1]
        model.load_state_dict(params_from_flax(states[k - 1]))
        loss = float(step(torch.from_numpy(resized[sel]),
                          torch.from_numpy(labels[sel])))
        assert abs(loss - want[k - 1]) <= TEACHER_TOL["loss"], (k, loss)
        got = params_from_flax(params_to_flax(model))
        for name, ref in params_from_flax(states[k]).items():
            err = float((got[name] - ref).abs().max())
            assert err <= TEACHER_TOL["state"], (k, name, err)


@pytest.mark.parametrize("plan", [p[0] for p in PLANS])
def test_30_steps_follow_the_jax_curve(plan):
    _check(plan, 30)


@pytest.mark.parametrize("plan", [p[0] for p in PLANS])
def test_20_steps_without_bn_follow_the_jax_curve(plan):
    """Without BN the plans stay within 5e-7 of JAX's plain ConvNet: held
    to line 401's bar."""
    _check(plan, 20, use_bn=False, same_function=False, window=False)


@pytest.mark.slow
@pytest.mark.parametrize("plan", [p[0] for p in PLANS])
def test_400_steps_follow_the_jax_curve(plan):
    _check(plan, 400, spread=True)
