"""The loss-curve protocol of ``parity_run.py`` (:70-130), held against the
port: the JAX package trains its plain ``ConvNet`` from ``jax.random.key(0)``
with ``optax.sgd(1e-4)`` in fp32 on synthetic MNIST resized once on the
host to 128x128, batch 5, in the batch order of
``np.random.default_rng(0).permutation(2000)[:5]`` per step; the port
trains the same bridged tree on the same arrays with its own trainer on
each of its three plans: the plain ``ConvNet``, ``ConvNetS2D`` with its
CPU defaults and ``ConvNetS2DT`` with the card's default options (the
fused tails, the sparse conv1 and the fused conv1+tail backward, here
their plain versions). Each port curve must stay within the committed
record of ``parity_curves.jsonl:401`` (the JAX package against its own
torch twin over 400 steps): max abs deviation 1.173e-3, max relative
0.143 %, mean abs 4.7e-5.

Tier-1 runs 30 steps a plan (and 20 with ``use_bn=False``); the same
protocol over the record's whole 400 steps is marked slow (about a
minute and a half on the CPU), and prints each plan's summary beside the
JAX package's own ``ConvNetS2D`` against its plain ``ConvNet`` on the
same protocol (the reference's spread between two of its plans):

    JAX_PLATFORMS=cpu python -m pytest -m slow -s tests/test_torch_loss_curve.py
"""

import functools

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
from tpu_sandbox_torch.utils.bridge import params_from_flax

N_DATA, IMAGE, BS, LR = 2000, 128, 5, 1e-4
#: parity_curves.jsonl:401, the committed record
BAR = {"max_abs_dev": 1.173e-3, "max_rel_dev": 1.43e-3, "mean_abs_dev": 4.7e-5}
#: (plan id, model class, options)
PLANS = [
    ("plain", ConvNet, {}),
    ("s2d", ConvNetS2D, {}),
    ("s2dt", ConvNetS2DT, dict(fused_tail=True, sparse_conv1=True,
                               fused_conv1_bwd=True)),
]


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


@functools.lru_cache(maxsize=4)
def _jax_curve(steps: int, use_bn: bool, s2d: bool = False):
    """JAX's plain ConvNet curve (or, with ``s2d``, its ConvNetS2D's from
    the same tree) and the initial variables (numpy)."""
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
    losses = []
    for sel in order[:steps]:
        state, loss = step(state, jnp.asarray(resized[sel]),
                           jnp.asarray(labels[sel].astype(np.int32)))
        losses.append(float(loss))
    return np.asarray(losses), jax.tree.map(np.asarray, variables)


def _port_curve(cls, options, variables, steps: int, use_bn: bool):
    resized, labels, order = _data()
    model = cls((IMAGE, IMAGE), device="cpu", use_bn=use_bn, **options)
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


def _check(plan, steps, use_bn=True, spread=False):
    _, cls, options = next(p for p in PLANS if p[0] == plan)
    want, variables = _jax_curve(steps, use_bn)
    got = _port_curve(cls, options, variables, steps, use_bn)
    summary = curve_summary(got, want)
    print(f"{plan} use_bn={use_bn} steps={steps}: {summary}")
    if spread:
        jax_s2d, _ = _jax_curve(steps, use_bn, s2d=True)
        print(f"JAX ConvNetS2D against JAX ConvNet, steps={steps}: "
              f"{curve_summary(jax_s2d, want)}")
    assert np.isfinite(got).all() and len(got) == steps
    for key, limit in BAR.items():
        assert summary[key] <= limit, (key, summary)


@pytest.mark.parametrize("plan", [p[0] for p in PLANS])
def test_30_steps_follow_the_jax_curve(plan):
    _check(plan, 30)


@pytest.mark.parametrize("plan", [p[0] for p in PLANS])
def test_20_steps_without_bn_follow_the_jax_curve(plan):
    _check(plan, 20, use_bn=False)


@pytest.mark.slow
@pytest.mark.parametrize("plan", [p[0] for p in PLANS])
def test_400_steps_follow_the_jax_curve(plan):
    _check(plan, 400, spread=True)
