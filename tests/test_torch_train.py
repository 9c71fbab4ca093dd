"""The port's trainer (tpu_sandbox_torch/train/) == the JAX trainer: three
SGD steps from bridged weights on the same batches give the same losses
(fp32, rtol 1e-4) on each plan (the scattered-3x3 conv1 with the BN tails
unfused and fused; the sparse-tap conv1 with the fused conv1+tail
backward, with the unfused conv1 backward, and with unfused tails), and
the port's entry script prints the reference's log lines."""

import importlib.util
import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpu_sandbox.data import BatchLoader as JaxBatchLoader
from tpu_sandbox.data import normalize as jax_normalize
from tpu_sandbox.data import synthetic_mnist as jax_synthetic_mnist
from tpu_sandbox.models.convnet import ConvNet as JaxConvNet
from tpu_sandbox.models.convnet_s2d import ConvNetS2D as JaxConvNetS2D
from tpu_sandbox.models.convnet_s2d_t import ConvNetS2DT as JaxConvNetS2DT
from tpu_sandbox.train import TrainState as JaxTrainState
from tpu_sandbox.train import make_train_step as jax_make_train_step
from tpu_sandbox.train.trainer import resize_on_device as jax_resize
from tpu_sandbox_torch import mnist_onegpu
from tpu_sandbox_torch.data import BatchLoader, normalize, synthetic_mnist
from tpu_sandbox_torch.models import ConvNet, ConvNetS2D
from tpu_sandbox_torch.models.convnet_s2d_t import ConvNetS2DT
from tpu_sandbox_torch.train import TrainState, make_eval_step, make_train_step
from tpu_sandbox_torch.train.trainer import resize_on_device, to_device
from tpu_sandbox_torch.utils.bridge import params_from_flax, params_to_flax

ROOT = Path(__file__).resolve().parent.parent
HW = (32, 32)
STEPS, BS = 3, 2


def _check_three_sgd_steps(fused_tail, sparse_conv1=False,
                           fused_conv1_bwd=True):
    plan = dict(fused_tail=fused_tail, sparse_conv1=sparse_conv1,
                fused_conv1_bwd=fused_conv1_bwd)
    images, labels = synthetic_mnist(n=STEPS * BS, seed=0)
    jm = JaxConvNetS2DT(dtype=jnp.float32, **plan)
    tx = optax.sgd(1e-4)
    jstate = JaxTrainState.create(jm, jax.random.key(0),
                                  jnp.zeros((1, *HW, 1)), tx)
    variables = jax.tree.map(np.asarray, jstate.variables())
    jstep = jax_make_train_step(jm, tx, image_size=HW)
    jimages, jlabels = jax_synthetic_mnist(n=STEPS * BS, seed=0)
    jloader = JaxBatchLoader(jax_normalize(jimages), jlabels.astype("int32"),
                             BS, shuffle=True, seed=0)
    jlosses = []
    for im, lb in jloader:
        jstate, loss = jstep(jstate, im, lb)
        jlosses.append(float(loss))

    model = ConvNetS2DT(HW, device="cpu", **plan)
    model.load_state_dict(params_from_flax(variables))
    state = TrainState(model, lr=1e-4)
    step = make_train_step(state, image_size=HW)
    tloader = BatchLoader(normalize(images), labels.astype("int32"), BS,
                          shuffle=True, seed=0)
    losses = [float(step(*to_device(im, lb, torch.device("cpu"))))
              for im, lb in tloader]
    assert state.step == STEPS
    # fp32 both sides, sums in other orders: relative 1e-4 over 3 steps
    np.testing.assert_allclose(losses, jlosses, rtol=1e-4)
    got = params_to_flax(model)
    for coll in ("params", "batch_stats"):
        want = jax.tree.map(np.asarray, getattr(jstate, coll))
        for mod, leaves in want.items():
            for leaf, w in leaves.items():
                # conv biases start at 0 and BN cancels their gradient: both
                # sides move them by lr * rounding noise (~1e-10)
                zero_grad = mod.startswith("conv") and leaf == "bias"
                scale = float(np.max(np.abs(w))) or 1.0
                np.testing.assert_allclose(
                    got[coll][mod][leaf], w, rtol=0,
                    atol=1e-8 if zero_grad else 1e-5 * scale,
                    err_msg=f"{coll}/{mod}/{leaf}")


def test_three_sgd_steps_match_jax():
    _check_three_sgd_steps(fused_tail=False)


def test_three_sgd_steps_fused_tail_match_jax():
    """The same on the fused plan: the conv stats kernels and the fused
    BN/ReLU/pool tails, forward and backward."""
    _check_three_sgd_steps(fused_tail=True)


@pytest.mark.parametrize("fused_tail,fused_conv1_bwd",
                         [(True, True), (True, False), (False, True)])
def test_three_sgd_steps_sparse_conv1_match_jax(fused_tail, fused_conv1_bwd):
    """The same on the sparse-tap conv1 plans: the JAX package's whole
    chip plan, its unfused conv1 backward, and the unfused tails."""
    _check_three_sgd_steps(fused_tail, sparse_conv1=True,
                           fused_conv1_bwd=fused_conv1_bwd)


def test_resize_on_device_matches_jax():
    rng = np.random.default_rng(4)
    images = rng.random((2, 28, 28, 1), dtype=np.float32)
    want = np.asarray(jax_resize(jnp.asarray(images), (36, 20)))
    got = resize_on_device(torch.from_numpy(images), (36, 20)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_eval_step_counts_and_leaves_stats():
    model = ConvNetS2DT(HW, device="cpu")
    before = {k: v.clone() for k, v in model.named_buffers()}
    images, labels = synthetic_mnist(n=4, seed=1)
    correct, loss = make_eval_step(model, image_size=HW)(
        *to_device(normalize(images), labels, torch.device("cpu")))
    assert 0 <= int(correct) <= 4 and np.isfinite(float(loss))
    for k, v in model.named_buffers():
        assert torch.equal(v, before[k]), k


def _run_entry(*flags):
    env = {**os.environ, "MNIST_DIR": str(ROOT / "no-such-mnist-dir")}
    return subprocess.run(
        [sys.executable, "-m", "tpu_sandbox_torch.mnist_onegpu", *flags],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)


def test_entry_script_prints_reference_log_lines():
    proc = _run_entry("--force-cpu", "--image-size", "32", "--limit-steps",
                      "2", "--epochs", "1", "--synthetic-n", "10",
                      "--log-every", "1")
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert lines[0] == ("MNIST IDX files not found; using deterministic "
                        "synthetic MNIST")
    assert re.fullmatch(r"Epoch \[1/1\], Step \[1/2\], Loss: \d+\.\d{4}",
                        lines[1])
    assert re.fullmatch(r"Epoch \[1/1\], Step \[2/2\], Loss: \d+\.\d{4}",
                        lines[2])
    assert re.fullmatch(r"Training complete in: \d+:\d\d:\d\d(\.\d+)?",
                        lines[3])


def test_entry_script_needs_the_card_or_force_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present here")
    proc = _run_entry("--image-size", "32", "--limit-steps", "1")
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr


def test_entry_script_refuses_unported_flags():
    """The checkpoint flags are not ported yet: argparse refuses all
    three."""
    proc = _run_entry("--force-cpu", "--resume", "--ckpt-dir", "ck",
                      "--ckpt-every", "5")
    assert proc.returncode == 2
    assert ("unrecognized arguments: --resume --ckpt-dir ck --ckpt-every 5"
            in proc.stderr)


# -- gradient accumulation ---------------------------------------------------

def _accum_batch(n=8, hw=32, seed=0):
    rng = np.random.default_rng(seed)
    images = rng.standard_normal((n, hw, hw, 1), dtype=np.float32)
    labels = rng.integers(0, 10, size=n).astype(np.int32)
    return images, labels


def test_grad_accumulation_matches_full_batch():
    """Without BN, k = 4 accumulated microbatches == one full-batch step
    (the mean CE is the mean of equal-size microbatch means; SGD is
    linear), at JAX's own test's tolerances (tests/test_trainer.py)."""
    images, labels = _accum_batch()
    models_ = [ConvNet((32, 32), use_bn=False, device="cpu") for _ in "ab"]
    full = make_train_step(TrainState(models_[0], lr=1e-2))
    acc = make_train_step(TrainState(models_[1], lr=1e-2), accum_steps=4)
    batch = to_device(images, labels, torch.device("cpu"))
    np.testing.assert_allclose(float(full(*batch)), float(acc(*batch)),
                               rtol=1e-5)
    for (name, a), (_, b) in zip(models_[0].named_parameters(),
                                 models_[1].named_parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=2e-5, atol=2e-6, err_msg=name)


def test_grad_accumulation_with_bn_trains():
    """With BN the two differ by design (statistics per microbatch); the
    accumulated step still trains and counts one step per call."""
    images, labels = synthetic_mnist(n=16, seed=0)
    state = TrainState(ConvNet((28, 28), device="cpu"), lr=1e-2)
    step = make_train_step(state, accum_steps=2)
    batch = to_device(normalize(images), labels, torch.device("cpu"))
    losses = [float(step(*batch)) for _ in range(8)]
    assert losses[-1] < losses[0], losses
    assert state.step == 8


@pytest.mark.parametrize("plan", ["plain", "s2d"])
def test_accumulated_step_matches_jax(plan):
    """Two steps of k = 2 accumulation, resized per microbatch, from
    bridged weights on equal batches: the port's losses, parameters and BN
    running stats against JAX's accumulated step (fp32, sums in other
    orders: losses rtol 1e-5, parameters 1e-5 of each leaf's scale)."""
    jm = JaxConvNet() if plan == "plain" else JaxConvNetS2D()
    tx = optax.sgd(1e-2)
    jstate = JaxTrainState.create(jm, jax.random.key(0),
                                  jnp.zeros((1, *HW, 1)), tx)
    variables = jax.tree.map(np.asarray, jstate.variables())
    jstep = jax_make_train_step(jm, tx, image_size=HW, accum_steps=2,
                                donate=False)
    cls = ConvNet if plan == "plain" else ConvNetS2D
    model = cls(HW, device="cpu")
    model.load_state_dict(params_from_flax(variables))
    state = TrainState(model, lr=1e-2)
    step = make_train_step(state, image_size=HW, accum_steps=2)
    images, labels = synthetic_mnist(n=8, seed=2)
    jlosses, losses = [], []
    for i in (0, 4):
        im, lb = normalize(images[i:i + 4]), labels[i:i + 4].astype("int32")
        jstate, loss = jstep(jstate, im, lb)
        jlosses.append(float(loss))
        losses.append(float(step(*to_device(im, lb, torch.device("cpu")))))
    np.testing.assert_allclose(losses, jlosses, rtol=1e-5)
    assert state.step == 2 and int(jstate.step) == 2
    got = params_to_flax(model)
    for coll in ("params", "batch_stats"):
        want = jax.tree.map(np.asarray, getattr(jstate, coll))
        for mod, leaves in want.items():
            for leaf, w in leaves.items():
                zero_grad = mod.startswith("conv") and leaf == "bias"
                scale = float(np.max(np.abs(w))) or 1.0
                np.testing.assert_allclose(
                    got[coll][mod][leaf], w, rtol=0,
                    atol=1e-7 if zero_grad else 1e-5 * scale,
                    err_msg=f"{coll}/{mod}/{leaf}")


def test_accum_steps_below_one_or_not_dividing_the_batch_fail():
    state = TrainState(ConvNet((28, 28), use_bn=False, device="cpu"))
    with pytest.raises(ValueError, match="accum_steps must be >= 1"):
        make_train_step(state, accum_steps=0)
    step = make_train_step(state, accum_steps=3)
    images, labels = _accum_batch(n=5, hw=28)
    with pytest.raises(ValueError, match="not divisible by accum_steps 3"):
        step(*to_device(images, labels, torch.device("cpu")))


def _jax_script():
    spec = importlib.util.spec_from_file_location("jax_mnist_onegpu",
                                                  ROOT / "mnist_onegpu.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("flags", [["--accum-steps", "0"],
                                   ["--accum-steps", "3"]])
def test_entry_script_accum_steps_fail_like_the_jax_script(flags):
    """--accum-steps 0, and 3 into batch 5, stop both scripts with the
    same SystemExit message before anything is built."""
    args = mnist_onegpu.build_parser().parse_args(["--force-cpu", *flags])
    with pytest.raises(SystemExit) as want:
        _jax_script().train(0, args)
    with pytest.raises(SystemExit) as got:
        mnist_onegpu.train(args)
    assert str(got.value) == str(want.value)
    assert "--accum-steps" in str(got.value)


def test_entry_script_accum_steps_trains_on_microbatches(capsys):
    """--accum-steps 5 at batch 5: one update a batch on five microbatches
    of one image; the ragged tail (2 of 12 images) is dropped."""
    trainer, state = mnist_onegpu.main([
        "--force-cpu", "--image-size", "32", "--synthetic-n", "12",
        "--epochs", "1", "--accum-steps", "5", "--log-every", "1",
        "--data-dir", str(ROOT / "no-such-mnist-dir")])
    assert state.step == 2 and len(trainer.losses) == 2
    assert np.isfinite(trainer.losses).all()
    assert "Step [2/2]" in capsys.readouterr().out
