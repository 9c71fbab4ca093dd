"""The port's trainer (tpu_sandbox_torch/train/) == the JAX trainer: three
SGD steps from bridged weights on the same batches give the same losses
(fp32, rtol 1e-4), and the port's entry script prints the reference's
log lines."""

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
from tpu_sandbox.models.convnet_s2d_t import ConvNetS2DT as JaxConvNetS2DT
from tpu_sandbox.train import TrainState as JaxTrainState
from tpu_sandbox.train import make_train_step as jax_make_train_step
from tpu_sandbox.train.trainer import resize_on_device as jax_resize
from tpu_sandbox_torch.data import BatchLoader, normalize, synthetic_mnist
from tpu_sandbox_torch.models.convnet_s2d_t import ConvNetS2DT
from tpu_sandbox_torch.train import TrainState, make_eval_step, make_train_step
from tpu_sandbox_torch.train.trainer import resize_on_device, to_device
from tpu_sandbox_torch.utils.bridge import params_from_flax, params_to_flax

ROOT = Path(__file__).resolve().parent.parent
HW = (32, 32)
STEPS, BS = 3, 2


def test_three_sgd_steps_match_jax():
    images, labels = synthetic_mnist(n=STEPS * BS, seed=0)
    jm = JaxConvNetS2DT(dtype=jnp.float32, fused_tail=False,
                        sparse_conv1=False)
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

    model = ConvNetS2DT(HW, device="cpu")
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
    proc = _run_entry("--force-cpu", "--plan", "s2dt")
    assert proc.returncode == 2
    assert "unrecognized arguments" in proc.stderr
