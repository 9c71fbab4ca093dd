"""The port's fused cross-entropy (tpu_sandbox_torch/ops/ce.py) == the
JAX pallas_cross_entropy with its Pallas kernel in interpret mode: the
mean loss and its gradient in fp32 and bf16, labels outside [0, C), the
vocabulary too wide for a row block, and the dispatch of
losses.cross_entropy_loss below and above 4096 classes. On the CPU the
port runs its kernel's plain version; chip_smoke.py holds the kernel
against it on the card."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from tpu_sandbox.ops.losses import cross_entropy_loss as jax_ce_loss
from tpu_sandbox.ops.pallas_ce import _block_rows as jax_block_rows
from tpu_sandbox.ops.pallas_ce import pallas_cross_entropy
from tpu_sandbox_torch.ops import ce, losses
from torch_threads import one_torch_thread  # noqa: F401

DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
# the loss, relative: fp32 the same f32 math in other summation orders;
# bf16 the same bf16 logits upcast exactly, then f32 math as in fp32, and
# the mean of 100 rows in another order
LOSS_RTOL = {"fp32": 1e-6, "bf16": 1e-3}
# the gradient, of max|ref|: f32 softmax in another order, rounded once to
# the logits' dtype
GRAD_TOL = {"fp32": 1e-6, "bf16": 1e-3}


def _case(n, c, dt, seed=0, labels=None):
    rng = np.random.default_rng(seed)
    x = (3 * rng.standard_normal((n, c))).astype(np.float32)
    lab = (rng.integers(0, c, size=n, dtype=np.int32) if labels is None
           else np.asarray(labels, np.int32))
    jd, td = DTYPES[dt]
    return ((jnp.asarray(x, jd), jnp.asarray(lab)),
            (torch.from_numpy(x).to(td).requires_grad_(),
             torch.from_numpy(lab)))


def _check(jx, jlab, tx, tlab, dt, fn=ce.cross_entropy):
    loss, vjp = jax.vjp(lambda x: pallas_cross_entropy(x, jlab, True), jx)
    (jg,) = vjp(jnp.ones((), jnp.float32))
    tloss = fn(tx, tlab)
    tloss.backward()
    assert tloss.dtype == torch.float32 and tx.grad.dtype == tx.dtype
    np.testing.assert_allclose(tloss.item(), float(loss),
                               rtol=LOSS_RTOL[dt])
    want = np.asarray(jnp.asarray(jg, jnp.float32))
    got = tx.grad.float().numpy()
    assert np.max(np.abs(got - want)) <= GRAD_TOL[dt] * np.max(np.abs(want))


@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_loss_and_grad_match_pallas_cross_entropy(dt):
    (jx, jlab), (tx, tlab) = _case(100, 4100, dt)
    _check(jx, jlab, tx, tlab, dt)


def test_labels_outside_the_classes_pick_nothing():
    """Negative labels and labels past the 128-padded classes pick 0 on
    both sides (the Pallas kernel's label in [C, round_up(C, 128)) would
    pick its -1e30 filler; that case is left out)."""
    (jx, jlab), (tx, tlab) = _case(6, 4100, "fp32",
                                   labels=[0, -1, 4099, 4224, 7, 99999])
    _check(jx, jlab, tx, tlab, "fp32")


def test_vocab_too_wide_for_a_row_block_takes_the_plain_loss():
    """C = 140,000: no row block fits the kernel's budget, so both sides
    take the plain loss (the same function)."""
    assert ce._block_rows(ce.round_up(140_000, ce.LANE)) is None
    (jx, jlab), (tx, tlab) = _case(2, 140_000, "fp32")
    _check(jx, jlab, tx, tlab, "fp32")


@pytest.mark.parametrize("cp", [128, 4224, 32768, 65536, 131072, 131200,
                                262144])
def test_block_rows_rule_is_the_jax_packages(cp):
    assert ce._block_rows(cp) == jax_block_rows(cp)


@pytest.mark.parametrize("c", [10, 4095, 4096, 4100])
def test_cross_entropy_loss_on_the_cpu_is_the_plain_loss(c):
    """On CPU tensors the dispatch takes the plain path on both sides of
    4096 classes, as the JAX package does off the TPU."""
    (jx, jlab), (tx, tlab) = _case(20, c, "fp32", seed=c)
    got = losses.cross_entropy_loss(tx, tlab)
    want = jax_ce_loss(jx, jlab)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)
    torch.testing.assert_close(got, F.cross_entropy(tx, tlab.long()))


def test_cross_entropy_loss_takes_the_kernel_off_the_cpu_from_4096():
    """Off the CPU (a meta tensor stands in for a card's) 4096 classes and
    up go to the fused CE, whose kernel wrapper refuses a non-CUDA tensor;
    below 4096 the plain loss runs."""
    lab = torch.zeros(4, dtype=torch.long, device="meta")
    small = losses.cross_entropy_loss(
        torch.empty((4, 4095), device="meta"), lab)
    assert small.device.type == "meta"
    with pytest.raises(ValueError, match="CUDA"):
        losses.cross_entropy_loss(torch.empty((4, 4096), device="meta"), lab)
