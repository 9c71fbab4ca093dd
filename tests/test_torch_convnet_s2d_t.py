"""The port's ConvNetS2DT (tpu_sandbox_torch/models/convnet_s2d_t.py) ==
the JAX ConvNetS2DT(fused_tail=False, sparse_conv1=False): the resize
weights, the fused input stage, and at 32x32, batch 2, fp32 from bridged
weights the logits, the loss, every gradient and the BN running stats.
The JAX side runs its Pallas kernels in interpret mode on the CPU; the
port runs its kernels' plain PyTorch versions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_sandbox.models.convnet_s2d_t import ConvNetS2DT as JaxConvNetS2DT
from tpu_sandbox.models.convnet_s2d_t import block_max_pool_t as jax_pool
from tpu_sandbox.models.convnet_s2d_t import resize_weights as jax_resize_weights
from tpu_sandbox.ops.losses import cross_entropy_loss as jax_ce
from tpu_sandbox.train.trainer import prepare_inputs as jax_prepare_inputs
from tpu_sandbox_torch.models import pick_convnet
from tpu_sandbox_torch.models.convnet_s2d_t import (
    ConvNetS2DT,
    block_max_pool_t,
    resize_weights,
)
from tpu_sandbox_torch.ops.losses import cross_entropy_loss
from tpu_sandbox_torch.utils.bridge import params_from_flax, params_to_flax

HW = (32, 32)


def _jax_model(dtype=jnp.float32):
    return JaxConvNetS2DT(dtype=dtype, fused_tail=False, sparse_conv1=False)


@pytest.fixture(scope="module")
def case():
    """One JAX forward+backward at 32x32, batch 2, fp32, as numpy."""
    rng = np.random.default_rng(0)
    images = rng.random((2, 28, 28, 1), dtype=np.float32)
    labels = rng.integers(0, 10, size=2).astype(np.int32)
    jm = _jax_model()
    variables = jm.init(jax.random.key(0), jnp.zeros((1, *HW, 1)), train=False)

    def loss_fn(params, batch_stats, images, labels):
        x = jax_prepare_inputs(jm, images, HW)
        logits, mut = jm.apply({"params": params, "batch_stats": batch_stats},
                               x, train=True, mutable=["batch_stats"])
        return jax_ce(logits, labels), (logits, mut["batch_stats"])

    (loss, (logits, stats)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], variables["batch_stats"], images, labels)
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return dict(images=images, labels=labels, variables=to_np(variables),
                loss=float(loss), logits=np.asarray(logits),
                grads=to_np(grads), stats=to_np(stats))


def _torch_model(variables, dtype=torch.float32):
    model = ConvNetS2DT(HW, dtype=dtype, device="cpu")
    model.load_state_dict(params_from_flax(variables))
    return model


def _close(got, want, rel, what):
    """|got - want| <= rel * max|want| elementwise."""
    scale = float(np.max(np.abs(want))) or 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                               err_msg=what)


@pytest.mark.parametrize("src,dst", [(28, 32), (28, 3000), (28, 12), (5, 7)])
def test_resize_weights_match_jax(src, dst):
    # both compute in f32; the orders of the sums differ (a numpy
    # triangle kernel here, XLA's resize of the identity there)
    np.testing.assert_allclose(resize_weights(src, dst),
                               jax_resize_weights(src, dst), rtol=0, atol=5e-6)


def test_fused_input_stage_matches_jax():
    rng = np.random.default_rng(1)
    images = rng.random((3, 28, 28, 1), dtype=np.float32)
    want = np.asarray(_jax_model().fused_input_stage(jnp.asarray(images), HW))
    model = ConvNetS2DT(HW, device="cpu")
    got = model.fused_input_stage(torch.from_numpy(images), HW).numpy()
    assert got.shape == (3, 8, 16, 8)
    # two f32 contractions over 28 taps each, summed in other orders:
    # a few ulps of values in [0, 1]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_block_max_pool_t_ties_split_like_jax():
    """Equal inputs split the cotangent 0.5/0.5 in both frameworks."""
    y = np.zeros((1, 2, 4 * 4 * 3, 5), np.float32)
    y[..., ::7, :] = 1.0
    g = np.arange(2 * 4 * 3 * 5, dtype=np.float32).reshape(1, 2, 12, 5)
    _, vjp = jax.vjp(lambda t: jax_pool(t, 4, 3), jnp.asarray(y))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    t = torch.from_numpy(y).requires_grad_()
    block_max_pool_t(t, 4, 3).backward(torch.from_numpy(g))
    np.testing.assert_array_equal(t.grad.numpy(), want)


def test_logits_loss_grads_and_stats_match_jax(case):
    model = _torch_model(case["variables"])
    x = model.fused_input_stage(torch.from_numpy(case["images"]), HW)
    logits = model(x)
    loss = cross_entropy_loss(logits, torch.from_numpy(case["labels"]))
    loss.backward()
    # fp32 both sides; sums run in other orders (per-tap einsums here,
    # one 9C-deep dot there), so agreement is to ~1e-5 of the scale
    _close(logits.detach().numpy(), case["logits"], 1e-5, "logits")
    np.testing.assert_allclose(loss.item(), case["loss"], rtol=1e-5)
    grads = {name: p.grad.numpy() for name, p in model.named_parameters()}
    for mod, leaves in case["grads"].items():
        for leaf, want in leaves.items():
            if mod.startswith("conv") and leaf == "bias":
                # BN follows each conv, so the exact conv-bias gradient is
                # 0: both sides hold rounding noise of sums of O(1e-1)
                # terms, compared in absolute terms
                np.testing.assert_allclose(grads[f"{mod}.{leaf}"], want,
                                           rtol=0, atol=2e-5)
                continue
            _close(grads[f"{mod}.{leaf}"], want, 1e-4, f"d{mod}.{leaf}")
    got_stats = params_to_flax(model)["batch_stats"]
    for mod, leaves in case["stats"].items():
        for leaf, want in leaves.items():
            _close(got_stats[mod][leaf], want, 1e-5, f"{mod}.{leaf}")


def test_bf16_logits_match_jax(case):
    """bf16 compute over f32 params: both frameworks round at the same
    points (weight before the scatter, conv output once, BN output before
    ReLU); the remaining difference is a few bf16 ulps."""
    jm = _jax_model(jnp.bfloat16)
    x = jax_prepare_inputs(jm, case["images"], HW)
    want, _ = jm.apply(case["variables"], x, train=True,
                       mutable=["batch_stats"])
    model = _torch_model(case["variables"], torch.bfloat16)
    got = model(model.fused_input_stage(torch.from_numpy(case["images"]), HW))
    _close(got.detach().numpy(), np.asarray(want), 3e-2, "bf16 logits")


def test_bridge_round_trip_is_bitwise(case):
    model = _torch_model(case["variables"])
    back = params_to_flax(model)
    for coll, mods in case["variables"].items():
        for mod, leaves in mods.items():
            for leaf, want in leaves.items():
                got = back[coll][mod][leaf]
                assert got.dtype == want.dtype and got.shape == want.shape
                np.testing.assert_array_equal(got, want)


def test_param_tree_matches_jax(case):
    model = ConvNetS2DT(HW, device="cpu")
    got = {c: {m: {k: v.shape for k, v in ls.items()} for m, ls in t.items()}
           for c, t in params_to_flax(model).items()}
    want = {c: {m: {k: v.shape for k, v in ls.items()} for m, ls in t.items()}
            for c, t in case["variables"].items()}
    assert got == want


def test_same_seed_same_weights():
    a = ConvNetS2DT(HW, seed=3, device="cpu")
    b = ConvNetS2DT(HW, seed=3, device="cpu")
    for (na, pa), (_, pb) in zip(a.named_parameters(), b.named_parameters()):
        assert torch.equal(pa, pb), na


@pytest.mark.parametrize("kwargs", [
    dict(plan="s2d"), dict(plan="plain"), dict(fused_tail=True),
    dict(sparse_conv1=True), dict(fused_conv1_bwd=True)])
def test_unported_plans_raise(kwargs):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pick_convnet(HW, device="cpu", **kwargs)


def test_pick_convnet_gives_the_ported_plan():
    assert isinstance(pick_convnet(32, device="cpu"), ConvNetS2DT)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        pick_convnet(30, device="cpu")


def test_model_needs_the_card_unless_the_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ConvNetS2DT(HW)
