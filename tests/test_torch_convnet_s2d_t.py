"""The port's ConvNetS2DT (tpu_sandbox_torch/models/convnet_s2d_t.py) ==
the JAX ConvNetS2DT on each plan: the scattered-3x3 conv1
(sparse_conv1=False) with fused_tail False and True, and the sparse-tap
conv1 with the fused conv1+tail backward, with the unfused conv1
backward, and with unfused tails. The resize weights, the fused input
stage, and at 32x32, batch 2, fp32 from bridged weights the logits, the
loss, every gradient and the BN running stats; bf16 logits; eval mode;
and pick_convnet's plan, options and fused_tail resolution (the NHWC
plan, and 'auto' on the CPU, in tests/test_torch_convnet_s2d.py). The JAX side
runs its Pallas kernels in interpret mode on the CPU; the port runs its
kernels' plain PyTorch versions."""

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
from tpu_sandbox_torch import mnist_onegpu
from tpu_sandbox_torch.models import (
    ConvNet,
    ConvNetS2D,
    pick_convnet,
    resolve_fused_tail,
)
from tpu_sandbox_torch.models.convnet_s2d_t import (
    ConvNetS2DT,
    block_max_pool_t,
    resize_weights,
)
from tpu_sandbox_torch.ops.losses import cross_entropy_loss
from tpu_sandbox_torch.utils.bridge import params_from_flax, params_to_flax

HW = (32, 32)


#: the plans with the sparse conv1, as (fused_tail, fused_conv1_bwd):
#: the JAX package's whole chip plan, its unfused conv1 backward, and the
#: unfused tails (where fused_conv1_bwd has no effect)
SPARSE_PLANS = [(True, True), (True, False), (False, True)]


def _plan(fused_tail=False, sparse_conv1=False, fused_conv1_bwd=True):
    return dict(fused_tail=fused_tail, sparse_conv1=sparse_conv1,
                fused_conv1_bwd=fused_conv1_bwd)


def _jax_model(dtype=jnp.float32, **plan):
    return JaxConvNetS2DT(dtype=dtype, **_plan(**plan))


def _jax_case(**plan):
    """One JAX forward+backward at 32x32, batch 2, fp32, as numpy."""
    rng = np.random.default_rng(0)
    images = rng.random((2, 28, 28, 1), dtype=np.float32)
    labels = rng.integers(0, 10, size=2).astype(np.int32)
    jm = _jax_model(**plan)
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
                grads=to_np(grads), stats=to_np(stats), plan=_plan(**plan))


@pytest.fixture(scope="module")
def case():
    return _jax_case(fused_tail=False)


@pytest.fixture(scope="module")
def fused_case():
    return _jax_case(fused_tail=True)


@pytest.fixture(scope="module", params=SPARSE_PLANS,
                ids=lambda p: f"fused_tail{int(p[0])}-fused_bwd{int(p[1])}")
def sparse_case(request):
    fused_tail, fused_conv1_bwd = request.param
    return _jax_case(fused_tail=fused_tail, sparse_conv1=True,
                     fused_conv1_bwd=fused_conv1_bwd)


def _torch_model(variables, dtype=torch.float32, **plan):
    model = ConvNetS2DT(HW, dtype=dtype, device="cpu", **_plan(**plan))
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


def _check_step_against_jax(case):
    model = _torch_model(case["variables"], **case["plan"])
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


def test_logits_loss_grads_and_stats_match_jax(case):
    _check_step_against_jax(case)


def test_fused_tail_logits_loss_grads_and_stats_match_jax(fused_case):
    """The fused plan: conv stats kernels feeding the fused tails, forward
    and backward, against JAX's fused plan with the same tolerances."""
    _check_step_against_jax(fused_case)


def test_sparse_conv1_logits_loss_grads_and_stats_match_jax(sparse_case):
    """The sparse-tap conv1 plans: the JAX package's whole chip plan
    (fused tails and the fused conv1+tail backward), its unfused conv1
    backward, and the unfused tails, against JAX's same plan with the
    same tolerances."""
    _check_step_against_jax(sparse_case)


def _check_bf16_logits(case):
    jm = _jax_model(jnp.bfloat16, **case["plan"])
    x = jax_prepare_inputs(jm, case["images"], HW)
    want, _ = jm.apply(case["variables"], x, train=True,
                       mutable=["batch_stats"])
    model = _torch_model(case["variables"], torch.bfloat16, **case["plan"])
    got = model(model.fused_input_stage(torch.from_numpy(case["images"]), HW))
    _close(got.detach().numpy(), np.asarray(want), 3e-2, "bf16 logits")


def test_bf16_logits_match_jax(case):
    """bf16 compute over f32 params: both frameworks round at the same
    points (weight before the scatter, conv output once, BN output before
    ReLU); the remaining difference is a few bf16 ulps."""
    _check_bf16_logits(case)


def test_fused_tail_bf16_logits_match_jax(fused_case):
    """The same on the fused plan: z rounds to bf16 before the ReLU and
    the pool on both sides."""
    _check_bf16_logits(fused_case)


def test_sparse_conv1_bf16_logits_match_jax(sparse_case):
    """The same on the sparse conv1 plans: the weight rounds to bf16
    before the scatter and y1 once, on both sides."""
    _check_bf16_logits(sparse_case)


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


@pytest.mark.parametrize("kwargs", [dict(plan="s2d"), dict(plan="plain")])
def test_unported_plans_raise(kwargs):
    """Every plan is ported now and none raises: 's2d' gives ConvNetS2D
    and 'plain' the plain ConvNet."""
    want = {"s2d": ConvNetS2D, "plain": ConvNet}[kwargs["plan"]]
    assert type(pick_convnet(HW, device="cpu", **kwargs)) is want


@pytest.mark.parametrize("option", ["sparse_conv1", "fused_conv1_bwd"])
@pytest.mark.parametrize("value", [False, True])
def test_pick_convnet_honours_the_conv1_options(option, value):
    model = pick_convnet(HW, plan="s2dt", device="cpu", **{option: value})
    assert getattr(model, option) is value
    assert model.conv1.sparse is (value if option == "sparse_conv1" else True)


def test_pick_convnet_gives_the_ported_plan():
    """The transposed plan with the JAX module's defaults under 's2dt';
    'auto' on the CPU gives the NHWC plan, as JAX's rule does where its
    kernels would run interpreted."""
    model = pick_convnet(32, plan="s2dt", device="cpu")
    assert isinstance(model, ConvNetS2DT)
    # the JAX module's defaults: the sparse conv1, the fused conv1 backward
    assert model.sparse_conv1 is True and model.fused_conv1_bwd is True
    assert model.conv1.sparse and not model.conv2.sparse
    assert isinstance(pick_convnet(32, device="cpu"), ConvNetS2D)
    assert isinstance(pick_convnet(30, device="cpu"), ConvNet)


def test_pick_convnet_on_the_card_runs_the_whole_chip_plan(monkeypatch):
    """On a CUDA device pick_convnet gives ConvNetS2DT(fused_tail=True,
    sparse_conv1=True, fused_conv1_bwd=True): checked with the device
    resolution and the model stubbed, as this machine has no card."""
    import tpu_sandbox_torch.models as models

    got = {}
    monkeypatch.setattr(models, "resolve_device",
                        lambda device: torch.device("cuda"))
    monkeypatch.setattr(models, "ConvNetS2DT",
                        lambda image_size, **kw: got.update(kw) or kw)
    models.pick_convnet(3000)
    assert got["fused_tail"] is True and got["sparse_conv1"] is True
    assert got["fused_conv1_bwd"] is True
    assert got["device"] == torch.device("cuda")


@pytest.mark.parametrize("fused_tail,device,want", [
    (None, "cuda", True), (None, "cpu", False), (True, "cpu", True),
    (False, "cuda", False), (True, "cuda", True), (False, "cpu", False)])
def test_fused_tail_resolves_by_device(fused_tail, device, want):
    """None: fused wherever the kernels run (a CUDA model), unfused on the
    CPU; an explicit value is kept on both."""
    assert resolve_fused_tail(fused_tail, torch.device(device)) is want


def test_pick_convnet_fuses_the_tail_on_request_only_on_the_cpu():
    assert pick_convnet(32, plan="s2dt", device="cpu").fused_tail is False
    assert pick_convnet(32, plan="s2dt", device="cpu",
                        fused_tail=True).fused_tail is True


@pytest.mark.parametrize("plan", ["s2d", "plain"])
def test_entry_plan_flag_raises_for_unported_plans(plan):
    """No plan raises now: --plan s2d trains ConvNetS2D (unfused on the
    CPU) and --plan plain the plain ConvNet."""
    argv = ["--force-cpu", "--plan", plan, "--image-size", "32",
            "--limit-steps", "1", "--epochs", "1", "--synthetic-n", "5",
            "--log-every", "1"]
    trainer, state = mnist_onegpu.main(argv)
    assert state.step == 1 and np.isfinite(trainer.losses).all()
    if plan == "plain":
        assert type(state.model) is ConvNet
        return
    assert isinstance(state.model, ConvNetS2D)
    assert not state.model.fused_conv and not state.model.fused_tail


def test_eval_mode_runs_the_unfused_tail_with_running_stats(case):
    """Eval ignores fused_tail: the same logits as the unfused model."""
    fused = _torch_model(case["variables"], fused_tail=True).eval()
    plain = _torch_model(case["variables"]).eval()
    x = plain.fused_input_stage(torch.from_numpy(case["images"]), HW)
    with torch.no_grad():
        assert torch.equal(fused(x), plain(x))


def test_eval_mode_sparse_conv1_runs_the_plain_forward_and_tail(case):
    """Eval on the sparse plans: the sparse forward without statistics and
    the plain tail with the running stats, whatever fused_tail and
    fused_conv1_bwd say; the logits equal across those options and match
    JAX's eval of the same plan (fp32, sums in other orders: 1e-5)."""
    models = [_torch_model(case["variables"], fused_tail=ft, sparse_conv1=True,
                           fused_conv1_bwd=fb).eval()
              for ft, fb in SPARSE_PLANS]
    x = models[0].fused_input_stage(torch.from_numpy(case["images"]), HW)
    with torch.no_grad():
        logits = [m(x) for m in models]
    for other in logits[1:]:
        assert torch.equal(other, logits[0])
    jm = _jax_model(fused_tail=True, sparse_conv1=True)
    want = jm.apply(case["variables"],
                    jax_prepare_inputs(jm, case["images"], HW), train=False)
    _close(logits[0].numpy(), np.asarray(want), 1e-5, "eval logits")


def test_model_needs_the_card_unless_the_cpu_is_asked_for():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present here")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ConvNetS2DT(HW)


# -- use_bn=False ------------------------------------------------------------

#: (fused_tail, sparse_conv1, fused_conv1_bwd): the card's default plan
#: and the scattered conv1; without BN the tail options change nothing
#: (the tails are plain and the convs run without statistics)
NO_BN_PLANS = [(True, True, True), (True, False, True)]


@pytest.fixture(scope="module", params=NO_BN_PLANS,
                ids=lambda p: "fused_tail{}-sparse{}-fused_bwd{}".format(
                    *map(int, p)))
def no_bn_case(request):
    fused_tail, sparse_conv1, fused_conv1_bwd = request.param
    plan = _plan(fused_tail, sparse_conv1, fused_conv1_bwd)
    rng = np.random.default_rng(0)
    images = rng.random((2, 28, 28, 1), dtype=np.float32)
    labels = rng.integers(0, 10, size=2).astype(np.int32)
    jm = JaxConvNetS2DT(dtype=jnp.float32, use_bn=False, **plan)
    variables = jm.init(jax.random.key(0), jnp.zeros((1, *HW, 1)), train=False)

    def loss_fn(params, images, labels):
        logits = jm.apply({"params": params},
                          jax_prepare_inputs(jm, images, HW), train=True)
        return jax_ce(logits, labels), logits

    (loss, logits), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], images, labels)
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return dict(images=images, labels=labels, variables=to_np(variables),
                loss=float(loss), logits=np.asarray(logits),
                grads=to_np(grads), plan=plan)


def test_use_bn_false_logits_loss_and_grads_match_jax(no_bn_case):
    """use_bn=False: ReLU and the block pool as each tail, the convs
    without statistics; no bn* in the tree (JAX has none), every gradient
    against JAX's same plan (fp32, sums in other orders: 1e-5 of the
    logits' scale, 1e-4 of each gradient's)."""
    case = no_bn_case
    model = ConvNetS2DT(HW, device="cpu", use_bn=False, **case["plan"])
    assert not any(k.startswith("bn") for k in model.state_dict())
    assert sorted(case["variables"]) == ["params"]
    model.load_state_dict(params_from_flax(case["variables"]))
    x = model.fused_input_stage(torch.from_numpy(case["images"]), HW)
    logits = model(x)
    loss = cross_entropy_loss(logits, torch.from_numpy(case["labels"]))
    loss.backward()
    _close(logits.detach().numpy(), case["logits"], 1e-5, "logits")
    np.testing.assert_allclose(loss.item(), case["loss"], rtol=1e-5)
    grads = {name: p.grad.numpy() for name, p in model.named_parameters()}
    assert sorted(grads) == sorted(
        f"{m}.{k}" for m, ls in case["grads"].items() for k in ls)
    for mod, leaves in case["grads"].items():
        for leaf, want in leaves.items():
            _close(grads[f"{mod}.{leaf}"], want, 1e-4, f"d{mod}.{leaf}")
    assert dict(model.named_buffers()) == {}
