"""The port's ConvNetS2D (tpu_sandbox_torch/models/convnet_s2d.py) == the
JAX ConvNetS2D on its four plans, (fused_conv, fused_tail) each on or
off: at 32x32, batch 2, fp32 from bridged weights the logits, the loss,
every gradient and the BN running stats; bf16 logits; eval mode; the
parameter tree, which is also ConvNetS2DT's; space_to_depth and
block_max_pool; resolve_plan and pick_convnet against JAX's rule case by
case; and three SGD steps of the s2d plan through the trainer. The JAX
side runs its Pallas kernels in interpret mode on the CPU; the port runs
its kernels' plain PyTorch versions."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import tpu_sandbox.models as jax_models
from tpu_sandbox.data import BatchLoader as JaxBatchLoader
from tpu_sandbox.data import normalize as jax_normalize
from tpu_sandbox.data import synthetic_mnist as jax_synthetic_mnist
from tpu_sandbox.models.convnet_s2d import ConvNetS2D as JaxConvNetS2D
from tpu_sandbox.models.convnet_s2d import block_max_pool as jax_pool
from tpu_sandbox.models.convnet_s2d import space_to_depth as jax_s2d
from tpu_sandbox.models.convnet_s2d_t import ConvNetS2DT as JaxConvNetS2DT
from tpu_sandbox.ops.losses import cross_entropy_loss as jax_ce
from tpu_sandbox.train import TrainState as JaxTrainState
from tpu_sandbox.train import make_train_step as jax_make_train_step
from tpu_sandbox.train.trainer import prepare_inputs as jax_prepare_inputs
import tpu_sandbox_torch.models as models
from tpu_sandbox_torch.data import BatchLoader, normalize, synthetic_mnist
from tpu_sandbox_torch.models.convnet_s2d import (
    ConvNetS2D,
    block_max_pool,
    space_to_depth,
)
from tpu_sandbox_torch.models.convnet_s2d_t import ConvNetS2DT
from tpu_sandbox_torch.ops.losses import cross_entropy_loss
from tpu_sandbox_torch.train import TrainState, make_train_step
from tpu_sandbox_torch.train.trainer import prepare_inputs, to_device
from tpu_sandbox_torch.utils.bridge import params_from_flax, params_to_flax

HW = (32, 32)
#: (fused_conv, fused_tail)
PLANS = [(False, False), (False, True), (True, False), (True, True)]


def _plan_id(p):
    return f"fused_conv{int(p[0])}-fused_tail{int(p[1])}"


def _jax_case(fused_conv, fused_tail):
    """One JAX forward+backward at 32x32, batch 2, fp32, as numpy."""
    rng = np.random.default_rng(0)
    images = rng.random((2, 28, 28, 1), dtype=np.float32)
    labels = rng.integers(0, 10, size=2).astype(np.int32)
    plan = dict(fused_conv=fused_conv, fused_tail=fused_tail)
    jm = JaxConvNetS2D(dtype=jnp.float32, **plan)
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
                grads=to_np(grads), stats=to_np(stats), plan=plan)


@pytest.fixture(scope="module", params=PLANS, ids=_plan_id)
def case(request):
    return _jax_case(*request.param)


def _torch_model(variables, dtype=torch.float32, **plan):
    model = ConvNetS2D(HW, dtype=dtype, device="cpu", **plan)
    model.load_state_dict(params_from_flax(variables))
    return model


def _close(got, want, rel, what):
    """|got - want| <= rel * max|want| elementwise."""
    scale = float(np.max(np.abs(want))) or 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                               err_msg=what)


def test_space_to_depth_and_block_max_pool_match_jax():
    """The layout helpers bitwise, and the pool's tie split 0.5/0.5."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 8, 12)).astype(np.float32)
    np.testing.assert_array_equal(space_to_depth(torch.from_numpy(x), 4),
                                  np.asarray(jax_s2d(jnp.asarray(x), 4)))
    y = np.zeros((1, 2, 5, 4 * 4 * 3), np.float32)
    y[..., ::7] = 1.0
    g = np.arange(2 * 5 * 12, dtype=np.float32).reshape(1, 2, 5, 12)
    out, vjp = jax.vjp(lambda t: jax_pool(t, 4, 3), jnp.asarray(y))
    t = torch.from_numpy(y).requires_grad_()
    got = block_max_pool(t, 4, 3)
    np.testing.assert_array_equal(got.detach().numpy(), np.asarray(out))
    got.backward(torch.from_numpy(g))
    np.testing.assert_array_equal(t.grad.numpy(),
                                  np.asarray(vjp(jnp.asarray(g))[0]))


def test_logits_loss_grads_and_stats_match_jax(case):
    model = _torch_model(case["variables"], **case["plan"])
    logits = model(prepare_inputs(model, torch.from_numpy(case["images"]), HW))
    loss = cross_entropy_loss(logits, torch.from_numpy(case["labels"]))
    loss.backward()
    # fp32 both sides; sums run in other orders (per-tap einsums or
    # F.conv2d here, one 9C-deep dot or lax.conv there), so agreement is
    # to ~1e-5 of the scale
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
    ReLU, the fc in bf16); the remaining difference is a few bf16 ulps."""
    jm = JaxConvNetS2D(dtype=jnp.bfloat16, **case["plan"])
    x = jax_prepare_inputs(jm, case["images"], HW)
    want, _ = jm.apply(case["variables"], x, train=True,
                       mutable=["batch_stats"])
    model = _torch_model(case["variables"], torch.bfloat16, **case["plan"])
    got = model(prepare_inputs(model, torch.from_numpy(case["images"]), HW))
    assert got.dtype == torch.float32
    _close(got.detach().numpy(), np.asarray(want), 3e-2, "bf16 logits")


def test_eval_mode_runs_the_plain_tail_with_running_stats(case):
    """Eval ignores fused_tail (and takes no statistics in the conv): the
    logits match JAX's eval of the same plan (fp32, sums in other orders:
    1e-5)."""
    model = _torch_model(case["variables"], **case["plan"]).eval()
    x = prepare_inputs(model, torch.from_numpy(case["images"]), HW)
    with torch.no_grad():
        got = model(x)
    jm = JaxConvNetS2D(dtype=jnp.float32, **case["plan"])
    want = jm.apply(case["variables"],
                    jax_prepare_inputs(jm, case["images"], HW), train=False)
    _close(got.numpy(), np.asarray(want), 1e-5, "eval logits")


def test_param_tree_matches_jax_and_bridges_bitwise(case):
    model = _torch_model(case["variables"], **case["plan"])
    back = params_to_flax(model)
    for coll, mods in case["variables"].items():
        for mod, leaves in mods.items():
            for leaf, want in leaves.items():
                got = back[coll][mod][leaf]
                assert got.dtype == want.dtype and got.shape == want.shape
                np.testing.assert_array_equal(got, want)
    fresh = {c: {m: {k: v.shape for k, v in ls.items()} for m, ls in t.items()}
             for c, t in params_to_flax(ConvNetS2D(HW, device="cpu")).items()}
    want = {c: {m: {k: v.shape for k, v in ls.items()} for m, ls in t.items()}
            for c, t in case["variables"].items()}
    assert fresh == want


def test_jax_s2dt_tree_loads_and_same_seed_matches_s2dt():
    """A JAX ConvNetS2DT variable tree loads into ConvNetS2D as it is, and
    one seed draws both port plans the same weights."""
    tree = JaxConvNetS2DT(dtype=jnp.float32).init(
        jax.random.key(1), jnp.zeros((1, *HW, 1)), train=False)
    model = ConvNetS2D(HW, device="cpu")
    model.load_state_dict(params_from_flax(jax.tree.map(np.asarray, tree)))
    a = ConvNetS2D(HW, seed=3, device="cpu").state_dict()
    b = ConvNetS2DT(HW, seed=3, device="cpu").state_dict()
    assert sorted(a) == sorted(b)
    for key, t in a.items():
        assert torch.equal(t, b[key]), key


# -- the plan switch against JAX's rule ------------------------------------

#: (image size, plan, options)
PICK_CASES = [
    (32, "auto", {}), (32, "s2d", {}), (32, "s2dt", {}), (32, "plain", {}),
    (30, "auto", {}), (30, "s2d", {}), (30, "s2dt", {}),
    (32, "auto", dict(fused_conv=False)), (32, "s2dt", dict(fused_conv=False)),
    (32, "s2d", dict(fused_conv=True, fused_tail=False)),
    (32, "auto", dict(fused_tail=True)), (32, "auto", dict(fused_tail=False)),
    (32, "auto", dict(sparse_conv1=False)),
    (32, "s2d", dict(fused_conv1_bwd=False, sparse_conv1=False)),
    (32, "s2dt", dict(sparse_conv1=False, fused_conv1_bwd=False)),
]
_OPTIONS = ("fused_tail", "fused_conv", "sparse_conv1", "fused_conv1_bwd")


def _jax_pick(device, size, plan, options, monkeypatch):
    """JAX's (plan, options) for this request, "compiled" read as "the
    device is CUDA" (TPU_SANDBOX_FORCE_COMPILED_KERNELS makes JAX's rule
    take the compiled branch); None where JAX gives a space-to-depth
    ConvNet that cannot take the size."""
    if device == "cuda":
        monkeypatch.setenv("TPU_SANDBOX_FORCE_COMPILED_KERNELS", "1")
    else:
        monkeypatch.delenv("TPU_SANDBOX_FORCE_COMPILED_KERNELS", raising=False)
    resolved = jax_models.resolve_plan(size, plan)
    m = jax_models.pick_convnet(size, plan=plan, **options)
    name = type(m).__name__
    if name != "ConvNet" and size % 4:
        return resolved, None
    return resolved, (name, {k: getattr(m, k) for k in _OPTIONS
                             if hasattr(m, k)})


def _cpu_checked(cls):
    """A stand-in for the model class ``cls`` that builds the real model
    on the CPU (so its shape checks run) and returns (cls, kwargs)."""
    real = getattr(models, cls)

    def build(hw, **kw):
        real(hw, **{**kw, "device": "cpu"})
        return cls, kw
    return build


def _port_pick(device, size, plan, options, monkeypatch):
    if device == "cuda":
        # the tests may run without a card: the device resolution and the
        # models are stubbed, so the rule itself is what runs
        monkeypatch.setattr(models, "resolve_device",
                            lambda d: torch.device("cuda"))
        for cls in ("ConvNet", "ConvNetS2D", "ConvNetS2DT"):
            monkeypatch.setattr(models, cls, _cpu_checked(cls))
    resolved = models.resolve_plan(size, plan, device)
    try:
        m = models.pick_convnet(size, plan=plan, device=device, **options)
    except ValueError as e:
        # an explicit s2d plan at a size not divisible by 4: the model's
        # own shape check, as JAX's model fails on its shape assertion
        assert "divisible by 4" in str(e) and size % 4
        return resolved, None
    if device == "cuda":
        name, kw = m
        assert kw["device"] == torch.device("cuda")
        return resolved, (name, {k: v for k, v in kw.items() if k in _OPTIONS})
    return resolved, (type(m).__name__, {k: getattr(m, k) for k in _OPTIONS
                                         if hasattr(m, k)})


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("size,plan,options", PICK_CASES,
                         ids=lambda v: str(v).replace(" ", ""))
def test_resolve_plan_and_pick_convnet_follow_jax(device, size, plan,
                                                  options, monkeypatch):
    """The same concrete plan, model and options as JAX's rule on each
    device (the plain ConvNet with the space-to-depth options dropped);
    where JAX gives a model that cannot take an image not divisible by 4,
    the port's model raises its shape error."""
    want = _jax_pick(device, size, plan, options, monkeypatch)
    got = _port_pick(device, size, plan, options, monkeypatch)
    assert got == want


@pytest.mark.parametrize("plan", ["s2d", "s2dt"])
def test_explicit_s2d_plan_off_the_4_grid_fails_like_jax(plan, monkeypatch):
    """pick_convnet((30, 30), plan=...) with an explicit space-to-depth
    plan: JAX resolves it to that plan and its model fails on its shape
    assertion; the port resolves it the same way and its model raises its
    shape error (it does not fall back to the plain ConvNet)."""
    monkeypatch.delenv("TPU_SANDBOX_FORCE_COMPILED_KERNELS", raising=False)
    jm = jax_models.pick_convnet((30, 30), plan=plan)
    assert jax_models.resolve_plan((30, 30), plan) == plan
    assert type(jm).__name__ == {"s2d": "ConvNetS2D",
                                 "s2dt": "ConvNetS2DT"}[plan]
    with pytest.raises(AssertionError, match="30"):
        jm.init(jax.random.key(0), jnp.zeros((1, 30, 30, 1)))
    assert models.resolve_plan((30, 30), plan, "cpu") == plan
    with pytest.raises(ValueError, match="divisible by 4"):
        models.pick_convnet((30, 30), plan=plan, device="cpu")


# -- the trainer ------------------------------------------------------------


@pytest.mark.parametrize("fused", [False, True], ids=["unfused", "fused"])
def test_three_sgd_steps_of_plan_s2d_match_jax(fused):
    """--plan s2d through the trainer: three SGD steps from bridged
    weights on the same batches, the convs and tails both fused or both
    not; losses within rtol 1e-4 (fp32, sums in other orders) and the
    trained parameters and running stats within 1e-5 of the scale."""
    steps, bs = 3, 2
    plan = dict(fused_conv=fused, fused_tail=fused)
    jm = JaxConvNetS2D(dtype=jnp.float32, **plan)
    tx = optax.sgd(1e-4)
    jstate = JaxTrainState.create(jm, jax.random.key(0),
                                  jnp.zeros((1, *HW, 1)), tx)
    variables = jax.tree.map(np.asarray, jstate.variables())
    jstep = jax_make_train_step(jm, tx, image_size=HW)
    jimages, jlabels = jax_synthetic_mnist(n=steps * bs, seed=0)
    jlosses = []
    for im, lb in JaxBatchLoader(jax_normalize(jimages),
                                 jlabels.astype("int32"), bs, shuffle=True,
                                 seed=0):
        jstate, loss = jstep(jstate, im, lb)
        jlosses.append(float(loss))

    model = models.pick_convnet(HW, plan="s2d", device="cpu", **plan)
    assert isinstance(model, ConvNetS2D)
    model.load_state_dict(params_from_flax(variables))
    state = TrainState(model, lr=1e-4)
    step = make_train_step(state, image_size=HW)
    images, labels = synthetic_mnist(n=steps * bs, seed=0)
    losses = [float(step(*to_device(im, lb, torch.device("cpu"))))
              for im, lb in BatchLoader(normalize(images),
                                        labels.astype("int32"), bs,
                                        shuffle=True, seed=0)]
    assert state.step == steps
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


# -- use_bn=False ------------------------------------------------------------

#: without BN fused_tail changes nothing: the tails are plain and the
#: convs run without statistics, so the fused and the unfused conv
NO_BN_PLANS = [(False, True), (True, True)]


@pytest.fixture(scope="module", params=NO_BN_PLANS, ids=_plan_id)
def no_bn_case(request):
    fused_conv, fused_tail = request.param
    plan = dict(fused_conv=fused_conv, fused_tail=fused_tail)
    rng = np.random.default_rng(0)
    images = rng.random((2, 28, 28, 1), dtype=np.float32)
    labels = rng.integers(0, 10, size=2).astype(np.int32)
    jm = JaxConvNetS2D(dtype=jnp.float32, use_bn=False, **plan)
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
    """use_bn=False on each (fused_conv, fused_tail) plan: ReLU and the
    block pool as each tail, the convs without statistics; no bn* in the
    tree (JAX has none), every gradient against JAX's same plan (fp32,
    sums in other orders: 1e-5 of the logits' scale, 1e-4 of each
    gradient's)."""
    case = no_bn_case
    model = ConvNetS2D(HW, device="cpu", use_bn=False, **case["plan"])
    assert not any(k.startswith("bn") for k in model.state_dict())
    assert sorted(case["variables"]) == ["params"]
    model.load_state_dict(params_from_flax(case["variables"]))
    logits = model(prepare_inputs(model, torch.from_numpy(case["images"]), HW))
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
