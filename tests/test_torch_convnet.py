"""The port's plain ConvNet (tpu_sandbox_torch/models/convnet.py) == the JAX
ConvNet (tpu_sandbox/models/convnet.py): at 32x32 and at 30x30 (not
divisible by 4), batch 2, fp32 from bridged weights, with and without BN,
the logits, the loss, every gradient and the BN running stats; bf16
logits; eval mode; the pool's tie rule (the whole gradient on a window's
first maximum) in f32 and bf16; the parameter tree, which is also the
space-to-depth plans' tree, and one seed giving the three plans the same
state dict; the plan rule for 'plain' and for 'auto' off the 4-grid; and
``mnist_onegpu --plan plain`` on the CPU."""

import re

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_sandbox.models as jax_models
from tpu_sandbox.models.convnet import ConvNet as JaxConvNet
from tpu_sandbox.ops.losses import cross_entropy_loss as jax_ce
import tpu_sandbox_torch.models as models
from tpu_sandbox_torch import mnist_onegpu
from tpu_sandbox_torch.models import ConvNet, ConvNetS2D, ConvNetS2DT
from tpu_sandbox_torch.models.convnet import max_pool
from tpu_sandbox_torch.ops.losses import cross_entropy_loss
from tpu_sandbox_torch.utils.bridge import params_from_flax, params_to_flax

#: (H, W, use_bn)
CASES = [(32, 32, True), (32, 32, False), (30, 30, True), (30, 30, False)]


def _case_id(c):
    return f"{c[0]}x{c[1]}-bn{int(c[2])}"


def _jax_case(h, w, use_bn):
    """One JAX forward+backward, batch 2, fp32, as numpy."""
    rng = np.random.default_rng(0)
    images = rng.random((2, h, w, 1), dtype=np.float32)
    labels = rng.integers(0, 10, size=2).astype(np.int32)
    jm = JaxConvNet(dtype=jnp.float32, use_bn=use_bn)
    variables = jm.init(jax.random.key(0), jnp.zeros((1, h, w, 1)),
                        train=False)

    def loss_fn(params, batch_stats, images, labels):
        vs = {"params": params, "batch_stats": batch_stats}
        logits, mut = jm.apply(vs, images, train=True,
                               mutable=["batch_stats"])
        return jax_ce(logits, labels), (logits, mut.get("batch_stats", {}))

    (loss, (logits, stats)), grads = jax.jit(
        jax.value_and_grad(loss_fn, has_aux=True))(
        variables["params"], variables.get("batch_stats", {}), images,
        labels)
    to_np = lambda t: jax.tree.map(np.asarray, t)  # noqa: E731
    return dict(hw=(h, w), use_bn=use_bn, images=images, labels=labels,
                variables=to_np(variables), loss=float(loss),
                logits=np.asarray(logits), grads=to_np(grads),
                stats=to_np(stats))


@pytest.fixture(scope="module", params=CASES, ids=_case_id)
def case(request):
    return _jax_case(*request.param)


def _torch_model(case, dtype=torch.float32):
    model = ConvNet(case["hw"], dtype=dtype, use_bn=case["use_bn"],
                    device="cpu")
    model.load_state_dict(params_from_flax(case["variables"]))
    return model


def _close(got, want, rel, what):
    """|got - want| <= rel * max|want| elementwise."""
    scale = float(np.max(np.abs(want))) or 1.0
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                               err_msg=what)


def _shapes(tree):
    return {c: {m: {k: v.shape for k, v in ls.items()} for m, ls in t.items()}
            for c, t in tree.items() if t}


def test_logits_loss_grads_and_stats_match_jax(case):
    model = _torch_model(case)
    logits = model(torch.from_numpy(case["images"]))
    loss = cross_entropy_loss(logits, torch.from_numpy(case["labels"]))
    loss.backward()
    # fp32 both sides; the conv sums run in other orders (oneDNN here,
    # XLA's conv there), so agreement is to ~1e-5 of the scale
    _close(logits.detach().numpy(), case["logits"], 1e-5, "logits")
    np.testing.assert_allclose(loss.item(), case["loss"], rtol=1e-5)
    grads = {name: p.grad.numpy() for name, p in model.named_parameters()}
    assert sorted(grads) == sorted(
        f"{m}.{k}" for m, ls in case["grads"].items() for k in ls)
    for mod, leaves in case["grads"].items():
        for leaf, want in leaves.items():
            if case["use_bn"] and mod.startswith("conv") and leaf == "bias":
                # BN follows each conv, so the exact conv-bias gradient is
                # 0: both sides hold rounding noise, compared in absolute
                # terms
                np.testing.assert_allclose(grads[f"{mod}.{leaf}"], want,
                                           rtol=0, atol=2e-5)
                continue
            _close(grads[f"{mod}.{leaf}"], want, 1e-4, f"d{mod}.{leaf}")
    got_stats = params_to_flax(model)["batch_stats"]
    assert sorted(got_stats) == sorted(case["stats"])
    for mod, leaves in case["stats"].items():
        for leaf, want in leaves.items():
            _close(got_stats[mod][leaf], want, 1e-5, f"{mod}.{leaf}")


def test_bf16_logits_match_jax(case):
    """bf16 compute over f32 params: the input, kernels and biases cast to
    bf16 as nn.Conv(dtype=...) does, BN output rounded before ReLU, the fc
    in bf16; the convs' inner sums differ (one bf16 rounding of the
    output here, the bias added after it there): a few bf16 ulps."""
    jm = JaxConvNet(dtype=jnp.bfloat16, use_bn=case["use_bn"])
    want, _ = jm.apply(case["variables"], case["images"], train=True,
                       mutable=["batch_stats"])
    got = _torch_model(case, torch.bfloat16)(torch.from_numpy(case["images"]))
    assert got.dtype == torch.float32
    _close(got.detach().numpy(), np.asarray(want), 3e-2, "bf16 logits")


def test_eval_mode_uses_the_running_stats(case):
    """Eval mode: BN on the running statistics, which it leaves as they
    are; the logits match JAX's eval (fp32, sums in other orders: 1e-5)."""
    model = _torch_model(case).eval()
    before = {k: v.clone() for k, v in model.named_buffers()}
    with torch.no_grad():
        got = model(torch.from_numpy(case["images"]))
    want = JaxConvNet(dtype=jnp.float32, use_bn=case["use_bn"]).apply(
        case["variables"], case["images"], train=False)
    _close(got.numpy(), np.asarray(want), 1e-5, "eval logits")
    for k, v in model.named_buffers():
        assert torch.equal(v, before[k]), k


def test_param_tree_matches_jax_and_bridges_bitwise(case):
    """The same tree as JAX's (no bn* without BN), each leaf bitwise
    through the bridge, and a fresh model's tree shaped like JAX's."""
    back = params_to_flax(_torch_model(case))
    assert _shapes(back) == _shapes(case["variables"])
    for coll, mods in case["variables"].items():
        for mod, leaves in mods.items():
            for leaf, want in leaves.items():
                got = back[coll][mod][leaf]
                assert got.dtype == want.dtype
                np.testing.assert_array_equal(got, want)
    fresh = ConvNet(case["hw"], use_bn=case["use_bn"], device="cpu")
    assert _shapes(params_to_flax(fresh)) == _shapes(case["variables"])
    assert any(m.startswith("bn") for m in back["params"]) is case["use_bn"]


#: pool windows with two-, three- and four-way ties, and a lone maximum
TIE_WINDOWS = [
    [[1.0, 1.0], [0.0, 0.0]], [[0.0, 1.0], [0.0, 1.0]],
    [[0.5, 1.0], [1.0, 1.0]], [[2.0, 2.0], [2.0, 2.0]],
    [[0.0, 0.0], [0.0, 3.0]], [[1.5, 0.5], [1.5, 1.5]],
]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_pool_tie_gradient_goes_to_the_first_maximum_like_jax(dtype):
    """The pool's forward and backward bitwise JAX's nn.max_pool on
    windows that tie two, three and four ways: the whole upstream
    gradient goes to the first maximum in row-major window order. An odd
    row and column past the last window are floored away."""
    windows = np.asarray(TIE_WINDOWS, np.float32)              # [6, 2, 2]
    x = np.zeros((2, 5, 7, 2), np.float32)
    for i, win in enumerate(windows):
        n, c, r = i % 2, (i // 2) % 2, i // 4
        x[n, 2 * r:2 * r + 2, 2 * (i % 3):2 * (i % 3) + 2, c] = win
    g = np.random.default_rng(3).standard_normal((2, 2, 3, 2)).astype(
        np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    pool = lambda t: fnn.max_pool(t, (2, 2), strides=(2, 2))  # noqa: E731
    want, vjp = jax.vjp(pool, jnp.asarray(x, jdt))
    (want_dx,) = vjp(jnp.asarray(g, jdt))
    t = torch.from_numpy(x).to(tdt).requires_grad_()
    got = max_pool(t)
    got.backward(torch.from_numpy(g).to(tdt))
    np.testing.assert_array_equal(got.detach().float().numpy(),
                                  np.asarray(want, np.float32))
    np.testing.assert_array_equal(t.grad.float().numpy(),
                                  np.asarray(want_dx, np.float32))
    # the four-way tie at 2.0 (window 3: image 1, channel 1, top left):
    # its gradient sits wholly on the window's first element
    assert x[1, 0:2, 0:2, 1].tolist() == TIE_WINDOWS[3]
    assert t.grad[1, 0, 0, 1].item() == torch.tensor(g[1, 0, 0, 1]).to(tdt)
    assert t.grad[1, 0:2, 0:2, 1].count_nonzero() == 1


def test_one_seed_gives_the_three_plans_one_state_dict():
    a = ConvNet((32, 32), seed=3, device="cpu").state_dict()
    for cls in (ConvNetS2D, ConvNetS2DT):
        b = cls((32, 32), seed=3, device="cpu").state_dict()
        assert sorted(a) == sorted(b)
        for key, t in a.items():
            assert torch.equal(t, b[key]), (cls.__name__, key)


@pytest.mark.parametrize("device", ["cpu", "cuda"])
@pytest.mark.parametrize("size,plan", [(32, "plain"), (30, "plain"),
                                       (30, "auto"), ((30, 32), "auto")])
def test_plain_plan_follows_jax_rule_and_drops_the_s2d_options(
        device, size, plan, monkeypatch):
    """'plain', and 'auto' off the 4-grid, resolve to the plain ConvNet on
    both devices, as JAX's rule does, with the space-to-depth options
    dropped and use_bn passed through."""
    options = dict(fused_tail=True, fused_conv=True, sparse_conv1=False,
                   fused_conv1_bwd=False)
    if device == "cuda":
        monkeypatch.setenv("TPU_SANDBOX_FORCE_COMPILED_KERNELS", "1")
        monkeypatch.setattr(models, "resolve_device",
                            lambda d: torch.device("cuda"))
        got = {}
        monkeypatch.setattr(models, "ConvNet",
                            lambda hw, **kw: got.update(hw=hw, **kw) or kw)
    else:
        monkeypatch.delenv("TPU_SANDBOX_FORCE_COMPILED_KERNELS",
                           raising=False)
    jm = jax_models.pick_convnet(size, plan=plan, use_bn=False, **options)
    assert type(jm).__name__ == "ConvNet" and jm.use_bn is False
    assert jax_models.resolve_plan(size, plan) == "plain"
    assert models.resolve_plan(size, plan, device) == "plain"
    m = models.pick_convnet(size, plan=plan, device=device, use_bn=False,
                            **options)
    hw = (size, size) if isinstance(size, int) else size
    if device == "cuda":
        assert got == dict(hw=hw, device=torch.device("cuda"), use_bn=False)
        return
    assert isinstance(m, ConvNet) and m.image_size == hw
    assert m.use_bn is False and not hasattr(m, "bn1")


def test_entry_script_plan_plain_prints_reference_log_lines(capsys):
    argv = ["--force-cpu", "--plan", "plain", "--image-size", "30",
            "--limit-steps", "2", "--epochs", "1", "--synthetic-n", "10",
            "--log-every", "1", "--data-dir", "no-such-mnist-dir"]
    trainer, state = mnist_onegpu.main(argv)
    assert isinstance(state.model, ConvNet) and state.step == 2
    lines = capsys.readouterr().out.strip().splitlines()
    assert lines[0] == ("MNIST IDX files not found; using deterministic "
                        "synthetic MNIST")
    for i, line in enumerate(lines[1:3], start=1):
        assert re.fullmatch(
            rf"Epoch \[1/1\], Step \[{i}/2\], Loss: \d+\.\d{{4}}", line)
    assert re.fullmatch(r"Training complete in: \d+:\d\d:\d\d(\.\d+)?",
                        lines[3])
    assert np.isfinite(trainer.losses).all()
