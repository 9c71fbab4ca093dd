"""The port's MoE MLP (tpu_sandbox_torch/parallel/expert.py) == the JAX
package's ``MoeMlp``, the contract of tests/test_moe.py: top-1 and top-2
routing with ample capacity (against JAX's output and against the
expert FFNs by hand), first choices' priority, overflow, the load-balance
loss, the gradients, the MoE LM's forward, Flax's init scale (fan-in
E*d), the MoE LM training, and expert parallelism.

Layers take JAX's init (bridged) on JAX's inputs, fp32: outputs within
atol 1e-5 (JAX's own bar against the hand-written FFNs), the aux loss and
the LM's loss within rtol 1e-6, gradients within 1e-5 of max|ref|.

Four gloo ranks, spawned once for the module (tests/torch_dist_workers.py
``pjit_worker``), run ``PjitEngine(task="lm")`` on the MoE LM (E 4,
tests/test_moe.py's CFG with 2 layers) against JAX's ``PjitEngine`` on 4
virtual CPU devices of the same mesh, 3 steps from JAX's init: the
expert rule on {"data": 2, "expert": 2} with SGD (0.1, as
tests/test_moe.py:234-264) and with top-2 routing, Adam and clipping, at
tests/test_torch_pjit_engine.py's bar (loss rtol 1e-5, parameters atol
2e-5); and ``aux_weight`` 0 and 0.5 at rate 0 on {"data": 4}, where the
step's loss is the objective itself (tests/test_moe.py:174-198).
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from test_torch_pjit_engine import (
    WORLD,
    _bridge,
    _flat,
    check_run,
    jax_run,
    lm_batches,
)
from torch_dist_workers import PJIT_CFG, pjit_worker
from tpu_sandbox.models.transformer import TransformerConfig as JaxConfig
from tpu_sandbox.models.transformer import TransformerLM as JaxLM
from tpu_sandbox.ops.losses import cross_entropy_loss as jax_ce
from tpu_sandbox.parallel.expert import MoeMlp as JaxMoeMlp
from tpu_sandbox_torch.models.transformer import TransformerConfig, TransformerLM
from tpu_sandbox_torch.ops.losses import cross_entropy_loss
from tpu_sandbox_torch.parallel.expert import MoeMlp, route
from tpu_sandbox_torch.parallel.launch import spawn
from tpu_sandbox_torch.train.optim import Adam, constant_schedule
from tpu_sandbox_torch.utils.bridge import params_to_flax
from torch_threads import one_torch_thread  # noqa: F401

OUT_ATOL, AUX_RTOL, GRAD_TOL = 1e-5, 1e-6, 1e-5
#: tests/test_moe.py's CFG
CFG = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=1, d_ff=64,
           max_len=64, n_experts=4, capacity_factor=2.0)
#: (config, input shape, JAX keys of the input and of the init)
LAYERS = {
    "top1_ample": (dict(d_model=8, d_ff=16, n_experts=2,
                        capacity_factor=4.0), (1, 6, 8), (2, 3)),
    "top2_ample": (dict(d_model=8, d_ff=16, n_experts=4,
                        capacity_factor=8.0, router_top_k=2), (1, 6, 8),
                   (7, 8)),
    "top2_priority": (dict(d_model=8, d_ff=16, n_experts=2,
                           capacity_factor=1.0, router_top_k=2), (1, 8, 8),
                      (9, 10)),
    "overflow": (dict(d_model=8, d_ff=16, n_experts=1, capacity_factor=0.5),
                 (1, 8, 8), (4, 5)),
    "cfg": (CFG, (2, 16, 32), (0, 1)),
    "top2_tight": (dict(CFG, capacity_factor=1.0, router_top_k=2),
                   (3, 16, 32), (11, 12)),
}
MOE_LM = dict(PJIT_CFG, n_experts=4)
EP_CASES = {
    "ep_sgd": dict(task="lm", cfg=MOE_LM, mesh={"data": 2, "expert": 2},
                   rules="expert", opt="sgd"),
    "ep_top2_adam_clip": dict(task="lm", cfg=dict(MOE_LM, router_top_k=2),
                              mesh={"data": 2, "expert": 2},
                              rules="expert", opt="adam", clip_norm=0.5),
    "aux_0": dict(task="lm", cfg=MOE_LM, mesh={"data": 4}, rules="none",
                  opt="sgd0", options=dict(aux_weight=0.0)),
    "aux_0.5": dict(task="lm", cfg=MOE_LM, mesh={"data": 4}, rules="none",
                    opt="sgd0", options=dict(aux_weight=0.5)),
}


def jax_layer(name):
    """JAX's MoeMlp on its input: (x, params, y, aux)."""
    cfg, shape, (kx, kp) = LAYERS[name]
    layer = JaxMoeMlp(JaxConfig(**cfg))
    x = jax.random.normal(jax.random.key(kx), shape)
    params = layer.init(jax.random.key(kp), x)["params"]
    y, sown = jax.jit(lambda p, x: layer.apply(
        {"params": p}, x, mutable=["aux_loss"]))(params, x)
    return x, params, y, float(jax.tree.leaves(sown["aux_loss"])[0])


def port_layer(name, params):
    cfg = LAYERS[name][0]
    layer = MoeMlp(TransformerConfig(**cfg), torch.Generator())
    layer.load_state_dict(_bridge(params))
    return layer


def _run_port(name):
    x, params, y, aux = jax_layer(name)
    layer = port_layer(name, params)
    out = layer(torch.from_numpy(np.array(x)))
    return x, params, np.asarray(y), aux, layer, out.detach()


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_matches_jax(name):
    _, _, y, aux, layer, out = _run_port(name)
    assert out.shape == y.shape and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), y, rtol=0, atol=OUT_ATOL)
    np.testing.assert_allclose(float(layer.aux_loss.detach()), aux,
                               rtol=AUX_RTOL)


def _hand(x, p, t, choices):
    return sum(g * (fnn.gelu(x[0, t] @ p["w_up"][e]) @ p["w_down"][e])
               for g, e in choices)


@pytest.mark.parametrize("name", ["top1_ample", "top2_ample"])
def test_ample_capacity_is_the_gated_mix_by_hand(name):
    """Every token kept: the output is its gates' mix of its experts'
    FFNs (tests/test_moe.py:32-82)."""
    x, p, _, _, _, out = _run_port(name)
    k = LAYERS[name][0].get("router_top_k", 1)
    probs = jax.nn.softmax(x @ p["router"]["kernel"] + p["router"]["bias"],
                           -1)[0]
    for t in range(x.shape[1]):
        vals, idx = jax.lax.top_k(probs[t], k)
        gates = vals if k == 1 else vals / vals.sum()
        want = _hand(x, p, t, [(float(g), int(e)) for g, e in
                               zip(gates, idx)])
        np.testing.assert_allclose(out[0, t].numpy(),
                                   np.asarray(want), rtol=0, atol=OUT_ATOL)


def test_first_choices_have_priority():
    """Choice-major capacity (E 2, k 2, capacity 4 for 8 tokens): a
    token's first choice queues behind the earlier first choices of its
    expert only, a second choice behind every first choice of its expert
    too; a choice is kept iff its place is under 4 (tests/test_moe.py:
    85-118), and the output is JAX's."""
    x, p, y, _, _, out = _run_port("top2_priority")
    probs = torch.softmax(torch.from_numpy(np.array(
        x @ p["router"]["kernel"] + p["router"]["bias"])), -1)
    _, experts, positions, kept = route(probs, 2, 4)
    first, second = experts[0, :, 0].numpy(), experts[0, :, 1].numpy()
    assert 0 < (first == 0).sum() < 8, "degenerate draw"
    for t in range(8):
        assert positions[0, t, 0] == (first[:t] == first[t]).sum()
        assert positions[0, t, 1] == ((first == second[t]).sum()
                                      + (second[:t] == second[t]).sum())
    np.testing.assert_array_equal(kept[0].numpy(),
                                  positions[0].numpy() < 4)
    np.testing.assert_allclose(out.numpy(), y, rtol=0, atol=OUT_ATOL)


def test_overflow_drops_tokens():
    """One expert of capacity 4: tokens 4-7 get zero output
    (tests/test_moe.py:121-132), as JAX's."""
    _, _, y, _, _, out = _run_port("overflow")
    out = out.numpy()
    assert not np.allclose(out[0, :4], 0.0)
    np.testing.assert_array_equal(out[0, 4:], 0.0)
    np.testing.assert_array_equal(y[0, 4:], 0.0)


def test_aux_loss_is_at_least_one():
    """Balanced top-1 routing gives aux 1; any routing gives >= 1
    (tests/test_moe.py:19-29)."""
    _, _, _, aux, layer, _ = _run_port("cfg")
    assert float(layer.aux_loss.detach()) >= 0.99 and aux >= 0.99


@pytest.mark.parametrize("name", ["cfg", "top2_tight"])
def test_gradients_match_jax(name):
    """d(sum(y * w) + aux) by the input and every parameter."""
    x, params, _, _ = jax_layer(name)
    cfg = LAYERS[name][0]
    layer = JaxMoeMlp(JaxConfig(**cfg))
    w = np.random.default_rng(3).standard_normal(x.shape).astype(np.float32)

    def objective(p, x):
        y, sown = layer.apply({"params": p}, x, mutable=["aux_loss"])
        return (y * w).sum() + jax.tree.leaves(sown["aux_loss"])[0]

    jgrads, jdx = jax.jit(jax.grad(objective, argnums=(0, 1)))(params, x)
    port = port_layer(name, params)
    xt = torch.from_numpy(np.array(x)).requires_grad_()
    ((port(xt) * torch.from_numpy(w)).sum() + port.aux_loss).backward()
    want = {**_flat(jgrads), "x": jdx}
    got = {**{k: p.grad for k, p in port.named_parameters()}, "x": xt.grad}
    assert sorted(got) == sorted(want)
    for k, g in got.items():
        ref = np.asarray(want[k])
        err = np.abs(g.numpy() - ref).max() / max(np.abs(ref).max(), 1e-12)
        assert err <= GRAD_TOL, f"d{k}: {err:.3g}"


def test_moe_lm_forward_matches_jax():
    """The MoE LM (tests/test_moe.py's CFG): logits, the mean CE plus
    aux_weight times the mean aux loss, and the gradients."""
    cfg = dict(CFG, n_layers=2)
    model = JaxLM(JaxConfig(**cfg), mlp_cls=JaxMoeMlp)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 64, size=(4, 16)).astype(np.int32)
    targets = (tokens + 7) % 64
    params = model.init(jax.random.key(0), jnp.asarray(tokens))["params"]

    def loss_fn(p):
        logits, sown = model.apply({"params": p}, tokens,
                                   mutable=["aux_loss"])
        aux = jax.tree.leaves(sown["aux_loss"])
        return jax_ce(logits.reshape(-1, 64), targets.reshape(-1)) + (
            0.01 * sum(aux) / len(aux)), logits

    (jloss, jlogits), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)
    port = TransformerLM(TransformerConfig(**cfg), mlp_cls=MoeMlp, seed=3)
    port.load_state_dict(_bridge(params))
    logits = port(torch.from_numpy(tokens).long())
    aux = port.aux_losses()
    assert len(aux) == 2
    loss = cross_entropy_loss(logits.reshape(-1, 64), torch.from_numpy(
        targets).long().reshape(-1)) + 0.01 * sum(aux) / len(aux)
    loss.backward()
    np.testing.assert_allclose(logits.detach().numpy(), np.asarray(jlogits),
                               rtol=0, atol=OUT_ATOL)
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=AUX_RTOL)
    want = _flat(jgrads)
    for k, p in port.named_parameters():
        ref = np.asarray(want[k])
        err = np.abs(p.grad.numpy() - ref).max() / max(np.abs(ref).max(),
                                                         1e-12)
        assert err <= GRAD_TOL, f"d{k}: {err:.3g}"


def test_bridge_carries_the_moe_leaves_both_ways():
    """params_from_flax and params_to_flax on the MoE LM: JAX's tree (the
    router's kernel and bias, w_up, w_down a block) and back, bit for
    bit."""
    cfg = dict(CFG, n_layers=2)
    params = JaxLM(JaxConfig(**cfg), mlp_cls=JaxMoeMlp).init(
        jax.random.key(0), jnp.zeros((1, 16), jnp.int32))["params"]
    port = TransformerLM(TransformerConfig(**cfg), mlp_cls=MoeMlp, seed=3)
    port.load_state_dict(_bridge(params))
    back = _flat(params_to_flax(port)["params"])
    want = _flat(params)
    assert sorted(back) == sorted(want)
    assert "block1.mlp.router.kernel" in back and "block0.mlp.w_up" in back
    for k, v in want.items():
        np.testing.assert_array_equal(back[k], np.asarray(v), err_msg=k)


def test_init_scale_is_flaxs():
    """Flax's lecun_normal on [E, d, d_ff] counts E as receptive field:
    std 1/sqrt(E*d) (and 1/sqrt(E*d_ff) for w_down), the router's
    1/sqrt(d); the port's seeded draws within 2 % of JAX's and of the
    formula."""
    cfg = dict(d_model=256, d_ff=512, n_experts=4)
    params = JaxMoeMlp(JaxConfig(**cfg)).init(
        jax.random.key(0), jnp.zeros((1, 8, 256)))["params"]
    port = MoeMlp(TransformerConfig(**cfg), torch.Generator().manual_seed(0))
    for name, fan_in in (("w_up", 4 * 256), ("w_down", 4 * 512),
                         ("router.kernel", 256)):
        got = float(port.state_dict()[name].std())
        want = float(np.std(np.asarray(_flat(params)[name])))
        assert abs(got / want - 1) < 0.02, (name, got, want)
        assert abs(got * np.sqrt(fan_in) - 1) < 0.02, (name, got)
    assert not port.router.bias.any()


@pytest.mark.parametrize("cfg", [dict(n_experts=0), dict(
    n_experts=2, router_top_k=3), dict(n_experts=2, router_top_k=0)],
    ids=["no_experts", "top_k_above", "top_k_zero"])
def test_config_errors_are_jaxs(cfg):
    with pytest.raises(ValueError) as jerr:
        JaxMoeMlp(JaxConfig(d_model=8, d_ff=16, **cfg)).init(
            jax.random.key(0), jnp.zeros((1, 4, 8)))
    with pytest.raises(ValueError) as err:
        MoeMlp(TransformerConfig(d_model=8, d_ff=16, **cfg),
               torch.Generator())
    assert str(err.value) == str(jerr.value)


def test_moe_transformer_trains():
    """30 Adam steps at 1e-2 on one batch take the loss under 0.6 of its
    start (tests/test_moe.py:141-171), on the port alone."""
    model = TransformerLM(TransformerConfig(**CFG), mlp_cls=MoeMlp)
    opt = Adam(model.parameters(), constant_schedule(1e-2))
    rng = np.random.default_rng(0)
    tokens = torch.from_numpy(rng.integers(0, 64, size=(8, 16))).long()
    targets = (tokens + 7) % 64
    losses = []
    for _ in range(30):
        logits = model(tokens)
        loss = cross_entropy_loss(logits.reshape(-1, 64), targets.reshape(-1))
        loss.backward()
        opt.step()
        losses.append(loss.item())
    assert losses[-1] < losses[0] * 0.6, (losses[0], losses[-1])


# -- the engine ------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_results():
    return {name: jax_run(case, lm_batches())
            for name, case in EP_CASES.items()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_results):
    tmp = tmp_path_factory.mktemp("moe")
    inputs = {"cases": {
        name: dict(case, params=jax_results[name]["init"],
                   batches=lm_batches())
        for name, case in EP_CASES.items()}}
    torch.save(inputs, tmp / "inputs.pt")
    spawn(pjit_worker, WORLD, str(tmp), str(tmp / "inputs.pt"),
          init_method=f"file://{tmp}/store", timeout=240)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


@pytest.mark.parametrize("case", sorted(EP_CASES))
def test_engine_matches_jax_on_the_moe_lm(ranks, jax_results, case):
    for r, res in enumerate(ranks):
        check_run(res[case], jax_results[case]["losses"],
                  jax_results[case]["params"], f"{case} rank {r}")


@pytest.mark.parametrize("case", ["ep_sgd", "ep_top2_adam_clip"])
def test_each_expert_rank_holds_its_experts(ranks, jax_results, case):
    """w_up and w_down hold E/2 = 2 experts a rank, JAX's shard of the
    expert axis; the router stays whole."""
    for r, res in enumerate(ranks):
        local = res[case]["local"]
        assert local["block0.mlp.w_up"] == ((2, 32, 64), ("expert", None,
                                                          None))
        assert local["block1.mlp.w_down"][0] == (2, 64, 32)
        assert local["block0.mlp.router.kernel"][0] == (32, 4)
        want = jax_results[case]["shards"]
        assert {k: s for k, (s, _) in local.items()} == \
            {k: s[r] for k, s in want.items()}


def test_aux_loss_is_wired_into_the_engine(ranks, jax_results):
    """At rate 0 the step's loss is the objective: aux_weight 0.5 adds
    half the mean load-balance loss (>= 0.99), as in JAX."""
    for res in ranks:
        gap = float(res["aux_0.5"]["losses"][0] - res["aux_0"]["losses"][0])
        want = (jax_results["aux_0.5"]["losses"][0]
                - jax_results["aux_0"]["losses"][0])
        assert gap >= 0.49
        np.testing.assert_allclose(gap, want, rtol=1e-5)
