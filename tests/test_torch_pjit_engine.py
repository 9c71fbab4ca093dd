"""The port's compiler-driven engine (tpu_sandbox_torch/parallel/
pjit_engine.py) == the JAX package's ``PjitEngine``: the rules and the
parameter and optimizer-state specs path for path, the constructor's
checks word for word, and the steps.

Four gloo ranks, spawned once for the module (tests/torch_dist_workers.py
``pjit_worker``), take 3 steps from the tree JAX's ``TrainState.create``
drew (carried over by the weight bridge) on 3 global batches; JAX's
``PjitEngine`` takes the same steps on a mesh of 4 virtual CPU devices of
the same shape: the LM (vocab 64, d 32, 2 heads, 2 layers, fp32, [8, 16]
batches, Adam 1e-2 with eps 1e-3 as tests/test_torch_pipeline.py) under
pure data parallelism on {"data": 4}, and Megatron's rules on {"data": 2,
"model": 2}, once with the flash attention (its plain version here; JAX's
Pallas kernel in interpret mode) and once with global-norm clipping; the
BN-free ConvNet (28x28, 16 images a batch, AdamW 1e-3 with eps 1e-3: at
optax's 1e-8 the first updates are lr * sign(g), noise where g is 0 up to
rounding) replicated, with ZeRO-1 and with FSDP over 'data', and with
FSDP over 'model' of {"data": 2, "model": 2}; the LM under pure data
parallelism with the bf16 and int8 gradient sync, with the bucketed sync
(16 KB buckets) alone and under int8, and the ConvNet's ZeRO-1 under int8;
on the image models (SGD at 0.1, the global batch's BN statistics): the
plain ConvNet with BN on {"data": 4}, the spatial spec P("data",
"spatial") on {"data": 2, "spatial": 2} and on {"data": 1, "spatial": 4}
(7-row bands: pool windows straddle ranks), with BN and a resize to 32x32,
with BN and the fc's row rule on {"data": 1, "spatial": 2, "model": 2};
the fc's column and row rules on {"data": 2, "model": 2} (AdamW); the
LM's qkv kernel sharded alone (gathered at use); ConvNetS2DT and
ConvNetS2D with BN and their fused kernels (the port's CPU versions,
JAX's Pallas in interpret mode) on {"data": 4}, and ConvNetS2DT under the
spatial spec (whole images on every spatial rank). Bars: the pipeline's, loss rtol 1e-5 and gathered parameters atol 2e-5;
the compressed cases within twice (bf16: four times) what the compression
moves JAX's own run beyond those bars; ZeRO-1 and FSDP also equal the
port's replicated engine within 1e-6 (JAX's own bar between them,
tests/test_pjit_engine.py:234-254), the bucketed sync the plain one, and
the LM cases the port's own single-device steps.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from torch_dist_workers import (
    PJIT_BATCH,
    PJIT_CFG,
    PJIT_IMAGE,
    PJIT_SEQ,
    PJIT_STEPS,
    PJIT_UNPORTED,
    PJIT_VALIDATIONS,
    SP_ADAM_EPS,
    SP_ADAM_LR,
    SP_SGD_LR,
    pjit_tx,
    pjit_worker,
)
from tpu_sandbox.data import synthetic_mnist
from tpu_sandbox.data.mnist import normalize
from tpu_sandbox.models import ConvNet as JaxConvNet
from tpu_sandbox.models.convnet_s2d import ConvNetS2D as JaxConvNetS2D
from tpu_sandbox.models.convnet_s2d_t import ConvNetS2DT as JaxConvNetS2DT
from tpu_sandbox.models.transformer import Mlp as JaxMlp
from tpu_sandbox.models.transformer import TransformerConfig as JaxConfig
from tpu_sandbox.models.transformer import TransformerLM as JaxLM
from tpu_sandbox.ops.pallas_attention import flash_attention_fn as jax_flash_fn
from tpu_sandbox.parallel import pjit_engine as jax_pjit
from tpu_sandbox.parallel.expert import MoeMlp as JaxMoeMlp
from tpu_sandbox.runtime.mesh import make_mesh as jax_make_mesh
from tpu_sandbox.train import TrainState as JaxTrainState
from tpu_sandbox_torch.models import ConvNet
from tpu_sandbox_torch.models.transformer import Mlp, TransformerConfig, TransformerLM
from tpu_sandbox_torch.ops.flash_attention import flash_attention_fn
from tpu_sandbox_torch.ops.losses import cross_entropy_loss
from tpu_sandbox_torch.parallel import pjit_engine
from tpu_sandbox_torch.parallel.expert import MoeMlp
from tpu_sandbox_torch.parallel.launch import spawn
from tpu_sandbox_torch.parallel.pjit_engine import P
from tpu_sandbox_torch.train.optim import clip_by_global_norm_
from tpu_sandbox_torch.utils.bridge import params_from_flax
from torch_threads import one_torch_thread  # noqa: F401

WORLD = 4
LOSS_RTOL, PARAM_ATOL = 1e-5, 2e-5
#: ZeRO-1 and FSDP against the replicated engine
SAME_TOL = 1e-6
LM, IMAGE = dict(task="lm", cfg=PJIT_CFG), dict(task="image", cfg={})
SPATIAL = ("data", "spatial")
CASES = {
    "dp": dict(LM, mesh={"data": 4}, rules="none", opt="adam"),
    "tp_flash": dict(LM, mesh={"data": 2, "model": 2}, rules="megatron",
                     opt="adam", flash=True),
    "tp_clip": dict(LM, mesh={"data": 2, "model": 2}, rules="megatron",
                    opt="adam", clip_norm=0.5),
    "replicated": dict(IMAGE, mesh={"data": 4}, rules="none", opt="adamw"),
    "zero": dict(IMAGE, mesh={"data": 4}, rules="none", opt="adamw",
                 options=dict(zero_axis="data")),
    "fsdp": dict(IMAGE, mesh={"data": 4}, rules="none", opt="adamw",
                 options=dict(fsdp_axis="data")),
    "fsdp_model": dict(IMAGE, mesh={"data": 2, "model": 2}, rules="none",
                       opt="adamw", options=dict(fsdp_axis="model")),
    # the compressed and bucketed sync (16 KB buckets: several a step)
    "dp_bf16": dict(LM, mesh={"data": 4}, rules="none", opt="adam",
                    options=dict(grad_compress="bf16")),
    "dp_int8": dict(LM, mesh={"data": 4}, rules="none", opt="adam",
                    options=dict(grad_compress="int8")),
    "dp_overlap": dict(LM, mesh={"data": 4}, rules="none", opt="adam",
                       options=dict(overlap_grad_sync=True,
                                    bucket_mb=16 / 1024)),
    "dp_overlap_int8": dict(LM, mesh={"data": 4}, rules="none", opt="adam",
                            options=dict(grad_compress="int8",
                                         overlap_grad_sync=True,
                                         bucket_mb=16 / 1024)),
    "zero_int8": dict(IMAGE, mesh={"data": 4}, rules="none", opt="adamw",
                      options=dict(zero_axis="data", grad_compress="int8")),
    # BN with global-batch statistics, spatial partitioning, rules on the
    # image models' head and a partial Megatron set
    "bn": dict(IMAGE, model="image_bn", mesh={"data": 4}, rules="none",
               opt="sgd"),
    "spatial": dict(IMAGE, mesh={"data": 2, "spatial": 2}, rules="none",
                    opt="sgd", options=dict(input_spec=SPATIAL)),
    "spatial4": dict(IMAGE, mesh={"data": 1, "spatial": 4}, rules="none",
                     opt="sgd", options=dict(input_spec=SPATIAL)),
    "spatial_bn": dict(IMAGE, model="image_bn", mesh={"data": 2, "spatial": 2},
                       rules="none", opt="sgd",
                       options=dict(input_spec=SPATIAL, image_size=(32, 32))),
    # JAX's engine runs this spec on this mesh to other numbers than its
    # own pure data parallelism (no BN, no rule: 2.27817 against 2.28455 at
    # the second step); the case is held to JAX's engine without the
    # spatial spec, the same function (JAX_OPTIONS)
    "spatial_fc_row_bn": dict(IMAGE, model="image_bn",
                              mesh={"data": 1, "spatial": 2, "model": 2},
                              rules="fc_row", opt="sgd",
                              options=dict(input_spec=SPATIAL)),
    "fc_column": dict(IMAGE, mesh={"data": 2, "model": 2}, rules="fc",
                      opt="adamw"),
    "fc_row": dict(IMAGE, mesh={"data": 2, "model": 2}, rules="fc_row",
                   opt="adamw"),
    "qkv_only": dict(LM, mesh={"data": 2, "model": 2}, rules="qkv_only",
                     opt="adam"),
    "bn_s2dt": dict(IMAGE, model="s2dt_bn", mesh={"data": 4}, rules="none",
                    opt="sgd"),
    "bn_s2d": dict(IMAGE, model="s2d_bn", mesh={"data": 4}, rules="none",
                   opt="sgd"),
    "spatial_s2dt_bn": dict(IMAGE, model="s2dt_bn",
                            mesh={"data": 2, "spatial": 2}, rules="none",
                            opt="sgd", options=dict(input_spec=SPATIAL)),
}
#: the engine options JAX runs a case with, where they are not the port's
JAX_OPTIONS = {"spatial_fc_row_bn": {}}
#: the compressed cases and the uncompressed case of the same function:
#: held to JAX within twice (bf16: four times) what the compression moves
#: JAX's own run, plus the plain bars (tests/test_torch_data_parallel_ext.py
#: gives the reasons)
COMPRESSED = {"dp_bf16": "dp", "dp_int8": "dp", "dp_overlap_int8": "dp",
              "zero_int8": "replicated"}
JAX_RULES = {"none": lambda: [], "megatron": jax_pjit.megatron_rules,
             "expert": lambda: [(r"w_(up|down)", JP("expert", None, None))],
             "fc": lambda: [("fc/kernel", JP(None, "model"))],
             "fc_row": lambda: [("fc/kernel", JP("model", None))],
             "qkv_only": lambda: [("attn/qkv/kernel",
                                   JP(None, None, "model", None))],
             "conv_model": lambda: [("conv1/kernel",
                                     JP(None, None, None, "model"))]}
#: the JAX model of each image model of the cases (the s2d plans with
#: their fused kernels, Pallas in interpret mode on the CPU)
JAX_IMAGE_MODELS = {
    "image": lambda: JaxConvNet(use_bn=False),
    "image_bn": lambda: JaxConvNet(use_bn=True),
    "s2d_bn": lambda: JaxConvNetS2D(fused_conv=True, fused_tail=True),
    "s2dt_bn": lambda: JaxConvNetS2DT(fused_tail=True)}


def _flat(tree, is_leaf=None) -> dict:
    """A nested tree -> {dotted name: leaf}."""
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): v
            for path, v in jax.tree_util.tree_leaves_with_path(
                tree, is_leaf=is_leaf)}


def _bridge(params, batch_stats=None) -> dict:
    """JAX parameters (and BN statistics) as the port's state dict."""
    return params_from_flax({
        "params": jax.tree.map(np.asarray, params),
        "batch_stats": jax.tree.map(np.asarray, batch_stats or {})})


def _specs(tree) -> dict:
    return {k: tuple(v) for k, v in
            _flat(tree, lambda x: isinstance(x, JP)).items()}


def lm_batches(seed=0, vocab=64):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(PJIT_STEPS):
        tokens = rng.integers(0, vocab, size=(PJIT_BATCH, PJIT_SEQ)
                              ).astype(np.int32)
        out.append((tokens, ((tokens + 7) % vocab).astype(np.int32)))
    return out


def image_batches():
    out = []
    for s in range(PJIT_STEPS):
        images, labels = synthetic_mnist(n=16, seed=s)
        out.append((normalize(images), labels.astype(np.int32)))
    return out


def _jax_tx(opt, clip_norm=0.0):
    tx = {"sgd": lambda: optax.sgd(SP_SGD_LR),
          "sgd0": lambda: optax.sgd(0.0),
          "adam": lambda: optax.adam(SP_ADAM_LR, eps=SP_ADAM_EPS),
          "adamw": lambda: optax.adamw(1e-3, eps=1e-3)}[opt]()
    if clip_norm:
        tx = optax.chain(optax.clip_by_global_norm(clip_norm), tx)
    return tx


def _jax_options(options: dict) -> dict:
    options = dict(options)
    if "input_spec" in options:
        options["input_spec"] = JP(*options["input_spec"])
    return options


def jax_model(case):
    if case["task"] == "image":
        size = case.get("options", {}).get("image_size", (PJIT_IMAGE,))[0]
        return JAX_IMAGE_MODELS[case.get("model", "image")](), jnp.zeros(
            (1, size, size, 1))
    cfg = JaxConfig(**case["cfg"])
    attn = jax_flash_fn(interpret=True) if case.get("flash") else None
    mlp = JaxMoeMlp if cfg.n_experts else JaxMlp
    return (JaxLM(cfg, attention_fn=attn, mlp_cls=mlp),
            jnp.zeros((1, PJIT_SEQ), jnp.int32))


def jax_run(case: dict, batches, options=None) -> dict:
    """JAX's PjitEngine on the case's mesh of virtual CPU devices: the
    init it drew (bridged), the losses of its steps and the parameters
    after them, and each leaf's shard shape on each device of the mesh."""
    mesh = jax_make_mesh(case["mesh"], devices=jax.devices()[:WORLD])
    model, sample = jax_model(case)
    tx = _jax_tx(case["opt"], case.get("clip_norm", 0.0))
    state = JaxTrainState.create(model, jax.random.key(0), sample, tx)
    eng = jax_pjit.PjitEngine(model, tx, mesh, task=case["task"],
                              rules=JAX_RULES[case["rules"]](),
                              donate=False, **_jax_options(
                                  case.get("options", {}) if options is None
                                  else options))
    st = eng.shard_state(state)
    devices = list(mesh.devices.flat)
    shards = {name: [next(s.data.shape for s in x.addressable_shards
                          if s.device == d) for d in devices]
              for name, x in _flat(st.params).items()}
    losses = []
    for x, y in batches:
        st, loss = eng.train_step(st, *eng.shard_batch(x, y))
        losses.append(float(loss))
    return {"init": _bridge(state.params, state.batch_stats),
            "losses": losses, "params": _bridge(st.params, st.batch_stats),
            "shards": shards}


def _batches(case):
    return lm_batches() if case["task"] == "lm" else image_batches()


@pytest.fixture(scope="module")
def jax_results():
    return {name: jax_run(case, _batches(case), JAX_OPTIONS.get(name))
            for name, case in CASES.items()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_results):
    tmp = tmp_path_factory.mktemp("pjit")
    inputs = {"cases": {
        name: dict(case, params=jax_results[name]["init"],
                   batches=_batches(case))
        for name, case in CASES.items()}, "checks": True}
    torch.save(inputs, tmp / "inputs.pt")
    spawn(pjit_worker, WORLD, str(tmp), str(tmp / "inputs.pt"),
          init_method=f"file://{tmp}/store", timeout=240)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def check_run(res, losses, params, what, *, rtol=LOSS_RTOL, atol=PARAM_ATOL):
    np.testing.assert_allclose(res["losses"].numpy(), losses, rtol=rtol,
                               err_msg=f"{what} losses")
    assert sorted(res["params"]) == sorted(params), what
    for name, value in res["params"].items():
        np.testing.assert_allclose(value.numpy(), np.asarray(params[name]),
                                   rtol=0, atol=atol,
                                   err_msg=f"{what} {name}")


# -- specs -----------------------------------------------------------------


def test_megatron_rules_are_jaxs():
    for axis in ("model", "tp"):
        got = pjit_engine.megatron_rules(axis)
        want = jax_pjit.megatron_rules(axis)
        assert [(p, tuple(s)) for p, s in got] == \
            [(p, tuple(s)) for p, s in want]
        assert all(isinstance(s, P) for _, s in got)


@pytest.mark.parametrize("path", [
    "block0/attn/qkv/kernel", "block3/mlp/up/bias", "lm_head/kernel",
    "fc/kernel", "conv1/kernel", "block0/mlp/w_up", "tok_emb/embedding"])
def test_spec_for_path_is_jaxs(path):
    rules = [(r"w_(up|down)", P("expert", None, None)), ("fc/kernel",
                                                         P("model", None)),
             ("fc", P()), *pjit_engine.megatron_rules()]
    jrules = [(r"w_(up|down)", JP("expert", None, None)),
              ("fc/kernel", JP("model", None)), ("fc", JP()),
              *jax_pjit.megatron_rules()]
    assert tuple(pjit_engine.spec_for_path(path, rules)) == tuple(
        jax_pjit.spec_for_path(path, jrules))


def _spec_models(kind):
    """(JAX TrainState under optax.adam, the port's model) of one kind."""
    if kind == "convnet":
        case = dict(IMAGE)
        port = ConvNet((PJIT_IMAGE, PJIT_IMAGE), device="cpu", use_bn=False)
    else:
        cfg = dict(PJIT_CFG, n_experts=4) if kind == "moe" else PJIT_CFG
        case = dict(LM, cfg=cfg)
        port = TransformerLM(TransformerConfig(**cfg),
                             mlp_cls=MoeMlp if kind == "moe" else Mlp)
    model, sample = jax_model(case)
    state = JaxTrainState.create(model, jax.random.key(0), sample,
                                 optax.adam(1e-3))
    return state, port


SPEC_CASES = {
    "lm_megatron": ("lm", "megatron", {}),
    "lm_fsdp4": ("lm", "none", dict(fsdp_axis="data", fsdp_axis_size=4)),
    "lm_zero8_megatron": ("lm", "megatron",
                          dict(zero_axis="data", zero_axis_size=8)),
    "moe_expert": ("moe", "expert", {}),
    "moe_expert_zero4": ("moe", "expert",
                         dict(zero_axis="data", zero_axis_size=4)),
    "convnet_fc": ("convnet", "fc", {}),
    "convnet_zero8": ("convnet", "none",
                      dict(zero_axis="data", zero_axis_size=8)),
    "convnet_fsdp8": ("convnet", "none",
                      dict(fsdp_axis="data", fsdp_axis_size=8)),
    "convnet_fsdp4_fc": ("convnet", "fc",
                         dict(fsdp_axis="data", fsdp_axis_size=4)),
}


@pytest.mark.parametrize("name", sorted(SPEC_CASES))
def test_param_and_state_specs_are_jaxs(name):
    """param_specs and state_specs on the port's model: JAX's specs on
    JAX's state, path for path (the moments as Adam's mu and nu)."""
    kind, rules, kw = SPEC_CASES[name]
    state, port = _spec_models(kind)
    rules_j, rules_p = JAX_RULES[rules](), [
        (pat, P(*spec)) for pat, spec in JAX_RULES[rules]()]
    fsdp = {k: v for k, v in kw.items() if k.startswith("fsdp")}
    got = pjit_engine.param_specs(port, rules_p, **fsdp)
    want = _specs(jax_pjit.param_specs(state.params, rules_j, **fsdp))
    assert {k: tuple(v) for k, v in got.items()} == want
    sgot = pjit_engine.state_specs(port.state_dict(), rules_p, **kw)
    swant = jax_pjit.state_specs(state, rules_j, **kw)
    assert {k: tuple(v) for k, v in sgot.params.items()} == \
        _specs(swant.params)
    adam = swant.opt_state[0]
    for moments in (adam.mu, adam.nu):
        assert {k: tuple(v) for k, v in sgot.moments.items()} == \
            _specs(moments)


def test_zero_and_fsdp_shard_as_jax_does():
    """ZeRO-1 shards the fc's moments, never the 5x5 conv kernels (dim 0
    is 5); FSDP shards the fc itself and implies ZeRO-1 over its axis."""
    port = ConvNet((PJIT_IMAGE, PJIT_IMAGE), device="cpu", use_bn=False)
    zero = pjit_engine.state_specs(port, [], zero_axis="data",
                                   zero_axis_size=8)
    assert zero.moments["fc.kernel"] == P("data")
    assert zero.moments["conv1.kernel"] == P()
    assert zero.params["fc.kernel"] == P()
    fsdp = pjit_engine.state_specs(port, [], fsdp_axis="data",
                                   fsdp_axis_size=8)
    assert fsdp.params["fc.kernel"] == P("data") == fsdp.moments["fc.kernel"]
    assert fsdp.params["conv2.kernel"] == P() == fsdp.moments["conv2.kernel"]


def test_spec_type_is_a_tuple_of_axes():
    assert P() == () and P(None, "model") == (None, "model")
    assert repr(P("data", None)) == repr(JP("data", None))
    assert P("a") != P("b") and hash(P("a")) == hash(("a",))


# -- the constructor -------------------------------------------------------


def _jax_validation(name: str) -> str:
    mesh, options, kind = PJIT_VALIDATIONS[name]
    options = _jax_options(options)
    rules = JAX_RULES[options.pop("rules", "none")]()
    options.setdefault("task", "image" if kind != "lm" else "lm")
    case = dict(LM) if kind == "lm" else dict(IMAGE)
    model, sample = jax_model(case)
    if kind == "image_bn":
        model = JaxConvNet(use_bn=True)
    try:
        eng = jax_pjit.PjitEngine(model, optax.sgd(0.1), jax_make_mesh(
            mesh, devices=jax.devices()[:WORLD]), rules=rules,
            donate=False, **options)
        if kind == "image_bn":          # JAX checks BN at the first step
            tx = optax.sgd(0.1)
            st = eng.shard_state(JaxTrainState.create(
                model, jax.random.key(0), sample, tx))
            images, labels = image_batches()[0]
            eng.train_step(st, *eng.shard_batch(images, labels))
    except ValueError as e:
        return str(e)
    return ""


@pytest.mark.parametrize("name", sorted(PJIT_VALIDATIONS))
def test_validations_match_jax(ranks, name):
    """Every ValueError of the constructor, word for word JAX's."""
    want = _jax_validation(name)
    assert want
    for res in ranks:
        assert res["errors"][name] == want


@pytest.mark.parametrize("name", sorted(PJIT_UNPORTED))
def test_what_is_not_ported_raises(ranks, name):
    """The input specs and combinations the port does not write out (a
    sharded width, a spatial spec on the LM, beside FSDP or a leaf
    gathered at use, bands narrower than a conv's halo) and lower_step
    raise NotImplementedError naming their ROADMAP item."""
    item = {"lower_step": "item 12"}.get(name, "item 8b")
    for res in ranks:
        assert "ROADMAP.md" in res["refusals"][name]
        assert item in res["refusals"][name], res["refusals"][name]


# -- the steps -------------------------------------------------------------


@pytest.mark.parametrize("case", sorted(CASES))
def test_steps_match_jax_pjit_engine(ranks, jax_results, case):
    want = jax_results[case]
    if case not in COMPRESSED:
        for r, res in enumerate(ranks):
            check_run(res[case], want["losses"], want["params"],
                      f"{case} rank {r}")
        return
    plain = jax_results[COMPRESSED[case]]
    k = 4 if "bf16" in case else 2
    loss_bar = k * np.abs(np.subtract(want["losses"], plain["losses"]))
    for r, res in enumerate(ranks):
        got = res[case]
        dev = np.abs(got["losses"].numpy() - want["losses"])
        assert (dev <= loss_bar + LOSS_RTOL * np.abs(want["losses"])).all()
        moved = False
        for name, value in got["params"].items():
            ref = np.asarray(want["params"][name])
            bar = k * np.abs(ref - np.asarray(plain["params"][name])).max()
            dev = np.abs(value.numpy() - ref).max()
            assert dev <= bar + PARAM_ATOL, (case, name, r, dev, bar)
            moved |= not torch.equal(value, res[COMPRESSED[case]]["params"][
                name])
        assert moved, f"{case}: the port's run is its uncompressed run"


def test_bucketed_sync_equals_the_plain_sync(ranks):
    for res in ranks:
        check_run(res["dp_overlap"], res["dp"]["losses"].numpy(),
                  {k: v.numpy() for k, v in res["dp"]["params"].items()},
                  "dp_overlap", rtol=SAME_TOL, atol=SAME_TOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_each_rank_holds_jaxs_shard(ranks, jax_results, case):
    """Rank r's tensor of every leaf has the shape of JAX's shard on mesh
    device r."""
    want = jax_results[case]["shards"]
    for r, res in enumerate(ranks):
        got = {name: shape for name, (shape, _) in res[case]["local"].items()}
        assert got == {name: s[r] for name, s in want.items()}, (case, r)


@pytest.mark.parametrize("case", ["zero", "fsdp", "fsdp_model"])
def test_zero_and_fsdp_equal_the_replicated_engine(ranks, case):
    for r, res in enumerate(ranks):
        rep = res["replicated"]
        check_run(res[case], rep["losses"].numpy(),
                  {k: v.numpy() for k, v in rep["params"].items()},
                  f"{case} rank {r}", rtol=SAME_TOL, atol=SAME_TOL)


def test_zero_updates_each_ranks_block(ranks):
    """ZeRO-1's moments: the fc kernel's 1568 rows in blocks of 392 a rank,
    the 5x5 conv kernels whole; FSDP's likewise beside its parameters."""
    for res in ranks:
        moments = res["zero"]["moments"]
        assert moments["fc.kernel"] == (392, 10)
        assert moments["conv1.kernel"] == (5, 5, 1, 16)
        assert res["zero"]["local"]["fc.kernel"][0] == (1568, 10)
        assert res["fsdp"]["moments"]["fc.kernel"] == (392, 10)
        assert res["fsdp"]["local"]["fc.kernel"] == ((392, 10), P("data"))


def _single_device_losses(case, init):
    """The port's own single-device steps from ``init``: the whole batch
    through TransformerLM, the mean CE, Adam (and clipping)."""
    model = TransformerLM(TransformerConfig(**case["cfg"]),
                          flash_attention_fn() if case.get("flash") else None)
    model.load_state_dict(init)
    opt = pjit_tx(case["opt"])(list(model.parameters()))
    losses = []
    for tokens, targets in lm_batches():
        logits = model(torch.from_numpy(tokens).long())
        loss = cross_entropy_loss(logits.reshape(-1, logits.shape[-1]),
                                  torch.from_numpy(targets).long().reshape(-1))
        loss.backward()
        if case.get("clip_norm"):
            clip_by_global_norm_([p.grad for p in model.parameters()],
                                 case["clip_norm"])
        opt.step()
        losses.append(loss.item())
    return losses, model.state_dict()


@pytest.mark.parametrize("case", ["dp", "tp_flash", "tp_clip"])
def test_lm_steps_match_the_single_device_steps(ranks, jax_results, case):
    losses, params = _single_device_losses(CASES[case],
                                           jax_results[case]["init"])
    for r, res in enumerate(ranks):
        check_run(res[case], losses, {k: v.numpy() for k, v in
                                      params.items()}, f"{case} rank {r}")


#: chip_smoke.py's PJIT_PATHS on the CPU at 32x32, fp32, one gloo rank in
#: this process: (plan, plan options, mesh, rules, input_spec)
ONE_RANK_PATHS = {
    "plain": ("plain", {}, {"data": 1, "spatial": 1, "model": 1},
              [("fc/kernel", P("model", None))], P("data", "spatial")),
    "s2dt": ("s2dt", {"fused_tail": True}, {"data": 1}, [], P("data")),
    "s2d": ("s2d", {"fused_conv": True, "fused_tail": True}, {"data": 1},
            [], P("data")),
}


@pytest.mark.parametrize("name", sorted(ONE_RANK_PATHS))
def test_one_rank_engine_with_bn_is_the_trainers_step(name):
    """PjitEngine at one rank with BN and TrainState's plain SGD (``tx``
    returning None) against make_train_step from the same seed on the
    same 3 batches resized to 32x32: losses and the whole state (BN
    statistics included) within the module's bars."""
    from tpu_sandbox_torch.models import pick_convnet
    from tpu_sandbox_torch.runtime import bootstrap
    from tpu_sandbox_torch.runtime.mesh import make_mesh
    from tpu_sandbox_torch.train import TrainState, make_train_step

    plan, options, mesh, rules, spec = ONE_RANK_PATHS[name]
    size = (32, 32)
    batches = image_batches()
    ref = pick_convnet(size, plan=plan, device="cpu", **options)
    step = make_train_step(TrainState(ref, lr=1e-4), image_size=size)
    want = [float(step(torch.from_numpy(x), torch.from_numpy(y).long()))
            for x, y in batches]
    model = pick_convnet(size, plan=plan, device="cpu", **options)
    bootstrap.init(device="cpu")
    try:
        eng = pjit_engine.PjitEngine(model, lambda params: None,
                                     make_mesh(mesh), rules=rules,
                                     input_spec=spec, image_size=size)
        state = eng.shard_state()
        assert state.optimizer is None and model.bn1.stats_group is not None
        got = [float(eng.train_step(state, *eng.shard_batch(x, y)))
               for x, y in batches]
        params = eng.full_params(state)
    finally:
        bootstrap.cleanup()
    check_run({"losses": torch.tensor(got), "params": params}, want,
              {k: v.numpy() for k, v in ref.state_dict().items()}, name)
