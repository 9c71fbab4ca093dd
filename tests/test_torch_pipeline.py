"""The port's pipeline engine (tpu_sandbox_torch/parallel/pipeline.py) ==
the JAX package's ``PipelineParallel``, the contract of
tests/test_pipeline.py: the parameter split and merge, the LayerNorm of the
head, ``bubble_fraction``, every validation, and the GPipe and circular
steps.

Four gloo ranks, spawned once for the module (tests/torch_dist_workers.py
``pipeline_worker``), take one step of the LM (vocab 64, d 32, 2 heads,
fp32, 2 microbatches) on one global batch [8, 16] from the tree JAX's
``init_state`` drew (carried over by the weight bridge): GPipe at
{"data": 1, "pipe": 4} with SGD (0.1) and with Adam (1e-2, eps 1e-3, as
tests/test_torch_seq_parallel.py), and the circular schedule v = 2 at
{"data": 2, "pipe": 2} (4 layers: a wrong layer order would still train).
JAX's ``PipelineParallel`` takes the same step on a mesh of 4 virtual CPU
devices. Bars: JAX's own between its pipeline and single-device training
(tests/test_pipeline.py:52-86), loss rtol 1e-5 and merged parameters atol
2e-5, against JAX's step and against the port's own single-device step.
Each rank also holds only pre, post and its own stage row, JAX's slice of
the same init. The tensor- and sequence-parallel stages are in
tests/test_torch_pipeline_parallel.py, which takes this module's harness.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_dist_workers import (
    PP_BATCH,
    PP_BUBBLES,
    PP_CFG,
    PP_SEQ,
    PP_VALIDATIONS,
    SP_ADAM_EPS,
    SP_ADAM_LR,
    SP_SGD_LR,
    pipeline_worker,
    sp_tx,
)
from tpu_sandbox.models.transformer import TransformerConfig as JaxConfig
from tpu_sandbox.parallel import pipeline as jax_pipeline
from tpu_sandbox.runtime.mesh import make_mesh as jax_make_mesh
from tpu_sandbox_torch.models.transformer import TransformerConfig, TransformerLM
from tpu_sandbox_torch.ops.losses import cross_entropy_loss
from tpu_sandbox_torch.parallel import pipeline
from tpu_sandbox_torch.parallel.launch import spawn
from tpu_sandbox_torch.utils.bridge import params_from_flax
from torch_threads import one_torch_thread  # noqa: F401

WORLD = 4
LOSS_RTOL, PARAM_ATOL = 1e-5, 2e-5
#: the bars with 'sp' (tests/test_pipeline.py:225-241)
SP_LOSS_RTOL, SP_PARAM_ATOL = 1e-4, 5e-5
CASES = {
    "gpipe_sgd": dict(mesh={"data": 1, "pipe": 4}, cfg=PP_CFG, options={},
                      opt="sgd"),
    "gpipe_adam": dict(mesh={"data": 1, "pipe": 4}, cfg=PP_CFG, options={},
                       opt="adam"),
    "circular": dict(mesh={"data": 2, "pipe": 2}, cfg=PP_CFG,
                     options=dict(circular_chunks=2), opt="sgd"),
}


def lm_batch():
    """tests/test_pipeline.py's batch: next token = (token + 7) % vocab."""
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, PP_CFG["vocab_size"],
                          size=(PP_BATCH, PP_SEQ)).astype(np.int32)
    return tokens, ((tokens + 7) % PP_CFG["vocab_size"]).astype(np.int32)


def _jax_tx(opt):
    return (optax.sgd(SP_SGD_LR) if opt == "sgd"
            else optax.adam(SP_ADAM_LR, eps=SP_ADAM_EPS))


def _flat(tree) -> dict:
    """A nested numpy tree -> {dotted name: array}."""
    return {".".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(tree)}


def jax_step(case: dict) -> dict:
    """JAX's PipelineParallel on the case's mesh of virtual CPU devices:
    its init (single-device state dict and stage tree [n, v, lps, ...]),
    its loss and merged parameters after one step."""
    mesh = jax_make_mesh(case["mesh"], devices=jax.devices()[:WORLD])
    pp = jax_pipeline.PipelineParallel(
        JaxConfig(**case["cfg"]), _jax_tx(case["opt"]), mesh,
        microbatches=2, donate=False, **case["options"])
    tokens, targets = lm_batch()
    state = pp.init_state(jax.random.key(0), jnp.asarray(tokens))
    init = params_from_flax({"params": pp.merged_params(state)})
    stages = _flat(state.params["stages"])
    new_state, loss = pp.train_step(pp.shard_state(state),
                                    *pp.shard_batch(tokens, targets))
    return {"init": init, "stages": stages, "loss": float(loss),
            "params": params_from_flax({"params": pp.merged_params(
                new_state)})}


def run_ranks(tmp, cases: dict, jax_results: dict, *, checks=False):
    """``pipeline_worker`` on four gloo ranks over every case, each from
    JAX's init; one result dict a rank."""
    inputs = {"cases": {
        name: dict(case, microbatches=2, batch=lm_batch(),
                   params=jax_results[name]["init"])
        for name, case in cases.items()}, "checks": checks}
    torch.save(inputs, tmp / "inputs.pt")
    spawn(pipeline_worker, WORLD, str(tmp), str(tmp / "inputs.pt"),
          init_method=f"file://{tmp}/store", timeout=240)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def single_device_step(case: dict, init: dict):
    """The port's own single-device step from ``init``: the whole batch
    through ``TransformerLM``, the mean CE, one SGD or Adam update."""
    model = TransformerLM(TransformerConfig(**case["cfg"]))
    model.load_state_dict(init)
    opt = sp_tx(case["opt"])(list(model.parameters()))
    tokens, targets = (torch.from_numpy(x) for x in lm_batch())
    logits = model(tokens.long())
    loss = cross_entropy_loss(logits.reshape(-1, logits.shape[-1]),
                              targets.reshape(-1))
    loss.backward()
    opt.step()
    return loss.item(), model.state_dict()


def check_step(res, loss, params, what, *, sp=False):
    """Loss within rtol, every merged parameter within atol."""
    rtol, atol = (SP_LOSS_RTOL, SP_PARAM_ATOL) if sp else (LOSS_RTOL,
                                                           PARAM_ATOL)
    np.testing.assert_allclose(float(res["loss"]), loss, rtol=rtol,
                               err_msg=f"{what} loss")
    assert sorted(res["merged"]) == sorted(params), what
    for name, value in res["merged"].items():
        np.testing.assert_allclose(value.numpy(), np.asarray(params[name]),
                                   rtol=0, atol=atol,
                                   err_msg=f"{what} {name}")


def check_stage_row(res, case: dict, stages: dict, what):
    """The rank holds pre, post and its own stage row [v, lps, ...] (its
    Megatron shard with 'model'): JAX's stage tree at its pipe coordinate,
    bit for bit, and no other layer."""
    v = case["options"].get("circular_chunks", 1)
    n = case["mesh"]["pipe"]
    lps = case["cfg"]["n_layers"] // (n * v)
    coords = res["coords"]
    want_names = sorted(
        [f"pre.{k}" for k in ("tok_emb.embedding", "pos_emb.embedding")]
        + [f"post.{k}" for k in ("ln_f.scale", "ln_f.bias",
                                 "lm_head.kernel", "lm_head.bias")]
        + [f"stages.{c}.{l}.{leaf}" for c in range(v) for l in range(lps)
           for leaf in stages])
    assert res["names"] == want_names, what
    for leaf, full in stages.items():
        want = full[coords["pipe"]]
        if "model" in coords and leaf in pipeline.MODEL_DIMS:
            want = np.split(want, case["mesh"]["model"],
                            pipeline.MODEL_DIMS[leaf])[coords["model"]]
        got = res["row"][leaf].numpy()
        assert got.shape == want.shape, (what, leaf, got.shape, want.shape)
        np.testing.assert_array_equal(got, want, err_msg=f"{what} {leaf}")


@pytest.fixture(scope="module")
def jax_results():
    return {name: jax_step(case) for name, case in CASES.items()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_results):
    return run_ranks(tmp_path_factory.mktemp("pipeline"), CASES,
                     jax_results, checks=True)


def _jax_params(seed=0, n_layers=4):
    from tpu_sandbox.models.transformer import TransformerLM as JaxLM

    cfg = JaxConfig(**{**PP_CFG, "n_layers": n_layers})
    tokens, _ = lm_batch()
    return JaxLM(cfg).init(jax.random.key(seed),
                           jnp.asarray(tokens))["params"]


def test_split_and_merge_match_jax():
    """The stacked leaves, pre and post array-equal to JAX's split, the
    merge its inverse, and 3 stages of 4 layers JAX's ValueError."""
    params = _jax_params()
    flat = params_from_flax({"params": jax.tree.map(np.asarray, params)})
    jpre, jstacked, jpost = jax_pipeline.split_transformer_params(params, 4)
    pre, stacked, post = pipeline.split_transformer_params(flat, 4)
    jstacked = _flat(jstacked)
    assert sorted(stacked) == sorted(jstacked)
    for leaf, x in stacked.items():
        assert x.shape[0] == 4
        np.testing.assert_array_equal(x.numpy(), jstacked[leaf])
    assert sorted(pre) == sorted(params_from_flax({"params": jpre}))
    assert sorted(post) == sorted(params_from_flax({"params": jpost}))
    merged = pipeline.merge_transformer_params(pre, stacked, post)
    assert sorted(merged) == sorted(flat)
    for name, t in flat.items():
        assert torch.equal(merged[name], t), name
    with pytest.raises(ValueError, match="divisible") as err:
        pipeline.split_transformer_params(flat, 3)
    with pytest.raises(ValueError) as jerr:
        jax_pipeline.split_transformer_params(params, 3)
    assert str(err.value) == str(jerr.value)


def test_head_layernorm_matches_jax():
    """The head's LayerNorm (JAX's ``_layernorm``: two-pass variance, f32)
    within 1e-6, from f32 and from bf16 inputs."""
    rng = np.random.default_rng(1)
    x = (3 * rng.standard_normal((2, 5, 32)) + 1).astype(np.float32)
    scale = rng.standard_normal(32).astype(np.float32)
    bias = rng.standard_normal(32).astype(np.float32)
    for jd, td in ((jnp.float32, torch.float32),
                   (jnp.bfloat16, torch.bfloat16)):
        want = jax_pipeline._layernorm(jnp.asarray(x, jd),
                                       {"scale": scale, "bias": bias})
        got = pipeline._layernorm(torch.from_numpy(x).to(td),
                                  torch.from_numpy(scale),
                                  torch.from_numpy(bias))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=1e-5)


@pytest.mark.parametrize("stages,microbatches,chunks", PP_BUBBLES)
def test_bubble_fraction_matches_jax(ranks, stages, microbatches, chunks):
    """JAX's value on a {"data": 4 / S, "pipe": S} mesh, or its
    ValueError where the circular schedule refuses M."""
    mesh = jax_make_mesh({"data": 4 // stages, "pipe": stages},
                         devices=jax.devices()[:WORLD])
    try:
        want = jax_pipeline.PipelineParallel(
            JaxConfig(**{**PP_CFG, "n_layers": 16}), optax.sgd(0.1), mesh,
            microbatches=microbatches, circular_chunks=chunks,
            donate=False).bubble_fraction()
    except ValueError as e:
        want = str(e)
    for res in ranks:
        assert res["bubbles"][(stages, microbatches, chunks)] == want


def _jax_validation(name: str) -> str:
    mesh, cfg, options = PP_VALIDATIONS[name]
    options = dict(options)
    if options.get("attention_fn"):
        options["attention_fn"] = lambda q, k, v: q
    try:
        pp = jax_pipeline.PipelineParallel(
            JaxConfig(**{**PP_CFG, **cfg}), optax.sgd(0.1),
            jax_make_mesh(mesh, devices=jax.devices()[:WORLD]),
            donate=False, **options)
        if name == "shard_batch_sp":
            bad = np.zeros((4, 15), np.int32)
            pp.shard_batch(bad, bad)
    except ValueError as e:
        return str(e)
    return ""


@pytest.mark.parametrize("name", sorted(PP_VALIDATIONS))
def test_validations_match_jax(ranks, name):
    """Every ValueError of the constructor and of shard_batch, word for
    word JAX's."""
    want = _jax_validation(name)
    assert want
    for res in ranks:
        assert res["errors"][name] == want


@pytest.mark.parametrize("case", sorted(CASES))
def test_step_matches_jax_pipeline(ranks, jax_results, case):
    for r, res in enumerate(ranks):
        check_step(res[case], jax_results[case]["loss"],
                   jax_results[case]["params"], f"{case} rank {r}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_step_matches_its_single_device_step(ranks, jax_results, case):
    loss, params = single_device_step(CASES[case],
                                      jax_results[case]["init"])
    for r, res in enumerate(ranks):
        check_step(res[case], loss, params, f"{case} rank {r}")


@pytest.mark.parametrize("case", sorted(CASES))
def test_each_rank_holds_only_its_stage_row(ranks, jax_results, case):
    for r, res in enumerate(ranks):
        check_stage_row(res[case], CASES[case], jax_results[case]["stages"],
                        f"{case} rank {r}")
