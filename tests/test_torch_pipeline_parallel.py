"""The port's pipeline engine with tensor- and sequence-parallel stages ==
the JAX package's ``PipelineParallel`` with ``model_axis`` and
``seq_axis`` (tests/test_pipeline.py:88-150, 209-241).

Four gloo ranks, spawned once for the module, take one SGD (0.1) step of
tests/test_torch_pipeline.py's LM from the tree JAX drew, on one global
batch [8, 16] in 2 microbatches: Megatron stages at {"data": 1, "model":
2, "pipe": 2} (4 layers), the sequence over 'sp' inside the stages at
{"data": 1, "pipe": 2, "sp": 2} with the ring and with the flash-ring (2
layers; JAX's Pallas kernels in interpret mode), and tensor times
sequence parallelism in one stage at {"data": 1, "model": 2, "pipe": 1,
"sp": 2}. JAX's ``PipelineParallel`` takes the same step on 4 virtual CPU
devices. Bars as JAX's: loss rtol 1e-5 and merged parameters atol 2e-5,
1e-4 and 5e-5 with 'sp'; against JAX's step and the port's single-device
step. Each rank holds only its stage row and its Megatron shard of it."""

import pytest

from test_torch_pipeline import (
    PP_CFG,
    check_stage_row,
    check_step,
    jax_step,
    run_ranks,
    single_device_step,
)
from torch_threads import one_torch_thread  # noqa: F401

TWO_LAYERS = {**PP_CFG, "n_layers": 2}
CASES = {
    "tp_stages": dict(mesh={"data": 1, "model": 2, "pipe": 2}, cfg=PP_CFG,
                      options=dict(model_axis="model"), opt="sgd"),
    "pp_sp_ring": dict(mesh={"data": 1, "pipe": 2, "sp": 2}, cfg=TWO_LAYERS,
                       options=dict(seq_axis="sp", seq_attn="ring"),
                       opt="sgd"),
    "pp_sp_flash_ring": dict(mesh={"data": 1, "pipe": 2, "sp": 2},
                             cfg=TWO_LAYERS,
                             options=dict(seq_axis="sp",
                                          seq_attn="flash_ring"),
                             opt="sgd"),
    "tp_sp": dict(mesh={"data": 1, "model": 2, "pipe": 1, "sp": 2},
                  cfg=TWO_LAYERS,
                  options=dict(model_axis="model", seq_axis="sp"),
                  opt="sgd"),
}


@pytest.fixture(scope="module")
def jax_results():
    return {name: jax_step(case) for name, case in CASES.items()}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, jax_results):
    return run_ranks(tmp_path_factory.mktemp("pipeline_parallel"), CASES,
                     jax_results)


def _sp(case):
    return "seq_axis" in CASES[case]["options"]


@pytest.mark.parametrize("case", sorted(CASES))
def test_step_matches_jax_pipeline(ranks, jax_results, case):
    for r, res in enumerate(ranks):
        check_step(res[case], jax_results[case]["loss"],
                   jax_results[case]["params"], f"{case} rank {r}",
                   sp=_sp(case))


@pytest.mark.parametrize("case", sorted(CASES))
def test_step_matches_its_single_device_step(ranks, jax_results, case):
    loss, params = single_device_step(CASES[case],
                                      jax_results[case]["init"])
    for r, res in enumerate(ranks):
        check_step(res[case], loss, params, f"{case} rank {r}",
                   sp=_sp(case))


@pytest.mark.parametrize("case", sorted(CASES))
def test_each_rank_holds_only_its_stage_row(ranks, jax_results, case):
    for r, res in enumerate(ranks):
        check_stage_row(res[case], CASES[case], jax_results[case]["stages"],
                        f"{case} rank {r}")

