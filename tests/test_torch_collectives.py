"""The port's collectives (``tpu_sandbox_torch/parallel/collectives.py``)
held against the JAX package's ``CollectiveGroup`` op by op: four gloo
ranks, spawned once for the module (``tests/torch_dist_workers.py``,
rendezvous through a ``FileStore`` under a temporary directory), compute
every case; JAX computes the same case on a 4-device mesh of virtual CPU
devices, and port rank r's result must equal JAX's row block r exactly,
dtype included (the inputs are exact in f32, so any summation order gives
the same bits). Also: sub-groups of a 2x2 mesh, the axis and shape
validations of ``tests/test_collectives.py`` and the bandwidth bench."""

import jax
import numpy as np
import pytest
import torch

from torch_dist_workers import (
    COLLECTIVE_CASES,
    COLLECTIVE_INPUTS,
    VALIDATIONS,
    collectives_worker,
)
from tpu_sandbox.parallel.collectives import CollectiveGroup as JaxGroup
from tpu_sandbox.runtime.mesh import make_mesh as jax_make_mesh
from tpu_sandbox_torch.parallel.launch import spawn
from torch_threads import one_torch_thread  # noqa: F401

WORLD = 4


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Each rank's results (a dict per rank), from one spawned group."""
    tmp = tmp_path_factory.mktemp("collectives")
    spawn(collectives_worker, WORLD, str(tmp),
          init_method=f"file://{tmp}/store", timeout=120)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


@pytest.fixture(scope="module")
def jax_group():
    return JaxGroup(jax_make_mesh({"data": WORLD},
                                  devices=jax.devices()[:WORLD]), "data")


def _jax_case(group, op, x, arg):
    values = COLLECTIVE_INPUTS[x]
    if op == "all_reduce":
        return np.asarray(group.all_reduce(values, arg))
    if op in ("broadcast", "shift"):
        return np.asarray(getattr(group, op)(values, arg))
    return np.asarray(getattr(group, op)(values))


@pytest.mark.parametrize("case", COLLECTIVE_CASES, ids=lambda c: c[0])
def test_each_rank_holds_jaxs_row(ranks, jax_group, case):
    name, op, x, arg = case
    want = _jax_case(jax_group, op, x, arg)
    for r, res in enumerate(ranks):
        got = res[name].numpy()
        if op in ("all_gather", "broadcast"):
            expect = want                           # replicated
        else:
            k = want.shape[0] // WORLD
            expect = want[r * k:(r + 1) * k]
            if op == "all_to_all":
                expect = expect[0]
        assert got.dtype == expect.dtype, (name, got.dtype, expect.dtype)
        np.testing.assert_array_equal(got.reshape(expect.shape), expect,
                                      err_msg=f"{name} rank {r}")


def test_subgroup_reduce_on_2x2_mesh(ranks):
    """Reducing over 'model' of a 2x2 mesh keeps the 'data' rows apart,
    and equals JAX's sub-group on its 2x2 mesh."""
    mesh = jax_make_mesh({"data": 2, "model": 2},
                         devices=jax.devices()[:WORLD])
    want = np.asarray(JaxGroup(mesh, "model").all_reduce(
        COLLECTIVE_INPUTS["sub"]))
    for r, res in enumerate(ranks):
        assert res["sub_size"] == 2
        np.testing.assert_array_equal(res["sub"].numpy(),
                                      want[r % 2:r % 2 + 1])
        d = r // 2
        assert float(res["sub_rows"]) == 20.0 * d + 1.0
        assert res["submesh"] == (2, r % 2)


@pytest.mark.parametrize("what", sorted(VALIDATIONS))
def test_validation_raises_as_jax(ranks, what):
    for res in ranks:
        assert VALIDATIONS[what] in res["errors"][what], res["errors"]


def test_mesh_needs_the_world_size(ranks):
    assert all("needs 3 ranks, have 4" in res["errors"]["mesh_size"]
               for res in ranks)


def test_group_and_topology(ranks):
    for r, res in enumerate(ranks):
        assert res["group"] == (WORLD, r)
        assert res["backend"] == "gloo"
        assert res["topology"]["process_id"] == r
        assert res["topology"]["num_processes"] == WORLD


def test_bandwidth_bench_runs(ranks):
    for res in ranks:
        bw = res["bandwidth"]
        assert bw["bytes"] == (1 << 16)
        assert bw["busbw_GBps"] > 0 or "degraded" in bw
        if bw["busbw_GBps"] > 0:
            # NCCL-tests' accounting: busbw = algbw * 2(n-1)/n
            assert bw["busbw_GBps"] == pytest.approx(
                bw["algbw_GBps"] * 2 * (WORLD - 1) / WORLD)
