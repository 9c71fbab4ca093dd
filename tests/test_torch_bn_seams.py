"""The BN statistics seams of the compiler-driven engine's global-batch BN
(``StatsGroup`` in tpu_sandbox_torch/parallel/collectives.py): each fused
tail (``ops/bn_tail_t.py``, ``ops/bn_tail.py``, with and without the
conv's per-channel sums), the fused conv1+tail unit
(``ops/conv1_tail_t.py``) and the plain chains (``GroupedBN``,
``GroupedBNT``), run on the CPU (the kernels' plain versions) by two gloo
ranks each holding half the batch rows under one group (its count the
ranks' equal rows times the ranks, or summed with the statistics, as
under unequal image bands), against one rank on the whole batch without
a group.

The forward: each rank's output is its rows of the whole batch's output,
and mu and var are the whole batch's on both ranks. The backward of
sum(out * cot): each rank's input gradient is its rows of the whole
batch's, and the parameter gradients of the two ranks sum to the whole
batch's (each rank returns its share; the engine's sync adds them). Bars:
the same f32 sums in another order, 1e-5 of each quantity's scale (2e-5
for the gradients, sums of products with t_hat; the conv bias gradient,
zero under BN, as tiny on both sides).
"""

import numpy as np
import pytest
import torch

from torch_dist_workers import BN_SEAM_COUNTS, BN_SEAMS, bn_seam, bn_seam_worker
from tpu_sandbox_torch.parallel.launch import spawn
from torch_threads import one_torch_thread  # noqa: F401

WORLD = 2
FWD_REL, GRAD_REL = 1e-5, 2e-5
#: the conv bias gradient under BN: zero but for f32 summation noise
DCB_TINY = 1e-3


def _arrays(name: str, seed: int = 0) -> dict:
    """A seam's f32 inputs on a batch of 4 (two rows a rank)."""
    rng = np.random.default_rng(seed)
    n, hw = 4, 8
    if name == "conv1_tail_t":
        co, blk = 8, 4
        img = rng.standard_normal((n, 4 * hw, 4 * hw)).astype(np.float32)
        x = img.reshape(n, hw, 4, hw, 4).transpose(0, 1, 2, 4, 3).reshape(
            n, hw, 16, hw)
        return {"x": x, "co": co, "blk": blk,
                "k5": (0.3 * rng.standard_normal((5, 5, 1, co))).astype(
                    np.float32),
                "cb": (0.1 * rng.standard_normal(co)).astype(np.float32),
                "gamma": (1 + 0.1 * rng.standard_normal(co)).astype(
                    np.float32),
                "beta": (0.1 * rng.standard_normal(co)).astype(np.float32),
                "cot": rng.standard_normal((n, hw, 4 * co, hw)).astype(
                    np.float32)}
    co, blk = 8, 2
    c = blk * blk * co
    transposed = name.startswith("bn_tail_t") or name == "grouped_bn_t"
    shape = (n, hw, c, hw) if transposed else (n, hw, hw, c)
    pooled = name.startswith("bn_tail")
    cshape = ((n, hw, c // 4, hw) if transposed else (n, hw, hw, c // 4)) \
        if pooled else shape
    return {"y": (1.5 * rng.standard_normal(shape) + 0.3).astype(np.float32),
            "co": co, "blk": blk,
            "gamma": (1 + 0.1 * rng.standard_normal(co)).astype(np.float32),
            "beta": rng.standard_normal(co).astype(np.float32),
            "cot": rng.standard_normal(cshape).astype(np.float32)}


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("bn_seams")
    torch.save({name: _arrays(name) for name in BN_SEAMS}, tmp / "in.pt")
    spawn(bn_seam_worker, WORLD, str(tmp), str(tmp / "in.pt"),
          init_method=f"file://{tmp}/store", timeout=240)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def _close(got, want, rel, what):
    scale = max(float(np.abs(want).max()), 1e-6)
    np.testing.assert_allclose(got, want, rtol=0, atol=rel * scale,
                               err_msg=what)


@pytest.mark.parametrize("counts", BN_SEAM_COUNTS)
@pytest.mark.parametrize("name", BN_SEAMS)
def test_forward_under_a_group_is_the_whole_batch(ranks, name, counts):
    want = bn_seam(name, _arrays(name))
    key = name, counts
    _close(np.concatenate([r[key]["out"].numpy() for r in ranks]),
           want["out"].numpy(), FWD_REL, f"{name} out")
    for r, res in enumerate(ranks):
        for k in ("mu", "var"):
            _close(res[key][k].numpy(), want[k].numpy(), FWD_REL,
                   f"{name} {k} rank {r}")


@pytest.mark.parametrize("counts", BN_SEAM_COUNTS)
@pytest.mark.parametrize("name", BN_SEAMS)
def test_backward_under_a_group_is_the_whole_batch(ranks, name, counts):
    want = bn_seam(name, _arrays(name))
    name = name, counts
    grads = [k for k in want if k.startswith("d")]
    assert grads
    for k in grads:
        if k == "dcb":
            # sum(dy) over conv1's output, analytically 0 under BN (over
            # the whole batch: a rank's share is not): both sides hold f32
            # summation noise, compared as tiny
            got = sum(r[name][k].numpy() for r in ranks)
            assert max(np.abs(want[k].numpy()).max(),
                       np.abs(got).max()) < DCB_TINY
            continue
        if k in ("dy",):
            got = np.concatenate([r[name][k].numpy() for r in ranks])
        else:
            got = sum(r[name][k].numpy() for r in ranks)
        _close(got, want[k].numpy(), GRAD_REL, f"{name} {k}")


def test_a_group_changes_the_statistics(ranks):
    """Control: one rank's rows alone give other statistics than the
    group's (the seams do sum over the ranks)."""
    arrays = _arrays("bn_tail_t")
    half = {k: (v[:2] if k in ("y", "cot") else v) for k, v in arrays.items()}
    alone = bn_seam("bn_tail_t", half)
    assert np.abs(alone["mu"].numpy()
                  - ranks[0]["bn_tail_t", "equal"]["mu"].numpy()).max() > 1e-3
