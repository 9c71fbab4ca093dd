"""The port's ring and Ulysses attention (tpu_sandbox_torch/parallel/
ring_attention.py, ulysses.py) == the JAX package's, the cases of
tests/test_ring_attention.py that they port.

Four gloo ranks, spawned once for the module (tests/torch_dist_workers.py),
each hold a quarter of the sequence of the same global q, k, v [B 4, S 32,
H, D 16] (fp32, from a numpy seed) on a {"sp": 4} mesh; JAX runs
``make_ring_attention`` / ``make_ulysses_attention`` on a 4-device mesh of
virtual CPU devices over the global arrays (Ulysses' flash attention as
the Pallas kernel in interpret mode, the port's as its kernels' plain
version). Rank r's output and its gradients of sum(out * w) are JAX's
sequence block r. Tolerance (fp32 both sides, the same online-softmax
steps in other summation orders): the output within 2e-5, the gradients
within 1e-4 (absolute, on values of order 1)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_dist_workers import sp_attention_worker
from tpu_sandbox.ops.attention import causal_attention as jax_attention
from tpu_sandbox.parallel.ring_attention import make_ring_attention as jax_ring
from tpu_sandbox.parallel.ulysses import make_ulysses_attention as jax_ulysses
from tpu_sandbox.runtime.mesh import make_mesh as jax_make_mesh
from tpu_sandbox_torch.parallel.launch import spawn
from torch_threads import one_torch_thread  # noqa: F401

WORLD, B, S, D = 4, 4, 32, 16
OUT_ATOL, GRAD_ATOL = 2e-5, 1e-4
#: name -> (scheme, options, heads, seed)
CASES = {
    "ring_causal": ("ring", {"causal": True}, 2, 0),
    "ring_noncausal": ("ring", {"causal": False}, 2, 1),
    "ulysses_dense_causal": ("ulysses", {"impl": "dense", "causal": True},
                             4, 2),
    "ulysses_flash_causal": ("ulysses", {"impl": "flash", "causal": True},
                             4, 3),
    "ulysses_flash_noncausal": ("ulysses", {"impl": "flash",
                                            "causal": False}, 8, 4),
}
JAX_FN = {"ring": jax_ring, "ulysses": jax_ulysses}


def arrays(heads, seed):
    """q, k, v and the loss weights w, [B, S, heads, D] fp32."""
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, S, heads, D)).astype(np.float32)
            for _ in range(4)]


def jax_out_and_grads(fn, q, k, v, w):
    """fn's output and the gradients of sum(out * w) in q, k, v."""
    out = fn(q, k, v)
    grads = jax.grad(lambda *x: jnp.sum(fn(*x) * w), argnums=(0, 1, 2))(
        q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


def block(x, r):
    s = x.shape[1] // WORLD
    return x[:, r * s:(r + 1) * s]


def run_ranks(tmp_path_factory, cases):
    """Spawn the ranks once on ``cases`` (name -> (scheme, options,
    heads, seed)); each rank's results."""
    tmp = tmp_path_factory.mktemp("sp_attention")
    inputs = {"cases": {name: (scheme, options, arrays(heads, seed))
                        for name, (scheme, options, heads, seed)
                        in cases.items()}}
    torch.save(inputs, tmp / "inputs.pt")
    spawn(sp_attention_worker, WORLD, str(tmp), str(tmp / "inputs.pt"),
          init_method=f"file://{tmp}/store", timeout=120)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_ranks(tmp_path_factory, CASES)


@pytest.fixture(scope="module")
def jax_mesh():
    return jax_make_mesh({"sp": WORLD}, devices=jax.devices()[:WORLD])


def check_against(ranks, name, out, grads):
    for r, res in enumerate(ranks):
        got = res[name]
        np.testing.assert_allclose(got["out"].numpy(), block(out, r),
                                   rtol=0, atol=OUT_ATOL,
                                   err_msg=f"{name} out, rank {r}")
        for x, g, want in zip("qkv", got["grads"], grads):
            np.testing.assert_allclose(g.numpy(), block(want, r), rtol=0,
                                       atol=GRAD_ATOL,
                                       err_msg=f"{name} d{x}, rank {r}")


@pytest.mark.parametrize("name", list(CASES))
def test_matches_jax_forward_and_gradients(ranks, jax_mesh, name):
    scheme, options, heads, seed = CASES[name]
    fn = JAX_FN[scheme](jax_mesh, "sp", **options)
    out, grads = jax_out_and_grads(fn, *(jnp.asarray(x)
                                         for x in arrays(heads, seed)))
    check_against(ranks, name, out, grads)


def test_ring_first_token_attends_only_itself(ranks):
    """Causality across shard boundaries: token 0's output is v[0]."""
    _, _, v, _ = arrays(2, 0)
    np.testing.assert_allclose(ranks[0]["ring_causal"]["out"][:, 0].numpy(),
                               v[:, 0], rtol=0, atol=1e-6)


def test_ring_and_ulysses_match_the_reference(ranks):
    """Each rank's causal output against JAX's single-device reference
    attention on the whole sequence."""
    for name in ("ring_causal", "ulysses_dense_causal",
                 "ulysses_flash_causal"):
        _, options, heads, seed = CASES[name]
        q, k, v, _ = arrays(heads, seed)
        ref = np.asarray(jax_attention(q, k, v, causal=True))
        for r, res in enumerate(ranks):
            np.testing.assert_allclose(res[name]["out"].numpy(),
                                       block(ref, r), rtol=0, atol=OUT_ATOL,
                                       err_msg=f"{name} rank {r}")


@pytest.mark.parametrize("scheme", ["ring", "ulysses", "flash_ring"])
def test_validates_axis(ranks, scheme):
    """An axis the mesh lacks raises JAX's ValueError."""
    for res in ranks:
        assert "not in mesh" in res["errors"][scheme]


def test_ulysses_rejects_indivisible_heads(ranks):
    """2 heads over 4 ranks: JAX's message."""
    for res in ranks:
        assert "heads % ranks" in res["errors"]["heads"]
