"""The port's sequence-parallel engine (tpu_sandbox_torch/parallel/
seq_parallel.py) == the JAX package's ``SeqParallel``, the contract of
tests/test_transformer_sp.py.

Four gloo ranks, spawned once for the module (tests/torch_dist_workers.py),
take one step of the LM (vocab 64, d 32, 2 heads, 2 layers, d_ff 64, fp32)
on a {"data": 2, "sp": 2} mesh from the tree JAX drew (carried over by the
weight bridge, loaded on rank 0 and synced by ``shard_state``) on one
global batch [4, 32], for each attention scheme with SGD (0.1) and Adam
(1e-2, eps 1e-3); JAX's ``SeqParallel`` takes the same step on a 4-device
mesh of virtual CPU devices (its Pallas kernels in interpret mode). Bars:
JAX's own between its SP step and single-device training
(tests/test_transformer_sp.py:66-72), loss rtol 1e-5 and parameters atol
2e-5, against JAX's step and against the port's own single-device step;
the parameters after the step bitwise equal on every rank. Adam's eps is
1e-3 on both sides: at optax's 1e-8 its first update is lr * sign(g),
noise where g is 0 up to rounding (the k bias's gradient is 0, as sum_j
ds_ij = 0), which put parameters up to 6.2e-3 apart while the SGD steps
agree within 1.2e-7."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_dist_workers import (
    SP_ADAM_EPS,
    SP_ADAM_LR,
    SP_BATCH,
    SP_CFG,
    SP_SEQ,
    SP_SGD_LR,
    seq_parallel_worker,
)
from tpu_sandbox.models.transformer import TransformerConfig as JaxConfig
from tpu_sandbox.models.transformer import TransformerLM as JaxLM
from tpu_sandbox.parallel import SeqParallel as JaxSeqParallel
from tpu_sandbox.runtime.mesh import make_mesh as jax_make_mesh
from tpu_sandbox_torch.models.transformer import TransformerConfig, TransformerLM
from tpu_sandbox_torch.ops.losses import cross_entropy_loss
from tpu_sandbox_torch.parallel.launch import spawn
from tpu_sandbox_torch.utils.bridge import params_from_flax
from torch_threads import one_torch_thread  # noqa: F401

WORLD = 4
LOSS_RTOL, PARAM_ATOL = 1e-5, 2e-5
SCHEMES = ("ring", "ulysses", "flash_ring")
CASES = [f"{a}_{o}" for a in SCHEMES for o in ("sgd", "adam")]


def _batch():
    """Next token = (token + 7) % vocab, as tests/test_transformer_sp.py."""
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, SP_CFG["vocab_size"],
                          size=(SP_BATCH, SP_SEQ)).astype(np.int32)
    return tokens, ((tokens + 7) % SP_CFG["vocab_size"]).astype(np.int32)


def _jax_ctor(attention_fn):
    return JaxLM(JaxConfig(**SP_CFG), attention_fn)


def _tx(opt):
    if opt == "sgd":
        return optax.sgd(SP_SGD_LR)
    return optax.adam(SP_ADAM_LR, eps=SP_ADAM_EPS)


@pytest.fixture(scope="module")
def jax_mesh():
    return jax_make_mesh({"data": 2, "sp": 2}, devices=jax.devices()[:WORLD])


@pytest.fixture(scope="module")
def init_params(jax_mesh):
    tokens, _ = _batch()
    sp = JaxSeqParallel(_jax_ctor, _tx("sgd"), jax_mesh, donate=False)
    state = sp.init_state(jax.random.key(0), jnp.asarray(tokens))
    return jax.tree.map(np.asarray, state.params)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, init_params):
    tmp = tmp_path_factory.mktemp("seq_parallel")
    torch.save({"params": params_from_flax({"params": init_params}),
                "batch": _batch()}, tmp / "inputs.pt")
    spawn(seq_parallel_worker, WORLD, str(tmp), str(tmp / "inputs.pt"),
          init_method=f"file://{tmp}/store", timeout=120)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def _check(res, loss, params, what):
    np.testing.assert_allclose(float(res["loss"]), loss, rtol=LOSS_RTOL,
                               err_msg=f"{what} loss")
    for name, value in res["params"].items():
        np.testing.assert_allclose(value.numpy(), params[name].numpy(),
                                   rtol=0, atol=PARAM_ATOL,
                                   err_msg=f"{what} {name}")


@pytest.mark.parametrize("case", CASES)
def test_sp_step_matches_jax_seq_parallel(ranks, jax_mesh, init_params, case):
    attn, opt = case.rsplit("_", 1)
    sp = JaxSeqParallel(_jax_ctor, _tx(opt), jax_mesh, attn=attn,
                        donate=False)
    state = sp.init_state(jax.random.key(0), jnp.asarray(_batch()[0]))
    state = sp.shard_state(state.replace(
        params=jax.tree.map(jnp.asarray, init_params)))
    new_state, loss = sp.train_step(state, *sp.shard_batch(*_batch()))
    want = params_from_flax({"params": jax.tree.map(np.asarray,
                                                    new_state.params)})
    for r, res in enumerate(ranks):
        _check(res[case], float(np.asarray(loss)), want, f"{case} rank {r}")


def _single_device_sgd(init_params):
    """The port's own single-device step: the same LM with local
    attention on the whole batch, plain SGD."""
    model = TransformerLM(TransformerConfig(**SP_CFG))
    model.load_state_dict(params_from_flax({"params": init_params}))
    tokens, targets = (torch.from_numpy(x) for x in _batch())
    logits = model(tokens)
    loss = cross_entropy_loss(logits.reshape(-1, logits.shape[-1]),
                              targets.reshape(-1))
    loss.backward()
    with torch.no_grad():
        for p in model.parameters():
            p.sub_(SP_SGD_LR * p.grad)
    return loss.item(), model


@pytest.mark.parametrize("attn", SCHEMES)
def test_sp_step_matches_its_single_device_step(ranks, init_params, attn):
    loss, model = _single_device_sgd(init_params)
    want = model.state_dict()
    for r, res in enumerate(ranks):
        _check(res[f"{attn}_sgd"], loss, want, f"{attn} rank {r}")


@pytest.mark.parametrize("case", CASES)
def test_parameters_identical_on_every_rank(ranks, case):
    first = ranks[0][case]["params"]
    for r, res in enumerate(ranks[1:], 1):
        for name, value in res[case]["params"].items():
            assert torch.equal(value, first[name]), (case, r, name)


def test_eval_logits_take_the_stepped_parameters(ranks):
    """``eval_logits`` runs the local-attention twin, whose parameters are
    the engine's: after the step, the logits of the stepped weights."""
    res = ranks[0]["ring_sgd"]
    model = TransformerLM(TransformerConfig(**SP_CFG))
    model.load_state_dict(res["params"])
    with torch.no_grad():
        want = model(torch.from_numpy(_batch()[0][:1]))
    np.testing.assert_allclose(res["logits"].numpy(), want.numpy(),
                               rtol=0, atol=1e-6)


def test_validations(ranks):
    """A mesh without the 'sp' axis and an unknown scheme: JAX's
    ValueErrors."""
    for res in ranks:
        assert "not in mesh" in res["errors"]["axis"]
        assert "attn must be 'ring', 'ulysses' or 'flash_ring'" in (
            res["errors"]["attn"])
