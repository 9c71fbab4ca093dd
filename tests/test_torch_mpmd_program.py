"""The port's per-stage programs (tpu_sandbox_torch/mpmd/program.py)
against JAX's ``StageProgram`` (tpu_sandbox/mpmd/program.py) on the same
numpy inputs, at JAX's small config (vocab 64, d 32, 2 heads, 4 layers,
d_ff 64, fp32) from the tree JAX drew, on an even split (2 stages of 2
layers) and an uneven one ([2, 1, 1]): ``fwd``, ``bwd``, ``loss_grad``,
the five ZB-H1 functions and ``apply_grads`` under sgd and adam, every
stage. Bars: PROGRAM_TOL (1e-5) of max|JAX| on each output leaf, the
loss at rtol 1e-6 (``tools/mpmd_spread.py`` on the CPU: at most 3.7e-7 of
max|JAX| on the forwards, 7.9e-7 on the gradients, 1.9e-7 on the
updates, 9.7e-8 relative on the loss; the two packages order their fp32
reductions differently).
Also the stage slicing and merging (``stage_params``,
``merge_stage_params``, ``check_layer_split``) against JAX's."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpu_sandbox.models.transformer import TransformerConfig as JConfig
from tpu_sandbox.models.transformer import TransformerLM as JLM
from tpu_sandbox.mpmd import program as jprogram
from tpu_sandbox_torch.models.transformer import TransformerConfig
from tpu_sandbox_torch.mpmd.program import (
    StageProgram,
    check_layer_split,
    merge_stage_params,
    opt_state_tree,
    stage_params,
    tree_leaves,
)
from tpu_sandbox_torch.train.optim import SGD, Adam, constant_schedule
from tpu_sandbox_torch.utils.bridge import params_from_flax
from torch_threads import one_torch_thread  # noqa: F401

CFG = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=4, d_ff=64,
           max_len=64)
M, MB, SEQ = 4, 2, 16
#: the share of max|JAX| each output leaf may differ by
PROGRAM_TOL = 1e-5
SPLITS = {"even": (2, None), "uneven": (3, [2, 1, 1])}
TXS = {"sgd": (lambda: optax.sgd(0.1),
               lambda ps: SGD(ps, 0.1, momentum=0.0)),
       "adam": (lambda: optax.adam(1e-2),
                lambda ps: Adam(ps, constant_schedule(1e-2)))}


@pytest.fixture(scope="module")
def flat():
    tokens = np.zeros((1, SEQ), np.int32)
    return jax.tree.map(np.asarray, JLM(JConfig(**CFG)).init(
        jax.random.key(0), tokens)["params"])


def _dotted(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_dotted(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = np.asarray(v)
    return out


def _jtree(tree):
    """A JAX stage tree as the port's: {part: {dotted leaf: array}}."""
    return {part: _dotted(sub) for part, sub in tree.items()}


def close(got, want, what):
    """Every leaf of ``got`` (tensors or a port tree) within PROGRAM_TOL
    of max|want|."""
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), what
        for k in want:
            close(got[k], want[k], f"{what}/{k}")
        return
    want = np.asarray(want)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == want.shape and got.dtype == want.dtype, what
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= PROGRAM_TOL * scale, f"{what}: {err} of {scale}"


def _programs(flat, split, stage, tx="sgd"):
    n, layer_split = SPLITS[split]
    jtx, ptx = TXS[tx]
    jp = jprogram.StageProgram(JConfig(**CFG), jtx(), stage, n, M,
                               layer_split=layer_split)
    pp = StageProgram(TransformerConfig(**CFG), ptx, stage, n, M,
                      device="cpu", layer_split=layer_split)
    jparams = jprogram.stage_params(flat, stage, n, layer_split=layer_split)
    params = stage_params(params_from_flax({"params": flat}), stage, n,
                          layer_split=layer_split)
    return jp, pp, jparams, params


def _inputs(stage, seed=0):
    rng = np.random.default_rng(seed + 10 * stage)
    tokens = rng.integers(0, CFG["vocab_size"], (MB, SEQ)).astype(np.int32)
    x = tokens if stage == 0 else rng.standard_normal(
        (MB, SEQ, CFG["d_model"])).astype(np.float32)
    g = (rng.standard_normal((MB, SEQ, CFG["d_model"])) * 0.1).astype(
        np.float32)
    targets = ((tokens + 7) % CFG["vocab_size"]).astype(np.int32)
    return x, g, targets


def _stages(split):
    return list(range(SPLITS[split][0]))


def _t(a):
    return torch.from_numpy(np.array(a)).long() if a.dtype.kind == "i" \
        else torch.from_numpy(np.array(a))


# -- slicing -------------------------------------------------------------------


def test_check_layer_split_validates():
    assert check_layer_split(8, 4, None) == [2, 2, 2, 2]
    assert check_layer_split(8, 3, [4, 3, 1]) == [4, 3, 1]
    with pytest.raises(ValueError, match="layer_split"):
        check_layer_split(8, 3, None)
    with pytest.raises(ValueError):
        check_layer_split(8, 3, [4, 4])
    with pytest.raises(ValueError):
        check_layer_split(8, 3, [4, 3, 2])
    with pytest.raises(ValueError):
        check_layer_split(8, 3, [8, 0, 0])


@pytest.mark.parametrize("split", sorted(SPLITS))
def test_stage_params_are_jaxs_slices_and_merge_back(flat, split):
    n, layer_split = SPLITS[split]
    state = params_from_flax({"params": flat})
    parts = []
    for s in range(n):
        ours = stage_params(state, s, n, layer_split=layer_split)
        theirs = _jtree(jprogram.stage_params(flat, s, n,
                                              layer_split=layer_split))
        assert sorted(ours) == sorted(theirs)
        for part in theirs:
            assert sorted(ours[part]) == sorted(theirs[part])
            for k, v in theirs[part].items():
                assert np.array_equal(ours[part][k].numpy(), v), (s, k)
        parts.append(ours)
    merged = merge_stage_params(parts)
    assert sorted(merged) == sorted(state)
    assert all(torch.equal(merged[k], state[k]) for k in state)


def test_lowering_names_the_roadmap_item(flat):
    _, pp, _, params = _programs(flat, "even", 0)
    with pytest.raises(NotImplementedError, match="item 12"):
        pp.lower_train_programs(params, None)


# -- the programs --------------------------------------------------------------


@pytest.mark.parametrize("split", sorted(SPLITS))
def test_fwd_and_bwd_match_jax(flat, split):
    for s in _stages(split)[:-1]:
        jp, pp, jparams, params = _programs(flat, split, s)
        x, g, _ = _inputs(s)
        close(pp.fwd(params, _t(x)), jp.fwd(jparams, x), f"{split} fwd {s}")
        jgrads, jgx = jp.bwd(jparams, x, g)
        grads, gx = pp.bwd(params, _t(x), _t(g))
        close(grads, _jtree(jgrads), f"{split} bwd {s}")
        if s == 0:
            assert gx is None and jgx is None
        else:
            close(gx, jgx, f"{split} bwd gx {s}")


@pytest.mark.parametrize("split", sorted(SPLITS))
def test_loss_grad_matches_jax(flat, split):
    s = _stages(split)[-1]
    jp, pp, jparams, params = _programs(flat, split, s)
    x, _, targets = _inputs(s)
    jlv, jgrads, jgx = jp.loss_grad(jparams, x, targets)
    lv, grads, gx = pp.loss_grad(params, _t(x), _t(targets))
    np.testing.assert_allclose(lv.item(), float(jlv), rtol=1e-6)
    close(grads, _jtree(jgrads), f"{split} loss_grad")
    close(gx, jgx, f"{split} loss_grad gx")


@pytest.mark.parametrize("split", sorted(SPLITS))
def test_zb_split_matches_jax(flat, split):
    """B and W on every stage: the middle stages' ``bwd_input`` (its
    input cotangent and stash) and ``bwd_weight``, stage 0's
    ``bwd_weight_chain``, the last stage's ``loss_bwd_input`` and
    ``loss_bwd_weight``; each W from its own package's stash."""
    stages = _stages(split)
    for s in stages:
        jp, pp, jparams, params = _programs(flat, split, s)
        x, g, targets = _inputs(s)
        if s == 0:
            close(pp.bwd_weight_chain(params, _t(x), _t(g)),
                  _jtree(jp.bwd_weight_chain(jparams, x, g)),
                  f"{split} W chain {s}")
        elif s == stages[-1]:
            jlv, jgx, jst = jp.loss_bwd_input(jparams, x, targets)
            lv, gx, st = pp.loss_bwd_input(params, _t(x), _t(targets))
            np.testing.assert_allclose(lv.item(), float(jlv), rtol=1e-6)
            close(gx, jgx, f"{split} loss B gx")
            close(torch.stack(st[0]), jst[0], f"{split} loss B hs")
            close(torch.stack(st[1]), jst[1], f"{split} loss B gs")
            close(st[2], jst[2], f"{split} loss B h_out")
            close(pp.loss_bwd_weight(params, _t(targets), st),
                  _jtree(jp.loss_bwd_weight(jparams, targets, jst)),
                  f"{split} loss W")
        else:
            jgx, jst = jp.bwd_input(jparams, x, g)
            gx, st = pp.bwd_input(params, _t(x), _t(g))
            close(gx, jgx, f"{split} B gx {s}")
            close(torch.stack(st[0]), jst[0], f"{split} B hs {s}")
            close(torch.stack(st[1]), jst[1], f"{split} B gs {s}")
            close(pp.bwd_weight(params, st),
                  _jtree(jp.bwd_weight(jparams, jst)), f"{split} W {s}")


@pytest.mark.parametrize("tx", sorted(TXS))
@pytest.mark.parametrize("split", sorted(SPLITS))
def test_apply_grads_matches_jax(flat, split, tx):
    """Two stage-local updates from the same grads: the parameters, and
    Adam's moments and count, against optax's on JAX's stage slice."""
    for s in _stages(split):
        jp, pp, jparams, params = _programs(flat, split, s, tx)
        rng = np.random.default_rng(s)
        jgrads = jax.tree.map(
            lambda a: (rng.standard_normal(a.shape) * 0.1).astype(a.dtype),
            jparams)
        grads = {part: {k: torch.from_numpy(v) for k, v in sub.items()}
                 for part, sub in _jtree(jgrads).items()}
        jstate = jp.init_opt_state(jparams)
        opt = pp.init_opt_state(params)
        for _ in range(2):
            jparams, jstate = jp.apply_grads(jparams, jstate,
                                             jax.tree.map(jnp.asarray,
                                                          jgrads))
            params, opt = pp.apply_grads(params, opt, grads)
        close(params, _jtree(jax.tree.map(np.asarray, jparams)),
              f"{split} {tx} params {s}")
        if tx == "adam":
            adam = jstate[0]
            ours = opt_state_tree(opt, params)
            assert int(ours["count"]) == int(adam.count) == 2
            close(ours["mu"], _jtree(adam.mu), f"{split} mu {s}")
            close(ours["nu"], _jtree(adam.nu), f"{split} nu {s}")


def test_apply_grads_refuses_another_trees_optimizer(flat):
    _, pp, _, params = _programs(flat, "even", 1)
    opt = pp.init_opt_state(params)
    other = {part: {k: v.clone() for k, v in sub.items()}
             for part, sub in params.items()}
    with pytest.raises(ValueError, match="init_opt_state"):
        pp.apply_grads(other, opt, other)
    assert len(tree_leaves(params)) == len(opt.params)
