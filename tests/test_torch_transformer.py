"""The port's transformer LM (tpu_sandbox_torch/models/transformer.py) ==
the JAX TransformerLM from bridged weights: logits, the mean cross-entropy
and every parameter's gradient, in fp32 and bf16, with the plain causal
attention and with flash attention (JAX's Pallas kernels in interpret
mode, the port's kernels' plain versions on the CPU). Also the plain
attention op alone, the nested weight bridge, and ``remat`` (full and
dots): bitwise the model without it inside the port, JAX's remat model
across, and dots recomputing no matrix product."""

import dataclasses
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from tpu_sandbox.models.transformer import TransformerConfig as JaxConfig
from tpu_sandbox.models.transformer import TransformerLM as JaxLM
from tpu_sandbox.ops.attention import causal_attention as jax_causal_attention
from tpu_sandbox.ops.losses import cross_entropy_loss as jax_ce
from tpu_sandbox.ops.pallas_attention import flash_attention_fn as jax_flash_fn
from tpu_sandbox.parallel.expert import MoeMlp as JaxMoeMlp
from tpu_sandbox_torch.models.transformer import DOT_OPS, TransformerConfig, TransformerLM
from tpu_sandbox_torch.ops.attention import causal_attention
from tpu_sandbox_torch.ops.flash_attention import flash_attention_fn
from tpu_sandbox_torch.ops.losses import cross_entropy_loss
from tpu_sandbox_torch.parallel.expert import MoeMlp
from tpu_sandbox_torch.utils.bridge import params_from_flax, params_to_flax
from torch_threads import one_torch_thread  # noqa: F401

DTYPES = {"fp32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
SHAPE = dict(vocab_size=96, d_model=64, n_heads=2, n_layers=2, d_ff=128,
             max_len=128)
B, S = 2, 128
# of max|ref|. fp32: the same f32 math in other summation orders. bf16:
# every Dense output, residual add and the attention's p are rounded to
# bf16 on both sides at places the two compilers fuse differently, so two
# layers in, logits differ by a few bf16 ulps (2^-8 each) of their range;
# the gradients of those logits carry the same rounding noise through the
# backward, and the bf16 parameter-gradient casts add one more. Measured on
# the CPU: fp32 logits 6.4e-7, gradients 1.0e-6; bf16 logits 7.9e-3, loss
# 1.4e-4 relative, gradients 1.5e-2.
LOGITS_TOL = {"fp32": 1e-5, "bf16": 2e-2}
LOSS_RTOL = {"fp32": 1e-6, "bf16": 1e-3}
GRAD_TOL = {"fp32": 1e-5, "bf16": 4e-2}


def _batch(seed=0, vocab=96):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, vocab, size=(B, S), dtype=np.int32)
    targets = rng.integers(0, vocab, size=(B, S), dtype=np.int32)
    return tokens, targets


def _scaled_err(got, want):
    want = np.asarray(want, np.float32)
    scale = float(np.max(np.abs(want))) or 1.0
    return float(np.max(np.abs(np.asarray(got, np.float32) - want))) / scale


@pytest.mark.parametrize("flash", [False, True], ids=["plain", "flash"])
@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_logits_loss_and_grads_match_jax(dt, flash):
    _check_against_jax(dt, flash)


def _check_against_jax(dt, flash, remat=None):
    """The JAX model and the port's from the same weights, with ``remat``
    the policy of both: logits, loss and every gradient within the
    tolerances above."""
    jd, td = DTYPES[dt]
    opts = dict(remat=True, remat_policy=remat) if remat else {}
    jcfg = JaxConfig(**SHAPE, dtype=jd, fp32_logits=True, **opts)
    jm = JaxLM(jcfg, attention_fn=jax_flash_fn(interpret=True) if flash
               else None)
    tokens, targets = _batch()
    variables = jm.init(jax.random.key(0), jnp.asarray(tokens))
    params = variables["params"]

    def loss_fn(p):
        logits = jm.apply({"params": p}, jnp.asarray(tokens))
        loss = jax_ce(logits.reshape(-1, logits.shape[-1]),
                      jnp.asarray(targets).reshape(-1))
        return loss, logits

    (jloss, jlogits), jgrads = jax.jit(jax.value_and_grad(
        loss_fn, has_aux=True))(params)

    cfg = TransformerConfig(**SHAPE, dtype=td, fp32_logits=True, **opts)
    model = TransformerLM(cfg, flash_attention_fn() if flash else None,
                          seed=1)
    model.load_state_dict(params_from_flax(
        {"params": jax.tree.map(np.asarray, params)}))
    logits = model(torch.from_numpy(tokens).long())
    assert logits.dtype == torch.float32 and logits.shape == (B, S, 96)
    loss = cross_entropy_loss(logits.reshape(-1, 96),
                              torch.from_numpy(targets).reshape(-1))
    loss.backward()

    assert _scaled_err(logits.detach().numpy(), jlogits) <= LOGITS_TOL[dt]
    np.testing.assert_allclose(loss.item(), float(jloss), rtol=LOSS_RTOL[dt])
    got = params_to_flax(model)["params"]
    grads = {k: p.grad for k, p in model.named_parameters()}
    flat = {".".join(str(getattr(k, "key", k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_leaves_with_path(jgrads)}
    assert set(flat) == set(grads) and got.keys() == params.keys()
    for key, want in flat.items():
        err = _scaled_err(grads[key].numpy(), want)
        assert err <= GRAD_TOL[dt], f"d{key}: {err:.3g} of max|ref|"


def test_config_refuses_what_is_not_ported():
    """n_experts takes the MoE only through mlp_cls, as in JAX: the default
    MLP stays dense; MoeMlp refuses a config without experts with JAX's
    ValueError."""
    model = TransformerLM(TransformerConfig(n_experts=2))
    assert not any("w_up" in k for k in model.state_dict())
    with pytest.raises(ValueError) as jerr:
        JaxMoeMlp(JaxConfig()).init(jax.random.key(0), jnp.zeros((1, 4, 64)))
    with pytest.raises(ValueError) as err:
        TransformerLM(TransformerConfig(), mlp_cls=MoeMlp)
    assert str(err.value) == str(jerr.value)


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("flash", [False, True], ids=["plain", "flash"])
def test_remat_matches_jaxs_remat_model(flash, policy):
    """JAX's ``remat=True`` model with the same policy against the port's,
    fp32, at the tolerances of test_logits_loss_and_grads_match_jax."""
    _check_against_jax("fp32", flash, remat=policy)


def _logits_and_grads(cfg, flash, tokens):
    model = TransformerLM(cfg, flash_attention_fn() if flash else None,
                          seed=5)
    logits = model(tokens)
    cross_entropy_loss(logits.reshape(-1, logits.shape[-1]),
                       tokens.reshape(-1)).backward()
    return logits.detach(), {k: p.grad for k, p in model.named_parameters()}


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("flash", [False, True], ids=["plain", "flash"])
@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_remat_is_bitwise_the_model_without_it(dt, flash, policy):
    """The backward graph is the one the forward recorded and the
    recompute fills in the same values: logits and every gradient to the
    bit."""
    cfg = TransformerConfig(**SHAPE, dtype=DTYPES[dt][1])
    tokens = torch.from_numpy(_batch()[0]).long()
    logits, grads = _logits_and_grads(cfg, flash, tokens)
    r_logits, r_grads = _logits_and_grads(
        dataclasses.replace(cfg, remat=True, remat_policy=policy), flash,
        tokens)
    assert torch.equal(r_logits, logits)
    assert r_grads.keys() == grads.keys()
    for key, g in grads.items():
        assert torch.equal(r_grads[key], g), key


class _CountProducts(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.counts = Counter()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func in DOT_OPS:
            self.counts[str(func)] += 1
        return func(*args, **(kwargs or {}))


def test_dots_recomputes_no_product():
    """checkpoint_dots keeps every product: a step under ``dots`` runs
    the products of the step without remat, and ``full`` runs more (the
    blocks' forward products again, up to the last one the backward
    needs)."""
    cfg = TransformerConfig(**SHAPE)
    tokens = torch.from_numpy(_batch()[0]).long()
    counts = {}
    for name, c in (("none", cfg),
                    ("full", dataclasses.replace(cfg, remat=True)),
                    ("dots", dataclasses.replace(cfg, remat=True,
                                                 remat_policy="dots"))):
        with _CountProducts() as mode:
            _logits_and_grads(c, False, tokens)
        counts[name] = mode.counts
    assert counts["dots"] == counts["none"]
    assert sum(counts["full"].values()) > sum(counts["none"].values())


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_init_draws_on_a_cpu_generator_whatever_the_device(device,
                                                            monkeypatch):
    """Every generator the constructor makes is a CPU one, whatever device
    the model is asked for ("meta" stands in for the card here), so one
    seed gives the same weights on every device; the parameters end on
    the device asked for."""
    made = []
    real = torch.Generator

    def recording_generator(device="cpu"):
        made.append(torch.device(device).type)
        return real()

    monkeypatch.setattr(torch, "Generator", recording_generator)
    model = TransformerLM(TransformerConfig(**SHAPE), seed=3, device=device)
    assert made == ["cpu"]
    assert {p.device.type for p in model.parameters()} == {device}


def test_bf16_logits_stay_bf16_without_fp32_logits():
    cfg = TransformerConfig(**SHAPE, dtype=torch.bfloat16, fp32_logits=False)
    logits = TransformerLM(cfg)(torch.zeros((1, 8), dtype=torch.long))
    assert logits.dtype == torch.bfloat16 and logits.shape == (1, 8, 96)


@pytest.mark.parametrize("causal,q_offset,kv_offset",
                         [(True, 0, 0), (False, 0, 0), (True, 40, 8)])
@pytest.mark.parametrize("dt", ["fp32", "bf16"])
def test_causal_attention_matches_jax(dt, causal, q_offset, kv_offset):
    jd, td = DTYPES[dt]
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, 48, 2, 24)).astype(np.float32)
               for _ in range(3))
    want = jax_causal_attention(*(jnp.asarray(x, jd) for x in (q, k, v)),
                                causal=causal, q_offset=q_offset,
                                kv_offset=kv_offset)
    got = causal_attention(*(torch.from_numpy(x).to(td) for x in (q, k, v)),
                           causal=causal, q_offset=q_offset,
                           kv_offset=kv_offset)
    assert got.dtype == td
    # fp32: other summation orders; bf16: one rounding of the scores, the
    # weights and the output on each side
    assert _scaled_err(got.float().numpy(), want) <= (
        1e-5 if dt == "fp32" else 2e-2)


def test_bridge_round_trips_nested_and_flat_trees():
    model = TransformerLM(TransformerConfig(**SHAPE), seed=2)
    tree = params_to_flax(model)
    assert tree["params"]["block1"]["attn"]["qkv"]["kernel"].shape == (
        64, 3, 2, 32)
    assert tree["params"]["block0"]["attn"]["out"]["kernel"].shape == (
        2, 32, 64)
    assert tree["params"]["tok_emb"]["embedding"].shape == (96, 64)
    state = params_from_flax(tree)
    for key, t in model.state_dict().items():
        assert torch.equal(state[key], t), key
    flat = params_from_flax({"params": {"conv1": {"kernel": np.ones(3)}},
                             "batch_stats": {"bn1": {"mean": np.zeros(2)}}})
    assert sorted(flat) == ["bn1.mean", "conv1.kernel"]
