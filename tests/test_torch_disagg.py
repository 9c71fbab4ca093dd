"""The port's disaggregated prefill/decode (tpu_sandbox_torch/serve/disagg.py)
through JAX's ``test_disagg_tokens_identical_to_single_replica`` cases
(tests/test_mpmd.py:136), on JAX's geometry (vocab 64, d 32, 4 heads, 2
layers, fp32, 24 blocks of 4): the split path's tokens equal the port's
``ContinuousEngine`` serving the same request, greedy and sampled, over
the host wire and the device wire; the handoff is claim-once within a
generation and replays in the next. Greedy, the tokens also equal JAX's
disaggregated path's from the same (bridged) weights."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from tpu_sandbox.models.transformer import TransformerConfig as JConfig
from tpu_sandbox.models.transformer import TransformerLM as JLM
from tpu_sandbox.mpmd.transport import LocalTransport as JLocalTransport
from tpu_sandbox.serve import disagg as jdisagg
from tpu_sandbox.serve.cache import CacheConfig as JCacheConfig
from tpu_sandbox.serve.decode import build_decode_step as jbuild_decode_step
from tpu_sandbox_torch.models.transformer import TransformerConfig
from tpu_sandbox_torch.mpmd.transport import DeviceTransport, LocalTransport
from tpu_sandbox_torch.serve.cache import CacheConfig
from tpu_sandbox_torch.serve.decode import build_decode_step
from tpu_sandbox_torch.serve.disagg import (
    DecodeReplica,
    DisaggRequest,
    PrefillReplica,
    serve_disaggregated,
)
from tpu_sandbox_torch.serve.engine import ContinuousEngine, Request, ServeConfig
from tpu_sandbox_torch.utils.bridge import params_from_flax
from torch_threads import one_torch_thread  # noqa: F401

MODEL = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             max_len=128)
CACHE = dict(num_blocks=24, block_size=4, max_blocks_per_seq=8)
PROMPT = [5, 9, 3, 7, 11, 2]
WIRES = {"local": LocalTransport, "device": DeviceTransport}


@pytest.fixture(scope="module")
def jax_params():
    return JLM(JConfig(**MODEL, dtype=jnp.float32)).init(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]


@pytest.fixture(scope="module")
def setup(jax_params):
    mcfg, ccfg = TransformerConfig(**MODEL), CacheConfig(**CACHE)
    params = params_from_flax(
        {"params": jax.tree.map(np.asarray, jax_params)})
    step = build_decode_step(mcfg, ccfg, max_batch=3, buckets=(8, 16))
    return mcfg, ccfg, params, step


def _engine_tokens(setup, prompt, temperature, seed, n=9):
    mcfg, ccfg, params, step = setup
    eng = ContinuousEngine(params, ServeConfig(model=mcfg, cache=ccfg,
                                               max_batch=3, buckets=(8, 16)),
                           step=step, device="cpu")
    eng.submit(Request(rid="a", prompt=list(prompt), max_new_tokens=n,
                       temperature=temperature, seed=seed))
    eng.run_until_idle()
    return eng.results["a"].tokens


def _replicas(setup, tr, generation=0):
    mcfg, ccfg, params, step = setup
    return (PrefillReplica(params, mcfg, ccfg, tr, step=step, device="cpu"),
            DecodeReplica(params, mcfg, ccfg, tr, step=step, device="cpu",
                          generation=generation))


@pytest.mark.parametrize("wire", sorted(WIRES))
@pytest.mark.parametrize("temperature,seed", [(0.0, 0), (0.8, 42)])
def test_disagg_tokens_identical_to_single_replica(setup, temperature, seed,
                                                   wire):
    """Prefill on one replica, KV pages over the stage transport, decode
    on another: the tokens of a single ContinuousEngine serving the same
    request. A second decode of the request in one generation is refused;
    a relaunched decode replica (generation 1) replays it."""
    ref = _engine_tokens(setup, PROMPT, temperature, seed)
    tr = WIRES[wire]()
    prefill, decode = _replicas(setup, tr)
    req = DisaggRequest(rid="a", prompt=list(PROMPT), max_new_tokens=9,
                        temperature=temperature, seed=seed)
    assert serve_disaggregated(prefill, decode, req) == ref
    assert tr.stats.bytes_out == tr.stats.bytes_in > 0
    with pytest.raises(RuntimeError, match="already decoded"):
        decode.decode_from_handoff(req)
    prefill2, _ = _replicas(setup, tr)
    prefill2.prefill_and_ship(req)  # idempotent replay put
    _, decode2 = _replicas(setup, tr, generation=1)
    assert decode2.decode_from_handoff(req) == ref


def test_handoff_ships_only_the_requests_block_rows(setup):
    """The slot holds the request's rows (2 blocks of 4 for a 6-token
    prompt) and the next-token logits, not the page pool."""
    tr = LocalTransport()
    prefill, _ = _replicas(setup, tr)
    prefill.prefill_and_ship(DisaggRequest(rid="r", prompt=list(PROMPT),
                                           max_new_tokens=2))
    k_rows, v_rows, logits = tr.get("kvpage/r", 0, 0, timeout=5.0)
    hd = MODEL["d_model"] // MODEL["n_heads"]
    assert k_rows.shape == v_rows.shape == (MODEL["n_layers"], 2, 4,
                                            MODEL["n_heads"], hd)
    assert logits.shape == (MODEL["vocab_size"],)


def test_greedy_tokens_equal_jaxs_disaggregated_path(setup, jax_params):
    """Greedy, the port's split path gives JAX's split path's tokens from
    the same weights, for prompts across both buckets and a shared
    prefix."""
    jm = JConfig(**MODEL, dtype=jnp.float32)
    jc = JCacheConfig(**CACHE)
    jstep = jbuild_decode_step(jm, jc, max_batch=3, buckets=(8, 16))
    jtr, tr = JLocalTransport(), LocalTransport()
    jpre = jdisagg.PrefillReplica(jax_params, jm, jc, jtr, step=jstep)
    jdec = jdisagg.DecodeReplica(jax_params, jm, jc, jtr, step=jstep)
    prefill, decode = _replicas(setup, tr)
    prompts = [PROMPT, PROMPT + [13, 17, 19, 23, 29, 31], [1, 2, 3],
               list(range(40, 53))]
    for i, prompt in enumerate(prompts):
        want = jdisagg.serve_disaggregated(
            jpre, jdec, jdisagg.DisaggRequest(rid=f"q{i}", prompt=prompt,
                                              max_new_tokens=6))
        got = serve_disaggregated(
            prefill, decode, DisaggRequest(rid=f"q{i}", prompt=prompt,
                                           max_new_tokens=6))
        assert got == want, (i, got, want)
