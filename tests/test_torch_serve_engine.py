"""The port's serve engines (tpu_sandbox_torch/serve/engine.py) at the JAX
serve tests' geometry (vocab 64, d 32, 4 heads, 2 layers, d_ff 64;
CacheConfig(24, 4, 8), max_batch 3, buckets (8, 16)), fp32 on the CPU:

- ContinuousEngine and StaticEngine give JAX's greedy tokens (JAX's own
  engines, from the same bridged weights) on one trace;
- prefix sharing and preemption under block pressure leave the tokens as
  they are without them (bitwise within the port, where JAX claims it);
- a sampled request interrupted mid-decode replays to the same tokens;
- the stub-step SLO cases of tests/test_serve_slo.py:80-145 (bounded queue,
  oldest-past-deadline shed, no result past its deadline, load report);
- swap_params: requests keep the weight version they were admitted on;
- a traced run of the port's recorder reads in JAX's trace collector.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tpu_sandbox.models.transformer import TransformerConfig as JaxConfig
from tpu_sandbox.models.transformer import TransformerLM as JaxLM
from tpu_sandbox.serve import CacheConfig as JaxCacheConfig
from tpu_sandbox.serve import ContinuousEngine as JaxContinuous
from tpu_sandbox.serve import Request as JaxRequest
from tpu_sandbox.serve import ServeConfig as JaxServeConfig
from tpu_sandbox.serve import StaticEngine as JaxStatic
from tpu_sandbox.serve.decode import build_decode_step as jax_build
from tpu_sandbox_torch.models.transformer import (TransformerConfig,
                                                  TransformerLM)
from tpu_sandbox_torch.obs import get_registry
from tpu_sandbox_torch.serve import (CacheConfig, ContinuousEngine, Request,
                                     ServeConfig, StaticEngine, live_engines)
from tpu_sandbox_torch.serve.decode import build_decode_step
from tpu_sandbox_torch.utils.bridge import params_from_flax
from torch_serve_stub import StubStep
from torch_threads import one_torch_thread  # noqa: F401

WIDTH = dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2, d_ff=64,
             max_len=128)
MCFG = TransformerConfig(**WIDTH)
CCFG = CacheConfig(num_blocks=24, block_size=4, max_blocks_per_seq=8)


@pytest.fixture(scope="module")
def jax_params():
    return JaxLM(JaxConfig(**WIDTH, dtype=jnp.float32)).init(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32))["params"]


@pytest.fixture(scope="module")
def params(jax_params):
    return params_from_flax({"params": jax.tree.map(np.asarray, jax_params)})


@pytest.fixture(scope="module")
def step():
    return build_decode_step(MCFG, CCFG, max_batch=3, buckets=(8, 16))


@pytest.fixture(scope="module")
def jax_step():
    return jax_build(JaxConfig(**WIDTH, dtype=jnp.float32),
                     JaxCacheConfig(24, 4, 8), max_batch=3, buckets=(8, 16))


def _scfg(**over):
    base = dict(model=MCFG, cache=CCFG, max_batch=3, buckets=(8, 16))
    base.update(over)
    return ServeConfig(**base)


def _requests(rng, n, *, lo=3, hi=13, new_lo=4, new_hi=10):
    """tests/test_serve.py's request generator, as (rid, prompt, new)."""
    out = []
    for i in range(n):
        prompt = [int(t) for t in rng.integers(1, 64,
                                               size=int(rng.integers(lo, hi)))]
        out.append((f"r{i}", prompt, int(rng.integers(new_lo, new_hi))))
    return out


def _serve(engine, reqs, **kw):
    for rid, prompt, n in reqs:
        engine.submit(Request(rid=rid, prompt=list(prompt), max_new_tokens=n,
                              **kw))
    engine.run_until_idle()
    return {rid: r.tokens for rid, r in engine.results.items()}


def _jax_serve(cls, jax_params, jax_step, reqs, cache=(24, 4, 8)):
    eng = cls(jax_params, JaxServeConfig(
        model=JaxConfig(**WIDTH, dtype=jnp.float32),
        cache=JaxCacheConfig(*cache), max_batch=3, buckets=(8, 16)),
        step=jax_step)
    for rid, prompt, n in reqs:
        eng.submit(JaxRequest(rid=rid, prompt=list(prompt),
                              max_new_tokens=n))
    eng.run_until_idle()
    return ({rid: r.tokens for rid, r in eng.results.items()},
            sum(r.preemptions for r in eng.results.values()))


@pytest.mark.parametrize("kind", ["continuous", "static"])
def test_engines_give_jax_greedy_tokens(kind, params, step, jax_params,
                                        jax_step):
    """One trace through the port's engine and JAX's of the same kind (and
    JAX's other kind), from one bridged tree: the same greedy tokens."""
    reqs = _requests(np.random.default_rng(1), 8)
    ours_cls, jax_cls = {"continuous": (ContinuousEngine, JaxContinuous),
                         "static": (StaticEngine, JaxStatic)}[kind]
    eng = ours_cls(params, _scfg(), step=step, device="cpu")
    got = _serve(eng, reqs)
    want, _ = _jax_serve(jax_cls, jax_params, jax_step, reqs)
    assert got == want
    assert all(r.ttft >= 0 for r in eng.results.values())
    assert not live_engines()


def test_continuous_and_static_agree_bitwise(params, step):
    reqs = _requests(np.random.default_rng(11), 9)
    cont = _serve(ContinuousEngine(params, _scfg(), step=step,
                                   device="cpu"), reqs)
    stat = _serve(StaticEngine(params, _scfg(), step=step, device="cpu"),
                  reqs)
    assert cont == stat


def test_prefix_sharing_preserves_outputs(params, step):
    """Duplicate prompts share prefix blocks (observable in the stats) and
    the outputs stay those of an engine that shares nothing."""
    rng = np.random.default_rng(2)
    prompt = [int(t) for t in rng.integers(1, 64, size=9)]
    eng = ContinuousEngine(params, _scfg(), step=step, device="cpu")
    eng.submit(Request(rid="a", prompt=list(prompt), max_new_tokens=6))
    eng.run_until_idle()
    eng.submit(Request(rid="b", prompt=list(prompt), max_new_tokens=6))
    eng.run_until_idle()
    assert eng.cache.stats["prefix_hits"] >= 1
    alone = _serve(ContinuousEngine(params, _scfg(), step=step,
                                    device="cpu"), [("c", prompt, 6)])
    assert eng.results["a"].tokens == alone["c"]
    assert eng.results["b"].tokens == alone["c"]


def test_preemption_under_block_pressure_replays_identically(
        params, step, jax_params, jax_step):
    """Three distinct 12-token prompts decoding to the 32-token context:
    3 x 8 blocks > 23 usable, so one grow fails and a sequence is
    preempted, requeued and replayed. Its tokens are bitwise those of a
    pool without pressure, and JAX's."""
    rng = np.random.default_rng(3)
    reqs = [(f"r{i}", [int(t) for t in rng.integers(1, 64, size=12)], 20)
            for i in range(3)]
    eng = ContinuousEngine(params, _scfg(), step=step, device="cpu")
    pressed = _serve(eng, reqs)
    assert sum(r.preemptions for r in eng.results.values()) >= 1
    roomy = CacheConfig(num_blocks=64, block_size=4, max_blocks_per_seq=8)
    calm_eng = ContinuousEngine(params, _scfg(cache=roomy), step=step,
                                device="cpu")
    calm = _serve(calm_eng, reqs)
    assert sum(r.preemptions for r in calm_eng.results.values()) == 0
    assert pressed == calm
    want, jax_preempted = _jax_serve(JaxContinuous, jax_params, jax_step,
                                     reqs)
    assert jax_preempted >= 1 and pressed == want


def test_sampled_request_interrupted_mid_decode_replays_bitwise(params,
                                                               step):
    """A temperature/top-k request decoded partway, drained back to request
    form (the replica's SIGTERM path) and replayed on a fresh engine draws
    the same tokens as an uninterrupted run, and they are not greedy's."""
    rng = np.random.default_rng(6)
    prompt = [int(t) for t in rng.integers(1, 64, size=9)]
    kw = dict(temperature=3.0, top_k=8, seed=7)
    want = _serve(ContinuousEngine(params, _scfg(), step=step, device="cpu"),
                  [("s", prompt, 12)], **kw)["s"]
    greedy = _serve(ContinuousEngine(params, _scfg(), step=step,
                                     device="cpu"), [("g", prompt, 12)])["g"]
    assert want != greedy, "temperature 3.0 reproduced greedy"
    eng = ContinuousEngine(params, _scfg(), step=step, device="cpu")
    eng.submit(Request(rid="s", prompt=list(prompt), max_new_tokens=12, **kw))
    for _ in range(4):
        eng.step()
    assert 3 <= len(eng.slots[0].generated) < 12
    (req,) = eng.drain_to_requests()
    again = ContinuousEngine(params, _scfg(), step=step, device="cpu")
    again.submit(req)
    again.run_until_idle()
    assert again.results["s"].tokens == want


def test_swap_params_keeps_each_request_on_its_version(params, step):
    """A request admitted before a swap decodes every token on the weights
    it pinned; one admitted after decodes on the new version; each equals
    an engine that only ever held that version. Unpinned versions are
    dropped, the prefix cache is flushed, and a pin to weights the engine
    no longer holds is shed as stale."""
    other = TransformerLM(MCFG, seed=1).state_dict()
    a = [int(t) for t in np.random.default_rng(7).integers(1, 64, size=6)]
    b = [int(t) for t in np.random.default_rng(8).integers(1, 64, size=7)]
    only_v0 = _serve(ContinuousEngine(params, _scfg(), step=step,
                                      device="cpu"), [("a", a, 10)])
    only_v1 = _serve(ContinuousEngine(other, _scfg(), step=step,
                                      device="cpu"), [("b", b, 6)])
    eng = ContinuousEngine(params, _scfg(), step=step, device="cpu")
    eng.submit(Request(rid="a", prompt=list(a), max_new_tokens=10))
    eng.step()
    eng.step()
    swaps = get_registry().counter("engine.swap").value
    eng.swap_params(other, 1)
    assert get_registry().counter("engine.swap").value == swaps + 1
    assert eng.version == 1 and eng.has_version(0) and eng.has_version(1)
    eng.submit(Request(rid="b", prompt=list(b), max_new_tokens=6))
    eng.run_until_idle()
    assert eng.results["a"].tokens == only_v0["a"]
    assert eng.results["a"].ver == 0
    assert eng.results["b"].tokens == only_v1["b"] and eng.results["b"].ver == 1
    eng.swap_params(params, 2)            # v1 is pinned by nothing now
    assert not eng.has_version(1) and eng.has_version(0)  # 0: boot version
    eng.submit(Request(rid="c", prompt=list(b), max_new_tokens=2, ver=1))
    eng.run_until_idle()
    assert eng.shed["c"].reason == "stale_version" and "c" not in eng.results
    assert eng.load_report()["ver"] == 2


def test_engine_needs_the_card_unless_asked_for_the_cpu(params):
    """The device defaults to CUDA: no card is an error, never a silent CPU
    run."""
    if torch.cuda.is_available():
        eng = ContinuousEngine(params, _scfg())
        assert eng.device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ContinuousEngine(params, _scfg())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StaticEngine(None, _scfg(), step=StubStep())


# -- SLO guardrails on the stub step (tests/test_serve_slo.py:25-145) ------


class _Clock:
    def __init__(self):
        self.t = 0.0

    def advance(self, dt):
        self.t += dt

    def __call__(self):
        return self.t


def _stub_engine(clock=None, **over):
    cfg = ServeConfig(model=MCFG, cache=CCFG, max_batch=2, buckets=(8, 16),
                      **over)
    return ContinuousEngine(None, cfg, step=StubStep(),
                            clock=clock or _Clock(), device="cpu")


def _req(rid, n=3, **kw):
    return Request(rid=rid, prompt=[1, 2, 3], max_new_tokens=n, **kw)


def test_stub_engine_serves_end_to_end():
    eng = _stub_engine()
    eng.submit(_req("r0", n=4))
    eng.run_until_idle()
    # next-token stub: 3 -> 4 -> 5 -> 6 -> 7
    assert eng.results["r0"].tokens == [4, 5, 6, 7]
    assert not eng.shed


def test_bounded_queue_sheds_incoming_with_verdict():
    eng = _stub_engine(max_waiting=2)
    assert eng.submit(_req("r0"))
    assert eng.submit(_req("r1"))
    assert not eng.submit(_req("r2"))
    assert eng.shed["r2"].reason == "queue_full"
    # shed is terminal and exclusive: never also queued
    assert [r.rid for r in eng.waiting] == ["r0", "r1"]
    eng.drain_to_requests()


def test_overload_sheds_oldest_past_deadline_first():
    clock = _Clock()
    eng = _stub_engine(clock, max_waiting=2)
    eng.submit(_req("r0", deadline=1.0))
    eng.submit(_req("r1"))
    clock.advance(2.0)  # r0 is now past its deadline
    assert eng.submit(_req("r2"))  # takes the slot r0's shed frees
    assert eng.shed["r0"].reason == "deadline"
    assert [r.rid for r in eng.waiting] == ["r1", "r2"]
    eng.drain_to_requests()


def test_no_result_ever_lands_past_deadline():
    clock = _Clock()
    eng = _stub_engine(clock)
    # expires while waiting: shed before admission
    eng.submit(_req("rw", deadline=1.0))
    clock.advance(2.0)
    eng.step()
    assert eng.shed["rw"].reason == "deadline" and "rw" not in eng.results
    # expires while active: shed mid-flight, blocks returned
    free0 = eng.cache.free_blocks
    eng.submit(_req("ra", n=20, deadline=5.0))
    eng.step()  # admit + prefill
    assert eng.active_requests == 1
    clock.advance(10.0)
    eng.step()
    assert eng.shed["ra"].reason == "deadline" and "ra" not in eng.results
    assert eng.active_requests == 0 and eng.cache.free_blocks == free0
    # finishes past deadline (deadline passes inside the final step):
    # verdict is SHED, not a late result
    eng.submit(_req("rf", n=1, deadline=clock.t + 0.5))
    clock.advance(0.4)

    real_pick = eng._pick_token

    def slow_pick(slot, row):
        clock.advance(1.0)  # the step outlives the deadline
        return real_pick(slot, row)

    eng._pick_token = slow_pick
    eng.step()
    assert eng.shed["rf"].reason == "deadline" and "rf" not in eng.results


def test_load_report_signals():
    clock = _Clock()
    eng = _stub_engine(clock, max_waiting=8)
    for i in range(4):
        eng.submit(_req(f"r{i}", n=6))
    eng.step()
    clock.advance(3.0)
    rep = eng.load_report()
    assert rep["active"] == 2 and rep["queue_depth"] == 2
    assert 0.0 < rep["free_block_frac"] < 1.0
    assert rep["step_age"] == pytest.approx(3.0)
    assert {"recorder", "dropped_events", "prefix_digest"} <= set(rep)
    eng.run_until_idle()


def test_sampled_stub_request_replays_bitwise_after_requeue():
    """tests/test_serve_slo.py:354: kill-and-requeue a temperature/top-k
    request mid-decode (stub step): the replayed trajectory is identical."""
    kw = dict(temperature=0.9, top_k=8, seed=42)
    ref = _stub_engine()
    ref.submit(_req("s0", n=12, **kw))
    ref.run_until_idle()
    want = ref.results["s0"].tokens

    eng = _stub_engine()
    eng.submit(_req("s0", n=12, **kw))
    for _ in range(5):
        eng.step()
    reqs = eng.drain_to_requests()
    assert len(reqs) == 1 and reqs[0].temperature == 0.9
    eng2 = _stub_engine()
    eng2.submit(reqs[0])
    eng2.run_until_idle()
    assert eng2.results["s0"].tokens == want


def test_traced_engine_run_reads_in_jax_collector(tmp_path, monkeypatch):
    """The port's whole recorder keeps JAX's trace format: a stub engine
    run traced under TPU_SANDBOX_TRACE_DIR (admit, prefill, decode spans
    chained to the request's context, a shed instant, a metric sample)
    loads, merges, renders and chains in JAX's collector."""
    from tpu_sandbox.obs import collect
    from tpu_sandbox_torch.obs import TraceContext, get_recorder, reset_recorder

    monkeypatch.setenv("TPU_SANDBOX_TRACE_DIR", str(tmp_path))
    reset_recorder()
    try:
        rec = get_recorder()
        assert rec.enabled
        with rec.span("submit", args={"rid": "r0"}) as root:
            tc = root.ctx.to_wire()
        eng = _stub_engine(max_waiting=1)
        eng.submit(_req("r0", n=3, tc=tc))
        eng.submit(_req("r1"))                 # the queue is full: shed
        eng.run_until_idle()
        rec.metric("engine.done", 1)
        assert rec.stats()["dropped"] == 0
    finally:
        reset_recorder()                       # flushes and closes the log
    merged = collect.load_merged(str(tmp_path))
    names = {r.get("name") for r in merged}
    assert {"submit", "admit", "prefill", "decode", "shed:queue_full",
            "engine.done"} <= names
    chain = collect.trace_chains(merged)[TraceContext.from_wire(tc).trace_id]
    check = collect.chain_check(chain)
    assert check["connected"], check
    assert {"submit", "admit", "prefill", "decode"} <= set(check["names"])
    chrome = collect.to_chrome_trace(merged)
    assert any(e.get("name") == "decode" for e in chrome["traceEvents"])
