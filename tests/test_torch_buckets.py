"""The port's bucketed gradient sync (tpu_sandbox_torch/parallel/
buckets.py) == the JAX package's (tpu_sandbox/parallel/buckets.py).

``plan_buckets`` equal to JAX's on fixed cases and on hypothesis-drawn
sizes and keys, its errors word for word. Four gloo ranks, spawned once
for the module (tests/torch_dist_workers.py ``buckets_worker``), run
``sync_buckets`` on the ConvNet's gradient shapes (JAX's flatten order)
at a ``bucket_bytes`` of 4096, which makes four buckets, three of them a
lone over-target leaf (conv2's and the fc's kernels, the fc's bias after
them), in modes none, bf16, int8 and int8 without error feedback; JAX's
``sync_buckets`` runs the same inputs under ``shard_map`` on 4 virtual
CPU devices. Bars: none within fp32 roundoff of the sum's order (rtol
1e-6, atol 1e-7: gloo's ring and XLA order the 4-rank sum differently);
bf16 within 4 bf16 roundings of the summed magnitudes (2^-6 * mean
over ranks of |x|, as tests/test_torch_grad_compress.py); int8 mean and
residual within one int8 step of their block's scale (the residual's
own-chunk term within ``size`` steps). A ``RecordingGroup`` shows the
buckets issued in reversed span order on every rank, and
``BucketedSync``'s hooks issue them in that order during the backward
though autograd completes them in the other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st
from jax.sharding import PartitionSpec as JP

from torch_dist_workers import buckets_worker
from tpu_sandbox.parallel import buckets as jax_buckets
from tpu_sandbox.parallel import collectives as jax_coll
from tpu_sandbox.runtime.mesh import make_mesh as jax_make_mesh
from tpu_sandbox.utils.compat import shard_map
from tpu_sandbox_torch.models import ConvNet
from tpu_sandbox_torch.parallel import buckets
from tpu_sandbox_torch.parallel.launch import spawn
from torch_threads import one_torch_thread  # noqa: F401

WORLD, BUCKET_BYTES = 4, 4096
MODES = {"none": dict(mode="none"), "bf16": dict(mode="bf16"),
         "int8": dict(mode="int8"),
         "int8_noef": dict(mode="int8", error_feedback=False)}


def _leaves():
    """The ConvNet's parameters (32x32) in JAX's flatten order."""
    model = ConvNet((32, 32), device="cpu")
    return buckets.flatten_order(model.named_parameters())


def _inputs():
    rng = np.random.default_rng(0)
    names = [n for n, _ in _leaves()]
    shapes = [tuple(p.shape) for _, p in _leaves()]
    grads = [(rng.standard_normal((WORLD, *s)) * 0.1).astype(np.float32)
             for s in shapes]
    res = [(rng.standard_normal((WORLD, *s)) * 1e-3).astype(np.float32)
           for s in shapes]
    x = rng.standard_normal((WORLD, 5, 4)).astype(np.float32)
    return {"names": names, "grads": grads, "residuals": res,
            "bucket_bytes": BUCKET_BYTES, "modes": MODES, "x": x}


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, inputs):
    tmp = tmp_path_factory.mktemp("buckets")
    torch.save(inputs, tmp / "inputs.pt")
    spawn(buckets_worker, WORLD, str(tmp), str(tmp / "inputs.pt"),
          init_method=f"file://{tmp}/store", timeout=120)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


@pytest.fixture(scope="module")
def spans(inputs):
    nbytes = [g[0].nbytes for g in inputs["grads"]]
    return jax_buckets.plan_buckets(nbytes, BUCKET_BYTES,
                                    keys=[g.dtype for g in inputs["grads"]])


@pytest.fixture(scope="module")
def jax_results(inputs):
    """JAX's sync_buckets on the same per-rank leaves (a dict keyed by the
    zero-padded leaf index flattens in the leaves' order)."""
    mesh = jax_make_mesh({"data": WORLD}, devices=jax.devices()[:WORLD])
    tree = {f"{i:02d}": jnp.asarray(g) for i, g in enumerate(
        inputs["grads"])}
    rtree = {f"{i:02d}": jnp.asarray(r) for i, r in enumerate(
        inputs["residuals"])}
    out = {}
    for mode, policy in MODES.items():
        compress = jax_coll.CompressedAllReduce(**policy)

        def body(g, r, compress=compress):
            g = jax.tree.map(lambda x: x[0], g)
            r = jax.tree.map(lambda x: x[0], r)
            means, res = jax_buckets.sync_buckets(
                g, "data", WORLD, compress, residuals=r,
                bucket_bytes=BUCKET_BYTES)
            res = r if res is None else res
            return (jax.tree.map(lambda x: x[None], means),
                    jax.tree.map(lambda x: x[None], res))

        run = shard_map(body, mesh=mesh, in_specs=(JP("data"), JP("data")),
                        out_specs=(JP("data"), JP("data")), check_vma=False)
        means, res = jax.jit(run)(tree, rtree)
        keys = sorted(means)
        out[mode] = ([np.asarray(means[k]) for k in keys],
                     [np.asarray(res[k]) for k in keys]
                     if compress.needs_residual else None)
    return out


# -- plan_buckets ------------------------------------------------------------

PLAN_CASES = {
    "empty": ([], 10, None),
    "one": ([5], 10, None),
    "greedy": ([4, 4, 4, 4], 8, None),
    "over_target": ([3, 100, 3, 3], 8, None),
    "exact_fit": ([5, 5, 5], 10, None),
    "dtype_break": ([1, 1, 1, 1], 100, ["f32", "f32", "bf16", "f32"]),
    "convnet": ([64, 64, 128, 128, 64, 1600, 128, 51200, 40, 81920], 4096,
                None),
}


@pytest.mark.parametrize("name", sorted(PLAN_CASES))
def test_plan_buckets_is_jaxs(name):
    nbytes, target, keys = PLAN_CASES[name]
    assert buckets.plan_buckets(nbytes, target, keys) == \
        jax_buckets.plan_buckets(nbytes, target, keys)


@given(nbytes=st.lists(st.integers(0, 5000), max_size=40),
       target=st.integers(1, 6000), data=st.data())
@settings(max_examples=200, deadline=None)
def test_plan_buckets_is_jaxs_on_drawn_sizes(nbytes, target, data):
    keys = data.draw(st.one_of(st.none(), st.lists(
        st.sampled_from(["f32", "bf16", "i8"]), min_size=len(nbytes),
        max_size=len(nbytes))))
    got = buckets.plan_buckets(nbytes, target, keys)
    assert got == jax_buckets.plan_buckets(nbytes, target, keys)
    assert [i for a, b in got for i in range(a, b)] == list(
        range(len(nbytes)))


def _value_error(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


@pytest.mark.parametrize("args", [([1, 2], 0, None), ([1, 2], -5, None),
                                  ([1, 2], 8, ["f32"])],
                         ids=["zero", "negative", "keys"])
def test_plan_buckets_errors_are_jaxs(args):
    want = _value_error(lambda: jax_buckets.plan_buckets(*args))
    assert want
    assert _value_error(lambda: buckets.plan_buckets(*args)) == want


def test_flatten_order_is_jaxs():
    """The dotted names sorted part by part are jax.tree.flatten's order
    of the nested dict they name."""
    names = [n for n, _ in _leaves()]
    tree = {}
    for n in names:
        node = tree
        parts = n.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = n
    assert jax.tree.leaves(tree) == names
    assert buckets.DEFAULT_BUCKET_MB == jax_buckets.DEFAULT_BUCKET_MB


# -- sync_buckets on 4 ranks ---------------------------------------------------

def test_the_case_makes_lone_over_target_buckets(spans, inputs):
    lone = [(a, b) for a, b in spans if b - a == 1
            and inputs["grads"][a][0].nbytes > BUCKET_BYTES]
    assert len(spans) >= 3 and len(lone) >= 2, spans


def _step(mean_block):
    """One int8 step of a dequantised block: its absmax / 127."""
    return np.abs(mean_block).max(-1, keepdims=True) / np.float32(127.0)


def _int8_bound(spans, inputs, want, block_of):
    """Per leaf, the elementwise bound: the int8 step of the element's
    block in the flat bucket buffer's layout."""
    out = []
    for a, b in spans:
        flat = np.concatenate([w.reshape(WORLD, -1) for w in want[a:b]], 1)
        n = flat.shape[1]
        block = block_of(n)
        chunk = -(-n // (WORLD * block)) * block
        padded = np.pad(flat, ((0, 0), (0, WORLD * chunk - n)))
        step = np.broadcast_to(_step(padded.reshape(WORLD, -1, block)),
                               (WORLD, WORLD * chunk // block, block))
        step = step.reshape(WORLD, -1)[:, :n]
        off = 0
        for i in range(a, b):
            size = want[i][0].size
            out.append(step[:, off:off + size].reshape(want[i].shape))
            off += size
    return out


@pytest.mark.parametrize("mode", sorted(MODES))
def test_sync_buckets_means_are_jaxs(ranks, jax_results, inputs, spans,
                                     mode):
    want, _ = jax_results[mode]
    got = [np.stack([res[mode]["means"][i].numpy() for res in ranks])
           for i in range(len(want))]
    policy = jax_coll.CompressedAllReduce(**MODES[mode])
    if mode == "int8" or mode == "int8_noef":
        bounds = _int8_bound(spans, inputs, want,
                             lambda n: policy.block_for(n, WORLD))
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape
        for r in range(1, WORLD):
            np.testing.assert_array_equal(g[r], g[0])
        if mode == "none":
            np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-7)
        elif mode == "bf16":
            x = inputs["grads"][i]
            assert (np.abs(g - w) <= 2.0 ** -6 * np.abs(x).mean(0)).all()
        else:
            excess = np.abs(g - w) - bounds[i] * (1 + 1e-6)
            assert (excess <= 0).all(), (inputs["names"][i],
                                         float(excess.max()))


def test_sync_buckets_residuals_are_jaxs(ranks, jax_results, inputs, spans):
    """int8 with error feedback: each rank's leaf-shaped residuals against
    JAX's rank rows, within ``size`` int8 steps of the mean's block (the
    own-chunk term; shot 1's error is the same computation on both
    sides); without error feedback no residual comes back."""
    want_mean, want = jax_results["int8"]
    policy = jax_coll.CompressedAllReduce(mode="int8")
    bounds = _int8_bound(spans, inputs, want_mean,
                         lambda n: policy.block_for(n, WORLD))
    for i, w in enumerate(want):
        g = np.stack([res["int8"]["residuals"][i].numpy() for res in ranks])
        assert g.shape == w.shape
        excess = np.abs(g - w) - WORLD * bounds[i] * (1 + 1e-6) - 1e-7
        assert (excess <= 0).all(), (inputs["names"][i], float(excess.max()))
    for res in ranks:
        assert res["int8_noef"]["residuals"] is None
        assert res["none"]["residuals"] is None


def _bucket_sizes(spans, inputs, mode):
    """The numel each bucket's first collective carries, per span."""
    policy = jax_coll.CompressedAllReduce(**MODES[mode])
    out = []
    for a, b in spans:
        n = sum(inputs["grads"][i][0].size for i in range(a, b))
        if mode.startswith("int8"):
            block = policy.block_for(n, WORLD)
            n = WORLD * (-(-n // (WORLD * block)) * block)
        out.append(n)
    return out


@pytest.mark.parametrize("mode", sorted(MODES))
def test_buckets_issue_in_reversed_span_order_on_every_rank(ranks, inputs,
                                                            spans, mode):
    sizes = _bucket_sizes(spans, inputs, mode)
    assert len(set(sizes)) == len(sizes)
    for res in ranks:
        issued = res[mode]["issued"]
        first = [n for op, n, dtype in issued
                 if op == "sum" or dtype == "torch.int8"]
        assert first == sizes[::-1], issued


@pytest.mark.parametrize("mode", ["none", "int8"])
def test_hooks_issue_in_jax_order_whatever_autograd_delivers(ranks, inputs,
                                                            mode):
    """``_TwoLayer``: autograd lands a's gradient (span 0 in JAX's order)
    before b's (span 1); the hooks issue span 1 first, both during the
    backward, and ``finish`` leaves the mean of every rank's gradient in
    each ``.grad``."""
    grads = []
    for res in ranks:
        hooks = res["hooks"][mode]
        assert hooks["landed"] == ["a.kernel", "b.kernel"]
        sizes = [n for op, n, dtype in hooks["issued_in_backward"]
                 if op == "sum" or dtype == "torch.int8"]
        a, b = 18, 24                          # a.kernel 6x3, b.kernel 4x6
        if mode == "int8":                     # padded to whole blocks
            pol = jax_coll.CompressedAllReduce(mode="int8")
            a, b = (WORLD * (-(-n // (WORLD * pol.block_for(n, WORLD)))
                             * pol.block_for(n, WORLD)) for n in (a, b))
        assert sizes == [b, a]
        assert hooks["issued"] == hooks["issued_in_backward"]
        grads.append(hooks["grads"])
    for r in range(1, WORLD):
        for g, g0 in zip(grads[r], grads[0]):
            torch.testing.assert_close(g, g0, rtol=0, atol=0)
    # the mean of the per-rank gradients of sum((x b) a)^2
    from torch_dist_workers import _TwoLayer
    per_rank = []
    for r in range(WORLD):
        model = _TwoLayer()
        model(torch.from_numpy(inputs["x"][r])).square().sum().backward()
        per_rank.append([model.a.kernel.grad, model.b.kernel.grad])
    for i, g in enumerate(grads[0]):
        each = torch.stack([pr[i] for pr in per_rank])
        # int8: two quantisations, each within half a step of the largest
        # magnitude any rank sent
        atol = 1e-5 if mode == "none" else float(each.abs().max()) / 127
        torch.testing.assert_close(g, each.mean(0), rtol=1e-5, atol=atol)


def test_dropping_the_sync_frees_the_parameters_without_the_collector(ranks):
    """The hooks hold ``BucketedSync`` weakly: no reference cycle keeps a
    dropped model's parameters (and their device memory) until the garbage
    collector runs."""
    for res in ranks:
        assert res["freed_without_gc"]
