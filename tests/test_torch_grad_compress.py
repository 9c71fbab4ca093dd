"""The port's compressed gradient sync (tpu_sandbox_torch/parallel/
collectives.py: ``CompressedAllReduce``, ``int8_block_pmean``,
``_quantize_int8_blocks``, ``as_compress_policy``) == the JAX package's.

The policy's checks word for word, ``block_for`` and ``wire_bytes`` equal
to JAX's for a list of leaf sizes over 1, 2, 4 and 8 ranks, and the
quantiser bit for bit on the same blocks (ties at .5 included). Four gloo
ranks, spawned once for the module (tests/torch_dist_workers.py
``compress_worker``), run ``int8_block_pmean`` with and without a
residual and the bf16 mean on per-rank inputs that JAX's functions take
under ``shard_map`` on 4 virtual CPU devices.

Bars. int8: the mean and the new residual agree with JAX's element by
element within one int8 step of their block's scale (the shot-2 scale of
the element's block, absmax / 127 of JAX's mean block; the residual's
shot-2 term is ``size`` times the shot-2 error, so its step there is
``size`` times that scale); the quantised payloads (shot 1 from each
rank's input, shot 2 read back from each mean) differ from JAX's in under
1 % of their values, which happens only where an fp32 sum over ranks
lands on a rounding boundary (the share is printed). No bitwise match is
asked across frameworks: the sum over ranks is ordered differently. bf16:
JAX's CPU all-reduce sums the bf16 operand in fp32 and rounds once, gloo's
ring rounds to bf16 at each of its 3 hops, so the two means differ by at
most 4 bf16 roundings (unit 2^-8) of the summed magnitudes: element by
element |port - JAX| <= 2^-6 * mean over ranks of |x|.
The error feedback telescopes, as JAX's test states it
(tests/test_grad_compress.py:116): the sum of the means over 5 steps plus
the sum of the final residuals over ranks divided by the size is the sum
of the exact means within 1e-5.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from torch_dist_workers import compress_worker
from tpu_sandbox.parallel import collectives as jax_coll
from tpu_sandbox.runtime.mesh import make_mesh as jax_make_mesh
from tpu_sandbox.utils.compat import shard_map
from tpu_sandbox_torch.parallel import collectives as coll
from tpu_sandbox_torch.parallel.launch import spawn
from torch_threads import one_torch_thread  # noqa: F401

WORLD = 4
#: int8 cases: (per-rank shape, block, with a residual)
INT8 = {
    "33x77_b256": ((33, 77), 256, False),
    "33x77_b256_res": ((33, 77), 256, True),
    "2048x10_b64_res": ((2048, 10), 64, True),
    "5x5x16x32_b256_res": ((5, 5, 16, 32), 256, True),
    "bias16_b8_res": ((16,), 8, True),
    "odd1001_b32": ((1001,), 32, False),
}
BF16 = {"33x77": (33, 77), "2048x10": (2048, 10)}
TELE_SHAPE, TELE_STEPS, TELE_BLOCK = (19, 53), 5, 128
#: the leaf sizes of block_for / wire_bytes: the ConvNet's, a bias, odd
#: and round sizes, one large leaf
LEAF_SIZES = [400, 16, 12800, 32, 20480, 10, 1, 7, 255, 256, 257, 2048,
              1 << 20]


def _rng_values(seed, shape, scale=1.0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((WORLD, *shape)) * scale).astype(np.float32)


def _inputs():
    int8 = {}
    for i, (name, (shape, block, res)) in enumerate(INT8.items()):
        values = _rng_values(i, shape)
        values[1, ..., :1] = 0.0             # some blocks hold zeros
        residual = _rng_values(100 + i, shape, 1e-2) if res else None
        int8[name] = (values, residual, block)
    bf16 = {name: _rng_values(200 + i, shape)
            for i, (name, shape) in enumerate(BF16.items())}
    tele = [_rng_values(300 + s, TELE_SHAPE) for s in range(TELE_STEPS)]
    return {"int8": int8, "bf16": bf16, "tele": tele,
            "tele_block": TELE_BLOCK}


@pytest.fixture(scope="module")
def inputs():
    return _inputs()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory, inputs):
    tmp = tmp_path_factory.mktemp("compress")
    torch.save(inputs, tmp / "inputs.pt")
    spawn(compress_worker, WORLD, str(tmp), str(tmp / "inputs.pt"),
          init_method=f"file://{tmp}/store", timeout=120)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


@pytest.fixture(scope="module")
def mesh():
    return jax_make_mesh({"data": WORLD}, devices=jax.devices()[:WORLD])


def _jax_pmean(mesh, policy, values, residual=None):
    """JAX's ``policy.pmean`` under shard_map: every rank's (mean,
    residual) stacked on the leading axis."""
    def body(v, r):
        mean, res = policy.pmean(v[0], "data", WORLD,
                                 None if residual is None else r[0])
        return mean[None], (r if res is None else res[None])

    run = shard_map(body, mesh=mesh, in_specs=(JP("data"), JP("data")),
                    out_specs=(JP("data"), JP("data")), check_vma=False)
    r = np.zeros_like(values) if residual is None else residual
    mean, res = jax.jit(run)(jnp.asarray(values), jnp.asarray(r))
    return np.asarray(mean), (None if residual is None else np.asarray(res))


# -- the policy --------------------------------------------------------------

def _error(make):
    try:
        make()
    except ValueError as e:
        return str(e)
    return ""


@pytest.mark.parametrize("kwargs", [dict(mode="fp4"), dict(mode="int4"),
                                    dict(mode="int8", block=0),
                                    dict(mode="bf16", block=-3)],
                         ids=["fp4", "int4", "block0", "block-3"])
def test_policy_validation_is_jaxs(kwargs):
    want = _error(lambda: jax_coll.CompressedAllReduce(**kwargs))
    assert want
    assert _error(lambda: coll.CompressedAllReduce(**kwargs)) == want


def test_policy_properties_are_jaxs():
    for mode in ("none", "bf16", "int8"):
        for ef in (True, False):
            ours = coll.CompressedAllReduce(mode=mode, error_feedback=ef)
            ref = jax_coll.CompressedAllReduce(mode=mode, error_feedback=ef)
            assert ours.needs_residual == ref.needs_residual
            assert (ours.mode, ours.block) == (ref.mode, ref.block)
    for given in (None, "", "none", "bf16", "int8"):
        assert (coll.as_compress_policy(given).mode
                == jax_coll.as_compress_policy(given).mode)
    p = coll.CompressedAllReduce(mode="int8")
    assert coll.as_compress_policy(p) is p
    assert coll._COMPRESS_MODES == jax_coll._COMPRESS_MODES


@pytest.mark.parametrize("size", [1, 2, 4, 8])
def test_block_for_is_jaxs(size):
    for block in (256, 64, 8, 1):
        ours = coll.CompressedAllReduce(mode="int8", block=block)
        ref = jax_coll.CompressedAllReduce(mode="int8", block=block)
        for n in LEAF_SIZES:
            assert ours.block_for(n, size) == ref.block_for(n, size), (n,
                                                                        block)


@pytest.mark.parametrize("mode", ["none", "bf16", "int8"])
@pytest.mark.parametrize("size", [1, 2, 4, 8])
def test_wire_bytes_is_jaxs(mode, size):
    for block in (256, 32):
        ours = coll.CompressedAllReduce(mode=mode, block=block)
        ref = jax_coll.CompressedAllReduce(mode=mode, block=block)
        assert ours.wire_bytes(LEAF_SIZES, size) == ref.wire_bytes(
            LEAF_SIZES, size)
        for n in LEAF_SIZES:
            assert ours.wire_bytes([n], size) == ref.wire_bytes([n], size)


def test_quantizer_is_jaxs_bit_for_bit():
    """Symmetric per-block int8 on the same blocks: the same codes and
    scales; ties at .5 round to even; an all-zero block gives zero codes
    and a zero scale."""
    rng = np.random.default_rng(5)
    v = rng.standard_normal((6, 7, 64)).astype(np.float32)
    v[0, 0] = 0.0
    v[1, 0, :6] = [127.0, 2.5, -3.5, 0.5, -0.5, 1.5]   # scale 1: ties
    v[1, 0, 6:] = 0.0
    q, s = coll._quantize_int8_blocks(torch.from_numpy(v))
    jq, js = jax_coll._quantize_int8_blocks(jnp.asarray(v))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    assert q[1, 0, :6].tolist() == [127, 2, -4, 0, 0, 2]
    assert not q[0, 0].any() and float(s[0, 0]) == 0.0


# -- int8_block_pmean on 4 ranks ------------------------------------------

def _blocks(x, block):
    """[WORLD, *shape] -> the per-rank flat padded blocks of shot 2's
    layout: [WORLD, WORLD * nb, block] (chunk j of rank r's mean is rank
    j's requantised chunk)."""
    flat = x.reshape(WORLD, -1)
    n = flat.shape[1]
    chunk = -(-n // (WORLD * block)) * block
    pad = WORLD * chunk - n
    return np.pad(flat, ((0, 0), (0, pad))).reshape(WORLD, -1, block), n


def _codes(blocks):
    """The shot-2 codes a dequantised mean block holds: its values over
    its scale (absmax / 127), rounded."""
    s = np.abs(blocks).max(-1, keepdims=True) / np.float32(127.0)
    safe = np.where(s > 0, s, np.float32(1.0))
    return np.clip(np.round(blocks / safe), -127, 127).astype(np.int8), s


@pytest.fixture(scope="module")
def jax_int8(mesh, inputs):
    out = {}
    for name, (values, residual, block) in inputs["int8"].items():
        # the case's block: JAX's int8_block_pmean itself, as the port's
        # is called
        def body(v, r, block=block, res=residual is not None):
            mean, new = jax_coll.int8_block_pmean(
                v[0], r[0] if res else None, "data", WORLD, block)
            return mean[None], (r if new is None else new[None])

        run = shard_map(body, mesh=mesh, in_specs=(JP("data"), JP("data")),
                        out_specs=(JP("data"), JP("data")), check_vma=False)
        r = np.zeros_like(values) if residual is None else residual
        mean, res = jax.jit(run)(jnp.asarray(values), jnp.asarray(r))
        out[name] = (np.asarray(mean),
                     None if residual is None else np.asarray(res))
    return out


@pytest.mark.parametrize("name", sorted(INT8))
def test_int8_mean_is_jaxs_within_one_step(ranks, jax_int8, inputs, name):
    _, _, block = inputs["int8"][name]
    want, _ = jax_int8[name]
    got = np.stack([res["int8"][name][0].numpy() for res in ranks])
    assert got.shape == want.shape and got.dtype == np.float32
    for r in range(1, WORLD):       # every rank holds the same mean
        np.testing.assert_array_equal(got[r], got[0])
    gb, n = _blocks(got, block)
    wb, _ = _blocks(want, block)
    _, step = _codes(wb)
    excess = np.abs(gb - wb) - step * (1 + 1e-6)
    assert (excess <= 0).all(), float(excess.max())


@pytest.mark.parametrize("name", sorted(INT8))
def test_int8_payloads_differ_from_jaxs_in_under_1_percent(ranks, jax_int8,
                                                          inputs, name):
    """Shot 1's codes (each rank's own input and residual, quantised)
    and shot 2's (read back from the mean): the share that differ from
    JAX's."""
    values, residual, block = inputs["int8"][name]
    v = values + (0 if residual is None else residual)
    vb, _ = _blocks(v, block)
    q1, _ = coll._quantize_int8_blocks(torch.from_numpy(vb))
    jq1, _ = jax_coll._quantize_int8_blocks(jnp.asarray(vb))
    shot1 = float(np.mean(q1.numpy() != np.asarray(jq1)))
    got = np.stack([res["int8"][name][0].numpy() for res in ranks])
    q2, _ = _codes(_blocks(got, block)[0])
    jq2, _ = _codes(_blocks(jax_int8[name][0], block)[0])
    shot2 = float(np.mean(q2 != jq2))
    print(f"{name}: shot-1 codes differing {shot1:.3%}, shot-2 {shot2:.3%}")
    assert shot1 < 0.01 and shot2 < 0.01


@pytest.mark.parametrize("name", sorted(n for n, c in INT8.items() if c[2]))
def test_int8_residual_is_jaxs_within_one_step(ranks, jax_int8, inputs,
                                              name):
    """Each rank's new residual against JAX's rank row: within one shot-2
    step times the size on the rank's own chunk (the injected term) and
    one step elsewhere."""
    _, _, block = inputs["int8"][name]
    want_mean, want = jax_int8[name]
    got = np.stack([res["int8"][name][1].numpy() for res in ranks])
    assert got.shape == want.shape
    gb, _ = _blocks(got, block)
    wb, _ = _blocks(want, block)
    _, step = _codes(_blocks(want_mean, block)[0])   # [WORLD, W*nb, 1]
    nb = gb.shape[1] // WORLD
    bound = np.broadcast_to(step, gb.shape).copy()
    for r in range(WORLD):
        bound[r, r * nb:(r + 1) * nb] *= WORLD
    excess = np.abs(gb - wb) - bound * (1 + 1e-6) - 1e-7
    assert (excess <= 0).all(), float(excess.max())


def test_int8_without_residual_returns_none(ranks):
    for res in ranks:
        assert res["int8"]["33x77_b256"][1] is None


def test_error_feedback_telescopes(ranks, inputs):
    """Sum over steps of the mean + the final residuals' sum over ranks
    / size == the sum of the exact means, to fp32 roundoff: what the
    quantiser dropped is carried, not lost."""
    means, _ = ranks[0]["tele"]
    got = means.double().sum(0).numpy()
    got += sum(res["tele"][1].double().numpy() for res in ranks) / WORLD
    want = sum(v.astype(np.float64).mean(0) for v in inputs["tele"])
    np.testing.assert_allclose(got, want, atol=1e-5)
    for res in ranks[1:]:
        torch.testing.assert_close(res["tele"][0], means, rtol=0, atol=0)


@pytest.mark.parametrize("name", sorted(BF16))
def test_bf16_mean_is_jaxs(ranks, mesh, inputs, name):
    values = inputs["bf16"][name]
    want, _ = _jax_pmean(mesh, jax_coll.CompressedAllReduce(mode="bf16"),
                         values)
    got = np.stack([res["bf16"][name].numpy() for res in ranks])
    assert got.dtype == np.float32
    for r in range(1, WORLD):
        np.testing.assert_array_equal(got[r], got[0])
    bound = 2.0 ** -6 * np.abs(values).mean(0)
    assert (np.abs(got - want) <= bound).all(), float(
        (np.abs(got - want) - bound).max())
    assert (np.abs(got[0] - values.mean(0)) <= bound).all()
