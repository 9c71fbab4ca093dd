"""The port's stage transport (tpu_sandbox_torch/mpmd/transport.py) through
JAX's tests/test_mpmd_transport.py cases and the transport cases of
tests/test_mpmd_fastfabric.py (:196-258), then against JAX's transport
on one KV server: a slot either package writes is read by the other bit
for bit (fp32 and int32), and the same framing (meta, chunking, keys).
bf16, which JAX's wire cannot carry (its ``pack_views`` raises on an
ml_dtypes array, :94, and the meta it writes, ``dtype.str``, :90, is
``'<V2'``, which ``unpack_arrays``, :128, reads as 2-byte voids),
crosses the port's wire as ``"bfloat16"``, which JAX's ``unpack_arrays``
reads bit for bit; the port refuses a ``'<V2'`` slot."""

import json

import ml_dtypes
import numpy as np
import pytest
import torch

from tpu_sandbox.mpmd import transport as jtransport
from tpu_sandbox_torch.mpmd.transport import (
    DeviceTransport,
    EdgeNames,
    KVTransport,
    LocalTransport,
    iter_chunks,
    pack_arrays,
    pack_views,
    unpack_arrays,
)
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture
def kv_pair():
    from tpu_sandbox_torch.runtime.kvstore import KVClient, KVServer

    server = KVServer()
    kv = KVClient(port=server.port)
    yield server, kv
    kv.close()
    server.stop()


@pytest.fixture(params=["local", "kv"])
def transport(request, kv_pair):
    if request.param == "local":
        return LocalTransport()
    _, kv = kv_pair
    return KVTransport(kv, prefix="mpmd/pipe0")


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(3, 5)).astype(np.float32),
            rng.integers(0, 100, size=(7,)).astype(np.int32)]


# -- framing (JAX's cases) -----------------------------------------------------


def test_pack_unpack_roundtrip_bitwise():
    arrays = _arrays()
    meta, payload = pack_arrays(arrays)
    out = unpack_arrays(meta, payload)
    assert len(out) == len(arrays)
    for a, b in zip(arrays, out):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_unpack_rejects_corrupt_payload():
    meta, payload = pack_arrays(_arrays())
    with pytest.raises(ValueError, match="meta describes"):
        unpack_arrays(meta, payload + b"\x00")  # trailing garbage
    with pytest.raises(ValueError):
        unpack_arrays(meta, payload[:-1])  # truncated mid-array


def _sample_arrays():
    rng = np.random.default_rng(7)
    return [
        rng.standard_normal((13, 5)).astype(np.float32),
        np.arange(11, dtype=np.int32),
        rng.standard_normal(()).astype(np.float64),
        np.zeros((0, 4), np.float32),
    ]


def test_iter_chunks_matches_joined_payload():
    arrays = _sample_arrays()
    meta, views = pack_views(arrays)
    _meta2, payload = pack_arrays(arrays)
    for chunk_bytes in (1, 7, 64, 1 << 20):
        chunks = list(iter_chunks(views, chunk_bytes))
        assert all(len(c) <= chunk_bytes for c in chunks)
        assert b"".join(chunks) == payload
    back = unpack_arrays(meta, payload)
    for a, b in zip(arrays, back):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)


def test_pack_takes_tensors_as_jax_takes_arrays():
    """A tensor packs to the bytes and meta of the same array under JAX's
    ``pack_arrays`` (non-contiguous and 0-d included)."""
    x = torch.arange(24, dtype=torch.float32).reshape(4, 6).t()
    tensors = [x, torch.tensor(3, dtype=torch.int32),
               torch.zeros((0, 2), dtype=torch.float64)]
    assert pack_arrays(tensors) == jtransport.pack_arrays(
        [t.numpy() for t in tensors])


# -- delivery discipline (both wires; JAX's cases) -----------------------------


def test_put_get_roundtrip_and_stats(transport):
    arrays = _arrays()
    assert transport.put("act0", 3, 1, arrays) is True
    got = transport.get("act0", 3, 1, timeout=5.0)
    for a, b in zip(arrays, got):
        assert a.tobytes() == b.tobytes() and a.dtype == b.dtype
    s = transport.stats
    assert s.puts == 1 and s.gets == 1
    assert s.bytes_out == s.bytes_in > 0


def test_put_is_produce_once(transport):
    arrays = _arrays()
    assert transport.put("act0", 0, 0, arrays) is True
    # a replaying producer re-puts the same slot and loses the claim
    assert transport.put("act0", 0, 0, arrays) is False
    got = transport.get("act0", 0, 0, timeout=5.0)
    assert got[0].tobytes() == arrays[0].tobytes()
    assert transport.audit()["commits"].popitem()[1] == 2


def test_get_times_out_on_absent_slot(transport):
    with pytest.raises(TimeoutError):
        transport.get("act0", 9, 9, timeout=0.05)


def test_poll_and_release_step(transport):
    transport.put("act0", 4, 0, _arrays())
    transport.put("act0", 4, 1, _arrays(1))
    transport.put("act0", 5, 0, _arrays(2))
    transport.put("grad0", 4, 0, _arrays(3))
    assert transport.poll("act0", 4, 0) and transport.poll("act0", 4, 1)
    transport.release_step("act0", 4)
    assert not transport.poll("act0", 4, 0)
    assert not transport.poll("act0", 4, 1)
    # other steps and other edges survive the GC
    assert transport.poll("act0", 5, 0)
    assert transport.poll("grad0", 4, 0)


def test_claim_once_per_generation(transport):
    # within one generation a slot feeds exactly one consumer op
    assert transport.claim("act0", 2, 0, generation=0) is True
    assert transport.claim("act0", 2, 0, generation=0) is False
    # a relaunched generation legitimately re-claims for replay
    assert transport.claim("act0", 2, 0, generation=1) is True
    assert transport.claim("act0", 2, 1, generation=0) is True
    claims = transport.audit()["claims"]
    dup = {k: v for k, v in claims.items() if v != 1}
    assert list(dup.values()) == [2]  # exactly the double-claim we made


def test_bf16_slot_roundtrips_bitwise(transport):
    x = torch.randn(4, 6, generator=torch.Generator().manual_seed(0)
                    ).to(torch.bfloat16)
    transport.put("act0", 0, 0, [x, torch.ones(2)])
    (got, ones) = transport.get("act0", 0, 0, timeout=5.0)
    assert got.dtype == torch.bfloat16 and torch.equal(
        got.view(torch.int16), x.view(torch.int16))
    assert np.array_equal(ones, np.ones(2, np.float32))


# -- KV wire specifics (JAX's cases) -------------------------------------------


def test_kv_transport_chunks_large_payload(kv_pair):
    _, kv = kv_pair
    tr = KVTransport(kv, prefix="mpmd/pipe0", chunk_bytes=1024)
    big = np.arange(5000, dtype=np.float64)  # 40000 bytes -> 40 chunks
    assert tr.put("act0", 0, 0, [big]) is True
    (got,) = tr.get("act0", 0, 0, timeout=5.0)
    assert got.tobytes() == big.tobytes()
    meta = json.loads(kv.get("mpmd/pipe0/mpmd/slot/act0/0/0/meta"))
    assert meta["nchunks"] == 40 and meta["bytes"] == 40000


def test_kv_transport_finishes_dead_writers_slot(kv_pair):
    """Commit claimed, meta never landed (writer died mid-put): the
    replayer loses the claim but completes the slot with its own
    deterministic bytes."""
    _, kv = kv_pair
    tr = KVTransport(kv, prefix="mpmd/pipe0")
    kv.add("mpmd/pipe0/mpmd/slot/act0/0/0/commit", 1)  # the dead writer
    arrays = _arrays()
    assert tr.put("act0", 0, 0, arrays) is False  # lost claim, finished slot
    (a, b) = tr.get("act0", 0, 0, timeout=5.0)
    assert a.tobytes() == arrays[0].tobytes()


def test_kv_transport_prefix_isolation(kv_pair):
    _, kv = kv_pair
    t0 = KVTransport(kv, prefix="mpmd/pipe0")
    t1 = KVTransport(kv, prefix="mpmd/pipe1")
    t0.put("act0", 0, 0, _arrays())
    assert not t1.poll("act0", 0, 0)
    assert t1.claim("act0", 0, 0, generation=0) is True  # own claim plane


def test_kv_transport_rejects_oversized_chunks(kv_pair):
    _, kv = kv_pair
    with pytest.raises(ValueError, match="read cap"):
        KVTransport(kv, chunk_bytes=1 << 20)


def test_edge_names():
    e = EdgeNames(2)
    assert e.act == "act2" and e.grad == "grad2"


# -- the device tier (JAX's cases, tests/test_mpmd_fastfabric.py:214-258) ------


def test_device_transport_contract():
    tr = DeviceTransport()
    arrays = [torch.arange(6, dtype=torch.float32).reshape(2, 3)]
    assert tr.put("e", 0, 0, arrays) is True
    assert tr.put("e", 0, 0, arrays) is False  # produce-once via journal
    assert tr.poll("e", 0, 0)
    assert tr.claim("e", 0, 0, generation=0) is True
    assert tr.claim("e", 0, 0, generation=0) is False  # claim-once
    assert tr.claim("e", 0, 0, generation=1) is True   # new generation
    (got,) = tr.get("e", 0, 0, timeout=1.0)
    assert got is arrays[0]  # the published tensor itself, not a copy
    assert tr.stats.device_hits == 1
    assert tr.stats.journal_fallbacks == 0
    # the journal recorded the same slot durably
    assert tr.journal.poll("e", 0, 0)
    audit = tr.audit()
    assert audit["commits"]["e/0/0"] == 2  # both put attempts counted


def test_device_transport_journal_fallback_is_bitwise():
    """A transport rebuilt over a persisted journal (the tensors are gone)
    serves journal bytes — bitwise what the tensor held, bf16 too."""
    journal = LocalTransport()
    tr = DeviceTransport(journal)
    x = torch.randn(4, 4, generator=torch.Generator().manual_seed(3))
    tr.put("e", 1, 0, [x, x.to(torch.bfloat16)])
    rebuilt = DeviceTransport(journal)  # no tensors, same journal
    (got, got16) = rebuilt.get("e", 1, 0, timeout=1.0)
    assert got.tobytes() == x.numpy().tobytes()
    assert torch.equal(got16.view(torch.int16),
                       x.to(torch.bfloat16).view(torch.int16))
    assert rebuilt.stats.journal_fallbacks == 1
    assert rebuilt.stats.device_hits == 0


def test_device_transport_release_step_clears_both_tiers():
    tr = DeviceTransport()
    tr.put("e", 0, 0, [np.zeros(3, np.float32)])
    tr.put("e", 1, 0, [np.ones(3, np.float32)])
    tr.release_step("e", 0)
    assert not tr.poll("e", 0, 0)
    assert not tr.journal.poll("e", 0, 0)
    assert tr.poll("e", 1, 0)  # later steps untouched


def test_device_transport_get_timeout():
    tr = DeviceTransport()
    with pytest.raises(TimeoutError):
        tr.get("never", 0, 0, timeout=0.05)


# -- against JAX's transport, one KV server ------------------------------------


@pytest.fixture
def both(kv_pair):
    """(the port's KVTransport, JAX's KVTransport over the port's client
    on the same store and prefix, the raw client)."""
    _, kv = kv_pair
    return (KVTransport(kv, prefix="mpmd/pipe0", chunk_bytes=512),
            jtransport.KVTransport(kv, prefix="mpmd/pipe0", chunk_bytes=512),
            kv)


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_slots_interoperate_bitwise(both, writer):
    """A slot either package writes (fp32 and int32, several chunks) is
    read by the other bit for bit, under the same keys, meta and chunks;
    commits and claims are one counter plane."""
    port, jax_tr, kv = both
    arrays = [np.random.default_rng(1).standard_normal((17, 9)).astype(
        np.float32), np.arange(-50, 50, dtype=np.int32)]
    put, get = (jax_tr, port) if writer == "jax" else (port, jax_tr)
    assert put.put("act0", 2, 1, arrays) is True
    assert get.put("act0", 2, 1, arrays) is False   # one produce-once plane
    got = get.get("act0", 2, 1, timeout=5.0)
    for a, b in zip(arrays, got):
        assert b.dtype == a.dtype and b.shape == a.shape
        assert b.tobytes() == a.tobytes()
    assert get.claim("act0", 2, 1, generation=0) is True
    assert put.claim("act0", 2, 1, generation=0) is False
    assert port.audit() == jax_tr.audit()


def test_slot_bytes_equal_jaxs(kv_pair):
    """The port and JAX write the same keys and values for one slot."""
    _, kv = kv_pair
    arrays = _arrays(4)
    KVTransport(kv, prefix="a", chunk_bytes=16).put("act0", 0, 3, arrays)
    jtransport.KVTransport(kv, prefix="b", chunk_bytes=16).put(
        "act0", 0, 3, arrays)
    ours = {k[2:]: kv.get(k) for k in kv.keys("a/")}
    theirs = {k[2:]: kv.get(k) for k in kv.keys("b/")}
    assert ours == theirs and len(ours) > 3


def test_bf16_slot_written_by_the_port_reads_bitwise_in_jax(both):
    port, jax_tr, _ = both
    x = torch.randn(33, 7, generator=torch.Generator().manual_seed(5)
                    ).to(torch.bfloat16)
    port.put("act0", 0, 0, [x])
    (got,) = jax_tr.get("act0", 0, 0, timeout=5.0)
    assert got.dtype == ml_dtypes.bfloat16
    assert got.view(np.int16).tobytes() == x.view(torch.int16).numpy(
        ).tobytes()


def test_jaxs_own_bf16_wire_loses_the_dtype_and_the_port_refuses_it():
    """JAX's framing cannot carry a bfloat16 array: its ``pack_arrays``
    raises (a memoryview takes no ml_dtypes type), and the meta it would
    write, the array's ``dtype.str``, is ``'<V2'``, which its
    ``unpack_arrays`` reads back as raw voids (the fault on the record in
    ROADMAP). The port's round trip keeps bfloat16, and the port refuses a
    ``'<V2'`` meta with an error naming it."""
    x = np.arange(12, dtype=np.float32).astype(ml_dtypes.bfloat16)
    with pytest.raises(ValueError, match="buffer"):
        jtransport.pack_arrays([x])
    meta = {"arrays": [{"shape": list(x.shape), "dtype": x.dtype.str}]}
    assert meta["arrays"][0]["dtype"] == "<V2"
    (back,) = jtransport.unpack_arrays(meta, x.tobytes())
    assert back.dtype.kind == "V" and back.dtype != x.dtype
    with pytest.raises(ValueError, match="'<V2'.*bfloat16"):
        unpack_arrays(meta, x.tobytes())
    (ours,) = unpack_arrays(*pack_arrays([x]))
    assert ours.dtype == torch.bfloat16
    assert ours.view(torch.int16).numpy().tobytes() == x.tobytes()
    t = torch.from_numpy(x.astype(np.float32)).to(torch.bfloat16)
    (ours,) = unpack_arrays(*pack_arrays([t]))
    assert torch.equal(ours.view(torch.int16), t.view(torch.int16))
