"""The port's data pipeline (tpu_sandbox_torch/data/) gives the JAX
package's arrays and batch order bit for bit: synthetic_mnist, normalize,
the IDX reader, BatchLoader and DistributedSampler."""

import gzip
import struct

import numpy as np
import pytest

from tpu_sandbox.data import loader as jax_loader
from tpu_sandbox.data import mnist as jax_mnist
from tpu_sandbox.data import sampler as jax_sampler
from tpu_sandbox_torch.data import loader, mnist, sampler
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("n,seed", [(10, 0), (257, 3)])
def test_synthetic_mnist_and_normalize_bit_identical(n, seed):
    im, lb = mnist.synthetic_mnist(n=n, seed=seed)
    jim, jlb = jax_mnist.synthetic_mnist(n=n, seed=seed)
    assert im.dtype == jim.dtype and lb.dtype == jlb.dtype
    np.testing.assert_array_equal(im, jim)
    np.testing.assert_array_equal(lb, jlb)
    a, b = mnist.normalize(im), jax_mnist.normalize(jim)
    assert a.dtype == b.dtype == np.float32 and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def test_idx_reader_matches(tmp_path):
    rng = np.random.default_rng(0)
    images = rng.integers(0, 256, size=(7, 28, 28), dtype=np.uint8)
    labels = rng.integers(0, 10, size=7).astype(np.uint8)
    with gzip.open(tmp_path / "train-images-idx3-ubyte.gz", "wb") as f:
        f.write(struct.pack(">HBB", 0, 8, 3) + struct.pack(">3I", 7, 28, 28))
        f.write(images.tobytes())
    with open(tmp_path / "train-labels-idx1-ubyte", "wb") as f:
        f.write(struct.pack(">HBB", 0, 8, 1) + struct.pack(">I", 7))
        f.write(labels.tobytes())
    got = mnist.load_mnist("train", tmp_path)
    want = jax_mnist.load_mnist("train", tmp_path)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0], images)
    with pytest.raises(FileNotFoundError):
        mnist.load_mnist("test", tmp_path)


@pytest.mark.parametrize("shuffle,drop_last,bs", [
    (True, False, 5), (True, True, 4), (False, False, 3)])
def test_batch_loader_same_batches_in_same_order(shuffle, drop_last, bs):
    images = np.arange(23 * 2, dtype=np.float32).reshape(23, 2)
    labels = np.arange(23, dtype=np.int32)
    kw = dict(shuffle=shuffle, seed=7, drop_last=drop_last)
    ours = loader.BatchLoader(images, labels, bs, **kw)
    ref = jax_loader.BatchLoader(images, labels, bs, **kw)
    for epoch in (0, 2):
        ours.set_epoch(epoch)
        ref.set_epoch(epoch)
        assert len(ours) == len(ref)
        got, want = list(ours), list(ref)
        assert len(got) == len(want)
        for (gi, gl), (wi, wl) in zip(got, want):
            np.testing.assert_array_equal(gi, wi)
            np.testing.assert_array_equal(gl, wl)


@pytest.mark.parametrize("num_samples,replicas,shuffle", [
    (10, 3, True), (12, 4, False), (7, 2, True)])
def test_distributed_sampler_same_shards(num_samples, replicas, shuffle):
    for rank in range(replicas):
        ours = sampler.DistributedSampler(num_samples, replicas, rank,
                                          shuffle=shuffle, seed=5)
        ref = jax_sampler.DistributedSampler(num_samples, replicas, rank,
                                             shuffle=shuffle, seed=5)
        assert len(ours) == len(ref)
        for epoch in (0, 1):
            np.testing.assert_array_equal(ours.indices(epoch),
                                          ref.indices(epoch))


def test_loader_over_sampler_matches():
    images = np.arange(11, dtype=np.float32)[:, None]
    labels = np.arange(11, dtype=np.int32)
    s = sampler.DistributedSampler(11, 2, 1, seed=1)
    js = jax_sampler.DistributedSampler(11, 2, 1, seed=1)
    got = list(loader.BatchLoader(images, labels, 2, sampler=s))
    want = list(jax_loader.BatchLoader(images, labels, 2, sampler=js))
    assert len(got) == len(want)
    for (gi, _), (wi, _) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
    with pytest.raises(ValueError):
        loader.BatchLoader(images, labels, 2, shuffle=True, sampler=s)
