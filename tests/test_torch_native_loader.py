"""The port's C++ loader (tpu_sandbox_torch/native/, data/native_loader.py)
against the port's BatchLoader and the JAX package's: the same batches
in the same order, epoch reshuffles, DistributedSampler shards, bad
input refused (the checks of tests/test_native.py), and
``mnist_onegpu --native-loader`` on the CPU. The library builds with g++
at first use into tpu_sandbox_torch/_build/."""

import numpy as np
import pytest

from tpu_sandbox.data import BatchLoader as JaxBatchLoader
from tpu_sandbox.data.mnist import normalize as jax_normalize
from tpu_sandbox_torch import mnist_onegpu
from tpu_sandbox_torch.data import (
    BatchLoader,
    DistributedSampler,
    normalize,
    synthetic_mnist,
)
from tpu_sandbox_torch.data.native_loader import NativeBatchLoader
from torch_threads import one_torch_thread  # noqa: F401


@pytest.mark.parametrize("drop_last", [False, True])
def test_native_loader_matches_python_loaders(drop_last):
    """Labels equal and images within 1e-7 (uint8/255 in C++ and numpy)
    of the port's BatchLoader and of the JAX package's, batch for batch;
    the partial tail kept unless drop_last."""
    images, labels = synthetic_mnist(n=53, seed=0)
    nat = list(NativeBatchLoader(images, labels, 8, shuffle=True, seed=3,
                                 threads=3, drop_last=drop_last))
    for cls, norm in ((BatchLoader, normalize), (JaxBatchLoader,
                                                 jax_normalize)):
        py = list(cls(norm(images), labels.astype("int32"), 8, shuffle=True,
                      seed=3, drop_last=drop_last))
        assert len(py) == len(nat) == (6 if drop_last else 7)
        for (pi, pl), (ni, nl) in zip(py, nat):
            assert ni.dtype == np.float32 and nl.dtype == np.int32
            np.testing.assert_array_equal(pl, nl)
            np.testing.assert_allclose(pi, ni, rtol=0, atol=1e-7)
    assert nat[-1][0].shape == ((8 if drop_last else 53 % 8), 28, 28, 1)
    assert len(NativeBatchLoader(images, labels, 8,
                                 drop_last=drop_last)) == len(nat)


def test_native_loader_epochs_reshuffle():
    images, labels = synthetic_mnist(n=64, seed=0)
    nat = NativeBatchLoader(images, labels, 16, shuffle=True, threads=2)
    first = np.concatenate([lb for _, lb in nat])
    again = np.concatenate([lb for _, lb in nat])
    np.testing.assert_array_equal(first, again)      # same epoch, same order
    nat.set_epoch(1)
    third = np.concatenate([lb for _, lb in nat])
    assert not np.array_equal(first, third)
    py = BatchLoader(normalize(images), labels.astype("int32"), 16,
                     shuffle=True)
    py.set_epoch(1)
    np.testing.assert_array_equal(third, np.concatenate([lb for _, lb in py]))


def test_native_loader_with_distributed_sampler():
    """Each rank's shard equals the port's BatchLoader on the same sampler,
    and the two shards cover the data once."""
    images, labels = synthetic_mnist(n=40, seed=0)
    seen = []
    for rank in range(2):
        sampler = DistributedSampler(40, num_replicas=2, rank=rank)
        nat = np.concatenate([lb for _, lb in NativeBatchLoader(
            images, labels, 5, sampler=sampler, threads=2)])
        py = np.concatenate([lb for _, lb in BatchLoader(
            normalize(images), labels.astype("int32"), 5, sampler=sampler)])
        np.testing.assert_array_equal(nat, py)
        seen.append(sampler.indices(0))
    assert len(seen[0]) == len(seen[1]) == 20
    assert sorted(np.concatenate(seen)) == list(range(40))


def test_native_loader_rejects_bad_input():
    images, labels = synthetic_mnist(n=8, seed=0)
    with pytest.raises(TypeError, match="uint8"):
        NativeBatchLoader(normalize(images), labels, 4)
    with pytest.raises(ValueError, match="batch_size"):
        NativeBatchLoader(images, labels, 0)
    with pytest.raises(ValueError, match="mutually exclusive"):
        NativeBatchLoader(images, labels, 4, shuffle=True,
                          sampler=DistributedSampler(8, 2, 0))


def test_entry_script_native_loader_trains_like_the_python_loader(capsys):
    """--native-loader for 2 steps: the reference's log lines and the same
    losses as the Python loader's run, bitwise (equal batches)."""
    argv = ["--force-cpu", "--image-size", "32", "--limit-steps", "2",
            "--epochs", "1", "--synthetic-n", "10", "--log-every", "1",
            "--data-dir", "no-such-mnist-dir"]
    native, state = mnist_onegpu.main([*argv, "--native-loader"])
    out = capsys.readouterr().out
    python, _ = mnist_onegpu.main(argv)
    assert state.step == 2 and native.losses == python.losses
    assert "Epoch [1/1], Step [2/2], Loss: " in out
    assert "Training complete in: " in out
