"""Host-side batch iteration over in-memory numpy arrays.

Counterpart of ``tpu_sandbox/data/loader.py::BatchLoader``: same index
streams, so the port and the JAX package train on identical batches in
identical order. Batches stay numpy; the trainer moves them to the device.
"""

from __future__ import annotations

import math

import numpy as np

from tpu_sandbox_torch.data.sampler import DistributedSampler


class BatchLoader:
    """Minibatch iterator over in-memory arrays.

    ``shuffle`` uses a ``seed + epoch`` stream (call ``set_epoch``);
    ``sampler`` restricts iteration to a DistributedSampler shard. The two
    are mutually exclusive, like torch's DataLoader.
    """

    def __init__(
        self,
        images: np.ndarray,
        labels: np.ndarray,
        batch_size: int,
        *,
        shuffle: bool = False,
        seed: int = 0,
        drop_last: bool = False,
        sampler: DistributedSampler | None = None,
    ):
        if shuffle and sampler is not None:
            raise ValueError("shuffle and sampler are mutually exclusive")
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        self.images = images
        self.labels = labels
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.sampler = sampler
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        if self.sampler is not None:
            return self.sampler.indices(self.epoch)
        if self.shuffle:
            return np.random.default_rng(self.seed + self.epoch).permutation(
                len(self.images)
            )
        return np.arange(len(self.images))

    def _num_selected(self) -> int:
        return (
            self.sampler.per_replica if self.sampler is not None else len(self.images)
        )

    def __len__(self) -> int:
        n = self._num_selected()
        return n // self.batch_size if self.drop_last else math.ceil(n / self.batch_size)

    def __iter__(self):
        idx = self._indices()
        if self.drop_last:
            idx = idx[: (len(idx) // self.batch_size) * self.batch_size]
        for start in range(0, len(idx), self.batch_size):
            sel = idx[start : start + self.batch_size]
            yield self.images[sel], self.labels[sel]
