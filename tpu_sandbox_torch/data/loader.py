"""Host-side batch iteration over in-memory numpy arrays.

Counterpart of ``tpu_sandbox/data/loader.py``: ``BatchLoader``,
``ShardedBatchLoader`` and ``PrefetchLoader``, with the same index
streams, so the port and the JAX package train on identical batches in
identical order. Batches stay numpy; the trainer moves them to the device.
"""

from __future__ import annotations

import math
import queue
import threading

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


class ShardedBatchLoader:
    """The data-parallel batches: ``tpu_sandbox/data/loader.py``'s
    ``ShardedBatchLoader`` (:86-140).

    Each step yields ``num_replicas * batch_size`` rows; rows
    ``[r*bs, (r+1)*bs)`` are rank r's ``DistributedSampler`` shard in
    order, each rank's index list wrap-padded to a whole number of batches
    so every shard is full at the tail. ``rank=r`` yields only rank r's
    rows, so a rank's process reads only its own shard.
    """

    def __init__(self, images: np.ndarray, labels: np.ndarray,
                 batch_size: int, num_replicas: int, *, shuffle: bool = True,
                 seed: int = 0, rank: int | None = None):
        if rank is not None and not 0 <= rank < num_replicas:
            raise ValueError(
                f"rank {rank} out of range for num_replicas={num_replicas}")
        self.images = images
        self.labels = labels
        self.batch_size = batch_size
        self.num_replicas = num_replicas
        self.rank = rank
        self.samplers = [
            DistributedSampler(len(images), num_replicas, r,
                               shuffle=shuffle, seed=seed)
            for r in range(num_replicas)
        ]
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def __len__(self) -> int:
        return math.ceil(self.samplers[0].per_replica / self.batch_size)

    def _rank_indices(self, sampler: DistributedSampler) -> np.ndarray:
        padded = len(self) * self.batch_size
        idx = sampler.indices(self.epoch)
        if len(idx) < padded:
            idx = np.tile(idx, math.ceil(padded / len(idx)))[:padded]
        return idx

    def __iter__(self):
        ranks = (range(self.num_replicas) if self.rank is None
                 else [self.rank])
        per_rank = [self._rank_indices(self.samplers[r]) for r in ranks]
        bs = self.batch_size
        for step in range(len(self)):
            sel = np.concatenate([idx[step * bs:(step + 1) * bs]
                                  for idx in per_rank])
            yield self.images[sel], self.labels[sel]


class PrefetchLoader:
    """Background prefetch over any loader: ``tpu_sandbox/data/loader.py``'s
    ``PrefetchLoader`` (:143-219).

    A daemon thread assembles the next ``depth`` batches into a FIFO queue
    while the caller runs the current step. ``stage``: an optional
    ``(images, labels) -> staged batch`` run in the producer thread, e.g.
    ``Trainer.fit``'s copy to the rank's device, so that the host-side
    assembly and pinning overlap the previous step (the copy itself is
    enqueued on the producer thread's current stream, which on the card is
    the step's default stream). One producer and a FIFO:
    exactly the wrapped loader's batches in its order; ``set_epoch`` and
    ``len`` delegate. The producer is stopped and joined when iteration
    ends for any reason (exhausted, the consumer raised or broke off), and
    an error it raised is raised in the consumer.
    """

    def __init__(self, loader, *, depth: int = 2, stage=None):
        if depth < 1:
            raise ValueError(f"depth must be >= 1, got {depth}")
        self.loader = loader
        self.depth = depth
        self.stage = stage

    def set_epoch(self, epoch: int) -> None:
        self.loader.set_epoch(epoch)

    def __len__(self) -> int:
        return len(self.loader)

    def __iter__(self):
        q: queue.Queue = queue.Queue(self.depth)
        stop = threading.Event()

        def put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce():
            try:
                for batch in self.loader:
                    if self.stage is not None:
                        batch = self.stage(*batch)
                    if not put(("batch", batch)):
                        return
                put(("done", None))
            except BaseException as e:      # raised again by the consumer
                put(("error", e))

        t = threading.Thread(target=produce, name="prefetch-loader",
                             daemon=True)
        t.start()
        try:
            while True:
                kind, payload = q.get()
                if kind == "done":
                    return
                if kind == "error":
                    raise payload
                yield payload
        finally:
            stop.set()
            t.join(timeout=5.0)
