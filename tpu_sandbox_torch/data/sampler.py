"""Rank-strided dataset sharding with torch-DistributedSampler order.

Counterpart of ``tpu_sandbox/data/sampler.py``: pad the index list by
wrapping to a multiple of ``num_replicas``, then rank r takes
indices[r::num_replicas]. The shuffle stream is numpy's
``default_rng(seed + epoch)`` (not torch's generator), so the port draws
exactly the JAX package's batches.
"""

from __future__ import annotations

import math

import numpy as np


class DistributedSampler:
    """Yields rank ``rank``'s shard of ``range(num_samples)``."""

    def __init__(
        self,
        num_samples: int,
        num_replicas: int,
        rank: int,
        *,
        shuffle: bool = True,
        seed: int = 0,
    ):
        if not 0 <= rank < num_replicas:
            raise ValueError(
                f"rank {rank} out of range for num_replicas={num_replicas}"
            )
        if num_samples <= 0:
            raise ValueError(f"num_samples must be positive, got {num_samples}")
        self.num_samples = num_samples
        self.num_replicas = num_replicas
        self.rank = rank
        self.shuffle = shuffle
        self.seed = seed
        self.per_replica = math.ceil(num_samples / num_replicas)
        self.total_size = self.per_replica * num_replicas

    def __len__(self) -> int:
        return self.per_replica

    def indices(self, epoch: int = 0) -> np.ndarray:
        """This rank's index shard for ``epoch`` (len == per_replica)."""
        if self.shuffle:
            order = np.random.default_rng(self.seed + epoch).permutation(
                self.num_samples
            )
        else:
            order = np.arange(self.num_samples)
        pad = self.total_size - self.num_samples
        if pad:
            # torch order: indices += indices[:padding_size] (wrap, not repeat-last)
            reps = math.ceil(self.total_size / self.num_samples)
            order = np.tile(order, reps)[: self.total_size]
        return order[self.rank : self.total_size : self.num_replicas]
