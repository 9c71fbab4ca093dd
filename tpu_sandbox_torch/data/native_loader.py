"""ctypes front-end for the port's C++ prefetching data loader
(``tpu_sandbox_torch/native/src/dataloader.cpp``), counterpart of
``tpu_sandbox/data/native_loader.py``.

The native side does the per-batch host work (gather rows by index,
uint8 -> float32/255, ToTensor's semantics) on a worker pool with a
bounded in-order prefetch ring, off the Python thread. The index order
(shuffle, sampler, epoch) is computed in numpy with the same streams as
``BatchLoader``, so the two loaders give the same batches in the same
order.
"""

from __future__ import annotations

import ctypes
import math

import numpy as np

from tpu_sandbox_torch.data.sampler import DistributedSampler

_lib = None


def _load():
    global _lib
    if _lib is None:
        from tpu_sandbox_torch.native.build import load_library

        lib = load_library("dataloader")
        lib.loader_create.restype = ctypes.c_void_p
        lib.loader_create.argtypes = [
            ctypes.c_void_p,  # images (uint8*)
            ctypes.c_void_p,  # labels (uint8*)
            ctypes.c_int64,   # n
            ctypes.c_int64,   # item_len
            ctypes.c_int64,   # batch
            ctypes.c_void_p,  # indices (int64*)
            ctypes.c_int64,   # n_indices
            ctypes.c_int,     # threads
            ctypes.c_int,     # prefetch
        ]
        lib.loader_next.restype = ctypes.c_int64
        lib.loader_next.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_void_p]
        lib.loader_num_batches.restype = ctypes.c_int64
        lib.loader_num_batches.argtypes = [ctypes.c_void_p]
        lib.loader_destroy.restype = None
        lib.loader_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


class NativeBatchLoader:
    """Iterates (float32 [b,H,W,1] normalized images, int32 [b] labels).

    Takes raw uint8 images and labels (the C++ side normalizes); each
    iteration over an epoch creates a native loader with a fresh prefetch
    ring and destroys it when the epoch ends or the iteration stops.
    """

    def __init__(
        self,
        images: np.ndarray,
        labels: np.ndarray,
        batch_size: int,
        *,
        shuffle: bool = False,
        seed: int = 0,
        sampler: DistributedSampler | None = None,
        threads: int = 2,
        prefetch: int = 4,
        drop_last: bool = False,
    ):
        if images.dtype != np.uint8 or labels.dtype != np.uint8:
            raise TypeError(
                "NativeBatchLoader requires raw uint8 images and labels "
                f"(got {images.dtype}/{labels.dtype}); it normalizes in C++")
        if shuffle and sampler is not None:
            raise ValueError("shuffle and sampler are mutually exclusive")
        if batch_size <= 0:
            raise ValueError(f"batch_size must be positive, got {batch_size}")
        self.images = np.ascontiguousarray(images)
        self.labels = np.ascontiguousarray(labels)
        self.item_shape = images.shape[1:]
        self.item_len = int(np.prod(self.item_shape))
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.sampler = sampler
        self.threads = threads
        self.prefetch = prefetch
        self.drop_last = drop_last
        self.epoch = 0

    def set_epoch(self, epoch: int) -> None:
        self.epoch = epoch

    def _indices(self) -> np.ndarray:
        if self.sampler is not None:
            idx = self.sampler.indices(self.epoch)
        elif self.shuffle:
            idx = np.random.default_rng(self.seed + self.epoch).permutation(
                len(self.images))
        else:
            idx = np.arange(len(self.images))
        idx = np.ascontiguousarray(idx, dtype=np.int64)
        if self.drop_last:
            idx = idx[: len(idx) - len(idx) % self.batch_size]
        return idx

    def __len__(self) -> int:
        n = (self.sampler.per_replica if self.sampler is not None
             else len(self.images))
        if self.drop_last:
            return n // self.batch_size
        return math.ceil(n / self.batch_size)

    def __iter__(self):
        lib = _load()
        idx = self._indices()
        if len(idx) == 0:
            return  # drop_last on a tiny dataset: no batch, as BatchLoader
        handle = lib.loader_create(
            self.images.ctypes.data, self.labels.ctypes.data,
            len(self.images), self.item_len, self.batch_size,
            idx.ctypes.data, len(idx), self.threads, self.prefetch)
        if not handle:
            raise RuntimeError("native loader_create failed (bad indices or "
                               "arguments)")
        out_images = np.empty((self.batch_size, self.item_len), np.float32)
        out_labels = np.empty((self.batch_size,), np.int32)
        try:
            while True:
                count = lib.loader_next(handle, out_images.ctypes.data,
                                        out_labels.ctypes.data)
                if count == 0:
                    break
                batch = out_images[:count].reshape(count, *self.item_shape)
                yield batch[..., None].copy(), out_labels[:count].copy()
        finally:
            lib.loader_destroy(handle)
