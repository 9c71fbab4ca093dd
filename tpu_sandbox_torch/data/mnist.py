"""MNIST data source: pure-NumPy IDX reader + deterministic synthetic fallback.

Counterpart of ``tpu_sandbox/data/mnist.py``, copied so that this package
never imports the JAX one; ``tests/test_torch_data.py`` holds the two
bit-identical. The host only handles raw 28x28 bytes; the upsample to the
training size happens on the device inside the train step
(``train/trainer.py``).
"""

from __future__ import annotations

import gzip
import os
import struct
from pathlib import Path

import numpy as np

_FILES = {
    "train": ("train-images-idx3-ubyte", "train-labels-idx1-ubyte"),
    "test": ("t10k-images-idx3-ubyte", "t10k-labels-idx1-ubyte"),
}


def _read_idx(path: Path) -> np.ndarray:
    """Read one IDX file (raw or .gz): >HBB magic, big-endian u32 dims, data."""
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as f:
        zero, dtype_code, ndim = struct.unpack(">HBB", f.read(4))
        if zero != 0 or dtype_code != 0x08:
            raise ValueError(f"unsupported IDX header in {path}: "
                             f"magic={zero}, dtype=0x{dtype_code:02x}")
        shape = struct.unpack(f">{ndim}I", f.read(4 * ndim))
        data = np.frombuffer(f.read(), dtype=np.uint8)
    return data.reshape(shape)


def _find(data_dir: Path, stem: str) -> Path | None:
    for sub in ("", "MNIST/raw"):
        for suffix in ("", ".gz"):
            p = data_dir / sub / (stem + suffix)
            if p.exists():
                return p
    return None


def load_mnist(split: str, data_dir=None) -> tuple[np.ndarray, np.ndarray]:
    """Load MNIST IDX files -> (uint8 images [N,28,28], uint8 labels [N]).

    ``data_dir`` defaults to ``$MNIST_DIR`` or ``./data``. Accepts raw or
    gzipped files, flat or in torchvision's ``MNIST/raw`` layout.
    """
    if split not in _FILES:
        raise ValueError(f"unknown split {split!r}; expected 'train' or 'test'")
    data_dir = Path(data_dir or os.environ.get("MNIST_DIR", "data"))
    image_stem, label_stem = _FILES[split]
    image_path = _find(data_dir, image_stem)
    label_path = _find(data_dir, label_stem)
    if image_path is None or label_path is None:
        raise FileNotFoundError(
            f"MNIST IDX files for split {split!r} not found under {data_dir}; "
            "download them there or fall back to synthetic_mnist()"
        )
    return _read_idx(image_path), _read_idx(label_path)


def synthetic_mnist(n: int = 60000, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic synthetic MNIST: (uint8 [n,28,28], uint8 labels [n]).

    Ten fixed class prototypes (Gaussian blobs at class-specific
    positions) plus per-image Gaussian noise. Prototype geometry is
    independent of ``seed`` so class identity is stable across calls.
    """
    yy, xx = np.mgrid[0:28, 0:28].astype(np.float32)
    protos = []
    for c in range(10):
        cy = 6 + 4 * (c // 4) + 3 * ((c * 7) % 3)
        cx = 5 + 6 * (c % 4)
        protos.append(
            220.0 * np.exp(-(((yy - cy) ** 2 + (xx - cx) ** 2) / (2 * 3.0**2)))
        )
    protos = np.stack(protos)
    rng = np.random.default_rng(seed)
    labels = rng.integers(0, 10, size=n).astype(np.uint8)
    noise = rng.normal(0.0, 15.0, size=(n, 28, 28)).astype(np.float32)
    images = np.clip(protos[labels] + noise, 0, 255).astype(np.uint8)
    return images, labels


def normalize(images: np.ndarray) -> np.ndarray:
    """uint8 [N,H,W] -> float32 [N,H,W,1] in [0,1] (ToTensor semantics)."""
    return (images.astype(np.float32) / 255.0)[..., None]
