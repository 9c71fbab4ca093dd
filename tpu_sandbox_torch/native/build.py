"""Build-on-first-use for the port's host-side C++ (``native/src/*.cpp``),
the port's own counterpart of the JAX package's ``native/build.py``.

Each source compiles with ``g++ -O3 -shared -fPIC -std=c++17 -pthread``
into one shared library with a plain C interface, loaded with ctypes. The
library lives in ``_build/`` beside ``csrc/`` (listed in ``.gitignore``)
and is named by the hash of its source and the flags, so a changed source
builds anew. The compiler writes a temporary file that is then renamed
into place, so processes building at once (test workers) never load a
half-written library. Nothing runs at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path

SRC = Path(__file__).resolve().parent / "src"
BUILD = Path(__file__).resolve().parent.parent / "_build"
FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")


class NativeBuildError(RuntimeError):
    pass


def target(name: str) -> Path:
    """The library built from ``src/<name>.cpp``."""
    src = SRC / f"{name}.cpp"
    if not src.exists():
        raise NativeBuildError(f"no such native source: {src}")
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(FLAGS).encode())
    return BUILD / f"{name}-{h.hexdigest()[:16]}.so"


def build_library(name: str) -> Path:
    """Compile ``src/<name>.cpp`` unless its library exists; its path."""
    out = target(name)
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    with tempfile.NamedTemporaryFile(dir=BUILD, suffix=".so.tmp",
                                     delete=False) as tmp:
        tmp_path = Path(tmp.name)
    cmd = ["g++", *FLAGS, str(SRC / f"{name}.cpp"), "-o", str(tmp_path)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp_path.unlink(missing_ok=True)
        raise NativeBuildError(f"g++ failed for {name}:\n{proc.stderr[-2000:]}")
    os.replace(tmp_path, out)
    return out


def load_library(name: str) -> ctypes.CDLL:
    return ctypes.CDLL(str(build_library(name)))
