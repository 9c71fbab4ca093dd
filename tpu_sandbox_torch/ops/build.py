"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` file is one shared library with a plain C interface
(device pointers, sizes and the stream in; ``cudaError_t`` out), compiled
by ``nvcc`` for ``sm_90a`` and loaded with ctypes; ``csrc/*.cuh`` are
headers they share. Nothing includes PyTorch's headers, so a build takes
seconds. Each library is named by the hash of its source, the headers and
the flags and lives in ``_build/`` beside ``csrc/``
(listed in ``.gitignore``): a changed source builds anew, an unchanged one
is reused. ``build_all`` starts one ``nvcc`` per source, all at once.

Nothing here runs at import: the CPU tests import every module, and the
CPU has neither ``nvcc`` nor a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, else
    ``/usr/local/cuda/bin/nvcc``, else ``nvcc`` on PATH."""
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built on a machine with the CUDA toolkit")
    return found


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def target(src: Path) -> Path:
    """The library built from ``src``, named by the hash of the source, the
    shared headers of ``csrc/`` and the flags."""
    h = hashlib.sha256(src.read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> dict:
    """Compile every source whose library is missing, in parallel.
    Returns ``{'seconds': wall, 'built': [...], 'ptxas': {stem: lines}}``;
    raises with the compiler's output if any build fails."""
    t0 = time.monotonic()
    BUILD.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in sources():
        out = target(src)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs.append((src, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    ptxas, failed = {}, []
    for src, out, tmp, proc in procs:
        log, _ = proc.communicate()
        out.with_suffix(".log").write_text(log)
        ptxas[src.stem] = [ln.strip() for ln in log.splitlines()
                           if "registers" in ln or "spill" in ln]
        if proc.returncode != 0:
            failed.append(f"{src.name} (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return {"seconds": time.monotonic() - t0,
            "built": [p[0].name for p in procs], "ptxas": ptxas}


def load(stem: str) -> ctypes.CDLL:
    """The loaded library built from ``csrc/<stem>.cu``, building every
    missing library first."""
    lib = _LIBS.get(stem)
    if lib is None:
        src = CSRC / f"{stem}.cu"
        if not target(src).exists():
            build_all()
        lib = ctypes.CDLL(str(target(src)))
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        _LIBS[stem] = lib
    return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise on a non-zero ``cudaError_t`` returned by a C entry point of
    ``lib`` (a refused launch never runs, so it is caught only here)."""
    if err != 0:
        msg = lib.cuda_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA error {err} ({msg})")
