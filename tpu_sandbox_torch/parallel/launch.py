"""One OS process per rank: the port of the reference's ``mp.spawn``
launch (``test_init.py:74-106``, ``mnist_distributed.py`` :650
``spawn_multiprocess``).

``spawn(fn, world_size, *args)`` starts ``fn(rank, world_size, *args)`` in
processes made with the ``spawn`` start method (each imports ``fn``'s
module anew, so ``fn`` must live in a module that a fresh interpreter can
import). Rank arithmetic is the reference's ``rank = nr * gpus + local``
(mnist_distributed.py:49): a node ``node_rank`` starts ``nprocs`` ranks.
Each rank gets ``RANK``, ``LOCAL_RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT`` and ``INIT_METHOD`` in its environment, which
``runtime/bootstrap.init`` reads: a ``tcp://`` rendezvous on the store
that ``spawn`` serves on a loopback port the OS gives at its bind (the
ranks join it as clients, ``bootstrap.serve_store``), the caller's
served ``store``, the exported ``MASTER_ADDR``/``MASTER_PORT`` of a
multi-node job, or any ``init_method`` given (``file:///path`` for a
``FileStore``). Every child is joined with a deadline; on the first
failure or at the deadline the others are killed, and ``spawn`` raises
with each rank's exit code and the tail of its standard error.
"""

from __future__ import annotations

import multiprocessing
import os
import shutil
import sys
import tempfile
import time
import traceback
from typing import Callable
from urllib.parse import urlparse

from tpu_sandbox_torch.runtime.bootstrap import (
    AGENT_STORE_ENV,
    coordinator_address,
    serve_store,
)

#: bytes of each failed rank's standard error quoted in the error
TAIL_BYTES = 2000


class SpawnError(RuntimeError):
    """A rank failed or the deadline passed; ``codes`` per local rank."""

    def __init__(self, message: str, codes: list):
        super().__init__(message)
        self.codes = codes


def say(*lines: str) -> None:
    """Print ``lines`` in one write to standard output, so that lines of
    ranks sharing the stream do not interleave."""
    sys.stdout.write("".join(line + "\n" for line in lines))
    sys.stdout.flush()


def _child(fn: Callable, rank: int, local: int, world_size: int,
           args: tuple, env: dict, err_path: str) -> None:
    os.environ.update(env, RANK=str(rank), LOCAL_RANK=str(local))
    fd = os.open(err_path, os.O_WRONLY | os.O_CREAT | os.O_TRUNC, 0o644)
    sys.stderr.flush()
    os.dup2(fd, 2)
    os.close(fd)
    try:
        fn(rank, world_size, *args)
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        sys.stdout.flush()
        os._exit(1)
    sys.stdout.flush()


def _tail(path: str) -> str:
    try:
        with open(path, "rb") as f:
            f.seek(0, os.SEEK_END)
            f.seek(max(0, f.tell() - TAIL_BYTES))
            return f.read().decode(errors="replace")
    except OSError:
        return ""


def spawn(fn: Callable, world_size: int, *args, nprocs: int | None = None,
          node_rank: int = 0, init_method: str | None = None,
          store=None, timeout: float = 300.0) -> None:
    """Run ``fn(rank, world_size, *args)`` for this node's ranks
    ``node_rank * nprocs + local``, ``local`` in ``range(nprocs)``
    (``nprocs`` defaults to ``world_size``: one node). Returns when every
    rank exited 0; raises ``SpawnError`` otherwise or after ``timeout``
    seconds. A multi-node job passes the same ``init_method`` (or
    ``MASTER_ADDR``/``MASTER_PORT``) on every node; ``store`` is a
    rendezvous store the caller serves (``bootstrap.serve_store``), which
    a single-node spawn given neither serves itself."""
    nprocs = world_size if nprocs is None else nprocs
    if nprocs < 1 or (node_rank + 1) * nprocs > world_size:
        raise ValueError(f"node {node_rank} with {nprocs} ranks does not "
                         f"fit world size {world_size}")
    if (store is None and init_method is None
            and "MASTER_PORT" not in os.environ):
        store = serve_store()
    if store is not None:
        init_method = f"tcp://127.0.0.1:{store.port}"
    elif init_method is None:
        init_method = f"tcp://{coordinator_address()}"
    env = {"WORLD_SIZE": str(world_size), "INIT_METHOD": init_method}
    if store is not None:
        env[AGENT_STORE_ENV] = "True"
    url = urlparse(init_method)
    if url.scheme == "tcp":
        env.update(MASTER_ADDR=url.hostname, MASTER_PORT=str(url.port))
    ctx = multiprocessing.get_context("spawn")
    logdir = tempfile.mkdtemp(prefix="spawn-")
    errs = [os.path.join(logdir, f"rank{local}.err")
            for local in range(nprocs)]
    procs = []
    try:
        for local in range(nprocs):
            rank = node_rank * nprocs + local
            p = ctx.Process(target=_child, name=f"rank{rank}", args=(
                fn, rank, local, world_size, args, env, errs[local]))
            p.start()
            procs.append(p)
        deadline = time.monotonic() + timeout
        failed = None
        while any(p.exitcode is None for p in procs):
            if any(p.exitcode not in (None, 0) for p in procs):
                failed = "a rank failed"
                break
            if time.monotonic() > deadline:
                failed = f"ranks still running after {timeout:.0f} s"
                break
            for p in procs:
                p.join(timeout=0.05)
        if failed is None and any(p.exitcode for p in procs):
            failed = "a rank failed"
    finally:
        for p in procs:
            if p.exitcode is None:
                p.kill()
        for p in procs:
            p.join(timeout=30)
    codes = [p.exitcode for p in procs]
    try:
        if failed is not None:
            lines = [f"{failed}; exit codes {codes}"]
            for local, (code, path) in enumerate(zip(codes, errs)):
                if code:
                    lines.append(f"--- rank {node_rank * nprocs + local} "
                                 f"(exit {code}) stderr tail:\n{_tail(path)}")
            raise SpawnError("\n".join(lines), codes)
        for path in errs:                      # pass the ranks' warnings on
            with open(path, errors="replace") as f:
                sys.stderr.write(f.read())
    finally:
        shutil.rmtree(logdir, ignore_errors=True)
