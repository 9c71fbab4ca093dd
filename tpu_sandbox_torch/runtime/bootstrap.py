"""Process bootstrap and rendezvous on ``torch.distributed``: the port of
``tpu_sandbox/runtime/bootstrap.py`` (:47-184), back in the reference's
own idiom (one OS process per rank, ``init_process_group``; reference
``test_init.py:45-100``).

- ``find_free_port`` returns a string, as the reference's helper does (it
  feeds an environment variable). A launcher does not hand a probed port
  to its ranks: it serves the rendezvous store itself on a port the OS
  gives at the bind (``serve_store``) and the ranks join it as clients.
- The coordinator honours ``MASTER_ADDR``/``MASTER_PORT`` and defaults to
  loopback. ``init`` also takes an init-method URL (``tcp://host:port``
  or ``file:///path``, a ``FileStore`` that needs no port) as its
  coordinator, or the ``INIT_METHOD`` environment variable that
  ``parallel/launch.py`` sets in the ranks it spawns.
- The backend is ``nccl`` for a CUDA device and ``gloo`` for the CPU, the
  reference's choice (``test_init.py:84-88``); ``device`` defaults to
  ``cuda``, which must exist (``utils/device.py``).
- World size 1 still opens a one-rank group (over an in-process
  ``HashStore``), so the single-card run takes the same collective path as
  a multi-rank one.
- ``process_id == -1`` is the reference's serial sentinel: no group.
- Every group gets a finite timeout (``TIMEOUT``, 120 s at most), so a
  rank whose peer never comes fails instead of hanging.
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass
from datetime import timedelta

import torch
import torch.distributed as dist

from tpu_sandbox_torch.utils.device import resolve_device

SERIAL_RANK = -1
#: the process group's timeout: rendezvous and every collective
TIMEOUT = timedelta(seconds=120)

_state: dict = {"initialized": False, "serial": False, "device": None}


#: set in a rank's environment, torch's rendezvous joins the ``tcp://``
#: store as a client on every rank, rank 0 included (torchelastic's agent
#: store): the launcher that serves it (``serve_store``) owns the port
AGENT_STORE_ENV = "TORCHELASTIC_USE_AGENT_STORE"


def find_free_port() -> str:
    """Bind to port 0 and return the port the OS gave, as a string. The
    port is released on return, so another process may take it before
    whoever was told binds it: launchers serve their rendezvous store
    with ``serve_store`` instead."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        s.bind(("", 0))
        return str(s.getsockname()[1])


def serve_store(host: str = "127.0.0.1",
                timeout: timedelta = TIMEOUT) -> dist.TCPStore:
    """A rendezvous store served by the calling launcher on the port the
    OS gives at its bind (port 0): no port is probed and released before
    the bind. The ranks join ``tcp://host:<store.port>`` as clients with
    ``AGENT_STORE_ENV`` set in their environment; the store lives as long
    as the launcher holds it."""
    return dist.TCPStore(host, 0, is_master=True, timeout=timeout,
                         wait_for_workers=False)


def coordinator_address(host: str | None = None,
                        port: str | int | None = None) -> str:
    """``host:port`` from the arguments, else ``MASTER_ADDR`` /
    ``MASTER_PORT``, else loopback and a free port."""
    host = host or os.environ.get("MASTER_ADDR", "127.0.0.1")
    port = port or os.environ.get("MASTER_PORT") or find_free_port()
    return f"{host}:{port}"


@dataclass
class Topology:
    """What this process sees after ``init``: one device a rank."""

    process_id: int
    num_processes: int
    local_devices: int
    global_devices: int
    backend: str

    def summary(self) -> str:
        return (
            f"process {self.process_id}/{self.num_processes}: "
            f"{self.local_devices} local / {self.global_devices} global "
            f"{self.backend} device(s)"
        )


def _env_int(*names: str) -> int | None:
    for name in names:
        if name in os.environ:
            return int(os.environ[name])
    return None


def _init_method(coordinator: str | None) -> str:
    if coordinator is None:
        if "INIT_METHOD" in os.environ:
            return os.environ["INIT_METHOD"]
        if "MASTER_PORT" not in os.environ:
            raise ValueError(
                "multi-process init needs a shared coordinator: pass "
                "coordinator='host:port' (or a tcp:// or file:// URL) or "
                "export MASTER_ADDR/MASTER_PORT identically on every process")
        coordinator = coordinator_address()
    return coordinator if "://" in coordinator else f"tcp://{coordinator}"


def init(coordinator: str | None = None, num_processes: int | None = None,
         process_id: int | None = None, *,
         device: str | torch.device | None = None,
         timeout: timedelta = TIMEOUT) -> Topology:
    """Join the job as rank ``process_id`` of ``num_processes``.

    ``num_processes`` defaults to ``WORLD_SIZE`` (or ``NUM_PROCESSES``),
    else 1; ``process_id`` to ``RANK`` (or ``PROCESS_ID``). Above one
    process both the coordinator and the process id must be given or in the
    environment: a free port or rank 0 made up here would differ between
    processes and the rendezvous could never complete. A second call is a
    no-op that returns the topology. ``device`` (default ``cuda``) picks
    the backend; a CUDA device becomes this process's current device.
    """
    global _state
    if process_id == SERIAL_RANK:
        _state = {"initialized": True, "serial": True, "device": None}
        return topology()
    if _state["initialized"]:
        return topology()
    if timeout > TIMEOUT:
        raise ValueError(f"timeout {timeout} exceeds {TIMEOUT}")
    num_processes = (num_processes or _env_int("WORLD_SIZE", "NUM_PROCESSES")
                     or 1)
    dev = resolve_device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(dev)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if num_processes > 1:
        init_method = _init_method(coordinator)
        if process_id is None:
            process_id = _env_int("RANK", "PROCESS_ID")
            if process_id is None:
                raise ValueError(
                    "multi-process init needs process_id (or RANK / "
                    "PROCESS_ID env); defaulting it would make every "
                    "process claim rank 0")
        dist.init_process_group(backend, init_method=init_method,
                                world_size=num_processes, rank=process_id,
                                timeout=timeout)
    else:
        dist.init_process_group(backend, store=dist.HashStore(),
                                world_size=1, rank=0, timeout=timeout)
    _state = {"initialized": True, "serial": False, "device": dev}
    return topology()


def cleanup() -> None:
    """Destroy the process group (reference ``cleanup``, test_init.py:96-100,
    which the reference defines but never calls). Idempotent."""
    global _state
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _state = {"initialized": False, "serial": False, "device": None}


def is_initialized() -> bool:
    return bool(_state["initialized"])


def _grouped() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_index() -> int:
    return dist.get_rank() if _grouped() else 0


def process_count() -> int:
    return dist.get_world_size() if _grouped() else 1


def device() -> torch.device:
    """This rank's device (the CPU in serial mode)."""
    return _state["device"] or torch.device("cpu")


def backend_name() -> str:
    """The collective fabric: the group's backend, or without a group the
    one ``init`` would pick for this machine ('nccl' iff CUDA, else
    'gloo', reference test_init.py:84-88)."""
    if _grouped():
        return str(dist.get_backend())
    return "nccl" if torch.cuda.is_available() else "gloo"


def topology() -> Topology:
    n = process_count()
    return Topology(process_id=process_index(), num_processes=n,
                    local_devices=1, global_devices=n,
                    backend=backend_name())


def topology_summary() -> str:
    return topology().summary()
