"""The port's bootstrap (``tpu_sandbox_torch/runtime/bootstrap.py``) on the
cases of ``tests/test_bootstrap.py``, with gloo on the CPU: a one-rank
group in this process (the four-rank topology is checked in
``test_torch_collectives.py``)."""

import socket

import pytest
import torch

from tpu_sandbox.runtime import bootstrap as jax_bootstrap
from tpu_sandbox_torch.runtime import bootstrap
from torch_threads import one_torch_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _no_group_left():
    yield
    bootstrap.cleanup()


def test_find_free_port_is_string_and_bindable():
    port = bootstrap.find_free_port()
    assert isinstance(port, str)
    with socket.socket() as s:
        s.bind(("127.0.0.1", int(port)))


def test_coordinator_address_honors_env(monkeypatch):
    monkeypatch.setenv("MASTER_ADDR", "10.0.0.7")
    monkeypatch.setenv("MASTER_PORT", "29500")
    assert bootstrap.coordinator_address() == "10.0.0.7:29500"
    assert (bootstrap.coordinator_address()
            == jax_bootstrap.coordinator_address())


def test_coordinator_address_defaults_to_loopback(monkeypatch):
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    monkeypatch.delenv("MASTER_PORT", raising=False)
    host, port = bootstrap.coordinator_address().split(":")
    assert host == "127.0.0.1"
    assert 1024 <= int(port) <= 65535


def test_init_single_process_topology():
    topo = bootstrap.init(device="cpu")
    assert bootstrap.is_initialized()
    assert torch.distributed.is_initialized()       # a one-rank group
    assert topo.process_id == 0
    assert topo.num_processes == 1
    assert topo.global_devices == 1
    assert topo.backend == "gloo"
    assert "process 0/1" in topo.summary()
    assert bootstrap.topology_summary() == topo.summary()
    bootstrap.cleanup()
    assert not bootstrap.is_initialized()
    assert not torch.distributed.is_initialized()


def test_one_rank_group_all_reduces():
    from tpu_sandbox_torch.parallel.collectives import world_group

    bootstrap.init(device="cpu")
    got = world_group().all_reduce(torch.tensor([2.5, -1.0]), "sum")
    assert got.tolist() == [2.5, -1.0]


def test_serial_sentinel_skips_init():
    topo = bootstrap.init(process_id=bootstrap.SERIAL_RANK)
    assert bootstrap.is_initialized()
    assert not torch.distributed.is_initialized()
    assert topo.num_processes == 1
    bootstrap.cleanup()


def test_cleanup_idempotent():
    bootstrap.cleanup()
    bootstrap.cleanup()
    assert not bootstrap.is_initialized()


def test_backend_name_is_the_reference_choice():
    """'nccl' iff CUDA, else 'gloo' (reference test_init.py:84-88); a
    group reports its own."""
    assert bootstrap.backend_name() == (
        "nccl" if torch.cuda.is_available() else "gloo")
    bootstrap.init(device="cpu")
    assert bootstrap.backend_name() == "gloo"


def test_multiprocess_init_requires_shared_coordinator(monkeypatch):
    for name in ("MASTER_PORT", "PROCESS_ID", "RANK", "INIT_METHOD",
                 "WORLD_SIZE"):
        monkeypatch.delenv(name, raising=False)
    with pytest.raises(ValueError, match="shared coordinator"):
        bootstrap.init(num_processes=2, process_id=0, device="cpu")
    with pytest.raises(ValueError, match="process_id"):
        bootstrap.init(coordinator="127.0.0.1:1234", num_processes=2,
                       device="cpu")
    assert not bootstrap.is_initialized()


def test_init_twice_is_idempotent():
    bootstrap.init(device="cpu")
    topo = bootstrap.init(device="cpu")
    assert topo.num_processes == 1


def test_timeout_is_finite():
    from datetime import timedelta

    assert bootstrap.TIMEOUT <= timedelta(seconds=120)
    with pytest.raises(ValueError, match="timeout"):
        bootstrap.init(device="cpu", timeout=timedelta(seconds=600))


@pytest.mark.skipif(torch.cuda.is_available(), reason="needs a machine "
                    "without CUDA")
def test_default_device_is_the_card():
    """No silent CPU run: the default device is CUDA, which must exist."""
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bootstrap.init()
    assert not bootstrap.is_initialized()


def test_spawn_reports_a_failed_rank_and_kills_the_rest(tmp_path):
    """A rank that raises ends the job at once: the other ranks are
    killed long before their sleep ends, and the error names each rank's
    exit code and the failed rank's standard error."""
    import time

    from torch_dist_workers import failing_worker
    from tpu_sandbox_torch.parallel.launch import SpawnError, spawn

    t0 = time.monotonic()
    with pytest.raises(SpawnError) as exc:
        spawn(failing_worker, 3, 60.0, init_method=f"file://{tmp_path}/s",
              timeout=50)
    assert time.monotonic() - t0 < 40
    assert exc.value.codes[1] == 1
    assert all(c not in (None, 0) for c in exc.value.codes)
    assert "rank 1 fails on purpose" in str(exc.value)


def test_spawn_kills_ranks_past_the_deadline(tmp_path):
    from torch_dist_workers import failing_worker
    from tpu_sandbox_torch.parallel.launch import SpawnError, spawn

    with pytest.raises(SpawnError, match="still running after"):
        spawn(failing_worker, 1, 60.0, init_method=f"file://{tmp_path}/s",
              timeout=3)


@pytest.mark.parametrize("launcher", ["test_init", "spawn"])
def test_rendezvous_succeeds_with_the_probed_port_taken(monkeypatch,
                                                         capfd, launcher):
    """The probed-port race: another process holds (listens on) the port
    a probe would hand out. The launchers never hand a probed port to
    their ranks (they serve the rendezvous store on the port the OS gives
    at its bind), so two gloo ranks still meet: through test_init's
    served store, and through spawn's own."""
    from tpu_sandbox_torch import test_init
    from tpu_sandbox_torch.parallel.launch import spawn

    with socket.socket() as taken:
        taken.bind(("127.0.0.1", 0))
        taken.listen()
        port = str(taken.getsockname()[1])
        monkeypatch.setattr(bootstrap, "find_free_port", lambda: port)
        monkeypatch.delenv("MASTER_PORT", raising=False)
        monkeypatch.delenv("MASTER_ADDR", raising=False)
        if launcher == "test_init":
            test_init.test_setup(2, force_cpu=True)
        else:
            spawn(test_init.worker, 2, "served", True, timeout=120)
        out = capfd.readouterr().out
    for rank in range(2):
        assert f"rank {rank}: all_reduce check 3.0 == 3.0" in out
    assert f"port='{port}'" not in out
