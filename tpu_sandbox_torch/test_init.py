"""Distributed-init smoke test: the port of ``test_init.py`` (same flags,
same log lines, exit 0 on success).

    python -m tpu_sandbox_torch.test_init --world-size 4 --force-cpu

One OS process a rank, as the reference spawns them (test_init.py:112-
117): each rank prints ``setup_rank``'s lines (:28-36), joins the group
(NCCL on the card, gloo with ``--force-cpu``), checks a sum all-reduce of
``rank + 1`` against its closed form (the counterpart of the JAX script's
psum check) and tears the group down. The parent prints ``successful
test_setup!``. World size 1 runs its rank in the calling process; above
that the ranks are spawned (``--multiprocess`` is accepted for launch
compatibility: ranks are always processes here). On the card every rank
needs its own GPU; NCCL does not put two ranks on one.
"""

from __future__ import annotations

import argparse

import torch

from tpu_sandbox_torch.parallel.collectives import world_group
from tpu_sandbox_torch.parallel.launch import say, spawn
from tpu_sandbox_torch.runtime import bootstrap
from tpu_sandbox_torch.utils.device import rank_device

#: seconds the spawned ranks may take, rendezvous included
TIMEOUT = 180.0


def setup_rank(rank: int, world_size: int, port: str, backend: str) -> None:
    """Per-rank progress report, line for line with the reference's
    :74-94."""
    if rank != -1:  # -1 rank indicates serial code
        MASTER_ADDR = "127.0.0.1"
        say(f"setting up rank={rank} (with world_size={world_size})",
            f"{MASTER_ADDR=}", f"{port=}", f"{backend=}",
            f"--> done setting up rank={rank}")


def worker(rank: int, world_size: int, port: str, force_cpu: bool) -> None:
    """One rank: join (the store ``spawn`` set in ``INIT_METHOD``, served
    by the parent on ``port``), check a sum all-reduce, leave."""
    bootstrap.init(None, world_size, rank,
                   device=rank_device(rank, force_cpu))
    try:
        setup_rank(rank, world_size, port, bootstrap.backend_name())
        group = world_group()
        total = float(group.all_reduce(
            torch.full((1,), float(rank + 1)), "sum")[0])
        expected = world_size * (world_size + 1) / 2
        if total != expected:
            raise RuntimeError(f"all_reduce gave {total}, want {expected}")
        say(f"rank {rank}: all_reduce check {total} == {expected}")
    finally:
        bootstrap.cleanup()


def test_setup(world_size: int, force_cpu: bool = False) -> None:
    print("test_setup")
    rank_device(world_size - 1, force_cpu)      # enough cards, or raise
    # the rendezvous store, served here on the port the OS gives at its
    # bind (a world of one rank joins no store but prints the port)
    store = bootstrap.serve_store()
    port = str(store.port)
    if world_size == 1:
        worker(0, 1, port, force_cpu)
    else:
        spawn(worker, world_size, port, force_cpu, store=store,
              timeout=TIMEOUT)
    print("successful test_setup!")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--world-size", type=int, default=4)
    parser.add_argument("--multiprocess", action="store_true",
                        help="accepted for launch compatibility: ranks are "
                             "always OS processes here")
    parser.add_argument("--force-cpu", action="store_true",
                        help="gloo ranks on the CPU instead of one GPU a "
                             "rank over NCCL")
    args = parser.parse_args(argv)
    test_setup(args.world_size, args.force_cpu)


if __name__ == "__main__":
    main()
