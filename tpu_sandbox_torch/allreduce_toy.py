"""All-reduce-sum toy across N ranks: the port of ``allreduce_toy.py``
(same flags, same output lines).

    python -m tpu_sandbox_torch.allreduce_toy -s 4 --force-cpu

Each rank, one OS process, draws an unseeded ``randint(0, 10)`` a step
(reference :23), sum-all-reduces it over the group, waits at a barrier,
and ranks 0 and 1 print ``rank: R, step: S, value: V, reduced sum: T.``
for ``--steps`` steps (10 by default; the reference ignored its flag). The
group is built once, not a ``new_group`` a step (reference :26-27). Each
rank also gathers every rank's value and fails unless the reduced sum is
their sum. NCCL on the card (one GPU a rank), gloo with ``--force-cpu``.
``-s 1`` runs in the calling process; more ranks are spawned, or with
``-r R`` this process is rank R only and joins ``--init-method``.
"""

from __future__ import annotations

import argparse

import torch

from tpu_sandbox_torch.parallel.collectives import CollectiveGroup, world_group
from tpu_sandbox_torch.parallel.launch import say, spawn
from tpu_sandbox_torch.runtime import bootstrap
from tpu_sandbox_torch.utils.device import rank_device

#: seconds the spawned ranks may take, rendezvous included
TIMEOUT = 180.0


def run(group: CollectiveGroup, steps: int) -> None:
    for step in range(1, steps + 1):
        value = torch.randint(0, 10, (1,))
        reduced = group.all_reduce(value, "sum")
        group.barrier()
        every = group.all_gather(value)
        if int(reduced.item()) != int(every.sum()):
            raise RuntimeError(f"step {step}: reduced {int(reduced.item())} "
                               f"!= sum of {every.tolist()}")
        if group.rank < 2:
            say("rank: {}, step: {}, value: {}, reduced sum: {}.".format(
                group.rank, step, int(value.item()), int(reduced.item())))


def worker(rank: int, world_size: int, init_method: str | None, steps: int,
           force_cpu: bool) -> None:
    bootstrap.init(init_method, world_size, rank,
                   device=rank_device(rank, force_cpu))
    try:
        say(f"--> done setting up rank={rank}")
        run(world_group(), steps)
    finally:
        bootstrap.cleanup()


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--backend", type=str, default=None,
                        choices=["nccl", "gloo"],
                        help="nccl (GPU ranks, the default) or gloo (CPU "
                             "ranks, as --force-cpu)")
    parser.add_argument("-i", "--init-method", type=str, default=None,
                        help="rendezvous URL (tcp://host:port or "
                             "file:///path); default a free loopback port")
    parser.add_argument("-s", "--world_size", type=int, default=None,
                        help="Number of ranks participating in the job.")
    parser.add_argument("-r", "--rank", type=int, default=None,
                        dest="member",
                        help="run only this rank here (needs "
                             "--init-method); default: all ranks")
    parser.add_argument("--steps", type=int, default=10)
    parser.add_argument("--force-cpu", action="store_true",
                        help="gloo ranks on the CPU")
    args = parser.parse_args(argv)
    force_cpu = args.force_cpu or args.backend == "gloo"
    if args.backend == "nccl" and args.force_cpu:
        parser.error("--backend nccl needs GPU ranks, not --force-cpu")
    world_size = args.world_size or 1
    if args.member is not None and args.init_method is None:
        parser.error("-r/--rank needs -i/--init-method shared by every rank")
    if world_size > 1 and args.member is None:      # every rank, spawned
        rank_device(world_size - 1, force_cpu)      # enough cards, or raise
        spawn(worker, world_size, None, args.steps, force_cpu,
              init_method=args.init_method, timeout=TIMEOUT)
        return
    worker(args.member or 0, world_size, args.init_method, args.steps,
           force_cpu)

if __name__ == "__main__":
    main()
