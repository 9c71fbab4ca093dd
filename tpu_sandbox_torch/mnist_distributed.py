"""Data-parallel big-image MNIST training: the port of
``mnist_distributed.py`` (same flags, defaults and log lines as far as
ported).

    python -m tpu_sandbox_torch.mnist_distributed -g 1 --limit-steps 10

One OS process a rank, as the reference runs (mnist_distributed.py:48-
127): ``-n`` nodes of ``-g`` ranks, global rank ``nr * gpus + local``
(:49), NCCL with one GPU a rank, or gloo ranks on the CPU with
``--force-cpu``. Each rank builds the ConvNet from seed 0 (``--plan``,
``auto`` as ``mnist_onegpu``), trains on its ``DistributedSampler`` shard
(``ShardedBatchLoader`` with ``rank=``, never reshuffled across epochs:
the reference calls no ``set_epoch``), batch ``--batch-size`` a rank,
through ``parallel/data_parallel.py`` (mean gradients, per-rank BN
statistics; ``--zero`` ZeRO-1, ``--grad-compress none|bf16|int8`` with
error feedback unless ``--no-error-feedback``, ``--overlap-grad-sync``
with ``--bucket-mb`` buckets), and rank 0 prints ``Rank [0], Epoch
[e/E], Step [s/S], Loss: L`` every ``--log-every`` steps and the
wall-clock total. ``-g 1``
runs its rank in the calling process; more ranks are spawned (the
``--multiprocess`` flag is accepted for launch compatibility). ``-n 2
-nr 0`` and ``-n 2 -nr 1``, started on two machines (or twice on one)
with the same ``MASTER_ADDR``/``MASTER_PORT``, form one job (a node of
one rank runs it in its own process). ``--prefetch`` assembles and pins
the next batch and enqueues its copy to the rank's device in a background
thread (on the card that copy runs on the default stream, after the
current step's kernels).

Not ported yet, and refused by argparse with their ROADMAP item: the
checkpoint flags and the elastic, agent, pool and KV flags (queue 1 item
6).
"""

from __future__ import annotations

import argparse
import os

import torch

from tpu_sandbox_torch.data import (
    ShardedBatchLoader,
    load_mnist,
    normalize,
    synthetic_mnist,
)
from tpu_sandbox_torch.models import pick_convnet
from tpu_sandbox_torch.parallel.data_parallel import DataParallel
from tpu_sandbox_torch.parallel.launch import spawn
from tpu_sandbox_torch.runtime import bootstrap
from tpu_sandbox_torch.train import SGD, AdamW, Trainer, TrainState
from tpu_sandbox_torch.train.optim import constant_schedule
from tpu_sandbox_torch.utils import exact_fp32
from tpu_sandbox_torch.utils.cli import add_grad_compress_cli, add_overlap_cli
from tpu_sandbox_torch.utils.device import rank_device

IMAGE_SHAPE = [3000, 3000]
LR = 1e-4
#: seconds the spawned ranks may take, rendezvous included, before they are
#: killed (a wait on a dead peer fails sooner: bootstrap.TIMEOUT)
TIMEOUT = 3600.0

#: flag -> (takes a value, ROADMAP item): refused until ported
UNPORTED = {
    "--ckpt-every": (True, "queue 1 item 6, checkpoints"),
    "--ckpt-dir": (True, "queue 1 item 6, checkpoints"),
    "--resume": (False, "queue 1 item 6, checkpoints"),
    "--ckpt-sharded": (False, "queue 1 item 6, checkpoints"),
    "--ckpt-verify-interval": (True, "queue 1 item 6, checkpoints"),
    "--ckpt-compress": (False, "queue 1 item 6, checkpoints"),
    "--elastic": (False, "queue 1 item 6, elastic resume"),
    "--elastic-worker": (False, "queue 1 item 6, elastic resume"),
    "--max-restarts": (True, "queue 1 item 6, elastic resume"),
    "--agents": (True, "queue 1 item 6, elastic resume"),
    "--agent-id": (True, "queue 1 item 6, elastic resume"),
    "--leader": (False, "queue 1 item 6, elastic resume"),
    "--job-id": (True, "queue 1 item 6, elastic resume"),
    "--priority": (True, "queue 1 item 6, elastic resume"),
    "--pool": (True, "queue 1 item 6, elastic resume"),
    "--kv-bind": (True, "queue 1 item 6, elastic resume"),
    "--kv-port": (True, "queue 1 item 6, elastic resume"),
}


#: the JAX script's note on ``--zero`` with ``--opt sgd`` (:51-53)
ZERO_SGD_NOTE = ("note: --zero with plain SGD shards no optimizer state "
                 "(SGD is stateless); use --opt momentum|adamw for the "
                 "memory win")


class _Refuse(argparse.Action):
    """Fails the parse with the flag's ROADMAP item."""

    def __call__(self, parser, namespace, values, option_string=None):
        parser.error(f"{option_string} is not ported yet (ROADMAP "
                     f"{UNPORTED[option_string][1]})")


def load_training_arrays(args, world_size: int, verbose: bool = True):
    """Real MNIST if found, else the synthetic stand-in; normalized and
    trimmed to ``--limit-steps`` steps of the global batch (:32-48)."""
    try:
        images, labels = load_mnist("train", args.data_dir)
    except FileNotFoundError:
        if verbose:
            print("MNIST IDX files not found; using deterministic "
                  "synthetic MNIST")
        images, labels = synthetic_mnist(n=args.synthetic_n, seed=0)
    images = normalize(images)
    labels = labels.astype("int32")
    if args.limit_steps:
        keep = args.limit_steps * args.batch_size * world_size
        images, labels = images[:keep], labels[:keep]
    return images, labels


def make_optimizer(args, model):
    """``--opt``: ``sgd`` is the reference's plain SGD(1e-4) (the state's
    own update), ``momentum`` optax's ``sgd(1e-4, momentum=0.9)``,
    ``adamw`` optax's ``adamw(1e-4)`` (:56-68)."""
    if args.opt == "sgd":
        return None
    if args.opt == "momentum":
        return SGD(model.parameters(), LR, momentum=0.9)
    return AdamW(model.parameters(), constant_schedule(LR))


def train(args, rank: int = 0, world_size: int = 1, local_rank: int = 0, *,
          model_options: dict | None = None):
    """One rank's run, in this process, on GPU ``local_rank`` (or the CPU):
    join the group, train, leave. Returns ``(trainer, state)``.
    ``model_options`` go to ``pick_convnet``."""
    device = rank_device(local_rank, args.force_cpu)
    if device.type == "cuda":
        exact_fp32()
    bootstrap.init(None, world_size, rank, device=device)
    try:
        image_shape = (args.image_size, args.image_size)
        dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
        model = pick_convnet(image_shape, plan=args.plan, num_classes=10,
                             dtype=dtype, seed=0, device=device,
                             **(model_options or {}))
        state = TrainState(model, lr=LR,
                           optimizer=make_optimizer(args, model))
        images, labels = load_training_arrays(args, world_size,
                                              verbose=rank == 0)
        loader = ShardedBatchLoader(images, labels, args.batch_size,
                                    world_size, shuffle=True, seed=0,
                                    rank=rank)
        dp = DataParallel(model, image_size=image_shape, zero=args.zero,
                          grad_compress=args.grad_compress,
                          error_feedback=not args.no_error_feedback,
                          overlap_grad_sync=args.overlap_grad_sync,
                          bucket_mb=args.bucket_mb)
        state = dp.shard_state(state)
        trainer = Trainer(lambda x, y: dp.train_step(state, x, y), device,
                          log_every=args.log_every, log_rank=0,
                          verbose=rank == 0)
        state = trainer.fit(state, loader, args.epochs, set_epoch=False,
                            prefetch=args.prefetch)
    finally:
        bootstrap.cleanup()
    return trainer, state


def _rank_main(rank: int, world_size: int, args) -> None:
    if args.force_cpu:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // args.gpus))
    train(args, rank, world_size, int(os.environ["LOCAL_RANK"]))


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="data-parallel 3000x3000 MNIST training (PyTorch/CUDA "
                    "port)")
    parser.add_argument("-n", "--nodes", type=int, default=1, metavar="N",
                        help="number of nodes (each started with its -nr)")
    parser.add_argument("-g", "--gpus", type=int, default=1,
                        help="number of ranks (GPUs) per node")
    parser.add_argument("-nr", "--nr", type=int, default=0,
                        help="ranking of this node")
    parser.add_argument("--epochs", type=int, default=2, metavar="N",
                        help="number of epochs")
    parser.add_argument("--batch-size", type=int, default=5,
                        help="per-rank batch size (reference :60-61)")
    parser.add_argument("--image-size", type=int, default=IMAGE_SHAPE[0])
    parser.add_argument("--data-dir", type=str, default=None)
    parser.add_argument("--synthetic-n", type=int, default=60000)
    parser.add_argument("--limit-steps", type=int, default=None)
    parser.add_argument("--log-every", type=int, default=100)
    parser.add_argument("--opt", choices=["sgd", "momentum", "adamw"],
                        default="sgd",
                        help="optimizer (default: the reference's plain "
                             "SGD 1e-4; momentum/adamw give --zero real "
                             "state to shard)")
    parser.add_argument("--zero", action="store_true",
                        help="ZeRO-1: shard optimizer state over the data "
                             "axis (same math, 1/N the optimizer memory)")
    parser.add_argument("--plan", choices=["auto", "s2dt", "s2d", "plain"],
                        default="auto",
                        help="ConvNet execution plan, as mnist_onegpu's")
    parser.add_argument("--dtype", choices=["bf16", "fp32"], default="bf16")
    add_grad_compress_cli(parser)
    add_overlap_cli(parser)
    parser.add_argument("--force-cpu", action="store_true",
                        help="gloo ranks on the CPU instead of one GPU a "
                             "rank over NCCL")
    parser.add_argument("--multiprocess", action="store_true",
                        help="accepted for launch compatibility: ranks are "
                             "always OS processes here")
    for flag, (takes_value, _) in UNPORTED.items():
        parser.add_argument(flag, action=_Refuse,
                            nargs="?" if takes_value else 0,
                            help=argparse.SUPPRESS)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    world_size = args.gpus * args.nodes                      # reference :123
    if args.zero and args.opt == "sgd":
        print(ZERO_SGD_NOTE)                # once, from the launcher
    rank_device(args.gpus - 1, args.force_cpu)      # enough cards, or raise
    if world_size == 1:
        return train(args)
    init_method = None
    if args.nodes > 1:
        if "MASTER_PORT" not in os.environ:
            raise SystemExit("-n > 1 needs MASTER_ADDR/MASTER_PORT exported "
                             "identically on every node")
        init_method = f"tcp://{bootstrap.coordinator_address()}"
        if args.gpus == 1:                  # this node's one rank, here
            os.environ["INIT_METHOD"] = init_method
            return train(args, args.nr, world_size)
    spawn(_rank_main, world_size, args, nprocs=args.gpus, node_rank=args.nr,
          init_method=init_method, timeout=TIMEOUT)
    return None


if __name__ == "__main__":
    main()
