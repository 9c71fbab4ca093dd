"""Single-device big-image MNIST training on one NVIDIA GPU: the port of
``mnist_onegpu.py`` (same flags, defaults and log lines as far as ported).

    python -m tpu_sandbox_torch.mnist_onegpu --epochs 1 --limit-steps 10

Seed 0, the two-block ConvNet on 3000x3000 images (the 28x28 batch is
resized on the device), batch size 5, bf16 compute over f32 parameters,
mean cross-entropy, SGD at 1e-4, a loss line every ``--log-every`` steps
and the wall-clock total. Runs on ``cuda`` unless ``--force-cpu``; with
no card and no ``--force-cpu`` it fails. ``--plan s2dt`` runs the
transposed space-to-depth plan with the sparse conv1 and the fused
conv1+tail backward, its BN tails fused on the card; ``--plan s2d`` runs
the NHWC space-to-depth plan, its convs and BN tails fused on the card;
``--plan plain`` runs the plain NHWC ConvNet (no kernel of the port);
``--plan auto`` picks ``s2dt`` on the card and ``s2d`` on the CPU, as
the JAX script picks by whether its kernels compile, and ``plain`` at an
image size not divisible by 4. ``--accum-steps K`` splits each batch
into K microbatches with one SGD update (the single-device out-of-memory
workaround; the ragged last batch is dropped), ``--native-loader`` feeds
batches from the C++ prefetching loader, and ``--profile DIR`` writes a
torch.profiler trace of training into DIR. Without MNIST IDX files a
deterministic synthetic MNIST stands in. ``--ckpt-dir D`` saves a
checkpoint there after training ("saved checkpoint at step N") and, with
``--ckpt-every N``, every N steps while training (copied to the host at
the step, written in the background); ``--resume`` first restores the
newest step of D ("resumed from step N"). The format is the port's
single-device one (``train/checkpoint.py``), which
``mnist_distributed``'s checkpoints share.
"""

from __future__ import annotations

import argparse
import contextlib

import torch

from tpu_sandbox_torch.data import (
    BatchLoader,
    load_mnist,
    normalize,
    synthetic_mnist,
)
from tpu_sandbox_torch.models import pick_convnet
from tpu_sandbox_torch.train import checkpoint as ckpt
from tpu_sandbox_torch.train import (
    Trainer,
    TrainState,
    make_eval_step,
    make_train_step,
)
from tpu_sandbox_torch.train.trainer import to_device
from tpu_sandbox_torch.utils import exact_fp32, resolve_device
from tpu_sandbox_torch.utils.profiling import trace

IMAGE_SHAPE = [3000, 3000]


def train(args, *, model_options: dict | None = None):
    """Build, train and (with ``--eval``) evaluate; returns
    ``(trainer, state)`` so a caller can read losses and step times.
    ``model_options`` go to ``pick_convnet`` (e.g. ``fused_tail=False``
    for the unfused tails on the card)."""
    if args.accum_steps < 1:
        raise SystemExit(f"--accum-steps must be >= 1, got {args.accum_steps}")
    if args.batch_size % args.accum_steps:
        raise SystemExit(
            f"--batch-size {args.batch_size} must be divisible by "
            f"--accum-steps {args.accum_steps}")
    device = resolve_device("cpu" if args.force_cpu else "cuda")
    if device.type == "cuda":
        exact_fp32()
    image_shape = (args.image_size, args.image_size)
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    model = pick_convnet(image_shape, plan=args.plan, num_classes=10,
                         dtype=dtype, seed=0, device=device,
                         **(model_options or {}))
    state = TrainState(model, lr=1e-4)

    try:
        images, labels = load_mnist("train", args.data_dir)
    except FileNotFoundError:
        print("MNIST IDX files not found; using deterministic synthetic MNIST")
        images, labels = synthetic_mnist(n=args.synthetic_n, seed=0)
    if args.limit_steps:
        images = images[: args.limit_steps * args.batch_size]
        labels = labels[: args.limit_steps * args.batch_size]
    # accumulation needs every batch divisible into microbatches: drop the
    # ragged tail instead of failing on it at the end of an epoch
    drop_last = args.accum_steps > 1
    if args.native_loader:
        from tpu_sandbox_torch.data.native_loader import NativeBatchLoader

        loader = NativeBatchLoader(images, labels, args.batch_size,
                                   shuffle=True, seed=0, threads=2,
                                   drop_last=drop_last)
    else:
        loader = BatchLoader(normalize(images), labels.astype("int32"),
                             args.batch_size, shuffle=True, seed=0,
                             drop_last=drop_last)

    if args.ckpt_dir and args.resume:
        if ckpt.latest_step(args.ckpt_dir) is not None:
            ckpt.restore(args.ckpt_dir, state)
            print(f"resumed from step {state.step}")
    step = make_train_step(state, image_size=image_shape,
                           accum_steps=args.accum_steps)
    trainer = Trainer(step, device, log_every=args.log_every,
                      ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every)
    profile_ctx = (trace(args.profile, cuda=device.type == "cuda")
                   if args.profile else contextlib.nullcontext())
    with profile_ctx:
        state = trainer.fit(state, loader, args.epochs)
    if args.profile:
        print(f"profiler trace written to {args.profile}")

    if args.eval:
        try:
            eval_images, eval_labels = load_mnist("test", args.data_dir)
        except FileNotFoundError:
            eval_images, eval_labels = synthetic_mnist(n=2000, seed=1)
        eval_images = normalize(eval_images)
        eval_labels = eval_labels.astype("int32")
        eval_step = make_eval_step(model, image_size=image_shape)
        ebs = min(args.batch_size, len(eval_images))
        correct = total = batches = 0
        loss_sum = 0.0
        for i in range(0, len(eval_images) - ebs + 1, ebs):
            c, l = eval_step(*to_device(eval_images[i:i + ebs],
                                        eval_labels[i:i + ebs], device))
            correct += int(c)
            loss_sum += float(l)
            total += ebs
            batches += 1
        if total:
            print(f"Eval: accuracy {correct}/{total} = {correct / total:.4f}, "
                  f"mean loss {loss_sum / batches:.4f}")
        else:
            print("Eval: no test data available, skipped")
    if args.ckpt_dir:
        print(f"saved checkpoint at step {ckpt.save(args.ckpt_dir, state)}")
    return trainer, state


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="single-GPU 3000x3000 MNIST training (PyTorch/CUDA port)")
    parser.add_argument("--epochs", type=int, default=2, help="number of epochs")
    parser.add_argument("--batch-size", type=int, default=5,
                        help="bs=10 runs out of memory on one 24GB GPU in "
                             "the reference experiment")
    parser.add_argument("--image-size", type=int, default=IMAGE_SHAPE[0])
    parser.add_argument("--data-dir", type=str, default=None,
                        help="directory with MNIST IDX files; synthetic "
                             "fallback otherwise")
    parser.add_argument("--synthetic-n", type=int, default=60000)
    parser.add_argument("--limit-steps", type=int, default=None,
                        help="cap steps per epoch (quick runs)")
    parser.add_argument("--log-every", type=int, default=100)
    parser.add_argument("--accum-steps", type=int, default=1,
                        help="gradient accumulation: split each batch into k "
                             "sequential microbatches (the out-of-memory "
                             "workaround on one device)")
    parser.add_argument("--plan", choices=["auto", "s2dt", "s2d", "plain"],
                        default="auto",
                        help="ConvNet execution plan: s2dt = transposed "
                             "space-to-depth (models/convnet_s2d_t.py), s2d "
                             "= NHWC space-to-depth (models/convnet_s2d.py), "
                             "their kernels fused on the GPU; plain = the "
                             "NHWC ConvNet (models/convnet.py); auto picks "
                             "s2dt on the GPU and s2d on the CPU when the "
                             "image size allows, else plain")
    parser.add_argument("--dtype", choices=["bf16", "fp32"], default="bf16",
                        help="compute dtype; params and loss stay fp32")
    parser.add_argument("--native-loader", action="store_true",
                        help="use the C++ prefetching data loader")
    parser.add_argument("--ckpt-every", type=int, default=0, metavar="N",
                        help="with --ckpt-dir: also save every N steps "
                             "(crash recovery), not just at the end")
    parser.add_argument("--ckpt-dir", type=str, default=None,
                        help="save a checkpoint here after training")
    parser.add_argument("--resume", action="store_true",
                        help="restore the latest checkpoint from --ckpt-dir "
                             "first")
    parser.add_argument("--profile", type=str, default=None, metavar="DIR",
                        help="write a torch.profiler trace of training into "
                             "DIR (view in Perfetto or chrome://tracing)")
    parser.add_argument("--eval", action="store_true",
                        help="report test-set accuracy after training")
    parser.add_argument("--force-cpu", action="store_true",
                        help="run on the CPU (the kernels' plain PyTorch "
                             "versions) instead of the GPU")
    return parser


def main(argv=None):
    return train(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
