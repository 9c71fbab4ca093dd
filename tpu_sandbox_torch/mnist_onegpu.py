"""Single-device big-image MNIST training on one NVIDIA GPU: the port of
``mnist_onegpu.py`` (same flags, defaults and log lines as far as ported).

    python -m tpu_sandbox_torch.mnist_onegpu --epochs 1 --limit-steps 10

Seed 0, the two-block ConvNet on 3000x3000 images (the 28x28 batch is
resized on the device), batch size 5, bf16 compute over f32 parameters,
mean cross-entropy, SGD at 1e-4, a loss line every ``--log-every`` steps
and the wall-clock total. Runs on ``cuda`` unless ``--force-cpu``; with
no card and no ``--force-cpu`` it fails. Without MNIST IDX files a
deterministic synthetic MNIST stands in. The JAX script's other flags
(--accum-steps, --plan, --native-loader, --ckpt-every, --ckpt-dir,
--profile, --resume) are not ported yet and argparse refuses them.
"""

from __future__ import annotations

import argparse

import torch

from tpu_sandbox_torch.data import (
    BatchLoader,
    load_mnist,
    normalize,
    synthetic_mnist,
)
from tpu_sandbox_torch.models import pick_convnet
from tpu_sandbox_torch.train import (
    Trainer,
    TrainState,
    make_eval_step,
    make_train_step,
)
from tpu_sandbox_torch.train.trainer import to_device
from tpu_sandbox_torch.utils import exact_fp32, resolve_device

IMAGE_SHAPE = [3000, 3000]


def train(args):
    """Build, train and (with ``--eval``) evaluate; returns
    ``(trainer, state)`` so a caller can read losses and step times."""
    device = resolve_device("cpu" if args.force_cpu else "cuda")
    if device.type == "cuda":
        exact_fp32()
    image_shape = (args.image_size, args.image_size)
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    model = pick_convnet(image_shape, num_classes=10, dtype=dtype, seed=0,
                         device=device)
    state = TrainState(model, lr=1e-4)

    try:
        images, labels = load_mnist("train", args.data_dir)
    except FileNotFoundError:
        print("MNIST IDX files not found; using deterministic synthetic MNIST")
        images, labels = synthetic_mnist(n=args.synthetic_n, seed=0)
    if args.limit_steps:
        images = images[: args.limit_steps * args.batch_size]
        labels = labels[: args.limit_steps * args.batch_size]
    loader = BatchLoader(normalize(images), labels.astype("int32"),
                         args.batch_size, shuffle=True, seed=0)

    step = make_train_step(state, image_size=image_shape)
    trainer = Trainer(step, device, log_every=args.log_every)
    state = trainer.fit(state, loader, args.epochs)

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
    parser.add_argument("--dtype", choices=["bf16", "fp32"], default="bf16",
                        help="compute dtype; params and loss stay fp32")
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
