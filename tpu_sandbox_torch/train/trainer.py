"""Training engine: the train step and the epoch loop with the reference's
log lines. Counterpart of ``tpu_sandbox/train/trainer.py``:
``resize_on_device`` (:84), ``prepare_inputs`` (:99), ``make_train_step``
(:113-193, gradient accumulation included), ``make_eval_step`` (:209) and
``Trainer.fit`` (:273-352).

The step runs eagerly: the 28x28 batch goes to the device, the model's
fused input stage resizes it to the training size and folds it into
space-to-depth, then forward, mean cross-entropy, backward and the SGD
update run in place on the model.
"""

from __future__ import annotations

import time
from datetime import timedelta
from typing import Callable

import numpy as np
import torch

from tpu_sandbox_torch.models.convnet_s2d_t import resize_weights
from tpu_sandbox_torch.ops.losses import cross_entropy_loss
from tpu_sandbox_torch.train.state import TrainState


def resize_on_device(images: torch.Tensor, image_size) -> torch.Tensor:
    """[N,h,w,C] -> [N,H,W,C] bilinear with ``jax.image.resize``'s
    weights (``resize_weights``): resize is separable and linear, so it is
    two f32 products with the interpolation matrices."""
    H, W = image_size
    _, h0, w0, _ = images.shape
    ah = torch.from_numpy(resize_weights(h0, H)).to(images.device)
    aw = torch.from_numpy(resize_weights(w0, W)).to(images.device)
    return torch.einsum("hi,nijc,wj->nhwc", ah, images.float(), aw)


def prepare_inputs(model, images: torch.Tensor, image_size) -> torch.Tensor:
    """Models with ``fused_input_stage`` (ConvNetS2DT) take the raw small
    batch straight into their fused resize + space-to-depth; any other
    model gets the plain resize."""
    stage = getattr(model, "fused_input_stage", None)
    if stage is not None:
        return stage(images, image_size)
    return resize_on_device(images, image_size)


def to_device(images: np.ndarray, labels: np.ndarray, device: torch.device):
    return (torch.from_numpy(np.ascontiguousarray(images)).to(device),
            torch.from_numpy(np.ascontiguousarray(labels)).long().to(device))


def make_train_step(state: TrainState, *,
                    image_size: tuple[int, int] | None = None,
                    accum_steps: int = 1) -> Callable:
    """(images, labels) -> loss: one SGD update of ``state`` in place.
    ``images`` [N,h,w,1] and ``labels`` [N] lie on the model's device;
    with ``image_size`` they are resized there first.

    ``accum_steps`` k splits the batch into k microbatches run one after
    another (each resized on its own, so the full-size batch never exists
    at once; BN running stats update microbatch by microbatch). Their
    gradients are summed, then divided by k before the one update, JAX's
    order; the loss returned is the mean of the k losses. The
    single-device counterpart of the reference's out-of-memory
    workaround."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    model = state.model

    def train_step(images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        model.train()
        n = images.shape[0]
        if n % accum_steps:
            raise ValueError(
                f"batch {n} not divisible by accum_steps {accum_steps}")
        micro = n // accum_steps
        total = None
        for i in range(0, n, micro):
            x = images[i:i + micro]
            if image_size is not None:
                x = prepare_inputs(model, x, image_size)
            loss = cross_entropy_loss(model(x), labels[i:i + micro])
            loss.backward()                 # sums into each parameter's grad
            total = loss.detach() if total is None else total + loss.detach()
        if accum_steps > 1:
            with torch.no_grad():
                for p in model.parameters():
                    if p.grad is not None:
                        p.grad.div_(accum_steps)
            total = total / accum_steps
        state.apply_sgd()
        return total

    return train_step


def make_eval_step(model, *,
                   image_size: tuple[int, int] | None = None) -> Callable:
    """(images, labels) -> (correct_count, loss), with the running BN
    statistics and no gradient."""

    @torch.no_grad()
    def eval_step(images: torch.Tensor, labels: torch.Tensor):
        model.eval()
        x = images if image_size is None else prepare_inputs(
            model, images, image_size)
        logits = model(x)
        loss = cross_entropy_loss(logits, labels)
        correct = (logits.argmax(-1) == labels).sum()
        return correct, loss

    return eval_step


class Trainer:
    """Epoch loop with the reference's logging contract: every
    ``log_every`` steps ``Epoch [e/E], Step [s/S], Loss: L`` and at the end
    ``Training complete in: <timedelta>``.

    The loss is read on the host only at a log step, which waits for the
    device there; ``step_seconds`` holds each step's host wall time, so it
    is the device's step time only when every step is logged."""

    def __init__(self, train_step: Callable, device: torch.device, *,
                 log_every: int = 100):
        self.train_step = train_step
        self.device = device
        self.log_every = log_every
        self.losses: list[float] = []
        self.step_seconds: list[float] = []
        self.elapsed: timedelta | None = None

    def fit(self, state: TrainState, loader, epochs: int) -> TrainState:
        start = time.monotonic()
        total_step = len(loader)
        for epoch in range(epochs):
            for i, (images, labels) in enumerate(loader):
                t_step = time.monotonic()
                loss = self.train_step(*to_device(images, labels, self.device))
                if (i + 1) % self.log_every == 0:
                    loss_val = float(loss)
                    self.losses.append(loss_val)
                    print("Epoch [{}/{}], Step [{}/{}], Loss: {:.4f}".format(
                        epoch + 1, epochs, i + 1, total_step, loss_val))
                self.step_seconds.append(time.monotonic() - t_step)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.elapsed = timedelta(seconds=time.monotonic() - start)
        print("Training complete in: " + str(self.elapsed))
        return state
