"""Adam, AdamW, SGD with momentum, the LM's learning-rate schedules and
global-norm clipping, written out here: the counterparts of ``optax.adam``,
``optax.adamw``, ``optax.sgd(momentum=...)``, the schedules of
``lm_train.py:98-111`` and ``optax.clip_by_global_norm``, which the JAX
package takes from optax.

``Adam`` follows ``optax.scale_by_adam`` (eps_root 0) then
``scale_by_learning_rate``: mu = (1-b1) g + b1 mu, nu = (1-b2) g^2 + b2 nu,
update = mu_hat / (sqrt(nu_hat) + eps), p += -lr(count) * update, where the
schedule sees the count of updates before this one (0 for the first), so a
warmup's first update runs at lr 0. The moments are f32 and updated in
place. ``AdamW`` is ``optax.adamw``: ``add_decayed_weights`` between the
two, update + wd * p, so the decay is applied as lr * wd * p. ``SGD`` is
``optax.sgd`` with momentum: optax's ``trace`` (not Nesterov), t = g +
momentum * t, p - lr * t.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable

import numpy as np
import torch


def constant_schedule(lr: float) -> Callable[[int], float]:
    return lambda count: lr


def linear_schedule(init_value: float, end_value: float,
                    transition_steps: int) -> Callable[[int], float]:
    """``optax.linear_schedule`` (``transition_steps > 0``): ``init`` to
    ``end`` over the steps, then ``end``."""

    def schedule(count: int) -> float:
        frac = 1 - min(max(count, 0), transition_steps) / transition_steps
        return (init_value - end_value) * frac + end_value

    return schedule


def cosine_decay_schedule(init_value: float, decay_steps: int,
                          alpha: float = 0.0) -> Callable[[int], float]:
    """``optax.cosine_decay_schedule`` (exponent 1, ``decay_steps > 0``)."""

    def schedule(count: int) -> float:
        cosine = 0.5 * (1 + math.cos(math.pi * min(count, decay_steps)
                                     / decay_steps))
        return init_value * ((1 - alpha) * cosine + alpha)

    return schedule


def warmup_cosine_decay_schedule(init_value: float, peak_value: float,
                                 warmup_steps: int, decay_steps: int,
                                 end_value: float = 0.0
                                 ) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule``: linear warmup for
    ``warmup_steps``, then cosine decay to ``end_value`` over the rest of
    ``decay_steps``."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    warm = linear_schedule(init_value, peak_value, warmup_steps)
    decay = cosine_decay_schedule(peak_value, decay_steps - warmup_steps,
                                  alpha)
    return lambda count: (warm(count) if count < warmup_steps
                          else decay(count - warmup_steps))


def lm_schedule(schedule: str, lr: float, steps: int,
                warmup: int) -> Callable[[int], float]:
    """The learning rate of ``lm_train.py``'s ``--schedule``: ``const``, or
    ``cosine`` decaying to 10 % of ``lr`` over the run, after ``warmup``
    linear steps from 0 when ``warmup > 0``."""
    if schedule == "const":
        return constant_schedule(lr)
    if warmup > 0:
        return warmup_cosine_decay_schedule(
            0.0, lr, warmup_steps=warmup,
            decay_steps=max(steps, warmup + 1), end_value=lr * 0.1)
    return cosine_decay_schedule(lr, decay_steps=max(steps, 1), alpha=0.1)


@torch.no_grad()
def clip_by_global_norm_(grads: list[torch.Tensor], max_norm: float,
                         norm: torch.Tensor | None = None) -> torch.Tensor:
    """``optax.clip_by_global_norm`` in place: when the global norm
    ``sqrt(sum |g|^2)`` is at least ``max_norm``, every g becomes
    ``(g / norm) * max_norm``; below it nothing changes. Returns the
    norm. ``norm`` is the global norm when ``grads`` are shards of it
    (``PjitEngine`` sums the squares of sharded leaves over their axes)."""
    if norm is None:
        norm = torch.sqrt(sum((g.float() * g.float()).sum() for g in grads))
    keep = norm < max_norm                  # on the device: no host sync
    for g in grads:
        g.copy_(torch.where(keep, g, (g / norm) * max_norm))
    return norm


def _bias_correction(decay: float, count: int) -> float:
    """``1 - decay**count`` in f32, as ``optax.scale_by_adam`` computes it
    (in f64, 1 - 0.999 differs from optax's 0.0009999871 by 1.3e-5
    relative)."""
    return float(np.float32(1) - np.float32(decay) ** np.float32(count))


class Adam:
    """``optax.adam(lr)`` (b1 0.9, b2 0.999, eps 1e-8) over the model's
    parameters, in place; ``lr`` maps the count of earlier updates to the
    rate."""

    b1, b2, eps = 0.9, 0.999, 1e-8
    weight_decay = 0.0
    #: the per-parameter state lists, each one tensor a parameter of
    #: ``params`` (ZeRO-1 cuts them with their parameters)
    STATE = ("mu", "nu")

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 lr: Callable[[int], float]):
        self.params = list(params)
        self.lr = lr
        self.count = 0
        self.mu = [torch.zeros_like(p, dtype=torch.float32)
                   for p in self.params]
        self.nu = [torch.zeros_like(p, dtype=torch.float32)
                   for p in self.params]

    @torch.no_grad()
    def step(self) -> None:
        """One update from each parameter's ``.grad``, which it then
        clears."""
        lr = self.lr(self.count)
        self.count += 1
        c1 = _bias_correction(self.b1, self.count)
        c2 = _bias_correction(self.b2, self.count)
        for p, mu, nu in zip(self.params, self.mu, self.nu):
            g = p.grad.float()
            mu.mul_(self.b1).add_(g, alpha=1 - self.b1)
            nu.mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            update = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            if self.weight_decay:
                update = update + self.weight_decay * p.float()
            p.add_(update.to(p.dtype), alpha=-lr)
            p.grad = None


class AdamW(Adam):
    """``optax.adamw(lr)`` with optax's defaults: Adam's b1, b2 and eps,
    weight decay 1e-4 on every parameter."""

    def __init__(self, params: Iterable[torch.nn.Parameter],
                 lr: Callable[[int], float], weight_decay: float = 1e-4):
        super().__init__(params, lr)
        self.weight_decay = weight_decay


class SGD:
    """``optax.sgd(lr, momentum)`` over the model's parameters, in place, in
    f32: optax's ``trace`` (not Nesterov), t = g + momentum * t from zeros,
    then p - lr * t. (Plain SGD is ``TrainState.apply_sgd``.)"""

    STATE = ("trace",)

    def __init__(self, params: Iterable[torch.nn.Parameter], lr: float,
                 momentum: float):
        self.params = list(params)
        self.lr = lr
        self.momentum = momentum
        self.trace = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self) -> None:
        """One update from each parameter's ``.grad``, which it then
        clears."""
        for p, t in zip(self.params, self.trace):
            if p.grad is None:
                continue
            t.mul_(self.momentum).add_(p.grad)
            p.sub_(self.lr * t)
            p.grad = None
