"""Train state: the model (parameters and BN running stats), the SGD
optimizer and the step count. Counterpart of ``tpu_sandbox/train/state.py``.

The JAX package keeps these in one immutable pytree; here the model is an
``nn.Module`` updated in place, and SGD without momentum (optax.sgd)
needs no optimizer state beyond the learning rate.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class TrainState:
    model: torch.nn.Module
    lr: float = 1e-4
    step: int = 0

    @torch.no_grad()
    def apply_sgd(self) -> None:
        """p <- p - lr * grad for every parameter (optax.sgd, no
        momentum), in place; clears the gradients; counts the step."""
        for p in self.model.parameters():
            if p.grad is not None:
                p.sub_(self.lr * p.grad)
                p.grad = None
        self.step += 1
