"""Train state: the model (parameters and BN running stats), the SGD
optimizer, the step count and, under int8 gradient sync with error
feedback, this rank's residual. Counterpart of
``tpu_sandbox/train/state.py``.

The JAX package keeps these in one immutable pytree; here the model is an
``nn.Module`` updated in place. SGD without momentum (optax.sgd), the
default, needs no optimizer state beyond the learning rate; any other
optimizer (``train/optim.py``: ``SGD`` with momentum, ``AdamW``) rides in
``optimizer`` and keeps its own state.

``host_view`` is the state as the flat ``{path: array}`` of JAX's leaf
paths (``utils/bridge.py``), which every checkpoint format writes.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class TrainState:
    model: torch.nn.Module
    lr: float = 1e-4
    step: int = 0
    optimizer: object | None = None
    #: the error-feedback residual, one fp32 tensor a parameter (rank-local;
    #: ``DataParallel`` starts it at zeros), or None
    grad_residual: list[torch.Tensor] | None = None

    def host_view(self) -> dict:
        """This process's host copy of every leaf, in JAX's leaf paths:
        the whole value of each parameter, BN statistic (this rank's own)
        and residual, and under ZeRO-1 this rank's block of each dim-0
        sharded optimizer leaf. Read without a collective, so it works
        while peer ranks are dead."""
        from tpu_sandbox_torch.utils.bridge import state_to_leaves

        return state_to_leaves(self)

    def apply_update(self, params=None) -> None:
        """The optimizer's update from the gradients (plain SGD at ``lr``
        without one, of ``params`` or else the model's parameters), which
        clears them; counts the step."""
        if self.optimizer is None:
            self.apply_sgd(params)
            return
        self.optimizer.step()
        self.step += 1

    @torch.no_grad()
    def apply_sgd(self, params=None) -> None:
        """p <- p - lr * grad for every parameter (optax.sgd, no
        momentum), in place; clears the gradients; counts the step."""
        for p in self.model.parameters() if params is None else params:
            if p.grad is not None:
                p.sub_(self.lr * p.grad)
                p.grad = None
        self.step += 1
