"""Two-way weight bridge between a Flax variable tree (as numpy) and the
port's modules.

The pattern of ``tpu_sandbox/utils/parity.py`` (copy weights between the
frameworks so both start from bit-identical init), without importing it.
The port keeps the Flax layouts (conv kernels [5,5,ci,co], the fc kernel
[H*C*W, K] in canonical (h, c, w) row order), so the bridge is a rename:
``variables[collection][module][leaf]`` <-> the torch state-dict key
``module.leaf``, for the ``params`` and ``batch_stats`` collections.
"""

from __future__ import annotations

import numpy as np
import torch

COLLECTIONS = ("params", "batch_stats")


def params_from_flax(variables: dict) -> dict[str, torch.Tensor]:
    """``{'params': {...}, 'batch_stats': {...}}`` of numpy arrays -> a
    state dict for ``module.load_state_dict`` (CPU tensors, copied)."""
    state = {}
    for coll in COLLECTIONS:
        for mod, leaves in variables.get(coll, {}).items():
            for leaf, value in leaves.items():
                state[f"{mod}.{leaf}"] = torch.from_numpy(
                    np.array(value, copy=True))
    return state


def params_to_flax(module: torch.nn.Module) -> dict:
    """The module's parameters and buffers as a Flax-shaped numpy tree:
    parameters under ``params``, buffers under ``batch_stats``."""
    out: dict = {coll: {} for coll in COLLECTIONS}
    named = [("params", module.named_parameters()),
             ("batch_stats", module.named_buffers())]
    for coll, items in named:
        for key, t in items:
            mod, leaf = key.rsplit(".", 1)
            out[coll].setdefault(mod, {})[leaf] = (
                t.detach().to("cpu").numpy().copy())
    return out
