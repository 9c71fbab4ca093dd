"""Two-way weight bridge between a Flax variable tree (as numpy) and the
port's modules.

The pattern of ``tpu_sandbox/utils/parity.py`` (copy weights between the
frameworks so both start from bit-identical init), without importing it.
The port keeps the Flax layouts (conv kernels [5,5,ci,co], the fc kernel
[H*C*W, K] in canonical (h, c, w) row order, the transformer's qkv kernel
[d, 3, H, hd]), so the bridge is a rename: the path through
``variables[collection]`` joined by dots is the torch state-dict key, at any
depth (``conv1/kernel`` <-> ``conv1.kernel``, ``block3/attn/qkv/kernel``
<-> ``block3.attn.qkv.kernel``, the MoE's ``block0/mlp/w_up`` and
``block0/mlp/router/kernel``), for the ``params`` and ``batch_stats``
collections.
"""

from __future__ import annotations

import numpy as np
import torch

COLLECTIONS = ("params", "batch_stats")


def _flatten(tree, prefix: str, out: dict) -> None:
    for name, value in tree.items():
        key = f"{prefix}{name}"
        if hasattr(value, "items"):                     # a (frozen) dict
            _flatten(value, key + ".", out)
        else:
            out[key] = torch.from_numpy(np.array(value, copy=True))


def params_from_flax(variables: dict) -> dict[str, torch.Tensor]:
    """``{'params': {...}, 'batch_stats': {...}}`` of numpy arrays, nested
    to any depth -> a state dict for ``module.load_state_dict`` (CPU
    tensors, copied)."""
    state: dict = {}
    for coll in COLLECTIONS:
        _flatten(variables.get(coll, {}), "", state)
    return state


def params_to_flax(module: torch.nn.Module) -> dict:
    """The module's parameters and buffers as a Flax-shaped nested numpy
    tree: parameters under ``params``, buffers under ``batch_stats``."""
    out: dict = {coll: {} for coll in COLLECTIONS}
    named = [("params", module.named_parameters()),
             ("batch_stats", module.named_buffers())]
    for coll, items in named:
        for key, t in items:
            *path, leaf = key.split(".")
            node = out[coll]
            for name in path:
                node = node.setdefault(name, {})
            node[leaf] = t.detach().to("cpu").numpy().copy()
    return out
