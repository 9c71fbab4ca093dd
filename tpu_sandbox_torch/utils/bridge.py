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


# -- the train state in JAX's leaf paths ---------------------------------------
#
# JAX checkpoints a ``TrainState`` pytree; its ``_flatten_with_paths``
# (train/checkpoint.py:231) names each leaf by its path: ``step`` (int32),
# ``params/<module>/<name>``, ``batch_stats/<module>/<name>``, the optax
# state (``opt_state/0/trace/<param path>`` for sgd with momentum;
# ``opt_state/0/count`` (int32) and ``opt_state/0/{mu,nu}/<param path>``
# for adam and adamw; nothing for plain sgd) and, under int8 gradient sync
# with error feedback, ``grad_residual/<param path>``. The pair below is
# the one place that maps the port's ``TrainState`` onto those paths.

def _path(name: str) -> str:
    return name.replace(".", "/")


def _jax_order(named):
    """``(name, leaf)`` in JAX's flatten order of the nested dict the
    dotted names are paths of: sorted part by part."""
    return sorted(named, key=lambda kv: kv[0].split("."))


def state_refs(state) -> list[tuple[str, object]]:
    """``(path, leaf)`` of the state in JAX's order: a leaf is a live
    tensor, or ``("int", value)`` for an integer scalar (the step, Adam's
    count). The optimizer's lists follow the model's parameter order
    (``train/optim.py`` builds them from ``model.parameters()``); under
    ZeRO-1 their entries are this rank's blocks."""
    model = state.model
    refs: list = [("step", ("int", state.step))]
    refs += [(f"params/{_path(n)}", p)
             for n, p in _jax_order(model.named_parameters())]
    refs += [(f"batch_stats/{_path(n)}", b)
             for n, b in _jax_order(model.named_buffers())]
    opt = state.optimizer
    if opt is not None:
        names = [n for n, _ in model.named_parameters()]
        if len(opt.params) != len(names):
            raise ValueError(
                f"the optimizer holds {len(opt.params)} parameters, the "
                f"model {len(names)}: its lists must follow the model's "
                "parameter order")
        if hasattr(opt, "count"):
            refs.append(("opt_state/0/count", ("int", opt.count)))
        for field in opt.STATE:
            refs += [(f"opt_state/0/{field}/{_path(n)}", t)
                     for n, t in _jax_order(zip(names, getattr(opt, field)))]
    if state.grad_residual is not None:
        names = [n for n, _ in _jax_order(state.model.named_parameters())]
        refs += [(f"grad_residual/{_path(n)}", t)
                 for n, t in zip(names, state.grad_residual)]
    return refs


def _host(leaf):
    """A host copy: numpy, or a CPU tensor for bf16 (which numpy lacks)."""
    if isinstance(leaf, tuple):
        return np.asarray(leaf[1], np.int32)
    t = leaf.detach().to("cpu", copy=True)
    return t if t.dtype == torch.bfloat16 else t.numpy()


def state_to_leaves(state) -> dict:
    """The ``TrainState`` as the flat ``{path: array}`` that JAX's
    ``_flatten_with_paths(TrainState.host_view())`` gives: host copies
    (numpy, or CPU tensors for bf16 leaves), taken without a collective."""
    return {path: _host(leaf) for path, leaf in state_refs(state)}


def state_template(state) -> dict:
    """The same paths with ``ShapeDtype`` leaves: a restore template that
    copies nothing."""
    from tpu_sandbox_torch.train.checkpoint import ShapeDtype

    return {path: (ShapeDtype((), np.int32) if isinstance(leaf, tuple)
                   else ShapeDtype(tuple(leaf.shape), leaf.dtype))
            for path, leaf in state_refs(state)}


@torch.no_grad()
def state_from_leaves(state, leaves: dict) -> None:
    """Write ``leaves`` (the paths of ``state_to_leaves``, at this state's
    shapes) into the ``TrainState`` in place. A residual the state has no
    list for is created; a missing leaf raises ``KeyError``."""
    def value(path):
        if path not in leaves:
            raise KeyError(f"checkpoint misses leaf {path!r}")
        return leaves[path]

    if state.grad_residual is None and any(
            p.startswith("grad_residual/") for p in leaves):
        state.grad_residual = [
            torch.zeros_like(p, dtype=torch.float32)
            for _, p in _jax_order(state.model.named_parameters())]
    for path, leaf in state_refs(state):
        v = value(path)
        if isinstance(leaf, tuple):
            if path == "step":
                state.step = int(np.asarray(v))
            else:
                state.optimizer.count = int(np.asarray(v))
            continue
        src = torch.as_tensor(v if isinstance(v, torch.Tensor)
                              else np.asarray(v))
        if tuple(src.shape) != tuple(leaf.shape):
            raise ValueError(f"leaf {path!r}: shape {tuple(src.shape)} != "
                             f"the state's {tuple(leaf.shape)}")
        leaf.copy_(src)
