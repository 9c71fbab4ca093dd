"""Per-stage MPMD programs. Counterpart of ``tpu_sandbox/mpmd/program.py``:
``check_layer_split`` (:53), ``stage_params`` and ``merge_stage_params``
(:74, :98), ``accumulate_descending`` (:118) and ``StageProgram`` (:129)
with its programs, the ZB-H1 split among them (:261-297).

Each stage runs only its own programs: the forward of its layer slice
(stage 0 embeds), a backward that recomputes the forward and takes the
gradient against the downstream stage's cotangent, and a stage-local
optimizer over its own slice. The math is ``parallel/pipeline.py``'s (the
same ``Block`` through ``functional_call``, the f32 two-pass layernorm and
``head_loss / M`` of the head), and the head's cross-entropy is
``ops/losses.py``'s, the CE kernel on the card at LM vocabularies.

A stage's parameters are ``{"stages": {leaf: [layers, ...]}}`` (each block
leaf of ``split_transformer_params`` stacked over the stage's layers) plus
``"pre"`` (the embeddings) on stage 0 and ``"post"`` (ln_f, lm_head) on
the last stage, under the LM's state-dict names. Gradients have the same
tree. Per-microbatch gradients are folded in DESCENDING microbatch order
(``accumulate_descending``), JAX's order, which reproduces the SPMD scan
transpose there; the loss is summed ascending.

In PyTorch a program is the forward under ``torch.autograd.grad``: ``bwd``
recomputes the stage's forward and takes the gradient against the
parameters (and the input, past stage 0). The ZB-H1 split:

- ``bwd_input`` (B): the layers' inputs from a forward without a graph,
  then back along the chain one layer at a time, each layer recomputed
  from its stashed input and differentiated against that input alone; it
  stashes each layer's (input, output cotangent) and returns the stage's
  input cotangent;
- ``bwd_weight`` (W): each layer recomputed from its stashed input and
  differentiated against its parameters with its stashed cotangent, with
  no walk along the chain;
- ``bwd_weight_chain``: stage 0's W, the whole backward (nothing upstream
  wants its input cotangent);
- ``loss_bwd_input`` / ``loss_bwd_weight``: the last stage's pair, W
  recomputing the head loss for the head's gradient.

No graph outlives a program call, so what B stashes is tensors alone.

The optimizer is ``tx(params)``, the port's ``train/optim.py`` (``Adam``,
``SGD``), built over the stage's parameter tensors by ``init_opt_state``;
that object is the stage's optimizer state, and ``apply_grads`` updates
the parameters and it in place (the port's optimizers are in place). They
update leaf by leaf, so the stage-local update over a slice is the
whole-model update's on that slice.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch.func import functional_call

from tpu_sandbox_torch.models.transformer import Block, TransformerConfig
from tpu_sandbox_torch.ops.losses import cross_entropy_loss
from tpu_sandbox_torch.parallel.pipeline import (
    _layernorm,
    merge_transformer_params,
    split_transformer_params,
)
from tpu_sandbox_torch.utils.device import resolve_device

#: the top-level keys of a stage's tree, in flatten order
PARTS = ("post", "pre", "stages")
_LOWER = ("ahead-of-time lowering has no counterpart yet (ROADMAP queue 1 "
          "item 12)")


def check_layer_split(n_layers: int, n_stages: int,
                      layer_split) -> list[int]:
    """Validate (or derive) the per-stage layer counts. ``None`` keeps
    the original contract: layers must divide evenly."""
    if layer_split is None:
        if n_layers % n_stages:
            raise ValueError(
                f"{n_layers} layers not divisible into {n_stages} stages "
                "(pass layer_split for an uneven pipeline)")
        return [n_layers // n_stages] * n_stages
    split = [int(x) for x in layer_split]
    if len(split) != n_stages:
        raise ValueError(
            f"layer_split {split} has {len(split)} entries for "
            f"{n_stages} stages")
    if any(x < 1 for x in split) or sum(split) != n_layers:
        raise ValueError(
            f"layer_split {split} must be positive and sum to {n_layers}")
    return split


def stage_params(flat_params: dict, stage: int, n_stages: int, *,
                 layer_split=None) -> dict:
    """Slice a ``TransformerLM`` state dict to one stage's tree:
    ``{"stages": {leaf: [layers, ...]}}`` plus ``"pre"`` on stage 0 and
    ``"post"`` on the last stage, the leaves the SPMD engine gives that
    pipe rank, as tensors of its own (the programs update in place).
    ``layer_split`` gives each stage's layer count for uneven pipelines."""
    # n_stages=1 skips the splitter's own divisibility check — uneven
    # pipelines validate through check_layer_split instead
    flat = {k: torch.as_tensor(v) for k, v in flat_params.items()}
    pre, stacked, post = split_transformer_params(flat, 1)
    n_layers = next(iter(stacked.values())).shape[0]
    split = check_layer_split(n_layers, n_stages, layer_split)
    lo = sum(split[:stage])
    hi = lo + split[stage]
    out = {"stages": {k: x[lo:hi].clone() for k, x in stacked.items()}}
    if stage == 0:
        out["pre"] = {k: t.clone() for k, t in pre.items()}
    if stage == n_stages - 1:
        out["post"] = {k: t.clone() for k, t in post.items()}
    return out


def merge_stage_params(parts: list[dict]) -> dict:
    """Per-stage trees (stage order) -> the ``TransformerLM`` state dict,
    CPU tensors of its own."""
    def cpu(tree):
        return {k: v.detach().to("cpu", copy=True) for k, v in tree.items()}

    stacked = {k: torch.cat([p["stages"][k].detach().cpu() for p in parts])
               for k in parts[0]["stages"]}
    return merge_transformer_params(cpu(parts[0]["pre"]), stacked,
                                    cpu(parts[-1]["post"]))


def _leaf_order(names) -> list[str]:
    """Leaf names in JAX's flatten order of the nested dict they are
    paths of: sorted part by part."""
    return sorted(names, key=lambda n: n.split("."))


def tree_items(tree: dict) -> list[tuple[str, torch.Tensor]]:
    """``[(part/leaf, tensor)]`` of a stage tree in flatten order."""
    return [(f"{part}/{name}", tree[part][name])
            for part in PARTS if part in tree
            for name in _leaf_order(tree[part])]


def tree_leaves(tree: dict) -> list[torch.Tensor]:
    return [t for _, t in tree_items(tree)]


def tree_map(fn: Callable, tree: dict, *rest: dict) -> dict:
    """``fn`` over the leaves of stage trees of one structure."""
    return {part: {name: fn(t, *(r[part][name] for r in rest))
                   for name, t in leaves.items()}
            for part, leaves in tree.items()}


def accumulate_descending(grads_by_mb: dict) -> dict:
    """Left-fold per-microbatch grads in descending microbatch order —
    ``((0 + g[M-1]) + g[M-2]) + ... + g[0]``, where they lie (an fp32 add
    is the same bits on the host and the card). ``grads_by_mb`` maps
    microbatch index -> grad tree and must be dense over [0, M); it is
    emptied as the fold goes, so each microbatch's tree is freed once
    added."""
    order = sorted(grads_by_mb, reverse=True)
    acc = tree_map(torch.zeros_like, grads_by_mb[order[0]])
    for m in order:
        tree_map(lambda a, g: a.add_(g), acc, grads_by_mb.pop(m))
    return acc


def to_tensor(x) -> torch.Tensor:
    """A tensor as it is; an array as a tensor (copied when read-only)."""
    if isinstance(x, torch.Tensor):
        return x
    a = np.asarray(x)
    return torch.from_numpy(a if a.flags.writeable else a.copy())


def opt_state_tree(opt, params: dict) -> dict:
    """The optimizer's state as a tree (for checkpoints): each of its
    ``STATE`` lists under that name in the parameters' tree, and its
    update count where it keeps one."""
    names = [path for path, _ in tree_items(params)]
    out = {}
    for attr in opt.STATE:
        part: dict = {}
        for path, t in zip(names, getattr(opt, attr)):
            top, name = path.split("/", 1)
            part.setdefault(top, {})[name] = t
        out[attr] = part
    if hasattr(opt, "count"):
        out["count"] = np.int64(opt.count)
    return out


def load_opt_state(opt, state: dict) -> None:
    """Copy a tree of ``opt_state_tree``'s form into ``opt`` in place."""
    for attr in opt.STATE:
        for t, v in zip(getattr(opt, attr), tree_leaves(state[attr])):
            t.copy_(to_tensor(v))
    if hasattr(opt, "count"):
        opt.count = int(np.asarray(state["count"]))


class StageProgram:
    """The step functions of one pipeline stage, on its ``device`` (the
    card unless the caller asks for the CPU)."""

    def __init__(self, config: TransformerConfig, tx: Callable, stage: int,
                 n_stages: int, microbatches: int, *, device=None,
                 layer_split=None):
        self.layer_split = check_layer_split(config.n_layers, n_stages,
                                             layer_split)
        self.config = config
        self.tx = tx
        self.stage = stage
        self.n_stages = n_stages
        self.microbatches = microbatches
        self.device = resolve_device(device)
        self.is_first = stage == 0
        self.is_last = stage == n_stages - 1
        # the block's code with no weights of its own (JAX's
        # Block(config, None): the plain causal attention)
        with torch.device("meta"):
            self._block = Block(config, None, torch.Generator())

    # -- the per-stage math (parallel/pipeline.py's) -------------------------

    def _layer(self, stages: dict, i: int) -> dict:
        return {name: x[i] for name, x in stages.items()}

    def _apply(self, layer: dict, h: torch.Tensor) -> torch.Tensor:
        return functional_call(self._block, layer, (h,))

    def _stage_apply(self, stages: dict, h: torch.Tensor) -> torch.Tensor:
        for i in range(next(iter(stages.values())).shape[0]):
            h = self._apply(self._layer(stages, i), h)
        return h

    def _embed(self, pre: dict, tokens: torch.Tensor) -> torch.Tensor:
        positions = torch.arange(tokens.shape[1], device=tokens.device
                                 ).expand(tokens.shape)
        tok = F.embedding(tokens, pre["tok_emb.embedding"])
        pos = F.embedding(positions, pre["pos_emb.embedding"])
        return (tok + pos).to(self.config.dtype)

    def _head_loss(self, post: dict, h: torch.Tensor,
                   targets: torch.Tensor) -> torch.Tensor:
        dt = self.config.dtype
        hn = _layernorm(h, post["ln_f.scale"], post["ln_f.bias"]).to(dt)
        logits = (hn @ post["lm_head.kernel"].to(dt)
                  + post["lm_head.bias"].to(dt))
        return cross_entropy_loss(logits.reshape(-1, logits.shape[-1]),
                                  targets.reshape(-1))

    def _forward(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        h = self._embed(params["pre"], x) if self.is_first else x
        return self._stage_apply(params["stages"], h)

    # -- autograd plumbing ---------------------------------------------------

    @staticmethod
    def _with_grad(params: dict, parts=PARTS):
        """(tree whose ``parts`` are leaves requiring grad, the list of
        those leaves, a function of their grads -> grad tree). Under
        ``stages`` the tree holds one dict a layer: each layer's slice of
        a stacked leaf is its own leaf, so a layer's grads never pass
        through a [layers, ...] buffer."""
        tree, leaves, layout = {}, [], []
        for part in PARTS:
            if part not in params:
                continue
            src = params[part]
            if part not in parts:
                tree[part] = src
                continue
            names = _leaf_order(src)
            if part == "stages":
                n = src[names[0]].shape[0]
                rows = [{k: src[k][i].detach().requires_grad_()
                         for k in names} for i in range(n)]
                tree[part] = rows
                leaves += [r[k] for r in rows for k in names]
                layout.append((part, names, n))
            else:
                tree[part] = {k: src[k].detach().requires_grad_()
                              for k in names}
                leaves += [tree[part][k] for k in names]
                layout.append((part, names, None))

        def unflatten(grads) -> dict:
            it = iter(grads)
            out = {}
            for part, names, n in layout:
                if n is None:
                    out[part] = {k: next(it) for k in names}
                else:
                    rows = [{k: next(it) for k in names} for _ in range(n)]
                    out[part] = {k: torch.stack([r[k] for r in rows])
                                 for k in names}
            return out

        return tree, leaves, unflatten

    def _rows_forward(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        """``_forward`` over a ``_with_grad`` tree (stages as rows)."""
        h = self._embed(params["pre"], x) if self.is_first else x
        for row in params["stages"]:
            h = self._apply(row, h)
        return h

    # -- the programs --------------------------------------------------------

    @torch.no_grad()
    def fwd(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        return self._forward(params, x)

    def bwd(self, params: dict, x: torch.Tensor, g_out: torch.Tensor):
        """Recompute-forward plus the gradient: (param grads, input grad,
        None on stage 0)."""
        tree, leaves, unflatten = self._with_grad(params)
        with torch.enable_grad():
            if self.is_first:
                out = self._rows_forward(tree, x)
                return unflatten(torch.autograd.grad(out, leaves, g_out)), None
            xr = x.detach().requires_grad_()
            out = self._rows_forward(tree, xr)
            *grads, gx = torch.autograd.grad(out, [*leaves, xr], g_out)
        return unflatten(grads), gx

    def loss_grad(self, params: dict, x: torch.Tensor,
                  targets: torch.Tensor):
        """(loss / M, param grads, input grad) of the last stage."""
        tree, leaves, unflatten = self._with_grad(params)
        with torch.enable_grad():
            xr = x if self.is_first else x.detach().requires_grad_()
            out = self._rows_forward(tree, xr)
            lv = self._head_loss(tree["post"], out, targets) / \
                self.microbatches
            wrt = leaves if self.is_first else [*leaves, xr]
            grads = torch.autograd.grad(lv, wrt)
        if self.is_first:
            return lv.detach(), unflatten(grads), None
        return lv.detach(), unflatten(grads[:-1]), grads[-1]

    def apply_grads(self, params: dict, opt_state, grads: dict):
        """One optimizer update of ``params`` (the tensors ``opt_state``
        was built over by ``init_opt_state``) from ``grads``, in place;
        returns (params, opt_state)."""
        mine = tree_leaves(params)
        if any(a is not b for a, b in zip(mine, opt_state.params)):
            raise ValueError("opt_state was built over other tensors than "
                             "params (use init_opt_state(params))")
        for p, g in zip(mine, tree_leaves(grads)):
            p.grad = g
        opt_state.step()
        return params, opt_state

    # -- the ZB-H1 split -----------------------------------------------------

    @torch.no_grad()
    def _fwd_collect(self, params: dict, h0: torch.Tensor):
        """(output, [each layer's input]) of the stage's layers."""
        hs, h = [], h0
        stages = params["stages"]
        for i in range(next(iter(stages.values())).shape[0]):
            hs.append(h)
            h = self._apply(self._layer(stages, i), h)
        return h, hs

    def _chain(self, params: dict, hs: list, g_top: torch.Tensor):
        """Back along the layers: each layer's input cotangent from its
        output's, the parameters held constant. -> (input cotangent,
        [each layer's output cotangent])."""
        stages = params["stages"]
        g, gs = g_top, [None] * len(hs)
        for i in reversed(range(len(hs))):
            gs[i] = g
            with torch.enable_grad():
                h_in = hs[i].detach().requires_grad_()
                out = self._apply(self._layer(stages, i), h_in)
                (g,) = torch.autograd.grad(out, h_in, g)
        return g, gs

    def _weight_grads(self, params: dict, stash) -> dict:
        """Each layer's parameter grads from its stashed (input, output
        cotangent), stacked over the layers."""
        hs, gs = stash
        tree, _, unflatten = self._with_grad({"stages": params["stages"]})
        grads = []
        for row, h_in, g in zip(tree["stages"], hs, gs):
            with torch.enable_grad():
                out = self._apply(row, h_in)
                grads += torch.autograd.grad(out, list(row.values()), g)
        return unflatten(grads)["stages"]

    def bwd_input(self, params: dict, x: torch.Tensor, g_out: torch.Tensor):
        """B: (input cotangent, stash for W)."""
        _, hs = self._fwd_collect(params, x)
        gx, gs = self._chain(params, hs, g_out)
        return gx, (hs, gs)

    def bwd_weight(self, params: dict, stash) -> dict:
        """W: the stage's layer grads from B's stash alone."""
        return {"stages": self._weight_grads(params, stash)}

    def bwd_weight_chain(self, params: dict, x: torch.Tensor,
                         g_out: torch.Tensor) -> dict:
        """Stage 0's W: the whole backward (embeddings included)."""
        grads, _ = self.bwd(params, x, g_out)
        return grads

    def loss_bwd_input(self, params: dict, x: torch.Tensor,
                       targets: torch.Tensor):
        """The last stage's B: (loss / M, input cotangent, stash)."""
        h_out, hs = self._fwd_collect(params, x)
        with torch.enable_grad():
            hr = h_out.detach().requires_grad_()
            lv = self._head_loss(params["post"], hr, targets) / \
                self.microbatches
            (g_top,) = torch.autograd.grad(lv, hr, torch.ones_like(lv))
        gx, gs = self._chain(params, hs, g_top)
        return lv.detach(), gx, (hs, gs, h_out)

    def loss_bwd_weight(self, params: dict, targets: torch.Tensor,
                        stash) -> dict:
        """The last stage's W: its layers' and the head's grads (the head
        loss recomputed from the stashed stage output)."""
        hs, gs, h_out = stash
        tree, leaves, unflatten = self._with_grad(params, parts=("post",))
        with torch.enable_grad():
            lv = self._head_loss(tree["post"], h_out, targets) / \
                self.microbatches
            g_post = unflatten(torch.autograd.grad(lv, leaves))["post"]
        return {"stages": self._weight_grads(params, (hs, gs)),
                "post": g_post}

    # -- placement -----------------------------------------------------------

    def place(self, tree, *, copy: bool = False):
        """A tensor, array, or (nested) dict/tuple/list of them on this
        stage's device; integer token arrays as int64. ``copy`` makes the
        tensors the caller's own even where they already lie there."""
        if isinstance(tree, dict):
            return {k: self.place(v, copy=copy) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(self.place(v, copy=copy) for v in tree)
        if tree is None:
            return None
        t = to_tensor(tree)
        if not (t.is_floating_point() or t.is_complex()):
            t = t.long()
        return t.to(self.device, copy=copy)

    def init_opt_state(self, params: dict):
        """The stage's optimizer, ``tx`` over ``params``' tensors."""
        return self.tx(tree_leaves(params))

    def lower_train_programs(self, params, sample_x, sample_targets=None,
                             *, zb: bool = False):
        """JAX's AOT lowering of the stage's programs has no counterpart
        yet."""
        raise NotImplementedError(_LOWER)
