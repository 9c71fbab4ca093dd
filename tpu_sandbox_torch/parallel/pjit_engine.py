"""The compiler-driven engine, rule-based sharding specs and the step XLA
derives from them, one process a rank. The port of
``tpu_sandbox/parallel/pjit_engine.py`` (``megatron_rules``, the spec
functions :49-165, ``PjitEngine`` :168-437).

The JAX engine annotates the parameters with ``PartitionSpec`` rules
(regexes over the '/'-joined parameter path, first match wins), ``jit``s
the step and lets XLA insert the collectives. Here the same rules give the
same specs (``P``, a tuple of mesh axis names, one per leading dim), the
path being the port's parameter name with '.' read as '/' (the port keeps
Flax's names, so JAX's regexes match unchanged), and the engine writes out
what XLA derives from them:

- data: every rank runs its rows of the batch axis; the gradients and the
  loss are averaged over that axis;
- Megatron (``megatron_rules``): heads-sharded ``qkv`` and row-parallel
  ``out``, d_ff-sharded ``up`` and row-parallel ``down``, each branch's
  input through ``tp_region_input`` and its output summed over the axis
  (``tp_region_output``) before the whole bias is added; the vocab-sharded
  ``tok_emb`` looks up the ids it holds and the lookups are summed (the
  others add exact zeros); the d_model-sharded ``pos_emb`` and the
  vocab-sharded ``lm_head`` gather their outputs over the axis
  (``tp_gather``), so the loss sees the global logits;
- the expert rule (``w_(up|down)`` on dim 0): each rank holds E/n
  experts (``parallel/expert.py``);
- ``zero_axis`` (ZeRO-1): a leaf no rule claims, replicated, has its
  optimizer moments sharded on dim 0 where the axis size divides it: each
  rank updates its own block and the blocks are all-gathered;
- ``fsdp_axis``: those leaves themselves are sharded and gathered at use
  (below); over the batch axis their gradients come back
  reduce-scattered and averaged. FSDP implies ZeRO-1 over the same axis;
- ``grad_compress`` and ``overlap_grad_sync`` (pure data parallelism
  only, as in JAX, :240-262): the batch axis's gradient mean goes through
  ``CompressedAllReduce`` leaf by leaf, or through ``parallel/
  buckets.py``'s buckets issued by gradient hooks during the backward.
  Stateless: no error-feedback residual is carried (JAX's comment at
  :240-249; ``DataParallel`` carries one). The buckets follow JAX's
  flatten order of the parameters (``buckets.flatten_order``).

- any other leaf that a rule (or ``fsdp_axis``) shards is held sharded
  and gathered at use (``gather_param``, a parametrization, so a
  recompute gathers again): JAX's partial Megatron sets, the s2d plans'
  fc, a conv kernel. Its gradient comes back reduced to the shard: the
  mean over the batch axis, the sum over the image bands, this rank's
  block over an axis whose ranks computed the same gradient;
- image models (``task="image"``): the plain ConvNet's fc under
  ``("fc/kernel", P(None, m))`` computes its logit columns and gathers
  them (``tp_gather``) before the whole bias, under ``P(m, None)`` its
  rows' partial product summed over ``m`` before the bias, each behind
  ``tp_region_input``;
- BatchNorm: each BN module gets the engine's ``StatsGroup``, so its
  statistics are those of the global batch (JAX's BN under ``jit``): the
  plain chain sums E[y] and E[y^2] and the element count in a
  differentiable all-reduce, the fused tail kernels take the summed
  per-channel sums before their apply passes (``ops/bn_tail{,_t}.py``,
  ``ops/conv1_tail_t.py``). The running statistics, updated from the
  global ones, stay equal on every rank;
- ``input_spec=P(batch_axis, spatial)``: each rank holds its band of the
  image's rows. The plain ConvNet runs on the band (``parallel/
  spatial.py``: the band's resize, the convs' halo exchange, the pool's
  global windows) and its fc is a row-parallel product over the axis;
  the replicated leaves' gradients (all but the fc's bias, added after
  that sum) are summed over the axis. The space-to-depth plans, which
  JAX's engine runs under such a spec too, gather the band into the
  whole image on every rank of the axis, whose gradients are then equal.

Every rank builds the whole model from the same seed; ``shard_state``
cuts this rank's shards from its state dict (or from a bridged one, BN
statistics included) and wires the layouts into the model's modules.
With ``clip_norm`` the global norm sums the squares of every sharded
leaf over its axes and counts every replicated leaf once, as
``optax.clip_by_global_norm`` does on JAX's global arrays. ``task="lm"``
adds ``aux_weight`` times the mean over layers of the MoE's load-balance
losses to the mean cross-entropy.

Not ported (``NotImplementedError`` naming the ROADMAP item):
``lower_step`` (item 12); the combinations of queue 1 item 8b: an
``input_spec`` other than ``P(batch_axis)`` and ``P(batch_axis,
spatial)`` (a sharded width, a spatial spec on the LM or on a model
without a plan for it), a spatial spec beside a leaf gathered at use
(a rule other than the fc's two, ``fsdp_axis``) or ``zero_axis``, and
bands narrower than a conv's 2-row halo. ``donate`` is accepted: the port updates in place.
"""

from __future__ import annotations

import re
from collections.abc import Mapping, Sequence
from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh
from torch.nn.utils import parametrize

from tpu_sandbox_torch.models.convnet import ConvNet
from tpu_sandbox_torch.ops.losses import cross_entropy_loss
from tpu_sandbox_torch.parallel import spatial
from tpu_sandbox_torch.parallel.buckets import (
    DEFAULT_BUCKET_MB,
    BucketedSync,
    flatten_order,
)
from tpu_sandbox_torch.parallel.collectives import (
    CollectiveGroup,
    CompressedAllReduce,
    StatsGroup,
    as_compress_policy,
    gather_param,
    tp_gather,
    tp_region_input,
    tp_region_output,
)
from tpu_sandbox_torch.train.optim import clip_by_global_norm_
from tpu_sandbox_torch.train.state import TrainState
from tpu_sandbox_torch.train.trainer import prepare_inputs

_ITEM8B = "(ROADMAP.md, queue 1 item 8b)"
_LOWER = ("ahead-of-time lowering has no counterpart yet (ROADMAP.md, "
          "queue 1 item 12)")


class P(tuple):
    """A partition spec: the mesh axis (or None) each leading dim of a
    leaf is sharded over; ``P()`` is replicated. Equal to JAX's
    ``PartitionSpec`` of the same axes as a tuple."""

    def __new__(cls, *axes):
        return super().__new__(cls, axes)

    def __getnewargs__(self):
        return tuple(self)

    def __repr__(self) -> str:
        return f"PartitionSpec({', '.join(map(repr, self))})"


Rule = tuple[str, P]


def megatron_rules(model_axis: str = "model") -> list[Rule]:
    """The complete Megatron ruleset for ``models.transformer``:
    column-parallel qkv (heads) and mlp up (d_ff), row-parallel attention
    out and mlp down, vocab-sharded token embedding and lm_head,
    d_model-sharded position embedding."""
    m = model_axis
    return [
        (r"attn/qkv/kernel", P(None, None, m, None)),
        (r"attn/qkv/bias", P(None, m, None)),
        (r"attn/out/kernel", P(m, None, None)),
        (r"mlp/up/kernel", P(None, m)),
        (r"mlp/up/bias", P(m)),
        (r"mlp/down/kernel", P(m, None)),
        (r"lm_head/kernel", P(None, m)),
        (r"lm_head/bias", P(m)),
        (r"tok_emb/embedding", P(m, None)),
        (r"pos_emb/embedding", P(None, m)),
    ]


def _match_rule(path: str, rules: Sequence[Rule]) -> P | None:
    """First rule whose regex matches the '/'-joined path wins; None when
    no rule claims it."""
    for pattern, spec in rules:
        if re.search(pattern, path):
            return spec
    return None


def spec_for_path(path: str, rules: Sequence[Rule]) -> P:
    """Rule-matched spec for a path, default replicated."""
    s = _match_rule(path, rules)
    return P() if s is None else s


def _path(name: str) -> str:
    return name.replace(".", "/")


def _leaves(params) -> dict:
    return (dict(params.named_parameters()) if isinstance(params, nn.Module)
            else dict(params))


def _dim0_splits(leaf, size: int) -> bool:
    return (leaf.dim() >= 1 and leaf.shape[0] >= size
            and leaf.shape[0] % size == 0)


def param_specs(params, rules: Sequence[Rule], fsdp_axis: str | None = None,
                fsdp_axis_size: int = 1) -> dict[str, P]:
    """{parameter name: spec} for a module or state dict: the first
    matching rule, an explicit ``P()`` included; with ``fsdp_axis`` a leaf
    no rule claims is ``P(fsdp_axis)`` when the axis size divides its dim
    0; else replicated."""
    out = {}
    for name, leaf in _leaves(params).items():
        s = _match_rule(_path(name), rules)
        if s is None:
            s = (P(fsdp_axis) if fsdp_axis is not None
                 and _dim0_splits(leaf, fsdp_axis_size) else P())
        out[name] = s
    return out


class StateSpecs(NamedTuple):
    """The specs of the parameters and of their optimizer moments (both
    moments of Adam and AdamW, the trace of SGD), by parameter name."""
    params: dict
    moments: dict


def state_specs(params, rules: Sequence[Rule], zero_axis: str | None = None,
                zero_axis_size: int = 1, fsdp_axis: str | None = None,
                fsdp_axis_size: int = 1) -> StateSpecs:
    """``param_specs``, and the moments' specs: the parameter's rule, or
    with ``zero_axis`` (ZeRO-1) ``P(zero_axis)`` for an unclaimed leaf
    whose dim 0 the axis size divides, else replicated. ``fsdp_axis``
    implies ``zero_axis`` over the same axis."""
    if fsdp_axis is not None and zero_axis is None:
        zero_axis, zero_axis_size = fsdp_axis, fsdp_axis_size
    leaves = _leaves(params)
    moments = {}
    for name, leaf in leaves.items():
        s = _match_rule(_path(name), rules)
        if s is None:
            s = (P(zero_axis) if zero_axis is not None
                 and _dim0_splits(leaf, zero_axis_size) else P())
        moments[name] = s
    return StateSpecs(param_specs(leaves, rules, fsdp_axis, fsdp_axis_size),
                      moments)


#: the sharded LM leaves whose layout the engine writes out: path suffix ->
#: (the module group it belongs to, the dim its spec shards)
LAYOUTS = {
    "attn/qkv/kernel": ("attn", 2), "attn/qkv/bias": ("attn", 1),
    "attn/out/kernel": ("attn", 0),
    "mlp/up/kernel": ("mlp", 1), "mlp/up/bias": ("mlp", 0),
    "mlp/down/kernel": ("mlp", 0),
    "lm_head/kernel": ("lm_head", 1), "lm_head/bias": ("lm_head", 0),
    "tok_emb/embedding": ("tok_emb", 0), "pos_emb/embedding": ("pos_emb", 1),
    "mlp/w_up": ("experts", 0), "mlp/w_down": ("experts", 0),
}


def _sharded_dims(spec: P) -> list[tuple[int, str]]:
    return [(i, a) for i, a in enumerate(spec) if a is not None]


def _layout_key(name: str, spec: P):
    """(module, group kind, leaf key, axis) of a leaf that ``LAYOUTS``
    writes out under ``spec``, else None."""
    dims = _sharded_dims(spec)
    path = _path(name)
    key = next((k for k in LAYOUTS if path.endswith(k)), None)
    if key is None or len(dims) != 1 or dims[0][0] != LAYOUTS[key][1]:
        return None
    module = (path[:-len(key)] + key.split("/")[0]).replace("/", ".")
    return module, LAYOUTS[key][0], key, dims[0][1]


def layouts(specs: Mapping[str, P]) -> dict[str, tuple[str, str]]:
    """{module name: (group kind, axis)} of the LM's rule-sharded modules
    whose layout the engine writes out (``LAYOUTS``), each group whole:
    an attention's qkv kernel and bias and out kernel, an MLP's up kernel
    and bias and down kernel, the head's kernel and bias, an MoE's w_up
    and w_down, on one axis. Any other sharded leaf (a partial group, as
    ``qkv`` sharded alone) is left to be gathered at use."""
    found: dict[tuple[str, str], dict[str, str]] = {}
    for name, spec in specs.items():
        got = _layout_key(name, spec)
        if got is not None:
            module, kind, key, axis = got
            found.setdefault((module, kind), {})[key] = axis
    out = {}
    for (module, kind), axes in found.items():
        want = {k for k, (g, _) in LAYOUTS.items() if g == kind}
        if set(axes) == want and len(set(axes.values())) == 1:
            out[module] = (kind, next(iter(axes.values())))
    return out


def head_layout(specs: Mapping[str, P]) -> tuple[str, str] | None:
    """The plain ConvNet's written-out fc: ("column", axis) for
    ``P(None, axis)`` on ``fc.kernel``, ("row", axis) for ``P(axis,
    None)``, with the bias replicated; else None."""
    dims = _sharded_dims(specs.get("fc.kernel", P()))
    if len(dims) != 1 or _sharded_dims(specs.get("fc.bias", P())):
        return None
    dim, axis = dims[0]
    return ("column" if dim == 1 else "row"), axis


class _Gathered(nn.Module):
    """The parametrization of a leaf held sharded and gathered whole at
    each use: one ``gather_param`` a sharded dim, each with the reduction
    its axis's gradients take (``PjitEngine._reduction``)."""

    def __init__(self, dims: Sequence[tuple[int, CollectiveGroup, str]]):
        super().__init__()
        self.dims = list(dims)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for dim, group, reduce in self.dims:
            x = gather_param(x, group, dim, reduce)
        return x


class _Head:
    """The plain ConvNet's fc as the engine lays it out: this rank's rows
    [lo, hi) of the fc's input (its image band; all of them without a
    spatial axis) times its block of the kernel, summed over the band
    axis, then summed over the model axis of a row rule or gathered over
    that of a column rule (each behind ``tp_region_input``), then the
    whole bias, in the compute dtype as ``Dense``."""

    def __init__(self, dense: nn.Module, kind: str | None,
                 model: CollectiveGroup | None,
                 band: CollectiveGroup | None):
        self.dense, self.kind, self.model, self.band = dense, kind, model, band

    def __call__(self, x: torch.Tensor, lo: int, hi: int) -> torch.Tensor:
        d = self.dense
        k = d.kernel
        if self.model is not None:
            x = tp_region_input(x, self.model)
        if self.kind == "row":                 # this rank's block of rows
            c = self.model.rank * k.shape[0]
            a = min(max(lo, c), hi)
            b = max(a, min(hi, c + k.shape[0]))
            y = x[:, a - lo:b - lo].to(d.dtype) @ k[a - c:b - c].to(d.dtype)
        else:
            y = x.to(d.dtype) @ k[lo:hi].to(d.dtype)
        if self.band is not None:
            y = tp_region_output(y, self.band)
        if self.kind == "row":
            y = tp_region_output(y, self.model)
        elif self.kind == "column":
            y = tp_gather(y, self.model, -1)
        return y + d.bias.to(d.dtype)


def _input_region(group: CollectiveGroup):
    return lambda module, args: (tp_region_input(args[0], group), *args[1:])


def _gather_output(group: CollectiveGroup):
    return lambda module, args, out: tp_gather(out, group, -1)


def _row_parallel(dense, group: CollectiveGroup) -> None:
    """The partial products summed over the group, then the whole bias."""
    def forward(x):
        return (tp_region_output(dense.product(x), group)
                + dense.bias.to(dense.dtype))
    dense.forward = forward


def _vocab_sharded(embed, group: CollectiveGroup) -> None:
    """The rows this rank holds (its block of the vocabulary) looked up in
    the compute dtype, exact zeros for the other ids, summed over the
    group."""
    def forward(ids):
        v = embed.embedding.shape[0]
        local = ids - group.rank * v
        inside = ((local >= 0) & (local < v)).unsqueeze(-1)
        rows = F.embedding(local.clamp(0, v - 1),
                           embed.embedding.to(embed.dtype))
        return tp_region_output(torch.where(inside, rows, 0), group)
    embed.forward = forward


class Leaf(NamedTuple):
    name: str
    param: nn.Parameter        # this rank's tensor (a sharded leaf's shard)
    spec: P
    gathered: tuple            # the axes it is gathered over at use
    zero_rows: slice | None    # ZeRO-1: the block of dim 0 this rank updates
    update: nn.Parameter       # what the optimizer steps: param or its block


class PjitEngine:
    """The rule-sharded train step over ``mesh``. ``model`` is the whole
    model, built alike on every rank (``TransformerLM`` with
    ``task="lm"``, one of the three ConvNet plans, with or without BN,
    with ``task="image"``); ``tx`` builds the optimizer
    (``train/optim.py``: ``Adam``, ``AdamW``, ``SGD``) over the parameters
    it updates, or returns None for ``TrainState``'s plain SGD at its
    ``lr`` (optax.sgd, no state).

    Usage, in every rank's process::

        eng = PjitEngine(model, tx, make_mesh({"data": 2, "model": 2}),
                         task="lm", rules=megatron_rules())
        state = eng.shard_state()
        loss = eng.train_step(state, *eng.shard_batch(tokens, targets))
    """

    def __init__(self, model: nn.Module, tx: Callable, mesh: DeviceMesh, *,
                 rules: Sequence[Rule] = (), batch_axis: str = "data",
                 input_spec: P | None = None,
                 image_size: tuple[int, int] | None = None,
                 task: str = "image", aux_weight: float = 0.01,
                 zero_axis: str | None = None, fsdp_axis: str | None = None,
                 donate: bool = True,
                 grad_compress: str | CompressedAllReduce | None = "none",
                 overlap_grad_sync: bool = False,
                 bucket_mb: float = DEFAULT_BUCKET_MB,
                 clip_norm: float = 0.0):
        names = tuple(mesh.mesh_dim_names or ())
        if task not in ("image", "lm"):
            raise ValueError(f"task must be 'image' or 'lm', got {task!r}")
        if batch_axis not in names:
            raise ValueError(
                f"batch axis {batch_axis!r} not in mesh axes {names}")
        self.model, self.tx, self.mesh = model, tx, mesh
        self.rules = list(rules)
        self.batch_axis = batch_axis
        self.input_spec = input_spec if input_spec is not None else P(
            batch_axis)
        self.image_size = image_size
        self.task = task
        self.aux_weight = aux_weight
        if fsdp_axis is not None:
            if fsdp_axis not in names:
                raise ValueError(
                    f"fsdp axis {fsdp_axis!r} not in mesh axes {names}")
            if zero_axis is not None and zero_axis != fsdp_axis:
                raise ValueError(
                    f"zero_axis {zero_axis!r} conflicts with fsdp_axis "
                    f"{fsdp_axis!r}: moments must shard with their params "
                    "(omit zero_axis — FSDP subsumes ZeRO-1)")
            zero_axis = fsdp_axis
        if zero_axis is not None and zero_axis not in names:
            raise ValueError(
                f"zero axis {zero_axis!r} not in mesh axes {names}")
        self.zero_axis, self.fsdp_axis = zero_axis, fsdp_axis
        self.donate = donate
        self.grad_compress = as_compress_policy(grad_compress)
        if bucket_mb <= 0:
            raise ValueError(f"bucket_mb must be positive, got {bucket_mb}")
        self.overlap = bool(overlap_grad_sync)
        self.bucket_bytes = int(bucket_mb * 2 ** 20)
        if self.grad_compress.mode != "none" or self.overlap:
            what = ("grad_compress" if self.grad_compress.mode != "none"
                    else "overlap_grad_sync")
            if self.rules:
                raise ValueError(
                    f"{what} composes only with pure data parallelism; "
                    f"drop the TP rules or disable {what}")
            if fsdp_axis is not None:
                raise ValueError(
                    f"{what} does not compose with fsdp_axis (FSDP's "
                    "reduce-scatter is compiler-inserted)")
            if self.input_spec != P(batch_axis):
                raise ValueError(
                    f"{what} needs input_spec == P({batch_axis!r}) "
                    f"(batch-only sharding), got {self.input_spec}")
            if any(True for _ in model.buffers()):
                raise ValueError(
                    "grad_compress/overlap_grad_sync under PjitEngine "
                    "requires a BN-free model: batch stats mutate per data "
                    "shard inside the grad shard_map and cannot be returned "
                    "replicated. Use DataParallel (per-replica BN) instead."
                )
        spec = tuple(self.input_spec)
        while spec and spec[-1] is None:
            spec = spec[:-1]
        if (spec[:1] != (batch_axis,) or len(spec) > 2
                or (len(spec) == 2 and (spec[1] not in names
                                        or spec[1] == batch_axis))):
            raise NotImplementedError(
                f"input_spec {self.input_spec}: the engine shards the batch "
                f"rows and, over a spatial axis, the image rows only "
                f"{_ITEM8B}")
        self.spatial_axis = spec[1] if len(spec) == 2 else None
        #: the plain ConvNet runs on its band of rows; the s2d plans gather
        #: the band into the whole image
        self.bands = self.spatial_axis is not None and isinstance(
            model, ConvNet)
        if self.spatial_axis is not None and (
                task != "image" or zero_axis is not None):
            raise NotImplementedError(
                f"input_spec {self.input_spec} with task={task!r}, "
                f"zero_axis={zero_axis!r}, fsdp_axis={fsdp_axis!r} "
                f"{_ITEM8B}")
        self.clip_norm = clip_norm
        self.groups = {a: CollectiveGroup(mesh, a) for a in names}
        self.batch = self.groups[batch_axis]
        self.device = self.batch.device
        self.leaves: list[Leaf] = []
        self._moe: list[nn.Module] = []
        self.sync: BucketedSync | None = None
        self.head: _Head | None = None

    def _reduction(self, axis: str) -> str:
        """How a gradient crosses ``axis``: the mean over the batch rows,
        the sum over the image's bands, nothing over an axis whose ranks
        computed the same gradient (the model's, the s2d plans' spatial
        axis)."""
        if axis == self.batch_axis:
            return "mean"
        return "sum" if self.bands and axis == self.spatial_axis else "slice"

    # -- state --------------------------------------------------------------

    def state_specs(self, params=None) -> StateSpecs:
        """The specs of the model's parameters and moments on this mesh."""
        size = lambda a: self.groups[a].size if a else 1  # noqa: E731
        return state_specs(self.model if params is None else params,
                           self.rules, zero_axis=self.zero_axis,
                           zero_axis_size=size(self.zero_axis),
                           fsdp_axis=self.fsdp_axis,
                           fsdp_axis_size=size(self.fsdp_axis))

    def _cut(self, name: str, t: torch.Tensor, spec: P) -> torch.Tensor:
        """This rank's block of ``t`` under ``spec``."""
        for dim, axis in _sharded_dims(spec):
            if axis not in self.groups:
                raise ValueError(f"spec {spec} of {name}: axis {axis!r} not "
                                 f"in mesh axes {tuple(self.groups)}")
            g = self.groups[axis]
            if t.shape[dim] % g.size:
                raise ValueError(
                    f"{name} {tuple(t.shape)}: dim {dim} not divisible by "
                    f"{axis}={g.size}")
            t = t.chunk(g.size, dim)[g.rank]
        return t

    def _written(self, specs: Mapping[str, P]) -> set[str]:
        """Wire the layouts the engine writes out (the LM's ``LAYOUTS``
        groups, the plain ConvNet's fc) into the model; returns the names
        of the sharded leaves they take."""
        model, written = self.model, set()
        if self.task == "lm":
            lays = layouts(specs)
            for module, (kind, axis) in lays.items():
                self._wire(model.get_submodule(module), kind,
                           self.groups[axis])
            for name, spec in specs.items():
                got = _layout_key(name, spec)
                if got is not None and got[0] in lays:
                    written.add(name)
            return written
        if not isinstance(model, ConvNet):
            return written
        head = head_layout(specs)
        if head is not None and head[1] in (self.batch_axis,
                                            self.spatial_axis):
            head = None                     # gathered at use instead
        if head is None and not self.bands:
            return written
        kind, axis = head if head is not None else (None, None)
        self.head = _Head(model.fc, kind, self.groups.get(axis),
                          self.groups[self.spatial_axis] if self.bands
                          else None)
        if head is not None:
            written.add("fc.kernel")
            if not self.bands:
                model.fc.forward = lambda x: self.head(x, 0, x.shape[1])
        return written

    @torch.no_grad()
    def shard_state(self, params: Mapping[str, torch.Tensor] | None = None
                    ) -> TrainState:
        """This rank's share of the model, on its device, in the engine's
        model: each leaf cut to its spec from ``params`` (a whole state
        dict, e.g. bridged from JAX, BN statistics included) or from the
        model's own, the layouts wired in; and the optimizer over what
        this rank updates (a ZeRO-1 leaf's block)."""
        model = self.model
        full = model.state_dict() if params is None else params
        specs = self.state_specs(full)
        written = self._written(specs.params)
        # the bands of an odd-sized map differ in rows: their counts are
        # summed; the batch axis's ranks hold equal rows
        stats = StatsGroup([self.groups[a] for a in (
            [self.batch_axis] + ([self.spatial_axis] if self.bands else []))],
            equal_rows=not self.bands)
        for m in model.modules():
            if hasattr(m, "stats_group"):
                m.stats_group = stats
            if self.batch.size > 1 and hasattr(m, "batch_group"):
                m.batch_group = self.batch
        self._moe = [m for m in model.modules() if hasattr(m, "aux_loss")]
        for name, b in model.named_buffers():
            if name in full:
                b.data = full[name].to(self.device, copy=params is not None)
        self.leaves = []
        for name, p in list(model.named_parameters()):
            spec = specs.params[name]
            local = self._cut(name, full[name], spec)
            # the model's own whole tensor stays where it is; a shard or a
            # given tensor is copied
            p.data = local.to(
                self.device, memory_format=torch.contiguous_format,
                copy=params is not None or local.shape != full[name].shape)
            dims = _sharded_dims(spec) if name not in written else []
            if dims and self.bands:
                raise NotImplementedError(
                    f"spec {spec} on {_path(name)} gathered at use beside "
                    f"input_spec {self.input_spec} {_ITEM8B}")
            zero_rows = None
            if dims:
                owner, _, leaf = name.rpartition(".")
                module = model.get_submodule(owner)
                parametrize.register_parametrization(
                    module, leaf, _Gathered(
                        [(d, self.groups[a], self._reduction(a))
                         for d, a in dims]), unsafe=True)
                p = module.parametrizations[leaf].original
            elif specs.moments[name] != spec:            # ZeRO-1 block
                g = self.groups[self.zero_axis]
                k = p.shape[0] // g.size
                zero_rows = slice(g.rank * k, (g.rank + 1) * k)
            self.leaves.append(Leaf(
                name, p, spec, tuple(a for _, a in dims), zero_rows,
                p if zero_rows is None else nn.Parameter(
                    p[zero_rows].clone())))
        if self.overlap:       # the buckets hold JAX's flatten order
            flat = [leaf.param for _, leaf in flatten_order(
                (leaf.name, leaf) for leaf in self.leaves)]
            self.sync = BucketedSync(flat, self.batch, self.grad_compress,
                                     self.bucket_bytes)
        return TrainState(model, optimizer=self.tx(
            [leaf.update for leaf in self.leaves]))

    @staticmethod
    def _wire(module: nn.Module, kind: str, group: CollectiveGroup) -> None:
        """What XLA derives for one sharded group of the LM."""
        if kind in ("attn", "mlp"):
            module.register_forward_pre_hook(_input_region(group))
            _row_parallel(module.out if kind == "attn" else module.down,
                          group)
        elif kind == "lm_head":
            module.register_forward_pre_hook(_input_region(group))
            module.register_forward_hook(_gather_output(group))
        elif kind == "pos_emb":
            module.register_forward_hook(_gather_output(group))
        elif kind == "tok_emb":
            _vocab_sharded(module, group)
        else:                                            # experts
            module.expert_group = group

    def shard_batch(self, inputs, labels):
        """This rank's rows of the batch axis of a global batch (numpy or
        tensors), on its device, and under a spatial ``input_spec`` its
        band of the images' rows; token ids and labels as int64."""
        n = inputs.shape[0]
        size, rank = self.batch.size, self.batch.rank
        if n % size:
            raise ValueError(f"global batch {n} not divisible by the "
                             f"{self.batch_axis}={size} shards")
        rows = slice(rank * (n // size), (rank + 1) * (n // size))
        band = slice(None)
        if self.spatial_axis is not None:
            band = slice(*spatial.even_band(inputs.shape[1],
                                            self.groups[self.spatial_axis]))

        def local(x, long):
            t = (x.contiguous() if isinstance(x, torch.Tensor)
                 else torch.as_tensor(np.ascontiguousarray(x)))
            return t.to(self.device, torch.int64 if long else None)

        return (local(inputs[rows][:, band], self.task == "lm"),
                local(labels[rows], True))

    @torch.no_grad()
    def full_params(self, state: TrainState) -> dict[str, torch.Tensor]:
        """The whole model's state dict (CPU tensors): every shard gathered
        over its axes, and the BN statistics (equal on every rank). Every
        rank must call it."""
        out = {}
        for leaf in self.leaves:
            t = leaf.param.detach()
            for dim, axis in reversed(_sharded_dims(leaf.spec)):
                parts = self.groups[axis].all_gather(
                    t.movedim(dim, 0).contiguous()[None])
                t = torch.cat(parts.unbind(0), 0).movedim(0, dim)
            out[leaf.name] = t.cpu()
        for name, b in state.model.named_buffers():
            out[name] = b.detach().cpu()
        return out

    # -- the step -----------------------------------------------------------

    def _logits(self, model: nn.Module, inputs: torch.Tensor
                ) -> torch.Tensor:
        """The image model's logits on this rank's rows (its band of each
        under a spatial spec), resized to ``image_size`` first."""
        size = self.image_size
        if self.spatial_axis is None:
            return model(inputs if size is None else prepare_inputs(
                model, inputs, size))
        group = self.groups[self.spatial_axis]
        if not self.bands:                   # the s2d plans: whole images
            x = spatial.gather_rows(inputs, group)
            return model(x if size is None else prepare_inputs(model, x,
                                                               size))
        rows = inputs.shape[1] * group.size if size is None else size[0]
        x = inputs if size is None else spatial.resize_band(
            inputs, size, *spatial.even_band(size[0], group), group)
        feats, lo, hi = spatial.spatial_features(model, x, rows, group)
        return self.head(feats, lo, hi).float()

    def loss(self, model: nn.Module, inputs: torch.Tensor,
             labels: torch.Tensor) -> torch.Tensor:
        """This rank's objective: the mean cross-entropy of its rows, with
        ``task="lm"`` plus ``aux_weight`` times the mean over layers of the
        auxiliary losses (:307-320)."""
        if self.task == "image":
            return cross_entropy_loss(self._logits(model, inputs), labels)
        logits = model(inputs)
        loss = cross_entropy_loss(logits.reshape(-1, logits.shape[-1]),
                                  labels.reshape(-1))
        aux = model.aux_losses()
        if aux:                  # mean over layers: alpha independent of depth
            loss = loss + self.aux_weight * sum(aux) / len(aux)
        return loss

    @torch.no_grad()
    def _global_norm(self) -> torch.Tensor:
        """sqrt of the sum of every gradient's squares: a sharded leaf's
        summed over its axes, a replicated leaf's counted once."""
        by_axes: dict[tuple, torch.Tensor] = {}
        for leaf in self.leaves:
            axes = tuple(a for _, a in _sharded_dims(leaf.spec))
            sq = leaf.param.grad.float().square().sum()
            by_axes[axes] = by_axes.get(axes, 0) + sq
        total = 0
        for axes, sq in sorted(by_axes.items()):
            for a in axes:
                sq = self.groups[a].all_reduce(sq, "sum")
            total = total + sq
        return torch.sqrt(total)

    def train_step(self, state: TrainState, inputs: torch.Tensor,
                   labels: torch.Tensor) -> torch.Tensor:
        """One step on this rank's rows; returns the loss averaged over the
        batch axis (the mean over the global batch) on every rank."""
        model = state.model
        model.train()
        if self.sync is not None:
            self.sync.begin()
        loss = self.loss(model, inputs, labels)
        loss.backward()
        for m in self._moe:
            m.aux_loss = None
        if self.sync is not None:
            self.sync.finish()
        else:
            # a leaf gathered over the batch axis has its mean already
            self.grad_compress.mean_grads_(
                [leaf.param for leaf in self.leaves
                 if self.batch_axis not in leaf.gathered], self.batch)
        if self.bands:
            # the bands' shares of every leaf but the fc's bias, which is
            # added after the head's sum over the bands
            self.groups[self.spatial_axis].sum_grads_(
                [leaf.param for leaf in self.leaves
                 if leaf.name != "fc.bias"])
        if self.clip_norm:
            clip_by_global_norm_([leaf.param.grad for leaf in self.leaves],
                                 self.clip_norm, norm=self._global_norm())
        zero = [leaf for leaf in self.leaves if leaf.zero_rows is not None]
        for leaf in zero:
            leaf.update.grad = leaf.param.grad[leaf.zero_rows].clone()
            leaf.param.grad = None
        state.apply_update([leaf.update for leaf in self.leaves])
        with torch.no_grad():
            for leaf in zero:
                leaf.param.copy_(
                    self.groups[self.zero_axis].all_gather(leaf.update))
        return self.batch.all_reduce(loss.detach(), "mean")

    def lower_step(self, *args, **kwargs):
        raise NotImplementedError(_LOWER)
