"""Data parallelism, one process a rank: the port of
``tpu_sandbox/parallel/data_parallel.py`` (:43-230, 319-330, 359-488),
the counterpart of the reference's ``DistributedDataParallel(model)``
(mnist_distributed.py:67).

- ``shard_state`` broadcasts rank 0's parameters to every rank (DDP's
  first sync; every rank builds the model from the same seed anyway) and
  leaves the BN statistics alone: they stay per rank, as DDP's and JAX's
  do (``data_parallel.py:391``, ``:478``). The model is not wrapped in
  ``DistributedDataParallel``, whose default ``broadcast_buffers=True``
  would copy rank 0's BN statistics over every rank at each forward.
- ``train_step`` runs forward and backward on this rank's rows, then the
  gradient mean written out as JAX's ``lax.pmean`` (:466-468): one sum
  all-reduce a parameter, in place, in the module's parameter order, then
  a division by the world size (gloo has no ``ReduceOp.AVG``; the 720 MB
  fc gradient is reduced where it lies, never copied into a flat buffer).
  At one rank this is the single-device step bit for bit (x / 1.0 is x).
  Then the state's optimizer update. The loss returned is this rank's
  own (the reference prints rank 0's; ``average_loss=True`` is its dead
  AVG reduce, mnist_distributed.py:102).
- ``zero=True`` is ZeRO-1 (:422-465): a parameter whose dim 0 the world
  size divides (``_dim0_sharded``) is updated in this rank's dim-0 block
  only, by the optimizer over a block parameter that ``shard_state`` cuts
  (with its optimizer state: Adam's moments, SGD's trace); its gradient is
  reduce-scattered and divided by the size, the other gradients take the
  mean, and the updated blocks are all-gathered into the parameters.
- ``grad_compress`` (``none``, ``bf16``, ``int8``; ``parallel/
  collectives.py``'s ``CompressedAllReduce``) and ``overlap_grad_sync``
  (``parallel/buckets.py``: the buckets' exchanges issued by gradient
  hooks during the backward) replace that mean; under ZeRO-1 each rank
  then slices its block from the whole mean (:440-446). int8 with
  ``error_feedback`` carries the residual in ``TrainState.grad_residual``,
  one fp32 tensor a parameter in ``names`` order, zeros at
  ``shard_state``. ``none`` is the plain mean above.

The buckets follow JAX's flatten order of the parameters (``names``: the
dotted names sorted part by part, as ``jax.tree.flatten`` orders Flax's
nested dicts), so that a bucket holds the leaves it holds in JAX.

Checkpoints (JAX :184-358) speak JAX's leaf paths (``utils/bridge.py``):
``host_view`` is this rank's part of a sharded checkpoint (its BN
statistics and residual behind a leading axis of 1, its ZeRO-1 blocks),
``checkpoint_spec`` the kind of each leaf ("shard0" for those, "rep" for
the rest), ``checkpoint_template`` the restore template with the
residual's slot; ``shard_state(state, host)`` places a restored host
tree (every rank's own replica with ``stats_expanded``),
``shard_state_local`` a partial restore; ``unshard_state`` is the
single-device view that ``train/checkpoint.py::save`` takes.

``train_step(..., guard=True)`` is the step of the resumable loop: it
decides after the forward, before the backward, whether every rank's
loss is finite (one all-reduce of a flag); when one is not, it puts back
the BN statistics the forward moved and skips the backward and the
update on every rank, so the whole state stays bitwise what it was.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn as nn
from torch.distributed.device_mesh import DeviceMesh

from tpu_sandbox_torch.ops.losses import cross_entropy_loss
from tpu_sandbox_torch.parallel.buckets import (
    DEFAULT_BUCKET_MB,
    BucketedSync,
    flatten_order,
)
from tpu_sandbox_torch.parallel.collectives import (
    CollectiveGroup,
    CompressedAllReduce,
)
from tpu_sandbox_torch.train.checkpoint import ShapeDtype
from tpu_sandbox_torch.train.state import TrainState
from tpu_sandbox_torch.train.trainer import prepare_inputs
from tpu_sandbox_torch.utils.bridge import state_from_leaves, state_refs

#: leaves that hold one value a rank (BN statistics, the int8 residual)
PER_REPLICA = ("batch_stats/", "grad_residual/")
_LOWER = ("ahead-of-time lowering has no counterpart yet (ROADMAP queue 1 "
          "item 12)")


class DataParallel:
    """The data-parallel step over the ranks of a mesh axis (or the whole
    world with ``mesh=None``). The optimizer rides in the ``TrainState``.

    Usage, in every rank's process::

        dp = DataParallel(model, mesh, image_size=(3000, 3000))
        state = dp.shard_state(TrainState(model, lr=1e-4))
        loss = dp.train_step(state, images, labels)   # this rank's rows
    """

    def __init__(self, model: torch.nn.Module,
                 mesh: DeviceMesh | None = None, axis: str = "data", *,
                 image_size: tuple[int, int] | None = None,
                 average_loss: bool = False, zero: bool = False,
                 grad_compress: str | CompressedAllReduce | None = "none",
                 error_feedback: bool = True,
                 overlap_grad_sync: bool = False,
                 bucket_mb: float = DEFAULT_BUCKET_MB):
        if mesh is not None:
            names = tuple(mesh.mesh_dim_names or ())
            if axis not in names:
                raise ValueError(f"axis {axis!r} not in mesh axes {names}")
        self.model = model
        self.group = CollectiveGroup(mesh, axis if mesh is not None else None)
        self.size = self.group.size
        self.rank = self.group.rank
        self.image_size = image_size
        self.average_loss = average_loss
        self.zero = zero
        if isinstance(grad_compress, CompressedAllReduce):
            self.compress = grad_compress
        else:
            self.compress = CompressedAllReduce(
                mode=str(grad_compress) if grad_compress else "none",
                error_feedback=error_feedback,
            )
        if bucket_mb <= 0:
            raise ValueError(f"bucket_mb must be positive, got {bucket_mb}")
        self.overlap = bool(overlap_grad_sync)
        self.bucket_bytes = int(bucket_mb * 2 ** 20)
        named = flatten_order(model.named_parameters())
        self.names = [n for n, _ in named]
        self.params = [p for _, p in named]
        #: ZeRO-1: the rows of dim 0 this rank updates, a parameter (None:
        #: the whole parameter), and what the optimizer steps
        self.rows: list[slice | None] = [None] * len(self.params)
        self.updates = list(self.params)
        self.sync = (BucketedSync(self.params, self.group, self.compress,
                                  self.bucket_bytes)
                     if self.overlap else None)

    def _dim0_sharded(self, leaf) -> bool:
        """ZeRO placement rule for one tensor: shard dim 0 iff the world
        size divides it (the conv kernels' dim 0 of 5 stays whole; the fc
        kernel and the 1-D scales shard)."""
        return (leaf.dim() >= 1 and leaf.shape[0] >= self.size
                and leaf.shape[0] % self.size == 0)

    # -- state --------------------------------------------------------------

    @torch.no_grad()
    def shard_state(self, state: TrainState, host: dict | None = None, *,
                    stats_expanded: bool = False) -> TrainState:
        """Every rank takes group rank 0's parameters; BN statistics stay
        this rank's own. Under ``zero`` the optimizer steps this rank's
        dim-0 block of each eligible parameter, its state cut alike; with
        error feedback the residual starts at zeros.

        ``host`` is a restored host tree in JAX's leaf paths (global
        values: whole optimizer leaves, whatever world size wrote them, so
        this is also the reshard), loaded into the state first. With
        ``stats_expanded`` its BN statistics and residual carry a leading
        axis of one replica a rank, and each rank takes its own: the
        exact per-replica resume at an unchanged world size."""
        if host is not None:
            self._load(state, host, stats_expanded)
        self.group.broadcast_params_(self.model.parameters())
        if self.zero and all(r is None for r in self.rows):
            self._shard_optimizer(state.optimizer)
        if self.compress.needs_residual and state.grad_residual is None:
            state.grad_residual = [torch.zeros_like(p, dtype=torch.float32)
                                   for p in self.params]
        return state

    def _rows_of(self, path: str):
        """ZeRO-1 rows of the parameter an optimizer leaf belongs to (None:
        not sharded, or not an optimizer leaf of a parameter)."""
        parts = path.split("/")
        if parts[0] != "opt_state" or len(parts) < 4:
            return None
        name = ".".join(parts[3:])
        return self.rows[self.names.index(name)] if name in self.names \
            else None

    def _load(self, state: TrainState, host: dict,
              stats_expanded: bool) -> None:
        """Write a global host tree into this rank's state: its replica of
        the per-replica leaves, its rows of each sharded optimizer leaf."""
        local = {}
        for path, value in host.items():
            if stats_expanded and path.startswith(PER_REPLICA):
                value = value[self.rank]
            rows = self._rows_of(path)
            local[path] = value if rows is None else value[rows]
        state_from_leaves(state, local)
        self._refresh_blocks()

    @torch.no_grad()
    def _refresh_blocks(self) -> None:
        """ZeRO-1's block parameters take their rows of the (restored)
        parameters: the optimizer steps the blocks, not the parameters."""
        for p, rows, u in zip(self.params, self.rows, self.updates):
            if rows is not None:
                u.copy_(p[rows])

    @torch.no_grad()
    def shard_state_local(self, state: TrainState, local: dict,
                          template: dict) -> TrainState:
        """Place a partial restore (``ShardedCheckpoint.restore_partial``):
        replicated leaves arrive whole, this rank's BN statistics and
        residual as ``[1, ...]`` blocks and its ZeRO-1 optimizer rows as
        its block — written as they are, with no cross-rank read.
        ``template`` is the global template the restore used; a block
        that does not fit it raises."""
        self.shard_state(state)
        out = {}
        for path, value in local.items():
            want = tuple(template[path].shape)
            got = tuple(np.shape(value))
            if path.startswith(PER_REPLICA):
                if got != (1, *want):
                    raise ValueError(f"leaf {path!r}: local block {got} != "
                                     f"(1, *{want})")
                value = value[0]
            elif self._rows_of(path) is not None:
                block = (want[0] // self.size, *want[1:])
                if got != block:
                    raise ValueError(
                        f"local block shape {got} != expected {block} for "
                        f"global {want} over world {self.size}")
            elif got != want:
                raise ValueError(f"replicated leaf shape {got} != template "
                                 f"{want}")
            out[path] = value
        state_from_leaves(state, out)
        self._refresh_blocks()
        return state

    def _shard_optimizer(self, opt) -> None:
        """ZeRO-1's placement: a block parameter for each eligible
        parameter, put in the optimizer's place with its rows of every
        per-parameter state tensor (``opt.STATE``). A state tensor that
        would shard but matches no parameter's shape (factored moments)
        is refused, as JAX's structural guard (:148-166)."""
        names = getattr(opt, "STATE", ())
        shapes = {tuple(p.shape) for p in self.params}
        bad = [tuple(x.shape) for n in names for x in getattr(opt, n)
               if self._dim0_sharded(x) and tuple(x.shape) not in shapes]
        if bad:
            raise ValueError(
                "zero=True needs an elementwise optimizer whose state "
                f"mirrors param shapes; found opt-state leaves {bad} "
                "matching no parameter (e.g. factored moments)"
            )
        slot = {id(p): i for i, p in enumerate(getattr(opt, "params", []))}
        for i, p in enumerate(self.params):
            if not self._dim0_sharded(p):
                continue
            k = p.shape[0] // self.size
            rows = slice(self.rank * k, (self.rank + 1) * k)
            self.rows[i] = rows
            self.updates[i] = nn.Parameter(p.detach()[rows].clone())
            j = slot.get(id(p))
            if j is not None:
                opt.params[j] = self.updates[i]
                for n in names:
                    getattr(opt, n)[j] = getattr(opt, n)[j][rows].clone()

    @torch.no_grad()
    def unshard_state(self, state: TrainState, rank: int = 0) -> dict:
        """The single-device view, as the host leaves that
        ``train/checkpoint.py::save`` takes: the (replicated) parameters,
        group rank ``rank``'s BN statistics, the whole optimizer state
        (ZeRO-1 blocks gathered) and the step. The error-feedback residual
        is dropped: a single rank's slice of it means nothing to a resumed
        run. Every rank must call it (it broadcasts and gathers)."""
        src = self.group._global_rank(rank)
        out = {}
        for path, leaf in state_refs(state):
            if path.startswith("grad_residual/"):
                continue
            if isinstance(leaf, tuple):
                out[path] = np.asarray(leaf[1], np.int32)
                continue
            t = leaf.detach()
            if path.startswith("batch_stats/"):
                t = t.clone()
                dist.broadcast(t, src, group=self.group.group)
            elif self._rows_of(path) is not None:
                t = self.group.all_gather(t)
            out[path] = t.to("cpu", copy=True).numpy()
        return out

    def host_view(self, state: TrainState) -> dict:
        """This rank's part of a sharded checkpoint, in JAX's leaf paths:
        ``state.host_view()`` with the per-replica leaves behind a leading
        axis of 1 (JAX's first addressable shard of a ``P('data')``
        leaf)."""
        return {p: v[None] if p.startswith(PER_REPLICA) else v
                for p, v in state.host_view().items()}

    def checkpoint_spec(self, state: TrainState) -> dict:
        """The kind of each leaf for ``ShardedCheckpoint``: "shard0" for the
        per-replica leaves and, under ZeRO-1, the sharded optimizer
        blocks; "rep" for everything else."""
        return {path: "shard0" if (path.startswith(PER_REPLICA)
                                   or self._rows_of(path) is not None)
                else "rep"
                for path, _ in state_refs(state)}

    def checkpoint_template(self, template: dict) -> dict:
        """The global restore template with the error-feedback residual's
        slot (one fp32 leaf a parameter): a template built before the
        first step has none, and leaves a template does not name are never
        restored."""
        if not self.compress.needs_residual or any(
                p.startswith("grad_residual/") for p in template):
            return template
        out = dict(template)
        for name, p in zip(self.names, self.params):
            out["grad_residual/" + name.replace(".", "/")] = ShapeDtype(
                tuple(p.shape), torch.float32)
        return out

    def shard_batch(self, images, labels):
        """This rank's rows of a global batch whose rows ``[r*bs,
        (r+1)*bs)`` belong to rank r (``ShardedBatchLoader``'s layout)."""
        n = images.shape[0]
        if n % self.size:
            raise ValueError(
                f"global batch {n} not divisible by {self.size} ranks")
        bs = n // self.size
        rows = slice(self.rank * bs, (self.rank + 1) * bs)
        return images[rows], labels[rows]

    # -- the step -----------------------------------------------------------

    def train_step(self, state: TrainState, images: torch.Tensor,
                   labels: torch.Tensor, *, guard: bool = False):
        """One data-parallel step on this rank's rows (on the model's
        device); returns this rank's loss (or the mean over ranks with
        ``average_loss``). With ``guard`` it returns ``(loss, applied)``:
        ``applied`` is False on every rank when any rank's loss was not
        finite, and then nothing of the state changed."""
        model = state.model
        model.train()
        x = images
        if self.image_size is not None:
            x = prepare_inputs(model, x, self.image_size)
        residual = (state.grad_residual if self.compress.needs_residual
                    else None)
        saved = ([b.detach().clone() for b in model.buffers()]
                 if guard else None)
        loss = cross_entropy_loss(model(x), labels)
        if guard and not self._all_finite(loss):
            with torch.no_grad():
                for b, s in zip(model.buffers(), saved):
                    b.copy_(s)
            return self._loss_out(loss.detach()), False
        if self.sync is not None:
            self.sync.begin(residual)
        loss.backward()
        # ZeRO-1 with the plain mean reduce-scatters its blocks itself
        scatter = (self.zero and self.sync is None
                   and self.compress.mode == "none")
        if self.sync is not None:
            new_res = self.sync.finish()
        elif not scatter:
            new_res = self.compress.mean_grads_(self.params, self.group,
                                                residual)
        if residual is not None:
            state.grad_residual = new_res
        if self.zero:
            self._zero_step(state, scatter)
        else:
            state.apply_update()
        loss = self._loss_out(loss.detach())
        return (loss, True) if guard else loss

    def _loss_out(self, loss: torch.Tensor) -> torch.Tensor:
        if self.average_loss:
            loss = self.group.all_reduce(loss, "mean")
        return loss

    def _all_finite(self, loss: torch.Tensor) -> bool:
        """Every rank's verdict on its loss, reduced over the group: one
        all-reduce of a flag and one host sync."""
        bad = (~torch.isfinite(loss.detach())).float().reshape(1)
        return float(self.group.all_reduce(bad, "sum")) == 0.0

    @torch.no_grad()
    def _zero_step(self, state: TrainState, scatter: bool) -> None:
        """ZeRO-1's update: each block parameter takes its rows of the
        gradient (with ``scatter`` reduce-scattered and divided by the
        size, the other gradients meaned; else sliced from the mean already
        synced), the optimizer steps the blocks, and the blocks are
        all-gathered into the parameters."""
        for p, rows, u in zip(self.params, self.rows, self.updates):
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            if rows is None:
                if scatter:
                    self.group.mean_grads_([p])
                continue
            if scatter:
                u.grad = self.group.reduce_scatter(
                    p.grad.reshape(1, -1)).reshape(u.shape) / self.size
            else:
                u.grad = p.grad[rows].clone()
            p.grad = None
        state.apply_update(self.updates)
        for p, rows, u in zip(self.params, self.rows, self.updates):
            if rows is not None:
                p.copy_(self.group.all_gather(u))

    # -- not ported yet -----------------------------------------------------

    def lower_step(self, *args, **kwargs):
        raise NotImplementedError(_LOWER)
