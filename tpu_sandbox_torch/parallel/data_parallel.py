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
The sharded checkpoint hooks are not ported yet: they raise
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

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
from tpu_sandbox_torch.train.state import TrainState
from tpu_sandbox_torch.train.trainer import prepare_inputs

_CKPT = "sharded checkpoints are not ported yet (ROADMAP queue 1 item 6)"
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
    def shard_state(self, state: TrainState) -> TrainState:
        """Every rank takes group rank 0's parameters; BN statistics stay
        this rank's own. Under ``zero`` the optimizer steps this rank's
        dim-0 block of each eligible parameter, its state cut alike; with
        error feedback the residual starts at zeros."""
        self.group.broadcast_params_(self.model.parameters())
        if self.zero:
            self._shard_optimizer(state.optimizer)
        if self.compress.needs_residual and state.grad_residual is None:
            state.grad_residual = [torch.zeros_like(p, dtype=torch.float32)
                                   for p in self.params]
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
    def unshard_state(self, state: TrainState,
                      rank: int = 0) -> dict[str, torch.Tensor]:
        """The single-device view as a state dict: the (replicated)
        parameters and group rank ``rank``'s BN statistics. Every rank must
        call it (the statistics are broadcast from ``rank``)."""
        out = {k: v.detach().clone()
               for k, v in state.model.state_dict().items()}
        src = self.group._global_rank(rank)
        for name, _ in state.model.named_buffers():
            dist.broadcast(out[name], src, group=self.group.group)
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
                   labels: torch.Tensor) -> torch.Tensor:
        """One data-parallel step on this rank's rows (on the model's
        device); returns this rank's loss (or the mean over ranks with
        ``average_loss``)."""
        model = state.model
        model.train()
        x = images
        if self.image_size is not None:
            x = prepare_inputs(model, x, self.image_size)
        residual = (state.grad_residual if self.compress.needs_residual
                    else None)
        if self.sync is not None:
            self.sync.begin(residual)
        loss = cross_entropy_loss(model(x), labels)
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
        loss = loss.detach()
        if self.average_loss:
            loss = self.group.all_reduce(loss, "mean")
        return loss

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

    def shard_state_local(self, *args, **kwargs):
        raise NotImplementedError(_CKPT)

    def checkpoint_template(self, *args, **kwargs):
        raise NotImplementedError(_CKPT)

    def checkpoint_spec(self, *args, **kwargs):
        raise NotImplementedError(_CKPT)

    def lower_step(self, *args, **kwargs):
        raise NotImplementedError(_LOWER)
