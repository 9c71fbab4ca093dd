"""Data parallelism, one process a rank: the port of
``tpu_sandbox/parallel/data_parallel.py`` (:43-132, 184-230, 319-330,
359-368, 370-510), the counterpart of the reference's
``DistributedDataParallel(model)`` (mnist_distributed.py:67).

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

ZeRO-1, compressed and overlapped gradient sync and the sharded
checkpoint hooks are not ported yet: their switches raise
``NotImplementedError`` naming their ROADMAP item.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from tpu_sandbox_torch.ops.losses import cross_entropy_loss
from tpu_sandbox_torch.parallel.collectives import CollectiveGroup
from tpu_sandbox_torch.train.state import TrainState
from tpu_sandbox_torch.train.trainer import prepare_inputs

_ZERO = "ZeRO-1 is not ported yet (ROADMAP queue 1 item 4, first extension)"
_COMPRESS = ("compressed gradient sync is not ported yet (ROADMAP queue 1 "
             "item 4, second extension: grad_compress, int8_block_pmean, "
             "error feedback)")
_OVERLAP = ("overlapped gradient sync is not ported yet (ROADMAP queue 1 "
            "item 4, third extension: overlap buckets)")
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
                 grad_compress: str | None = "none",
                 error_feedback: bool = True,
                 overlap_grad_sync: bool = False, bucket_mb: float = 25.0):
        if zero:
            raise NotImplementedError(_ZERO)
        if grad_compress not in (None, "none"):
            raise NotImplementedError(_COMPRESS)
        if error_feedback is not True:
            raise NotImplementedError(_COMPRESS)
        if overlap_grad_sync or bucket_mb != 25.0:
            raise NotImplementedError(_OVERLAP)
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

    # -- state --------------------------------------------------------------

    @torch.no_grad()
    def shard_state(self, state: TrainState) -> TrainState:
        """Every rank takes group rank 0's parameters; BN statistics stay
        this rank's own."""
        self.group.broadcast_params_(self.model.parameters())
        return state

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
        loss = cross_entropy_loss(model(x), labels)
        loss.backward()
        self.group.mean_grads_(model.parameters())
        state.apply_update()
        loss = loss.detach()
        if self.average_loss:
            loss = self.group.all_reduce(loss, "mean")
        return loss

    # -- not ported yet -----------------------------------------------------

    def shard_state_local(self, *args, **kwargs):
        raise NotImplementedError(_CKPT)

    def checkpoint_template(self, *args, **kwargs):
        raise NotImplementedError(_CKPT)

    def checkpoint_spec(self, *args, **kwargs):
        raise NotImplementedError(_CKPT)

    def lower_step(self, *args, **kwargs):
        raise NotImplementedError(_LOWER)
