"""Raw collectives over a process group or a mesh axis: the port of
``tpu_sandbox/parallel/collectives.py`` (``CollectiveGroup`` :33-312,
``world_group`` / ``sub_groups`` :508-521) and its compressed gradient
sync (``CompressedAllReduce``, ``int8_block_pmean``, :300-505).

The JAX package is single-controller: a "per-rank value" there is an array
whose leading dimension is the group, rank i's block is row block i. Here
each rank is an OS process and passes its own block: the tensor that JAX's
rank i holds (``put`` cuts it from a host array of every rank's values).
Results are this rank's block of JAX's result. The group is bound once
(the reference built a new group every step, allreduce_toy.py:26-27).

gloo on the CPU, NCCL on CUDA tensors. gloo lacks ``reduce_scatter`` in
some PyTorch releases, so on gloo it is composed: a sum all-reduce of the
whole payload, then this rank's slice. NCCL data never goes through the
host.

The compressed mean of a gradient (``CompressedAllReduce``) has JAX's
modes: ``none`` is the port's plain mean (a sum all-reduce in place, then
a division by the group size), ``bf16`` the same on a bf16 copy, ``int8``
the two-shot block-quantised exchange of ``int8_block_pmean``. ``start``
issues a mean and returns the call that finishes it, so a caller can issue
the first shot and do other work before the second (``parallel/
buckets.py``); ``pmean`` does both at once.

``ring_shift`` and ``all_to_all_tiled`` are the differentiable forms that
sequence parallelism needs, where JAX differentiates ``lax.ppermute`` and
``lax.all_to_all`` itself: autograd functions whose backward issues the
adjoint collective (the shift by ``-offset``, the inverse all-to-all).
``tp_region_input`` and ``tp_region_output`` are Megatron's conjugate
pair around a tensor-parallel region, ``tp_gather`` the gather of a
sharded activation that every rank uses whole, ``gather_param`` the
gather of a sharded parameter at use (FSDP's, a partial rule set's), and
``StatsGroup`` the sums of BatchNorm's statistics over the ranks of one
batch: what XLA derives from the sharding specs of the pipeline and the
compiler-driven engine, written out.
Autograd runs a graph's backward nodes in one order on every rank, so
every rank issues those collectives in the same order.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import DeviceMesh

from tpu_sandbox_torch.runtime import bootstrap

_REDUCE_OPS = {"sum": dist.ReduceOp.SUM, "mean": dist.ReduceOp.SUM,
               "max": dist.ReduceOp.MAX, "min": dist.ReduceOp.MIN}


class CollectiveGroup:
    """The ranks of one process group or of one mesh axis, bound once.

    ``CollectiveGroup(mesh, axis)`` takes the mesh axis's sub-group that
    holds this rank; ``CollectiveGroup(None)`` (or a ``ProcessGroup``) the
    whole world (or that group). Every rank of the group must make the same
    calls in the same order.
    """

    def __init__(self, mesh: DeviceMesh | dist.ProcessGroup | None = None,
                 axis: str | None = None):
        if isinstance(mesh, DeviceMesh):
            names = tuple(mesh.mesh_dim_names or ())
            if axis is None:
                if len(names) != 1:
                    raise ValueError(
                        f"mesh has axes {names}; pass axis= explicitly")
                axis = names[0]
            if axis not in names:
                raise ValueError(f"axis {axis!r} not in mesh axes {names}")
            self.group = mesh.get_group(axis)
        else:
            self.group = mesh if mesh is not None else dist.group.WORLD
        self.mesh = mesh
        self.axis = axis
        self.size = dist.get_world_size(self.group)
        self.rank = dist.get_rank(self.group)
        self.nccl = dist.get_backend(self.group) == "nccl"
        self.device = bootstrap.device() if self.nccl else torch.device("cpu")

    # -- placement ----------------------------------------------------------

    def put(self, values) -> torch.Tensor:
        """This rank's block of a host array of every rank's values
        (leading dim a multiple of the group size), on the group's
        device."""
        values = np.asarray(values)
        if values.ndim == 0 or values.shape[0] % self.size:
            raise ValueError(
                f"leading dim {values.shape[:1]} not divisible by group "
                f"size {self.size}")
        k = values.shape[0] // self.size
        block = values[self.rank * k:(self.rank + 1) * k]
        return torch.from_numpy(np.ascontiguousarray(block)).to(self.device)

    def _local(self, x) -> torch.Tensor:
        t = x if isinstance(x, torch.Tensor) else torch.as_tensor(
            np.asarray(x))
        return t.to(self.device).clone()

    def _global_rank(self, group_rank: int) -> int:
        if self.group is dist.group.WORLD or self.group is None:
            return group_rank
        return dist.get_global_rank(self.group, group_rank)

    # -- collectives --------------------------------------------------------

    def all_reduce(self, x, op: str = "sum") -> torch.Tensor:
        """Elementwise reduce over the group; every rank gets the result.
        ``mean`` is the sum divided by the group size (true division, as
        ``lax.pmean``; gloo has no ``ReduceOp.AVG``)."""
        if op not in _REDUCE_OPS:
            raise ValueError(f"op {op!r} not in {sorted(_REDUCE_OPS)}")
        t = self._local(x)
        dist.all_reduce(t, _REDUCE_OPS[op], group=self.group)
        return t / self.size if op == "mean" else t

    def all_gather(self, x) -> torch.Tensor:
        """Every rank receives every rank's block, concatenated along
        dim 0 in rank order."""
        t = self._local(x)
        out = [torch.empty_like(t) for _ in range(self.size)]
        dist.all_gather(out, t, group=self.group)
        return torch.cat(out) if t.dim() else torch.stack(out)

    def reduce_scatter(self, x) -> torch.Tensor:
        """Each rank contributes a full payload ``[rows, m]`` with ``m`` a
        multiple of the group size; the payloads are summed and rank i
        keeps the i-th 1/size of the sum along dim 1, ``[rows, m/size]``.
        NCCL: ``reduce_scatter_tensor``; gloo: a sum all-reduce, then the
        slice."""
        t = self._local(x)
        if t.dim() != 2 or t.shape[1] % self.size:
            raise ValueError(
                f"reduce_scatter wants shape (rows, m) with m % {self.size} "
                f"== 0, got {tuple(t.shape)}")
        rows, m = t.shape
        part = m // self.size
        if not self.nccl:
            dist.all_reduce(t, group=self.group)
            return t[:, self.rank * part:(self.rank + 1) * part].contiguous()
        chunks = t.reshape(rows, self.size, part).transpose(0, 1).contiguous()
        out = torch.empty(rows, part, dtype=t.dtype, device=t.device)
        dist.reduce_scatter_tensor(out, chunks.reshape(-1, part),
                                   group=self.group)
        return out

    def broadcast(self, x, root: int = 0) -> torch.Tensor:
        """Every rank receives group rank ``root``'s tensor (DDP's first
        parameter sync, reference mnist_distributed.py:67)."""
        t = self._local(x)
        dist.broadcast(t, self._global_rank(root), group=self.group)
        return t

    @torch.no_grad()
    def broadcast_params_(self, params, root: int = 0) -> None:
        """Every rank takes group rank ``root``'s parameters, in place."""
        src = self._global_rank(root)
        for p in params:
            dist.broadcast(p.data, src, group=self.group)

    @torch.no_grad()
    def sum_grads_(self, params) -> None:
        """The gradient sum over the group, in place (``lax.psum``): one
        sum all-reduce a parameter in the given order. A parameter with no
        gradient takes zeros first, so every rank issues the same
        collectives."""
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
            self.sum_(p.grad)

    @torch.no_grad()
    def mean_grads_(self, params) -> None:
        """The gradient mean over the group, in place, as ``lax.pmean``
        writes it: ``sum_grads_``, then a true division by the group size
        (gloo has no ``ReduceOp.AVG``)."""
        params = list(params)
        self.sum_grads_(params)
        for p in params:
            p.grad.div_(self.size)

    def shift(self, x, offset: int = 1) -> torch.Tensor:
        """Ring permute: rank i's tensor moves to rank (i + offset) % size
        (paired sends and receives)."""
        t = self._local(x)
        if offset % self.size == 0:
            return t
        out = torch.empty_like(t)
        dst = self._global_rank((self.rank + offset) % self.size)
        src = self._global_rank((self.rank - offset) % self.size)
        ops = [dist.P2POp(dist.isend, t, dst, group=self.group),
               dist.P2POp(dist.irecv, out, src, group=self.group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return out

    def all_to_all(self, x) -> torch.Tensor:
        """Rank i holds ``[size, ...]`` whose j-th row goes to rank j;
        returns ``[size, ...]`` whose row i came from rank i (JAX's
        ``out[j, i] = values[i, j]`` seen from rank j)."""
        out, work = self.all_to_all_start(x)
        work.wait()
        return out

    def all_to_all_start(self, x) -> tuple[torch.Tensor, dist.Work]:
        """``all_to_all`` issued without waiting: the output buffer and
        the handle whose ``wait()`` completes it."""
        t = x.to(self.device) if isinstance(x, torch.Tensor) else \
            self._local(x)
        if t.dim() < 1 or t.shape[0] != self.size:
            raise ValueError(
                f"all_to_all wants shape (size, ...) with size "
                f"{self.size}, got {tuple(t.shape)}")
        out = torch.empty_like(t)
        work = dist.all_to_all_single(out, t.contiguous(), group=self.group,
                                      async_op=True)
        return out, work

    def sum_(self, t: torch.Tensor, async_op: bool = False):
        """The sum all-reduce of ``t`` in place; with ``async_op`` the
        handle whose ``wait()`` completes it (else None)."""
        return dist.all_reduce(t, group=self.group, async_op=async_op)

    def barrier(self) -> None:
        """Block the host until every rank of the group has arrived: a sum
        all-reduce of a unit token, read on the host (reference
        ``dist.barrier()``, allreduce_toy.py:33)."""
        token = torch.ones(1, dtype=torch.int32, device=self.device)
        dist.all_reduce(token, group=self.group)
        if int(token.item()) != self.size:
            raise RuntimeError(f"barrier counted {int(token.item())} of "
                               f"{self.size} ranks")

    # -- microbenchmark -----------------------------------------------------

    def _sync(self) -> None:
        if self.nccl:
            torch.cuda.synchronize(self.device)

    def allreduce_bandwidth(self, nbytes: int = 1 << 26,
                            iters: int = 10) -> dict:
        """All-reduce bandwidth with NCCL-tests' accounting: ``algbw`` is
        the payload over the time of one all-reduce, ``busbw`` is
        ``algbw * 2(n-1)/n`` (0 at one rank). The payload is f32, rounded
        down to a multiple of the group size; each timed run chains
        ``iters`` in-place all-reduces (each output the next input) after
        two warm-up calls, timed with CUDA events on NCCL and on the host
        clock after the last call on gloo. Every rank must call it."""
        n = self.size
        elems = max(nbytes // 4, n)
        elems -= elems % n
        x = torch.ones(elems, dtype=torch.float32, device=self.device)
        for _ in range(2):
            dist.all_reduce(x, group=self.group)
        self._sync()
        if self.nccl:
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                dist.all_reduce(x, group=self.group)
            stop.record()
            stop.synchronize()
            dt = start.elapsed_time(stop) / 1e3 / iters
            method = "cuda_events"
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                dist.all_reduce(x, group=self.group)
            dt = (time.perf_counter() - t0) / iters
            method = "host_wall"
        result = {"bytes": elems * 4, "seconds": dt, "timing_method": method,
                  "algbw_GBps": 0.0, "busbw_GBps": 0.0}
        if dt > 0:
            algbw = elems * 4 / dt
            result["algbw_GBps"] = algbw / 1e9
            result["busbw_GBps"] = algbw * (2 * (n - 1) / n) / 1e9
        else:
            result["degraded"] = f"non-positive time ({dt:.3e}s)"
        return result


class _Shift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, offset):
        ctx.group, ctx.offset = group, offset
        return group.shift(x.contiguous(), offset)

    @staticmethod
    def backward(ctx, g):
        return ctx.group.shift(g.contiguous(), -ctx.offset), None, None


def ring_shift(x: torch.Tensor, group: CollectiveGroup,
               offset: int = 1) -> torch.Tensor:
    """``group.shift`` (rank i's tensor to rank (i + offset) % size) as
    ``lax.ppermute`` differentiates: the cotangent shifts back by
    ``-offset``."""
    return _Shift.apply(x, group, offset)


class _RegionInput(torch.autograd.Function):
    """Megatron's 'f': identity forward, sum over the group backward. The
    input of a column-parallel matmul feeds every rank's shard, each of
    which gives only its shard's share of the cotangent."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce(g.contiguous(), "sum"), None


class _RegionOutput(torch.autograd.Function):
    """Megatron's 'g': sum over the group forward, identity backward (the
    conjugate of 'f'; a summing backward would multiply the row-parallel
    gradients by the group size)."""

    @staticmethod
    def forward(ctx, x, group):
        return group.all_reduce(x.contiguous(), "sum")

    @staticmethod
    def backward(ctx, g):
        return g, None


def tp_region_input(x: torch.Tensor, group: CollectiveGroup) -> torch.Tensor:
    """Megatron's 'f' over ``group``: the identity forward, the sum
    backward (``tpu_sandbox/parallel/pipeline.py::_tp_region_input``,
    :128-150)."""
    return _RegionInput.apply(x, group)


def tp_region_output(x: torch.Tensor, group: CollectiveGroup) -> torch.Tensor:
    """Megatron's 'g' over ``group``: the sum forward, the identity
    backward (``tpu_sandbox/parallel/pipeline.py::_tp_region_output``,
    :153-173)."""
    return _RegionOutput.apply(x, group)


class _GatherDim(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim, ctx.k = group, dim, x.shape[dim]
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(group.size)]
        dist.all_gather(parts, x, group=group.group)
        return torch.cat(parts, dim)

    @staticmethod
    def backward(ctx, g):
        k = ctx.k
        return (g.narrow(ctx.dim, ctx.group.rank * k, k).contiguous(), None,
                None)


def tp_gather(x: torch.Tensor, group: CollectiveGroup,
              dim: int = -1) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order, for a
    sharded activation that every rank of ``group`` then uses whole (a
    vocab-sharded head's logits, a d_model-sharded embedding): the
    backward is this rank's slice of the cotangent, which every rank
    computed alike, so nothing is summed."""
    return _GatherDim.apply(x, group, dim % x.dim())


class _GatherDimReduced(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, reduce):
        ctx.group, ctx.dim, ctx.reduce, ctx.k = group, dim, reduce, x.shape[dim]
        parts = group.all_gather(x.movedim(dim, 0).contiguous()[None])
        return torch.cat(parts.unbind(0), 0).movedim(0, dim)

    @staticmethod
    def backward(ctx, g):
        grp, k = ctx.group, ctx.k
        if ctx.reduce == "slice":
            return (g.narrow(ctx.dim, grp.rank * k, k).contiguous(), None,
                    None, None)
        rows = g.movedim(ctx.dim, 0).contiguous()
        part = grp.reduce_scatter(rows.reshape(1, -1)).reshape(
            k, *rows.shape[1:]).movedim(0, ctx.dim)
        if ctx.reduce == "mean":
            part = part / grp.size
        return part, None, None, None


def gather_param(x: torch.Tensor, group: CollectiveGroup, dim: int,
                 reduce: str) -> torch.Tensor:
    """A parameter sharded on ``dim`` over ``group``, whole at its use.
    The backward gives this rank its block of the cotangent: the mean
    (``reduce="mean"``) or the sum (``"sum"``) over the group, whose ranks
    computed different gradients (different rows of the batch, different
    bands of the image), or this rank's own block (``"slice"``), where
    every rank computed the same full gradient."""
    if reduce not in ("mean", "sum", "slice"):
        raise ValueError(f"reduce {reduce!r} not in ('mean', 'sum', 'slice')")
    return _GatherDimReduced.apply(x, group, dim, reduce)


class _SumBoth(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return group.all_reduce(x.contiguous(), "sum")

    @staticmethod
    def backward(ctx, g):
        return ctx.group.all_reduce(g.contiguous(), "sum"), None


class StatsGroup:
    """The ranks whose rows make up one batch for BatchNorm: the groups of
    the mesh axes the batch is spread over (its rows, and the image's row
    bands under spatial partitioning). The compiler-driven engine sets one
    on each BN module, whose statistics are then those of the whole batch
    (JAX's BN under ``jit``: the batch axis is a global axis); ``None``
    there is the rank's own batch. ``equal_rows``: every rank holds as
    many elements, so the whole batch's count is this rank's times the
    ranks, a host number as on one rank; else the counts are summed with
    the statistics (the image bands of a spatial axis can differ)."""

    def __init__(self, groups: Sequence[CollectiveGroup],
                 equal_rows: bool = True):
        self.groups = tuple(groups)
        self.equal_rows = equal_rows
        self.size = 1
        for g in self.groups:
            self.size *= g.size

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """The sum over the groups, differentiable: the sum forward and
        the sum backward (each rank's partial sums feed every rank's
        statistics)."""
        for g in self.groups:
            x = _SumBoth.apply(x, g)
        return x

    @torch.no_grad()
    def totals(self, parts: Sequence[torch.Tensor], count: int):
        """Per-channel f32 sums and this rank's element count, summed over
        the groups in one all-reduce: (the summed parts, the whole batch's
        count: an int with ``equal_rows``, else an f32 0-d tensor)."""
        flat = [p.reshape(-1).float() for p in parts]
        if not self.equal_rows:
            flat.append(torch.full((1,), float(count),
                                   device=flat[0].device))
        buf = torch.cat(flat)
        for g in self.groups:
            buf = g.all_reduce(buf, "sum")
        out, at = [], 0
        for p in parts:
            out.append(buf[at:at + p.numel()].view(p.shape))
            at += p.numel()
        return out, count * self.size if self.equal_rows else buf[at]


def _tiled(x, group, split_axis, concat_axis):
    if x.shape[split_axis] % group.size:
        raise ValueError(f"all_to_all: dim {split_axis} of {tuple(x.shape)} "
                         f"not divisible by {group.size} ranks")
    blocks = torch.stack(x.chunk(group.size, dim=split_axis))
    return torch.cat(group.all_to_all(blocks).unbind(0), dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.args = group, split_axis, concat_axis
        return _tiled(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        group, split_axis, concat_axis = ctx.args
        return _tiled(g, group, concat_axis, split_axis), None, None, None


def all_to_all_tiled(x: torch.Tensor, group: CollectiveGroup,
                     split_axis: int, concat_axis: int) -> torch.Tensor:
    """``lax.all_to_all(x, axis, split_axis, concat_axis, tiled=True)``:
    ``x`` splits into ``size`` blocks along ``split_axis``, block j goes to
    rank j, and the blocks that arrive are concatenated along
    ``concat_axis`` in rank order. Differentiable: the backward is the
    inverse all-to-all (split and concat axes swapped)."""
    return _AllToAll.apply(x, group, split_axis, concat_axis)


# -- compressed gradient synchronization ------------------------------------
#
# The wire payload of the gradient mean shrinks by a bf16 cast (2x) or an
# int8 block-scaled two-shot exchange (~4x), with an optional
# error-feedback residual that re-injects the quantisation error into the
# next step's gradient instead of losing it.

_COMPRESS_MODES = ("none", "bf16", "int8")


def _quantize_int8_blocks(v: torch.Tensor):
    """Symmetric per-block int8: ``v`` is fp32 ``[..., block]``; returns
    ``(q int8, scale fp32 [..., 1])`` with scale = blockwise absmax / 127
    (guarded so that an all-zero block dequantises to exact zeros).
    ``torch.round`` rounds half to even, as ``jnp.round``."""
    s = v.abs().amax(-1, keepdim=True) / 127.0
    safe = torch.where(s > 0, s, torch.ones_like(s))
    q = torch.clamp(torch.round(v / safe), -127, 127).to(torch.int8)
    return q, s


#: a mean in flight: calling it finishes it and returns ``(mean,
#: new_residual)``
Pending = Callable[[], tuple]


def int8_block_pmean_start(value: torch.Tensor,
                           residual: torch.Tensor | None,
                           group: CollectiveGroup, size: int,
                           block: int) -> Pending:
    """``int8_block_pmean`` with its first shot issued and its second left
    to the returned call."""
    shape, dtype = value.shape, value.dtype
    flat = value.float().reshape(-1)
    n = flat.numel()
    if residual is not None:
        flat = flat + residual.reshape(-1).float()
    chunk = -(-n // (size * block)) * block
    pad = size * chunk - n
    v = F.pad(flat, (0, pad)).reshape(size, chunk // block, block)
    q, s = _quantize_int8_blocks(v)
    qx, qwork = group.all_to_all_start(q)
    sx, swork = group.all_to_all_start(s)

    def finish():
        qwork.wait()
        swork.wait()
        red = (qx.float() * sx).sum(0) / size               # [nb, block]
        q2, s2 = _quantize_int8_blocks(red)
        q2g, s2g = group.all_gather(q2), group.all_gather(s2)
        mean = ((q2g.float() * s2g).reshape(-1)[:n].reshape(shape)
                .to(dtype))
        if residual is None:
            return mean, None
        err = v - q.float() * s
        err[group.rank] += (red - q2.float() * s2) * size
        return mean, err.reshape(-1)[:n].reshape(shape).to(residual.dtype)

    return finish


def int8_block_pmean(value: torch.Tensor, residual: torch.Tensor | None,
                     group: CollectiveGroup, size: int, block: int):
    """Block-quantised mean over ``group`` of one tensor (JAX
    ``parallel/collectives.py:324-373``). Returns ``(mean,
    new_residual)``.

    Two shots, so that the sum is taken in fp32, never in int8:

    1. flatten, add the residual, pad to ``size * chunk`` (chunk a
       multiple of ``block``), quantise ``[size, nb, block]`` and
       ``all_to_all`` the int8 payload and its fp32 scales: rank j
       receives every rank's chunk j (a quantised reduce-scatter);
    2. dequantise, take the fp32 mean of the chunks, quantise this rank's
       chunk again and ``all_gather`` it back.

    With ``residual`` (error feedback) the new residual is the shot-1
    error plus ``size`` times the shot-2 error at this rank's own chunk,
    so that the sum of the residuals over ranks next step re-injects
    exactly what this step's mean dropped."""
    return int8_block_pmean_start(value, residual, group, size, block)()


@dataclasses.dataclass(frozen=True)
class CompressedAllReduce:
    """The gradient sync's compression policy (JAX
    ``parallel/collectives.py:376-497``).

    ``mode``: ``"none"`` the plain mean, in place; ``"bf16"`` the mean of
    a bf16 copy, cast back; ``"int8"`` ``int8_block_pmean``. ``block``:
    the int8 scale granularity, one fp32 scale per ``block`` elements.
    ``error_feedback``: int8 only; the engine then carries a
    parameter-shaped fp32 residual from step to step
    (``needs_residual``)."""

    mode: str = "none"
    block: int = 256
    error_feedback: bool = True

    def __post_init__(self):
        if self.mode not in _COMPRESS_MODES:
            raise ValueError(
                f"grad_compress mode {self.mode!r} not in {_COMPRESS_MODES}"
            )
        if self.block < 1:
            raise ValueError(f"block must be positive, got {self.block}")

    @property
    def needs_residual(self) -> bool:
        return self.mode == "int8" and self.error_feedback

    def block_for(self, n: int, size: int) -> int:
        """The int8 block of a leaf of ``n`` elements over ``size`` ranks:
        ``block``, halved (to a floor of 8) while it exceeds the leaf's
        per-rank chunk, which ``int8_block_pmean`` pads to a whole
        block."""
        per_rank = -(-int(n) // size)
        b = self.block
        while b > 8 and b > per_rank:
            b //= 2
        return b

    def start(self, value: torch.Tensor, group: CollectiveGroup, size: int,
              residual: torch.Tensor | None = None) -> Pending:
        """Issue the mean of ``value`` over ``group``; calling the result
        gives ``(mean, new_residual)``. ``none`` sums ``value`` itself in
        place and divides it by ``size``, as
        ``CollectiveGroup.mean_grads_``."""
        if self.mode == "none":
            work = group.sum_(value, async_op=True)

            def finish():
                work.wait()
                return value.div_(size), residual

            return finish
        if self.mode == "bf16":
            t = value.to(torch.bfloat16)
            work = group.sum_(t, async_op=True)

            def finish():
                work.wait()
                return t.div_(size).to(value.dtype), residual

            return finish
        if not self.error_feedback:
            residual = None
        return int8_block_pmean_start(
            value, residual, group, size, self.block_for(value.numel(),
                                                         size))

    def pmean(self, value: torch.Tensor, group: CollectiveGroup, size: int,
              residual: torch.Tensor | None = None):
        """The compressed mean of one tensor over ``group``: ``(mean,
        new_residual)``."""
        return self.start(value, group, size, residual)()

    def pmean_tree(self, grads: Sequence[torch.Tensor],
                   group: CollectiveGroup, size: int,
                   residuals: Sequence[torch.Tensor] | None = None):
        """``pmean`` of each tensor in turn. ``residuals`` is None (no
        error feedback) or one per tensor; returns ``(means,
        new_residuals)``, ``new_residuals`` None iff no residual was
        threaded in."""
        if not self.needs_residual:
            residuals = None
        pairs = [self.pmean(g, group, size,
                            None if residuals is None else residuals[i])
                 for i, g in enumerate(grads)]
        means = [m for m, _ in pairs]
        if residuals is None:
            return means, None
        return means, [r for _, r in pairs]

    @torch.no_grad()
    def mean_grads_(self, params: Sequence[torch.Tensor],
                    group: CollectiveGroup,
                    residuals: Sequence[torch.Tensor] | None = None):
        """``pmean_tree`` of the parameters' gradients (zeros where there
        is none, so that every rank issues the same collectives), each
        gradient set to its mean; returns the new residuals."""
        for p in params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        means, new_res = self.pmean_tree([p.grad for p in params], group,
                                         group.size, residuals)
        for p, m in zip(params, means):
            p.grad = m
        return new_res

    def wire_bytes(self, leaf_sizes, size: int) -> dict:
        """Bytes each rank puts on the wire a step for gradients of the
        given element counts: ``payload`` the elements at the compressed
        width, ``overhead`` int8's scales and padding on both shots,
        ``total`` both (JAX's accounting, :458-497)."""
        payload = total = 0
        for n in leaf_sizes:
            n = int(n)
            if self.mode == "none":
                payload += 4 * n
                total += 4 * n
            elif self.mode == "bf16":
                payload += 2 * n
                total += 2 * n
            else:
                block = self.block_for(n, size)
                chunk = -(-n // (size * block)) * block
                nb = chunk // block
                payload += n + -(-n // size)
                total += size * chunk + size * nb * 4
                total += chunk + nb * 4
        return {"total": total, "payload": payload,
                "overhead": total - payload}


def as_compress_policy(policy) -> CompressedAllReduce:
    """A CLI string, None or a policy, as a policy."""
    if isinstance(policy, CompressedAllReduce):
        return policy
    return CompressedAllReduce(mode=str(policy) if policy else "none")


def world_group(mesh: DeviceMesh | None = None,
                axis: str = "data") -> CollectiveGroup:
    """The all-ranks group (the reference's implicit WORLD), or a 1-D
    mesh's axis."""
    return CollectiveGroup(mesh, axis if mesh is not None else None)


def sub_groups(mesh: DeviceMesh, axis: str) -> CollectiveGroup:
    """Collectives over one axis of a multi-axis mesh: this rank's slice
    along the other axes, a group created once with the mesh (the
    counterpart of ``dist.new_group(range(args.gpus))``,
    mnist_distributed.py:100)."""
    return CollectiveGroup(mesh, axis)
