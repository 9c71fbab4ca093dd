"""Bucketed gradient sync, DDP's reducer: the port of
``tpu_sandbox/parallel/buckets.py``.

PyTorch DDP's C++ reducer groups gradients into ~25 MB buckets and starts
one asynchronous all-reduce a bucket as soon as the bucket's gradients
exist, hiding the communication under the rest of the backward. JAX
writes the buckets as independent collectives over flat buffers and
leaves the overlap to XLA's latency-hiding scheduler. Here the overlap is
imperative:

- ``plan_buckets`` groups consecutive leaves (JAX's flatten order) into
  size-targeted spans, closing a bucket at a dtype change;
- ``BucketedSync`` registers a ``register_post_accumulate_grad_hook`` on
  each parameter. When the last gradient of a bucket lands, its hook
  issues that bucket's ``CompressedAllReduce.start`` (``async_op=True``
  collectives); ``finish`` waits on every bucket before the optimizer
  runs. The int8 exchange's second shot runs at wait time;
- buckets issue in reversed span order whatever order autograd delivers
  the gradients in (JAX's order, DDP's reverse-autograd heuristic): a
  bucket complete early waits until every later-issued bucket has
  issued, so every rank issues the same collectives in the same order;
- ``sync_buckets`` is the same exchange on gradients already computed.

A lone leaf is reduced where it lies, never copied into a flat buffer
(the fc gradient of the 3000x3000 model is 720 MB of fp32); a bucket of
several leaves concatenates them, and its mean and residual are split
back into leaf shapes. Residuals stay leaf-shaped. JAX chains the
buckets through ``optimization_barrier`` so that XLA's all-reduce
combiner cannot merge them back into one collective; issued one by one
from the host, the buckets need no such chain here.
"""

from __future__ import annotations

import weakref
from typing import Sequence

import torch

from tpu_sandbox_torch.parallel.collectives import (
    CollectiveGroup,
    CompressedAllReduce,
    as_compress_policy,
)

# PyTorch DDP's bucket_cap_mb default
DEFAULT_BUCKET_MB = 25.0


def flatten_order(named) -> list:
    """``(name, leaf)`` pairs in ``jax.tree.flatten``'s order of the Flax
    tree whose paths the dotted names are (the port keeps Flax's names):
    sorted part by part, as JAX sorts each level's dict keys."""
    return sorted(named, key=lambda kv: kv[0].split("."))


def plan_buckets(nbytes, bucket_bytes, keys=None):
    """Greedily group CONSECUTIVE leaves into size-targeted buckets.

    ``nbytes``: per-leaf byte sizes in flatten order. ``bucket_bytes``: the
    target; a bucket closes when adding the next leaf would push it past
    the target (a single over-target leaf still gets its own bucket).
    ``keys``: optional per-leaf grouping keys (dtypes); a key change
    forces a bucket boundary so that flat buffers never mix dtypes.

    Returns a list of ``(start, stop)`` index spans covering every leaf
    exactly once, in order."""
    nbytes = [int(b) for b in nbytes]
    bucket_bytes = int(bucket_bytes)
    if bucket_bytes <= 0:
        raise ValueError(f"bucket_bytes must be positive, got {bucket_bytes}")
    if keys is not None and len(keys) != len(nbytes):
        raise ValueError(
            f"keys length {len(keys)} != nbytes length {len(nbytes)}"
        )
    spans = []
    start, acc = 0, 0
    for i, b in enumerate(nbytes):
        boundary = i > start and (
            acc + b > bucket_bytes or (keys is not None and keys[i] != keys[start])
        )
        if boundary:
            spans.append((start, i))
            start, acc = i, 0
        acc += b
    if start < len(nbytes):
        spans.append((start, len(nbytes)))
    return spans


def _spans_of(leaves: Sequence[torch.Tensor], bucket_bytes: int):
    return plan_buckets([t.numel() * t.element_size() for t in leaves],
                        bucket_bytes, keys=[t.dtype for t in leaves])


class _Exchange:
    """One step's buckets: issued one at a time (``issue``), then waited
    on in the same order and split back into leaves (``finish``)."""

    def __init__(self, spans, group: CollectiveGroup, size: int,
                 compress: CompressedAllReduce, residuals):
        self.spans, self.group, self.size = spans, group, size
        self.compress = compress
        self.residuals = residuals if compress.needs_residual else None
        self.pending = {}                   # span index -> finish, in order

    def issue(self, k: int, grads: Sequence[torch.Tensor]) -> None:
        start, stop = self.spans[k]
        res = self.residuals
        if stop - start == 1:
            buf = grads[start]
            rbuf = None if res is None else res[start]
        else:
            buf = torch.cat([g.reshape(-1) for g in grads[start:stop]])
            rbuf = None if res is None else torch.cat(
                [r.reshape(-1) for r in res[start:stop]])
        self.pending[k] = self.compress.start(buf, self.group, self.size,
                                              rbuf)

    def finish(self, grads: Sequence[torch.Tensor]):
        """Wait on every bucket in issue order; ``(means, new_residuals)``
        per leaf, ``new_residuals`` None without a residual."""
        out = list(grads)
        new_res = None if self.residuals is None else list(self.residuals)
        for k, finish in self.pending.items():
            mean, rmean = finish()
            start, stop = self.spans[k]
            if stop - start == 1:
                out[start] = mean
                if new_res is not None:
                    new_res[start] = rmean
                continue
            off = 0
            for i in range(start, stop):
                n = grads[i].numel()
                out[i] = mean[off:off + n].view(grads[i].shape)
                if new_res is not None:
                    new_res[i] = rmean[off:off + n].view(grads[i].shape)
                off += n
        return out, new_res


def sync_buckets(grads: Sequence[torch.Tensor], group: CollectiveGroup,
                 size: int, compress=None, residuals=None,
                 bucket_bytes: int = int(DEFAULT_BUCKET_MB * 2 ** 20)):
    """The mean of ``grads`` (leaves in JAX's flatten order) over
    ``group`` as one ``compress.pmean`` exchange a size-targeted bucket,
    issued in reversed span order. ``compress``: a
    ``CompressedAllReduce``, a mode string or None. ``residuals``: one
    leaf-shaped error-feedback tensor a leaf, used only when the policy
    ``needs_residual``. Returns ``(means, new_residuals)``,
    ``new_residuals`` None iff no residual was threaded in. ``none`` means
    a lone leaf in place."""
    compress = as_compress_policy(compress)
    grads = list(grads)
    if not grads:
        return grads, None
    use_res = compress.needs_residual and residuals is not None
    spans = _spans_of(grads, bucket_bytes)
    ex = _Exchange(spans, group, size, compress,
                   list(residuals) if use_res else None)
    for k in range(len(spans) - 1, -1, -1):
        ex.issue(k, grads)
    return ex.finish(grads)


class BucketedSync:
    """The overlapped gradient sync of ``params`` (JAX's flatten order)
    over ``group``: hooks issue each bucket's exchange during the
    backward, in reversed span order.

    Usage, around each step's backward::

        sync = BucketedSync(params, group, compress, bucket_bytes)
        sync.begin(residuals)          # None without error feedback
        loss.backward()                # buckets issue as they complete
        new_residuals = sync.finish()  # every p.grad is the mean

    Outside ``begin``/``finish`` the hooks do nothing."""

    def __init__(self, params: Sequence[torch.nn.Parameter],
                 group: CollectiveGroup, compress: CompressedAllReduce,
                 bucket_bytes: int):
        self.params = list(params)
        self.group, self.size = group, group.size
        self.compress = compress
        self.spans = _spans_of(self.params, bucket_bytes)
        self.bucket_of = [k for k, (a, b) in enumerate(self.spans)
                          for _ in range(a, b)]
        self._ex: _Exchange | None = None
        # the hooks hold the sync weakly: a parameter that held it would
        # make a cycle (sync -> params -> hooks -> sync) that only the
        # garbage collector frees, with the parameters' device memory
        ref = weakref.ref(self)

        def landed(i: int) -> None:
            sync = ref()
            if sync is not None:
                sync._landed(i)

        self._handles = [p.register_post_accumulate_grad_hook(
            lambda p, i=i: landed(i)) for i, p in enumerate(self.params)]

    def begin(self, residuals=None) -> None:
        """Arm the hooks for one backward."""
        self._ex = _Exchange(self.spans, self.group, self.size,
                             self.compress, residuals)
        self._left = [b - a for a, b in self.spans]
        self._next = len(self.spans) - 1    # JAX issues the last span first

    def _landed(self, i: int) -> None:
        if self._ex is None:
            return
        self._left[self.bucket_of[i]] -= 1
        self._issue_ready()

    def _issue_ready(self, force: bool = False) -> None:
        while self._next >= 0 and (force or self._left[self._next] == 0):
            self._ex.issue(self._next, [p.grad for p in self.params])
            self._next -= 1

    def finish(self):
        """Issue what the backward did not (a parameter without a
        gradient takes zeros, so that every rank issues the same
        collectives), wait on every bucket, and set each parameter's
        gradient to its mean. Returns the new residuals (None without
        error feedback)."""
        for p in self.params:
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        self._issue_ready(force=True)
        ex, self._ex = self._ex, None
        means, new_res = ex.finish([p.grad for p in self.params])
        for p, m in zip(self.params, means):
            p.grad = m
        return new_res

    def remove(self) -> None:
        """Take the hooks off the parameters."""
        for h in self._handles:
            h.remove()
