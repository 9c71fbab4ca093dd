"""Training engine: the train step and the epoch loop with the reference's
log lines. Counterpart of ``tpu_sandbox/train/trainer.py``:
``resize_on_device`` (:84), ``prepare_inputs`` (:99), ``make_train_step``
(:113-193, gradient accumulation included), ``make_eval_step`` (:209),
``Trainer.fit`` with its periodic checkpoints (:224-365), and the
resumable loop of elastic runs (:388-783): ``ElasticEnv``, ``Preempted``,
``AbortOnAnomaly``, ``PreemptionHandler``, ``ResumableReport``,
``build_elastic_checkpoint`` and ``train_resumable``.

The step runs eagerly: the 28x28 batch goes to the device, the model's
fused input stage resizes it to the training size and folds it into
space-to-depth, then forward, mean cross-entropy, backward and the SGD
update run in place on the model.

JAX's resumable loop keeps the previous state by dropping the step's new
one; here the state is updated in place, so a step built with
``guard=True`` decides after the forward, before the backward: on a
non-finite loss it puts back the BN statistics the forward moved and
returns ``(loss, False)`` with nothing else touched (the data-parallel
step reduces that verdict over its ranks first). The loop then counts the
anomaly as JAX's does.
"""

from __future__ import annotations

import os
import signal
import time
from dataclasses import dataclass
from datetime import timedelta
from typing import Callable

import numpy as np
import torch

from tpu_sandbox_torch.data.loader import PrefetchLoader
from tpu_sandbox_torch.models.convnet_s2d_t import resize_weights
from tpu_sandbox_torch.ops.losses import cross_entropy_loss
from tpu_sandbox_torch.train.state import TrainState

#: Exit code the supervisor treats as "preempted: saved, restart for free"
#: (mirrors runtime/supervisor.py, which the training layer does not import).
PREEMPTED_EXIT_CODE = 75

#: KV key a preempted rank raises so every peer stops at the same boundary
#: (must match supervisor.PREEMPT_KEY; the supervisor clears it between
#: generations).
PREEMPT_KEY = "preempt/requested"

#: Env vars a supervisor sets on every rank it spawns (mirrored from
#: runtime/supervisor.py and the JAX package's host agent).
ENV_GENERATION = "TPU_SANDBOX_GENERATION"
ENV_AGENT_ID = "TPU_SANDBOX_AGENT_ID"
ENV_JOB_ID = "TPU_SANDBOX_JOB_ID"


@dataclass(frozen=True)
class ElasticEnv:
    """The elastic identity a rank inherits from whoever spawned it: its
    relaunch generation (stamps checkpoints and KV claims), its host agent
    (``None`` under the single-host supervisor) and its job's KV namespace
    (empty string = the default job)."""

    generation: str
    agent_id: int | None
    job_id: str = ""

    @classmethod
    def from_env(cls, environ=None) -> "ElasticEnv":
        env = os.environ if environ is None else environ
        raw = env.get(ENV_AGENT_ID, "")
        return cls(
            generation=env.get(ENV_GENERATION, "1"),
            agent_id=int(raw) if raw else None,
            job_id=env.get(ENV_JOB_ID, ""),
        )


def resize_on_device(images: torch.Tensor, image_size) -> torch.Tensor:
    """[N,h,w,C] -> [N,H,W,C] bilinear with ``jax.image.resize``'s
    weights (``resize_weights``): resize is separable and linear, so it is
    two f32 products with the interpolation matrices."""
    H, W = image_size
    _, h0, w0, _ = images.shape
    ah = torch.from_numpy(resize_weights(h0, H)).to(images.device)
    aw = torch.from_numpy(resize_weights(w0, W)).to(images.device)
    return torch.einsum("hi,nijc,wj->nhwc", ah, images.float(), aw)


def prepare_inputs(model, images: torch.Tensor, image_size) -> torch.Tensor:
    """Models with ``fused_input_stage`` (ConvNetS2DT) take the raw small
    batch straight into their fused resize + space-to-depth; any other
    model gets the plain resize."""
    stage = getattr(model, "fused_input_stage", None)
    if stage is not None:
        return stage(images, image_size)
    return resize_on_device(images, image_size)


def to_device(images, labels, device: torch.device, *,
              non_blocking: bool = False):
    """A host batch as tensors on ``device``, labels int64; a batch of
    tensors already there passes through. ``non_blocking`` pins the batch
    and enqueues its copy (on a CUDA device) without waiting for it."""
    def put(a, dtype=None):
        t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(a))
        if dtype is not None:
            t = t.to(dtype)
        if non_blocking and device.type == "cuda" and t.device.type == "cpu":
            t = t.pin_memory()
        return t.to(device, non_blocking=non_blocking)

    return put(images), put(labels, torch.long)


def make_train_step(state: TrainState, *,
                    image_size: tuple[int, int] | None = None,
                    accum_steps: int = 1, guard: bool = False) -> Callable:
    """(images, labels) -> loss: one SGD update of ``state`` in place.
    ``images`` [N,h,w,1] and ``labels`` [N] lie on the model's device;
    with ``image_size`` they are resized there first.

    ``accum_steps`` k splits the batch into k microbatches run one after
    another (each resized on its own, so the full-size batch never exists
    at once; BN running stats update microbatch by microbatch). Their
    gradients are summed, then divided by k before the one update, JAX's
    order; the loss returned is the mean of the k losses. The
    single-device counterpart of the reference's out-of-memory
    workaround.

    ``guard`` makes the step return ``(loss, applied)``: a microbatch
    whose loss is not finite ends the step before its backward, with the
    BN statistics put back and the gradients dropped, so the state is
    bitwise what it was and ``applied`` is False."""
    if accum_steps < 1:
        raise ValueError(f"accum_steps must be >= 1, got {accum_steps}")
    model = state.model

    def train_step(images: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        model.train()
        n = images.shape[0]
        if n % accum_steps:
            raise ValueError(
                f"batch {n} not divisible by accum_steps {accum_steps}")
        micro = n // accum_steps
        total = None
        saved = ([b.detach().clone() for b in model.buffers()]
                 if guard else None)
        for i in range(0, n, micro):
            x = images[i:i + micro]
            if image_size is not None:
                x = prepare_inputs(model, x, image_size)
            loss = cross_entropy_loss(model(x), labels[i:i + micro])
            if guard and not bool(torch.isfinite(loss)):
                with torch.no_grad():
                    for b, s in zip(model.buffers(), saved):
                        b.copy_(s)
                    for p in model.parameters():
                        p.grad = None
                return loss.detach(), False
            loss.backward()                 # sums into each parameter's grad
            total = loss.detach() if total is None else total + loss.detach()
        if accum_steps > 1:
            with torch.no_grad():
                for p in model.parameters():
                    if p.grad is not None:
                        p.grad.div_(accum_steps)
            total = total / accum_steps
        state.apply_update()
        return (total, True) if guard else total

    return train_step


def make_eval_step(model, *,
                   image_size: tuple[int, int] | None = None) -> Callable:
    """(images, labels) -> (correct_count, loss), with the running BN
    statistics and no gradient."""

    @torch.no_grad()
    def eval_step(images: torch.Tensor, labels: torch.Tensor):
        model.eval()
        x = images if image_size is None else prepare_inputs(
            model, images, image_size)
        logits = model(x)
        loss = cross_entropy_loss(logits, labels)
        correct = (logits.argmax(-1) == labels).sum()
        return correct, loss

    return eval_step


class Trainer:
    """Epoch loop with the reference's logging contract: every
    ``log_every`` steps ``Epoch [e/E], Step [s/S], Loss: L`` and at the end
    ``Training complete in: <timedelta>``.

    The loss is read on the host only at a log step, which waits for the
    device there; ``step_seconds`` holds each step's host wall time, so it
    is the device's step time only when every step is logged."""

    def __init__(self, train_step: Callable, device: torch.device, *,
                 log_every: int = 100, log_rank: int | None = None,
                 verbose: bool = True, ckpt_dir: str | None = None,
                 ckpt_every: int = 0,
                 state_for_checkpoint: Callable | None = None,
                 ckpt_writer: bool = True):
        """``log_rank`` r gives the data-parallel line ``Rank [r], Epoch
        [e/E], Step [s/S], Loss: L`` (reference mnist_distributed.py:104-
        106); ``verbose=False`` prints nothing (every rank but the one
        that logs).

        ``ckpt_every`` > 0 (with ``ckpt_dir``) saves every N optimizer
        steps in the single-device format (``train/checkpoint.py``'s
        ``AsyncSaver``). ``state_for_checkpoint`` maps the live state to
        what is saved (``DataParallel.unshard_state``, which every rank
        must call); only a ``ckpt_writer`` writes it. ``ckpt_timings``
        holds each save's (step, copy seconds, write seconds)."""
        self.train_step = train_step
        self.device = device
        self.log_every = log_every
        self.log_rank = log_rank
        self.verbose = verbose
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every if ckpt_dir else 0
        self.state_for_checkpoint = state_for_checkpoint or (lambda s: s)
        self.ckpt_writer = ckpt_writer
        self._saver = None
        self.ckpt_timings: list[tuple[int, float, float]] = []
        self.losses: list[float] = []
        self.step_seconds: list[float] = []
        self.elapsed: timedelta | None = None

    def _maybe_checkpoint(self, state, opt_step: int) -> None:
        """``opt_step`` is a host-side counter of the optimizer steps."""
        if not self.ckpt_every or opt_step % self.ckpt_every:
            return
        view = self.state_for_checkpoint(state)
        if not self.ckpt_writer:
            return
        if self._saver is None:
            from tpu_sandbox_torch.train.checkpoint import AsyncSaver

            self._saver = AsyncSaver(self.ckpt_dir)
        if self._saver.save(view, opt_step):
            if self.verbose:
                print(f"checkpoint saved at step {opt_step}")
        elif self.verbose:
            print(
                f"checkpoint SKIPPED at step {opt_step}: {self.ckpt_dir} "
                "already holds a later step (stale dir from a previous run? "
                "pass --resume or a fresh --ckpt-dir)"
            )

    def fit(self, state: TrainState, loader, epochs: int, *,
            set_epoch: bool = False, prefetch: bool = False) -> TrainState:
        """Run ``epochs`` epochs. ``set_epoch=False`` keeps the reference's
        quirk of never reshuffling across epochs (no ``sampler.set_epoch``);
        ``prefetch`` wraps the loader in a ``PrefetchLoader`` (same batches,
        same order, assembled and pinned on the host, and their copies to
        the device enqueued, while the previous step runs; the copies go on
        the producer thread's current stream, the default stream, so on
        the device they still run after the step's kernels)."""
        if prefetch and not isinstance(loader, PrefetchLoader):
            loader = PrefetchLoader(loader, stage=lambda x, y: to_device(
                x, y, self.device, non_blocking=True))
        start = time.monotonic()
        total_step = len(loader)
        opt_step = int(state.step)                  # resume-safe seed
        try:
            for epoch in range(epochs):
                if set_epoch:
                    loader.set_epoch(epoch)
                for i, (images, labels) in enumerate(loader):
                    t_step = time.monotonic()
                    loss = self.train_step(*to_device(images, labels,
                                                      self.device))
                    opt_step += 1
                    self._maybe_checkpoint(state, opt_step)
                    if (i + 1) % self.log_every == 0:
                        loss_val = float(loss)
                        self.losses.append(loss_val)
                        self._log(epoch, epochs, i, total_step, loss_val)
                    self.step_seconds.append(time.monotonic() - t_step)
        finally:
            if self._saver is not None:
                # drain the in-flight write even when the loop raised
                self._saver.close()
                self.ckpt_timings += self._saver.timings
                self._saver = None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.elapsed = timedelta(seconds=time.monotonic() - start)
        if self.verbose:
            print("Training complete in: " + str(self.elapsed))
        return state

    def _log(self, epoch, epochs, i, total_step, loss_val) -> None:
        if not self.verbose:
            return
        rank = ("" if self.log_rank is None
                else "Rank [{}], ".format(self.log_rank))
        print(rank + "Epoch [{}/{}], Step [{}/{}], Loss: {:.4f}".format(
            epoch + 1, epochs, i + 1, total_step, loss_val))


# -- elastic / resumable training -----------------------------------------

class Preempted(RuntimeError):
    """Raised by ``train_resumable`` after a SIGTERM-initiated checkpoint:
    state is saved, the process should exit with ``exit_code`` so the
    supervisor restarts it without charging the restart budget."""

    exit_code = PREEMPTED_EXIT_CODE

    def __init__(self, step: int):
        super().__init__(
            f"preempted at optimizer step {step}; checkpoint saved"
        )
        self.step = step


class AbortOnAnomaly(RuntimeError):
    """``max_bad_steps`` consecutive non-finite losses: the run is
    diverging, not glitching — restarting would replay the same batches
    into the same blowup, so fail for real (charges the restart budget)."""


class PreemptionHandler:
    """SIGTERM → finish the in-flight step, checkpoint, exit preempted.

    The handler itself only flips a flag (a signal handler that touched
    the KV client could re-enter its request lock mid-call and deadlock);
    the work happens at the next step boundary via :meth:`requested`,
    which also propagates the preemption through the KV store, where
    peers that never received the signal learn of it. Install it after
    ``init_process_group``, so that this handler owns SIGTERM.
    """

    def __init__(self, kv=None, key: str = PREEMPT_KEY):
        self.kv = kv
        self.key = key
        self._flag = False
        self._announced = False
        self._prev = None

    def install(self) -> "PreemptionHandler":
        try:
            self._prev = signal.signal(signal.SIGTERM, self._on_signal)
        except ValueError:
            self._prev = None  # not the main thread (tests); KV still works
        return self

    def uninstall(self) -> None:
        if self._prev is not None:
            try:
                signal.signal(signal.SIGTERM, self._prev)
            except ValueError:
                pass
            self._prev = None

    def _on_signal(self, signum, frame) -> None:
        self._flag = True  # flag only — see class docstring

    def preempt_now(self) -> None:
        """Programmatic preemption (tests)."""
        self._flag = True

    def requested(self) -> bool:
        """True once this rank should stop: locally signaled or a peer
        announced through the store. Call at step boundaries only."""
        if self._flag:
            if self.kv is not None and not self._announced:
                try:
                    self.kv.set(self.key, b"1")
                except Exception:
                    pass  # store gone: still honor the local signal
                self._announced = True
            return True
        if self.kv is not None:
            try:
                if self.kv.try_get(self.key) is not None:
                    self._flag = True
                    return True
            except Exception:
                pass
        return False


def _host_loss(loss) -> float:
    return float(torch.as_tensor(loss).detach().reshape(-1)[0])


@dataclass
class ResumableReport:
    resumed_step: int | None  # optimizer step restored from, None = fresh
    start_epoch: int
    start_offset: int
    steps_applied: int  # optimizer updates this call actually performed
    skipped_nonfinite: int
    final_step: int
    losses: list[float]


def build_elastic_checkpoint(
    directory,
    *,
    dp,
    state: TrainState,
    template: dict,
    rank: int,
    world_size: int,
    sharded: bool | None = None,
    kv=None,
    injector=None,
    verify_interval: float = 0.0,
    commit_timeout: float = 60.0,
    generation: int | str | None = None,
    keep: int = 3,
    verbose: bool = True,
    compress: bool = False,
):
    """Build the (save_fn, restore_fn, verifier) triple ``train_resumable``
    consumes, picking the checkpoint backend for an elastic run.
    ``template`` is the global host template in JAX's leaf paths
    (``utils/bridge.py::state_template`` of the state before
    ``dp.shard_state``); ``restore_fn`` loads into ``state`` in place.

    ``sharded=None`` selects the sharded backend; ZeRO requires it (rank
    0's ``HostCheckpoint`` would drop every other rank's optimizer rows).

    - save: each rank hands ``dp.host_view`` and ``dp.checkpoint_spec`` to
      :class:`ShardedCheckpoint`; rank 0 seals with the manifest after the
      two-phase commit. ``injector.maybe_fire_commit`` is wired into the
      commit window.
    - restore: at an unchanged world size each rank reads rank 0's shard
      and its own (``restore_partial``) and places them with
      ``dp.shard_state_local``; anything surprising falls back to the full
      restore, which reshards: at an unchanged world size every rank gets
      its own BN replica back bitwise, at a changed one per-replica leaves
      fold to replica 0 and ZeRO rows are cut for the new world.
    - verifier: a rank-0 :class:`CheckpointVerifier` when
      ``verify_interval`` > 0 (the caller starts and stops it).
    """
    from tpu_sandbox_torch.train.checkpoint import (
        CheckpointVerifier,
        HostCheckpoint,
        ShardedCheckpoint,
        fold_per_replica,
    )

    if sharded is None:
        sharded = True
    # the error-feedback residual's slot: leaves a template does not name
    # are never restored
    template = dp.checkpoint_template(template)
    if dp.zero and not sharded:
        raise ValueError(
            "ZeRO optimizer-state sharding needs the sharded checkpoint "
            "backend: HostCheckpoint is rank-0-only and would lose every "
            "other rank's optimizer shard"
        )

    if not sharded:
        hc = HostCheckpoint(directory, keep=keep)

        def restore_fn():
            res = hc.restore(template)
            if res is None:
                return None
            host_state, meta = res
            return dp.shard_state(state, host_state), meta

        def save_fn(dstate, step, epoch, offset):
            if rank == 0:
                hc.save(dstate.host_view(), step, epoch=epoch, offset=offset)

        return save_fn, restore_fn, None

    sc = ShardedCheckpoint(
        directory, rank=rank, world_size=world_size, kv=kv, keep=keep,
        commit_timeout=commit_timeout, generation=generation,
        verbose=verbose, compress=compress,
    )

    def save_fn(dstate, step, epoch, offset):
        hook = None
        if injector is not None:
            def hook(phase, _step=step):
                injector.maybe_fire_commit(_step)
        sc.save(
            dp.host_view(dstate), dp.checkpoint_spec(dstate), step,
            epoch=epoch, offset=offset, commit_hook=hook,
        )

    def restore_fn():
        if dp.size == world_size:
            try:
                res = sc.restore_partial(template)
            except Exception as e:
                if verbose:
                    print(f"[elastic] partial restore unavailable ({e}); "
                          "falling back to full restore", flush=True)
            else:
                if res is None:
                    return None
                local, meta = res
                return dp.shard_state_local(state, local, template), meta
        res = sc.restore(template)
        if res is None:
            return None
        host_state, meta = res
        if int(meta.get("world_size", world_size)) == world_size:
            return dp.shard_state(state, host_state,
                                  stats_expanded=True), meta
        return dp.shard_state(state, fold_per_replica(host_state,
                                                      template)), meta

    verifier = None
    if verify_interval > 0 and rank == 0:
        verifier = CheckpointVerifier(sc, interval=verify_interval)
    return save_fn, restore_fn, verifier


def train_resumable(
    step_fn: Callable,
    state: TrainState,
    loader,
    epochs: int,
    *,
    save_fn: Callable | None = None,
    restore_fn: Callable | None = None,
    ckpt_every: int = 0,
    preemption: PreemptionHandler | None = None,
    agree_fn: Callable[[bool], bool] | None = None,
    injector=None,
    max_bad_steps: int = 3,
    log_every: int = 100,
    log_rank: int | None = None,
    verbose: bool = True,
    set_epoch: bool = False,
    prefetch: bool = False,
    device: torch.device | None = None,
) -> tuple[TrainState, ResumableReport]:
    """The crash-safe epoch loop: checkpoint every ``ckpt_every`` optimizer
    steps with data-order state, resume exactly where the stream stood,
    survive preemption, and refuse to train on garbage.

    ``step_fn(state, images, labels) -> (loss, applied)`` updates the state
    in place, or leaves it bitwise as it was and returns ``applied=False``
    when the loss is not finite (``make_train_step(guard=True)``,
    ``DataParallel.train_step(guard=True)``). With ``device`` the batches
    go there first (``to_device``).

    - **Exact data order.** Each checkpoint records (epoch, batch offset);
      resume skips exactly the consumed batches of the loader's
      deterministic order — no batch replayed, none skipped.
    - **Preemption.** ``preemption.requested()`` is polled every boundary;
      when set the in-flight step has finished, so the loop saves and
      raises :class:`Preempted`. In a multi-process job ``agree_fn`` (an
      OR over the ranks, one all-reduce of a flag) puts every rank at the
      same verdict at the same boundary.
    - **Anomaly guard.** An update that was not applied counts against
      ``max_bad_steps`` consecutive anomalies, after which
      :class:`AbortOnAnomaly` ends the run as a real failure.
    - **Fault injection.** ``injector.maybe_fire(opt_step)`` runs after
      every applied update.

    ``restore_fn() -> (state, meta) | None`` and
    ``save_fn(state, step, epoch, offset)`` keep this loop agnostic of the
    checkpoint backend and of the engine's sharding.
    """
    if prefetch and not isinstance(loader, PrefetchLoader):
        loader = PrefetchLoader(loader, stage=None if device is None else (
            lambda x, y: to_device(x, y, device, non_blocking=True)))
    steps_per_epoch = len(loader)
    resumed_step = None
    start_epoch, start_offset = 0, 0
    if restore_fn is not None:
        res = restore_fn()
        if res is not None:
            state, meta = res
            resumed_step = int(meta.get("step", 0))
            # the checkpoint's data order is authoritative; derive it from
            # the step count when missing
            start_epoch = int(meta.get("epoch", resumed_step // steps_per_epoch))
            start_offset = int(
                meta.get("offset", resumed_step % steps_per_epoch)
            )
            if start_offset >= steps_per_epoch:
                start_epoch += 1
                start_offset = 0
    opt_step = resumed_step if resumed_step is not None else 0
    report = ResumableReport(
        resumed_step=resumed_step, start_epoch=start_epoch,
        start_offset=start_offset, steps_applied=0, skipped_nonfinite=0,
        final_step=opt_step, losses=[],
    )
    consecutive_bad = 0

    def checkpoint(epoch: int, offset: int) -> None:
        if save_fn is not None:
            save_fn(state, opt_step, epoch, offset)

    for epoch in range(start_epoch, epochs):
        if set_epoch:
            loader.set_epoch(epoch)
        for i, (images, labels) in enumerate(loader):
            if epoch == start_epoch and i < start_offset:
                continue  # consumed before the checkpoint: replay nothing
            if device is not None:
                images, labels = to_device(images, labels, device)
            loss, applied = step_fn(state, images, labels)
            if applied:
                opt_step += 1
                report.steps_applied += 1
                consecutive_bad = 0
            else:
                report.skipped_nonfinite += 1
                consecutive_bad += 1
                if verbose:
                    print(
                        f"non-finite loss at epoch {epoch + 1} batch "
                        f"{i + 1}; update skipped "
                        f"({consecutive_bad}/{max_bad_steps} consecutive)"
                    )
                if consecutive_bad >= max_bad_steps:
                    raise AbortOnAnomaly(
                        f"{consecutive_bad} consecutive non-finite losses "
                        f"around optimizer step {opt_step}; aborting"
                    )
            saved_here = False
            if applied and ckpt_every and opt_step % ckpt_every == 0:
                checkpoint(epoch, i + 1)
                saved_here = True
            if injector is not None and applied:
                injector.maybe_fire(opt_step)
            if preemption is not None or agree_fn is not None:
                want = preemption is not None and preemption.requested()
                stop = agree_fn(want) if agree_fn is not None else want
                if stop:
                    if preemption is not None:
                        # a rank outvoted here must still exit preempted
                        preemption.preempt_now()
                    if not saved_here:
                        checkpoint(epoch, i + 1)
                    report.final_step = opt_step
                    raise Preempted(opt_step)
            if applied and (i + 1) % log_every == 0:
                loss_val = _host_loss(loss)
                report.losses.append(loss_val)
                if verbose:
                    prefix = (
                        f"Rank [{log_rank}], " if log_rank is not None else ""
                    )
                    print(
                        "{}Epoch [{}/{}], Step [{}/{}], Loss: {:.4f}".format(
                            prefix, epoch + 1, epochs, i + 1,
                            steps_per_epoch, loss_val,
                        )
                    )
        start_offset = 0  # only the resumed epoch starts mid-stream
    report.final_step = opt_step
    return state, report
