"""Stage workers and the in-process MPMD pipeline. Counterpart of
``tpu_sandbox/mpmd/driver.py``: ``StageKilled``, ``StageWorker`` and
``MPMDPipeline``.

:class:`StageWorker` is the per-stage execution loop: it walks the stage's
op list, pulling activations and cotangents off the transport
(claim-once), running the stage's programs, shipping its own outputs, and
applying the stage-local optimizer once a step on the microbatch grads
folded in descending order. The same loop backs both deployment shapes:
:class:`MPMDPipeline` drives S workers in one process, one thread a stage
(on one card, or the CPU), and ``mpmd/worker.py`` runs one worker a
process under the cluster scheduler over a
:class:`~tpu_sandbox_torch.mpmd.transport.KVTransport`.

Where JAX pulls each microbatch's grads to the host and folds them there,
the port keeps them where they were computed and folds them there: an
fp32 add is the same bits on the card and the host, and at the LM's bench
width a stage's grads are ~0.45 GB a microbatch. The cost is memory: up
to M grad trees of the stage live until the step's apply. Op timings
synchronise the stage's device inside the timer (JAX's
``block_until_ready``), so ``op_seconds`` and the bubble measure the
card's work, not the enqueue. Stages on one card share its stream.

Recovery model (the reason the transport is durable): a stage that dies
mid-step is relaunched, restores params and optimizer state from its own
:class:`~tpu_sandbox_torch.train.checkpoint.HostCheckpoint`, and replays
from the checkpointed step + 1. Replay re-ships slots the dead generation
already produced (``put`` is a no-op on complete slots) and re-consumes
its inputs under a NEW claim generation, while the surviving stages never
rewind. Slots are garbage-collected only up to the minimum step every
stage has made durable. Every F/B/W is a deterministic function of
shipped values, so the replayed lineage lands bitwise on the unfaulted
run's parameters.
"""

from __future__ import annotations

import threading
import time

import numpy as np
import torch

from tpu_sandbox_torch.mpmd.program import (
    StageProgram,
    accumulate_descending,
    load_opt_state,
    merge_stage_params,
    opt_state_tree,
    stage_params,
    to_tensor,
    tree_leaves,
    tree_map,
)
from tpu_sandbox_torch.mpmd.schedule import bubble_fraction, ops_for
from tpu_sandbox_torch.mpmd.transport import EdgeNames, LocalTransport
from tpu_sandbox_torch.obs.metrics import get_registry
from tpu_sandbox_torch.obs.record import get_recorder
from tpu_sandbox_torch.train.checkpoint import HostCheckpoint
from tpu_sandbox_torch.utils.device import resolve_device


class StageKilled(RuntimeError):
    """In-process stand-in for a stage-host crash: raised by the
    ``fail_at`` hook mid-step, leaving half-shipped slots and an
    un-applied optimizer step behind."""


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


def synchronize(device: torch.device) -> None:
    """Wait for the work queued on ``device``'s current stream (a no-op
    on the CPU, where ops run as they are called)."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


class StageWorker:
    """Executes one stage's schedule against a transport.

    ``generation`` is the claim-once namespace: a relaunched worker for
    the same stage MUST carry a higher generation so its replay can
    re-consume slots the dead lineage already claimed. ``params`` (and
    ``opt_state``, a tree of ``opt_state_tree``'s form, or None for a
    fresh optimizer) are copied to the stage's device; the worker's
    tensors are its own.
    """

    def __init__(self, program: StageProgram, params, opt_state, transport,
                 *, generation: int = 0, checkpoint: HostCheckpoint | None
                 = None, get_timeout: float = 60.0, kind: str = "1f1b"):
        self.program = program
        self.transport = transport
        self.generation = generation
        self.checkpoint = checkpoint
        self.get_timeout = get_timeout
        self.kind = kind
        self.params = program.place(params, copy=True)
        self.opt_state = program.init_opt_state(self.params)
        if opt_state is not None:
            load_opt_state(self.opt_state, opt_state)
        # the starting state on the host, for a relaunch with nothing to
        # restore (the params are updated in place)
        self._template = {"params": tree_map(_host, self.params),
                          "opt_state": opt_state}
        self.ops = ops_for(kind, program.stage, program.n_stages,
                           program.microbatches)
        s = program.stage
        self.act_in = EdgeNames(s - 1).act if not program.is_first else None
        self.act_out = EdgeNames(s).act if not program.is_last else None
        self.grad_in = EdgeNames(s).grad if not program.is_last else None
        self.grad_out = EdgeNames(s - 1).grad if not program.is_first else None
        self.next_step = 0
        self.losses: dict[int, float] = {}
        self.step_seconds: dict[int, float] = {}
        #: op -> measured compute seconds, one entry per executed op (the
        #: durations the "stage:op" spans carry), for autotune_plan
        self.op_seconds: dict[str, list[float]] = {}
        #: step -> measured bubble fraction (1 - compute/wall), also the
        #: ``mpmd.bubble_fraction`` gauge
        self.bubble_by_step: dict[int, float] = {}
        self.applied_steps: list[int] = []
        #: (step, op_index) at which to raise StageKilled — fault hook
        self.fail_at: tuple[int, int] | None = None
        #: optional callback at every op boundary ``(step, op_index)`` —
        #: the process worker's fault-plan trigger and mailbox poll
        self.on_op = None

    # -- fault hook ----------------------------------------------------------

    def _maybe_fail(self, step: int, op_index: int) -> None:
        if self.fail_at is not None and self.fail_at == (step, op_index):
            self.fail_at = None
            raise StageKilled(
                f"stage {self.program.stage} killed at step {step} "
                f"op {op_index}")

    def _consume(self, edge: str, step: int, mb: int) -> None:
        if not self.transport.claim(edge, step, mb,
                                    generation=self.generation):
            raise RuntimeError(
                f"duplicate delivery: stage {self.program.stage} "
                f"generation {self.generation} already consumed "
                f"{edge}/{step}/{mb}")

    # -- one optimizer step --------------------------------------------------

    def run_step(self, step: int, *, tokens=None, targets=None) -> None:
        prog, tr = self.program, self.transport
        M = prog.microbatches
        if prog.is_first:
            if tokens is None:
                raise ValueError("stage 0 needs the token batch")
            tokens_mb = np.asarray(tokens).reshape(
                M, -1, np.shape(tokens)[-1])
        if prog.is_last:
            if targets is None:
                raise ValueError("last stage needs the target batch")
            targets_mb = np.asarray(targets).reshape(
                M, -1, np.shape(targets)[-1])
        stash: dict[int, object] = {}
        per_mb: dict[int, dict] = {}
        loss = np.float32(0.0)
        # "stage:wait" spans bracket the blocking transport gets,
        # "stage:op" spans the stage's compute, and the closing
        # "stage:step" span carries the measured bubble
        rec = get_recorder()
        s = prog.stage
        zb = self.kind == "zb_h1"
        compute_s = 0.0
        # one clock for the gauge and the spans: the "stage:step" span and
        # each "stage:op" span carry the readings the gauge is computed
        # from, so the trace's bubble is the gauge's by construction
        t_step = time.monotonic()

        def timed(op_name, mb, fn, *fn_args):
            # the device synchronised inside the timer: these durations
            # feed schedule.autotune_plan
            nonlocal compute_s
            t_op = time.monotonic()
            out = fn(self.params, *fn_args)
            synchronize(prog.device)
            dt = time.monotonic() - t_op
            compute_s += dt
            self.op_seconds.setdefault(op_name, []).append(dt)
            rec.complete("stage:op", t_op, dur=dt,
                         args={"stage": s, "step": step,
                               "op": op_name, "mb": mb})
            return out

        def waited(edge, mb, op_name):
            t_wait = time.monotonic()
            self._consume(edge, step, mb)
            (v,) = tr.get(edge, step, mb, timeout=self.get_timeout)
            rec.complete("stage:wait", t_wait,
                         args={"stage": s, "step": step,
                               "op": op_name, "mb": mb})
            return prog.place(v)

        for idx, (op, m) in enumerate(self.ops):
            self._maybe_fail(step, idx)
            if self.on_op is not None:
                self.on_op(step, idx)
            if op == "F":
                if prog.is_first:
                    x = prog.place(tokens_mb[m])
                else:
                    x = waited(self.act_in, m, "F")
                stash[m] = x
                if not prog.is_last:
                    h_out = timed("F", m, prog.fwd, x)
                    tr.put(self.act_out, step, m, [h_out])
            elif op == "B":
                if prog.is_last:
                    x = stash[m] if zb else stash.pop(m)
                    tg = prog.place(targets_mb[m])
                    if zb:
                        lv, gh, st = timed("B", m, prog.loss_bwd_input, x, tg)
                        stash[m] = (tg, st)  # W: pure weight grads
                    else:
                        lv, gp, gh = timed("B", m, prog.loss_grad, x, tg)
                    # ship the upstream cotangent before anything else:
                    # the previous stage is waiting on it
                    tr.put(self.grad_out, step, m, [gh])
                    loss = loss + np.float32(lv.item())
                    if not zb:
                        per_mb[m] = gp
                elif zb:
                    g = waited(self.grad_in, m, "B")
                    x = stash[m]
                    if not prog.is_first:
                        gx, st = timed("B", m, prog.bwd_input, x, g)
                        tr.put(self.grad_out, step, m, [gx])
                        stash[m] = st  # per-layer pairs, W is chain-free
                    else:
                        # stage 0's chain rides inside W (nothing
                        # upstream consumes its grad-input)
                        stash[m] = (x, g)
                else:
                    g = waited(self.grad_in, m, "B")
                    gp, gx = timed("B", m, prog.bwd, stash.pop(m), g)
                    if not prog.is_first:
                        tr.put(self.grad_out, step, m, [gx])
                    per_mb[m] = gp
            else:  # "W": the deferred grad-weight pass (ZB-H1 only)
                if prog.is_last:
                    tg, st = stash.pop(m)
                    gp = timed("W", m, prog.loss_bwd_weight, tg, st)
                elif prog.is_first:
                    x, g = stash.pop(m)
                    gp = timed("W", m, prog.bwd_weight_chain, x, g)
                else:
                    gp = timed("W", m, prog.bwd_weight, stash.pop(m))
                per_mb[m] = gp
        grads = accumulate_descending(per_mb)
        timed("A", -1, prog.apply_grads, self.opt_state, grads)
        wall = time.monotonic() - t_step
        self.step_seconds[step] = wall
        bubble = max(0.0, 1.0 - compute_s / wall) if wall > 0 else 0.0
        self.bubble_by_step[step] = bubble
        get_registry().gauge("mpmd.bubble_fraction",
                             labels={"stage": str(s)}).set(round(bubble, 6))
        rec.complete("stage:step", t_step, dur=wall,
                     args={"stage": s, "step": step,
                           "bubble": round(bubble, 6)})
        if prog.is_last:
            self.losses[step] = float(loss)
        self.applied_steps.append(step)
        self.next_step = step + 1

    # -- durability ----------------------------------------------------------

    def host_state(self) -> dict:
        """Params and optimizer state as CPU tensors."""
        return {"params": tree_map(_host, self.params),
                "opt_state": {k: v if k == "count" else tree_map(_host, v)
                              for k, v in opt_state_tree(
                                  self.opt_state, self.params).items()}}

    def save_checkpoint(self, step: int) -> None:
        if self.checkpoint is not None:
            self.checkpoint.save(self.host_state(), step, epoch=0, offset=0)

    def restore_checkpoint(self) -> int | None:
        """Restore params and optimizer state (in place) from the newest
        valid checkpoint; returns the restored step (``next_step`` becomes
        step + 1) or ``None`` for a fresh start (``next_step`` 0)."""
        if self.checkpoint is None:
            return None
        template = {"params": self.params,
                    "opt_state": opt_state_tree(self.opt_state, self.params)}
        out = self.checkpoint.restore(template)
        if out is None:
            self.next_step = 0
            return None
        state, meta = out
        for t, v in zip(tree_leaves(self.params),
                        tree_leaves(state["params"])):
            t.copy_(to_tensor(v))
        load_opt_state(self.opt_state, state["opt_state"])
        self.next_step = int(meta["step"]) + 1
        return int(meta["step"])


def _stage_devices(devices, n_stages: int) -> list[torch.device]:
    if devices is None or isinstance(devices, (str, torch.device)):
        return [resolve_device(devices)] * n_stages
    return [resolve_device(d) for d in devices]


class MPMDPipeline:
    """In-process MPMD harness: S stage workers, one thread each, over a
    shared transport. ``devices``: one device for every stage (None: the
    card) or a list, one a stage. ``tx(params)`` builds a stage's
    optimizer (``train/optim.py``).

    ``train`` runs the leader loop: launch stage threads, advance the
    release watermark (GC slots every stage has made durable), and — with
    ``recover=True`` — relaunch any stage that dies with
    :class:`StageKilled` from its checkpoint under a new claim
    generation.
    """

    def __init__(self, config, tx, *, n_stages: int = 2,
                 microbatches: int = 4, transport=None, devices=None,
                 ckpt_root=None, get_timeout: float = 60.0,
                 kind: str = "1f1b", layer_split=None):
        self.config = config
        self.tx = tx
        self.n_stages = n_stages
        self.microbatches = microbatches
        self.kind = kind
        self.layer_split = layer_split
        self.transport = LocalTransport() if transport is None else transport
        self.devices = _stage_devices(devices, n_stages)
        self.programs = [
            StageProgram(config, tx, s, n_stages, microbatches,
                         device=self.devices[s], layer_split=layer_split)
            for s in range(n_stages)
        ]
        self.ckpt_root = ckpt_root
        self.get_timeout = get_timeout
        self.workers: list[StageWorker] = []
        self._generations = [0] * n_stages
        self._released_through = -1

    # -- construction --------------------------------------------------------

    def _checkpoint_for(self, stage: int) -> HostCheckpoint | None:
        if self.ckpt_root is None:
            return None
        return HostCheckpoint(f"{self.ckpt_root}/stage-{stage}")

    def init_from_flat(self, flat_params: dict) -> None:
        """Build the stage workers from a ``TransformerLM`` state dict."""
        self.workers = [
            StageWorker(self.programs[s],
                        stage_params(flat_params, s, self.n_stages,
                                     layer_split=self.layer_split),
                        None, self.transport,
                        checkpoint=self._checkpoint_for(s),
                        get_timeout=self.get_timeout, kind=self.kind)
            for s in range(self.n_stages)
        ]

    def init(self, seed: int = 0) -> None:
        """The LM's init from ``seed`` (drawn on the CPU: the same bits on
        every device), sliced to the stages."""
        from tpu_sandbox_torch.models.transformer import TransformerLM

        self.init_from_flat(TransformerLM(self.config, seed=seed).state_dict())

    # -- recovery ------------------------------------------------------------

    def respawn_stage(self, stage: int) -> StageWorker:
        """Relaunch a dead stage: fresh worker, params restored from the
        stage's own checkpoint, claim generation bumped so replay can
        re-consume already-claimed slots."""
        old = self.workers[stage]
        self._generations[stage] += 1
        worker = StageWorker(
            old.program, old._template["params"],
            old._template["opt_state"], self.transport,
            generation=self._generations[stage],
            checkpoint=old.checkpoint, get_timeout=self.get_timeout,
            kind=old.kind)
        worker.restore_checkpoint()
        # carry the audit trail across the relaunch
        worker.applied_steps = list(old.applied_steps)
        worker.losses = dict(old.losses)
        worker.step_seconds = dict(old.step_seconds)
        self.workers[stage] = worker
        return worker

    # -- leader loop ---------------------------------------------------------

    def _stage_loop(self, stage: int, steps: int, tokens, targets,
                    done: list[int], errors: dict) -> None:
        worker = self.workers[stage]
        try:
            for step in range(worker.next_step, steps):
                worker.run_step(
                    step,
                    tokens=tokens if worker.program.is_first else None,
                    targets=targets if worker.program.is_last else None)
                worker.save_checkpoint(step)
                done[stage] = step
        except BaseException as e:  # noqa: BLE001 — the leader re-raises
            errors[stage] = e

    def release_through(self, step: int) -> None:
        """GC every edge's slots up to ``step`` inclusive (only once ALL
        stages have checkpointed past ``step``)."""
        for s in range(self._released_through + 1, step + 1):
            for edge in ([EdgeNames(i).act for i in range(self.n_stages - 1)]
                         + [EdgeNames(i).grad
                            for i in range(self.n_stages - 1)]):
                self.transport.release_step(edge, s)
        self._released_through = max(self._released_through, step)

    def train(self, steps: int, tokens, targets, *, recover: bool = False,
              release: bool = True) -> list[float]:
        """Run the pipeline to ``steps`` optimizer steps on a fixed batch;
        returns the per-step losses. With ``recover=True``, stages dying
        with StageKilled are respawned from checkpoint and the run
        continues to the same end state."""
        if not self.workers:
            raise RuntimeError("call init()/init_from_flat() first")
        done = [w.next_step - 1 for w in self.workers]
        errors: dict[int, BaseException] = {}

        def launch(stage: int) -> threading.Thread:
            t = threading.Thread(
                target=self._stage_loop,
                args=(stage, steps, tokens, targets, done, errors),
                name=f"mpmd-stage-{stage}", daemon=True)
            t.start()
            return t

        threads = {s: launch(s) for s in range(self.n_stages)}
        while threads:
            if release and self.ckpt_root is not None:
                watermark = min(done)
                if watermark > self._released_through:
                    self.release_through(watermark)
            for stage in list(threads):
                threads[stage].join(timeout=0.01)
                if threads[stage].is_alive():
                    continue
                del threads[stage]
                err = errors.pop(stage, None)
                if err is None:
                    continue
                if recover and isinstance(err, StageKilled):
                    worker = self.respawn_stage(stage)
                    done[stage] = worker.next_step - 1
                    threads[stage] = launch(stage)
                else:
                    # surviving threads exit via their get() timeouts
                    raise err
        if errors:
            raise next(iter(errors.values()))
        if release:
            self.release_through(steps - 1)
        last = self.workers[-1]
        return [last.losses[s] for s in sorted(last.losses)]

    # -- results / metrics ---------------------------------------------------

    def merged_params(self) -> dict:
        """The ``TransformerLM`` state dict of the trained stages (CPU)."""
        return merge_stage_params([w.params for w in self.workers])

    def bubble_fraction(self) -> float:
        return bubble_fraction(self.n_stages, self.microbatches)

    def stage_step_seconds(self) -> list[dict[int, float]]:
        return [dict(w.step_seconds) for w in self.workers]

    def measured_op_costs(self) -> dict[int, dict[str, float]]:
        """Median measured compute seconds per (stage, op) — the input
        :func:`~tpu_sandbox_torch.mpmd.schedule.autotune_plan` expects.
        Fused runs report F/B/A; ZB runs additionally report W."""
        out: dict[int, dict[str, float]] = {}
        for s, w in enumerate(self.workers):
            out[s] = {op: float(np.median(ts))
                      for op, ts in w.op_seconds.items() if ts}
        return out
