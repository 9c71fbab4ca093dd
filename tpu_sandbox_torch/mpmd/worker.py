"""Process entry for one MPMD stage: ``python -m tpu_sandbox_torch.mpmd.worker``.
Counterpart of ``tpu_sandbox/mpmd/worker.py``, with its positional
arguments and flags plus ``--device`` (the card unless ``cpu`` is given).

Each pipeline stage is its own scheduler job (a co-gang member, see
``JobSpec.cogroup``): the scheduler spawns this module once per stage
with the agent argv placeholders, and the stages find each other through
the shared KV store:

- the stage-0 worker is the LEADER: it publishes the plan (plus the
  model, optimizer and batch every stage must agree on) to
  ``mpmd/<pipeline>/plan`` on the RAW store, and advances the slot-GC
  watermark as stages publish their checkpoint progress;
- every stage fetches the plan, draws the SAME full-model init from the
  plan seed (the LM's init is drawn on a CPU generator, so it is the same
  bits in every process and on every device), keeps its own slice, and
  runs the :class:`StageWorker` loop over a :class:`KVTransport` rooted
  at ``mpmd/<pipeline>/``.

The transport prefix lives OUTSIDE the per-job namespaces: the scheduler
sweeps ``job/<id>/`` when each stage job finishes, and cross-stage slots
must outlive any single stage's job record.

Faults: the fault plan (env) fires at the MIDDLE of the step's op list,
and agent-targeted actions (kill_agent / partition_host) are read from
this agent's own mailbox at every op boundary, so a death lands
mid-shipment. A killed worker exits nonzero; the scheduler relaunches the
same argv, which restores from its per-stage HostCheckpoint, bumps the
claim generation (``mpmd/<pipeline>/gen/<s>``) and replays into the
durable slots.

On completion each stage ships its final params over the transport (edge
``final``, the leaves in the stage tree's flatten order) and posts its
job verdict; the last stage also publishes the per-step losses.

The model json takes ``TransformerConfig``'s fields, ``dtype`` by name
(``"float32"``, ``"bfloat16"``); the optimizer json ``{"name": "sgd" |
"adam", "lr": ...}`` (``optax.sgd`` and ``optax.adam``: the port's
``SGD`` without momentum and ``Adam``).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import threading
import time

DTYPES = ("float32", "bfloat16")


def _build_tx(spec: dict):
    from tpu_sandbox_torch.train.optim import SGD, Adam, constant_schedule

    name = spec.get("name", "sgd")
    lr = spec.get("lr", 0.1)
    if name == "sgd":
        return lambda params: SGD(params, lr, momentum=0.0)
    if name == "adam":
        return lambda params: Adam(params, constant_schedule(lr))
    raise ValueError(f"unknown optimizer {name!r}")


def model_config(spec: dict):
    """The plan's model json -> ``TransformerConfig``."""
    import torch

    from tpu_sandbox_torch.models.transformer import TransformerConfig

    spec = dict(spec)
    dtype = spec.pop("dtype", "float32")
    if dtype not in DTYPES:
        raise ValueError(f"model dtype {dtype!r} not in {DTYPES}")
    return TransformerConfig(**spec, dtype=getattr(torch, dtype))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("agent_id", type=int)
    p.add_argument("kv_port", type=int)
    p.add_argument("job_id")
    p.add_argument("--stage", type=int, required=True)
    p.add_argument("--pipeline", default="pipe0",
                   help="shared transport namespace: mpmd/<pipeline>/")
    p.add_argument("--ckpt-root", required=True)
    p.add_argument("--steps", type=int, default=0)
    p.add_argument("--n-stages", type=int, default=0)
    p.add_argument("--microbatches", type=int, default=0)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--schedule-kind", default="1f1b",
                   help="schedule family: 1f1b | zb_h1 (leader only)")
    p.add_argument("--layer-split", default="",
                   help="json list of per-stage layer counts for uneven "
                   "pipelines (leader only; others read the plan)")
    p.add_argument("--model", default="", help="TransformerConfig kwargs "
                   "json (leader only; others read the plan)")
    p.add_argument("--optimizer", default="",
                   help='{"name": "sgd"|"adam", "lr": ...} json')
    p.add_argument("--batch", default="", help="[batch, seqlen] json")
    p.add_argument("--get-timeout", type=float, default=120.0)
    p.add_argument("--device", default="cuda",
                   help="the stage's device (cuda, or cpu)")
    args = p.parse_args(argv)

    import numpy as np

    from tpu_sandbox_torch.models.transformer import TransformerLM
    from tpu_sandbox_torch.mpmd.driver import StageWorker
    from tpu_sandbox_torch.mpmd.program import (
        StageProgram,
        stage_params,
        tree_leaves,
    )
    from tpu_sandbox_torch.mpmd.schedule import fetch_plan, publish_plan
    from tpu_sandbox_torch.mpmd.transport import EdgeNames, KVTransport
    from tpu_sandbox_torch.obs.tsdb import TimeSeriesFlusher
    from tpu_sandbox_torch.runtime.faults import (
        FaultInjector,
        FaultPlan,
        agent_cmd_key,
    )
    from tpu_sandbox_torch.runtime.kvstore import KVClient, for_job
    from tpu_sandbox_torch.train.checkpoint import HostCheckpoint

    kv = KVClient(port=args.kv_port)
    jobkv = for_job(kv, args.job_id)
    prefix = f"mpmd/{args.pipeline}"
    stage = args.stage

    # -- heartbeat (pausable: partition_host silences it) --------------------
    partitioned = threading.Event()
    hb_stop = threading.Event()

    def beat():
        while not hb_stop.is_set():
            if not partitioned.is_set():
                jobkv.set_ttl(f"agent_hb/{args.agent_id}",
                              repr(time.time()), 5.0)
            hb_stop.wait(1.0)

    threading.Thread(target=beat, daemon=True).start()

    # -- leader publishes the plan; everyone fetches it ----------------------
    if stage == 0:
        publish_plan(
            kv, n_stages=args.n_stages, microbatches=args.microbatches,
            steps=args.steps, seed=args.seed, prefix=prefix,
            kind=args.schedule_kind,
            layer_split=(json.loads(args.layer_split)
                         if args.layer_split else None),
            extra={
                "model": json.loads(args.model or "{}"),
                "optimizer": json.loads(args.optimizer or "{}"),
                "batch": json.loads(args.batch or "[8, 16]"),
            })
    plan = fetch_plan(kv, prefix=prefix, timeout=args.get_timeout)
    n_stages, microbatches = plan["n_stages"], plan["microbatches"]
    kind, layer_split = plan["kind"], plan["layer_split"]

    config = model_config(plan["model"])
    tx = _build_tx(plan["optimizer"])
    b, s = plan["batch"]
    rng = np.random.default_rng(plan["seed"])
    tokens = rng.integers(0, config.vocab_size, size=(b, s)).astype(np.int32)
    targets = ((tokens + 7) % config.vocab_size).astype(np.int32)

    # every stage draws the same init from the plan seed and keeps only
    # its own slice — deterministic, so nothing needs shipping
    flat = TransformerLM(config, seed=plan["seed"]).state_dict()
    program = StageProgram(config, tx, stage, n_stages, microbatches,
                           device=args.device, layer_split=layer_split)
    transport = KVTransport(kv, prefix=f"{prefix}/")
    generation = kv.add(f"{prefix}/gen/{stage}", 1)
    worker = StageWorker(
        program,
        stage_params(flat, stage, n_stages, layer_split=layer_split),
        None, transport, generation=generation,
        checkpoint=HostCheckpoint(f"{args.ckpt_root}/stage-{stage}"),
        get_timeout=args.get_timeout, kind=kind)
    del flat
    worker.restore_checkpoint()

    # -- fault plan + agent mailbox, polled at every op boundary -------------
    injector = FaultInjector(FaultPlan.from_env(), rank=stage, kv=jobkv,
                             agent_id=args.agent_id)
    mid_op = len(worker.ops) // 2

    def poll_mailbox():
        raw = jobkv.try_get(agent_cmd_key(args.agent_id))
        if raw is None:
            return
        jobkv.delete(agent_cmd_key(args.agent_id))
        cmd = json.loads(raw)
        if cmd["action"] == "kill_agent":
            os._exit(9)  # host death: no cleanup, no verdict
        elif cmd["action"] == "partition_host":
            dur = float(cmd.get("arg") or 3.0)
            partitioned.set()  # heartbeats stop; peers just see stall
            time.sleep(dur)
            partitioned.clear()

    def on_op(step, idx):
        if idx == mid_op:
            # step-boundary faults land MID-schedule: the nastiest
            # recovery point, with half the step's slots out
            injector.maybe_fire(step)
        poll_mailbox()

    worker.on_op = on_op

    # -- online bubble publication -------------------------------------------
    # run_step sets the mpmd.bubble_fraction gauge per step; flushing the
    # registry through the tsdb ring after every step makes it durable,
    # so the health plane can rule on it and fleetop renders it live
    flusher = TimeSeriesFlusher(
        kv, proc=f"mpmd-{args.pipeline}-s{stage}".replace("/", "-"))

    # -- the training loop ---------------------------------------------------
    edges = ([EdgeNames(i).act for i in range(n_stages - 1)]
             + [EdgeNames(i).grad for i in range(n_stages - 1)])
    released = -1
    for step in range(worker.next_step, plan["steps"]):
        worker.run_step(
            step,
            tokens=tokens if program.is_first else None,
            targets=targets if program.is_last else None)
        flusher.flush()
        worker.save_checkpoint(step)
        kv.set(f"{prefix}/ckpt/{stage}", str(step))
        if program.is_last:
            # durable per-step loss: a relaunched worker's in-memory dict
            # only covers replayed steps (replays write identical values)
            kv.set(f"{prefix}/loss/{step}", repr(worker.losses[step]))
        if stage == 0:
            # leader-driven GC: drop slots every stage has made durable
            marks = [int(kv.try_get(f"{prefix}/ckpt/{s2}") or -1)
                     for s2 in range(n_stages)]
            watermark = min(marks)
            while released < watermark - 1:
                released += 1
                for edge in edges:
                    transport.release_step(edge, released)

    # -- results -------------------------------------------------------------
    transport.put("final", 0, stage,
                  tree_leaves(worker.host_state()["params"]))
    if program.is_last:
        kv.set(f"{prefix}/losses", json.dumps(
            [float(kv.get(f"{prefix}/loss/{s2}"))
             for s2 in range(plan["steps"])]))

    if args.agent_id == 0:
        jobkv.set("job/done", json.dumps({
            "ok": True, "preempted": False,
            "reason": f"stage {stage} finished {plan['steps']} steps",
            "summary": "", "restarts": 0, "preemptions": 0,
            "generations": generation,
        }))
    hb_stop.set()
    kv.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
