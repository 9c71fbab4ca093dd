"""Data-parallel big-image MNIST training: the port of
``mnist_distributed.py`` (same flags, defaults and log lines as far as
ported).

    python -m tpu_sandbox_torch.mnist_distributed -g 1 --limit-steps 10

One OS process a rank, as the reference runs (mnist_distributed.py:48-
127): ``-n`` nodes of ``-g`` ranks, global rank ``nr * gpus + local``
(:49), NCCL with one GPU a rank, or gloo ranks on the CPU with
``--force-cpu``. Each rank builds the ConvNet from seed 0 (``--plan``,
``auto`` as ``mnist_onegpu``), trains on its ``DistributedSampler`` shard
(``ShardedBatchLoader`` with ``rank=``, never reshuffled across epochs:
the reference calls no ``set_epoch``), batch ``--batch-size`` a rank,
through ``parallel/data_parallel.py`` (mean gradients, per-rank BN
statistics; ``--zero`` ZeRO-1, ``--grad-compress none|bf16|int8`` with
error feedback unless ``--no-error-feedback``, ``--overlap-grad-sync``
with ``--bucket-mb`` buckets), and rank 0 prints ``Rank [0], Epoch
[e/E], Step [s/S], Loss: L`` every ``--log-every`` steps and the
wall-clock total. ``-g 1``
runs its rank in the calling process; more ranks are spawned (the
``--multiprocess`` flag is accepted for launch compatibility). ``-n 2
-nr 0`` and ``-n 2 -nr 1``, started on two machines (or twice on one)
with the same ``MASTER_ADDR``/``MASTER_PORT``, form one job (a node of
one rank runs it in its own process). ``--prefetch`` assembles and pins
the next batch and enqueues its copy to the rank's device in a background
thread (on the card that copy runs on the default stream, after the
current step's kernels).

Checkpoints (``--ckpt-dir D``, ``--ckpt-every N``, ``--resume``): every
rank restores the newest step of D before the first sync, and rank 0
saves the single-device view (``DataParallel.unshard_state``: rank 0's BN
statistics) in ``mnist_onegpu``'s format, every N steps and at the end,
so the two scripts' checkpoints interoperate.

``--elastic`` runs the ranks under the single-host supervisor
(``runtime/supervisor.py``): each generation spawns one ``python -m
tpu_sandbox_torch.mnist_distributed --elastic-worker --rank r`` a rank on
a fresh coordinator port, with a KV store for heartbeats, rendezvous,
fault claims and the preemption flag. A worker trains in
``train_resumable``: it checkpoints with the data order (rank 0's npz, or
with ``--ckpt-sharded`` or ``--zero`` every rank's shard sealed by a
manifest), resumes where the newest valid step left off, skips a step
whose loss is not finite on any rank, and on SIGTERM saves and exits 75,
which the supervisor does not charge to ``--max-restarts``. The
``TPU_SANDBOX_*`` environment (fault plan, backoff, watchdog, commit
timeout) is the JAX package's.

``--elastic --agents N`` runs the cross-host plane on one machine
(``runtime/host_agent.py``): an ``AgentLauncher`` owns the KV store and
spawns N host-agent processes (``--agent-id a``, each owning a contiguous
block of ranks), which elect a leader that drives the generations; the
launcher replaces an agent that dies. ``--agent-id a --kv-port P`` (or
``--leader``, which hosts the store, bound to ``--kv-bind``) runs one
agent by hand, one a host. ``--elastic --pool S`` submits the job
(``--job-id``, ``--priority``) to a ``ClusterScheduler`` of S host slots
(``runtime/scheduler.py``), which gang-admits it, may preempt it for a
higher priority (it saves and resumes, uncharged) and sweeps its KV
namespace when it ends. An agent's ranks are ``--elastic-worker``
processes of this module, on the card of their global rank unless
``--force-cpu`` is given, exactly as the supervisor's ranks are.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import torch

from tpu_sandbox_torch.data import (
    ShardedBatchLoader,
    load_mnist,
    normalize,
    synthetic_mnist,
)
from tpu_sandbox_torch.models import pick_convnet
from tpu_sandbox_torch.parallel.data_parallel import DataParallel
from tpu_sandbox_torch.parallel.launch import spawn
from tpu_sandbox_torch.runtime import bootstrap
from tpu_sandbox_torch.train import SGD, AdamW, Trainer, TrainState
from tpu_sandbox_torch.train import checkpoint as ckpt
from tpu_sandbox_torch.train.optim import constant_schedule
from tpu_sandbox_torch.utils import exact_fp32
from tpu_sandbox_torch.utils.cli import (
    add_checkpoint_cli,
    add_elastic_cli,
    add_grad_compress_cli,
    add_overlap_cli,
)
from tpu_sandbox_torch.utils.device import rank_device

IMAGE_SHAPE = [3000, 3000]
LR = 1e-4
#: seconds the spawned ranks may take, rendezvous included, before they are
#: killed (a wait on a dead peer fails sooner: bootstrap.TIMEOUT)
TIMEOUT = 3600.0

#: a directory: every elastic rank that finishes its generation writes its
#: kernel launch counts there (``launches-g<gen>-r<rank>.json``)
ENV_LAUNCH_COUNTS = "TPU_SANDBOX_LAUNCH_COUNTS"

#: the package's parent directory: the supervisor's workers import the
#: package from there whatever their working directory
_ROOT = str(Path(__file__).resolve().parent.parent)


#: the JAX script's note on ``--zero`` with ``--opt sgd`` (:51-53)
ZERO_SGD_NOTE = ("note: --zero with plain SGD shards no optimizer state "
                 "(SGD is stateless); use --opt momentum|adamw for the "
                 "memory win")


def load_training_arrays(args, world_size: int, verbose: bool = True):
    """Real MNIST if found, else the synthetic stand-in; normalized and
    trimmed to ``--limit-steps`` steps of the global batch (:32-48)."""
    try:
        images, labels = load_mnist("train", args.data_dir)
    except FileNotFoundError:
        if verbose:
            print("MNIST IDX files not found; using deterministic "
                  "synthetic MNIST")
        images, labels = synthetic_mnist(n=args.synthetic_n, seed=0)
    images = normalize(images)
    labels = labels.astype("int32")
    if args.limit_steps:
        keep = args.limit_steps * args.batch_size * world_size
        images, labels = images[:keep], labels[:keep]
    return images, labels


def make_optimizer(args, model):
    """``--opt``: ``sgd`` is the reference's plain SGD(1e-4) (the state's
    own update), ``momentum`` optax's ``sgd(1e-4, momentum=0.9)``,
    ``adamw`` optax's ``adamw(1e-4)`` (:56-68)."""
    if args.opt == "sgd":
        return None
    if args.opt == "momentum":
        return SGD(model.parameters(), LR, momentum=0.9)
    return AdamW(model.parameters(), constant_schedule(LR))


def _build(args, device, world_size: int, rank: int, *,
           model_options: dict | None = None):
    """The model, its state (with ``--opt``'s optimizer), this rank's
    loader and the data-parallel engine, as every rank builds them."""
    image_shape = (args.image_size, args.image_size)
    dtype = torch.bfloat16 if args.dtype == "bf16" else torch.float32
    model = pick_convnet(image_shape, plan=args.plan, num_classes=10,
                         dtype=dtype, seed=0, device=device,
                         **(model_options or {}))
    state = TrainState(model, lr=LR, optimizer=make_optimizer(args, model))
    images, labels = load_training_arrays(args, world_size,
                                          verbose=rank == 0)
    loader = ShardedBatchLoader(images, labels, args.batch_size,
                                world_size, shuffle=True, seed=0, rank=rank)
    dp = DataParallel(model, image_size=image_shape, zero=args.zero,
                      grad_compress=args.grad_compress,
                      error_feedback=not args.no_error_feedback,
                      overlap_grad_sync=args.overlap_grad_sync,
                      bucket_mb=args.bucket_mb)
    return state, loader, dp


def train(args, rank: int = 0, world_size: int = 1, local_rank: int = 0, *,
          model_options: dict | None = None):
    """One rank's run, in this process, on GPU ``local_rank`` (or the CPU):
    join the group, train, leave. Returns ``(trainer, state)``.
    ``model_options`` go to ``pick_convnet``."""
    device = rank_device(local_rank, args.force_cpu)
    if device.type == "cuda":
        exact_fp32()
    bootstrap.init(None, world_size, rank, device=device)
    try:
        state, loader, dp = _build(args, device, world_size, rank,
                                   model_options=model_options)
        if args.ckpt_dir and args.resume:
            if ckpt.latest_step(args.ckpt_dir) is not None:
                ckpt.restore(args.ckpt_dir, state)
                if rank == 0:
                    print(f"resumed from step {state.step}")
        state = dp.shard_state(state)
        trainer = Trainer(lambda x, y: dp.train_step(state, x, y), device,
                          log_every=args.log_every, log_rank=0,
                          verbose=rank == 0, ckpt_dir=args.ckpt_dir,
                          ckpt_every=args.ckpt_every,
                          state_for_checkpoint=dp.unshard_state,
                          ckpt_writer=rank == 0)
        state = trainer.fit(state, loader, args.epochs, set_epoch=False,
                            prefetch=args.prefetch)
        if args.ckpt_dir:
            # the single-device view (rank 0's BN statistics), the layout
            # mnist_onegpu saves: the two scripts' checkpoints interoperate
            view = dp.unshard_state(state)
            if rank == 0:
                print(f"saved checkpoint at step {ckpt.save(args.ckpt_dir, view)}")
    finally:
        bootstrap.cleanup()
    return trainer, state


def train_elastic_worker(args, world_size: int) -> None:
    """One rank of an elastic generation: heartbeat and generation-scoped
    rendezvous over the supervisor's KV store, fault injection from the
    environment's plan, resumable training with coordination-free
    checkpoints (rank 0's npz, or every rank's shard sealed by rank 0's
    manifest, which ``--zero`` requires), and SIGTERM → save → exit 75 so
    the supervisor restarts the generation without charging its budget."""
    from tpu_sandbox_torch.runtime import Heartbeat, wait_for_world
    from tpu_sandbox_torch.runtime.faults import FaultInjector, FaultPlan
    from tpu_sandbox_torch.runtime.kvstore import KVClient, for_job
    from tpu_sandbox_torch.train import (
        PREEMPTED_EXIT_CODE,
        ElasticEnv,
        Preempted,
        PreemptionHandler,
        build_elastic_checkpoint,
        train_resumable,
    )
    from tpu_sandbox_torch.utils.bridge import state_template

    rank = args.rank
    if args.force_cpu:
        _cpu_rank_threads(world_size)
    eenv = ElasticEnv.from_env()
    kv = for_job(KVClient(port=int(args.kv_port)), eenv.job_id)
    hb = Heartbeat(kv, rank, interval=0.5).start()
    preemption = PreemptionHandler(kv)
    plan = FaultPlan.from_env()
    injector = None
    if plan.faults:
        injector = FaultInjector(
            plan, rank, kv,
            on_hang_heartbeat=lambda: hb.stop(deregister=False),
            agent_id=eenv.agent_id,
        )
    wait_for_world(kv, world_size, rank, timeout=120.0)
    device = rank_device(rank, args.force_cpu)
    if device.type == "cuda":
        exact_fp32()
    bootstrap.init(f"127.0.0.1:{args.port}", world_size, rank, device=device)
    # after init_process_group: whoever installs last owns SIGTERM
    preemption.install()
    state, loader, dp = _build(args, device, world_size, rank)
    template = state_template(state)           # global shapes, before ZeRO

    def agree_preempt(flag: bool) -> bool:
        """OR of every rank's flag: one all-reduce at each boundary."""
        vote = torch.tensor([1.0 if flag else 0.0], device=device)
        return float(dp.group.all_reduce(vote, "sum")) > 0

    gen = eenv.generation
    save_fn = restore_fn = verifier = None
    if args.ckpt_dir:
        save_fn, restore_fn, verifier = build_elastic_checkpoint(
            args.ckpt_dir, dp=dp, state=state, template=template, rank=rank,
            world_size=world_size,
            sharded=bool(args.ckpt_sharded or args.zero),
            kv=kv, injector=injector,
            verify_interval=args.ckpt_verify_interval,
            commit_timeout=float(
                os.environ.get("TPU_SANDBOX_COMMIT_TIMEOUT", 60.0)),
            generation=gen, verbose=rank == 0, compress=args.ckpt_compress,
        )
    if verifier is not None:
        verifier.start()
    state = dp.shard_state(state)
    try:
        state, report = train_resumable(
            lambda s, x, y: dp.train_step(s, x, y, guard=True), state,
            loader, args.epochs, save_fn=save_fn, restore_fn=restore_fn,
            ckpt_every=args.ckpt_every, preemption=preemption,
            agree_fn=agree_preempt if world_size > 1 else None,
            injector=injector, log_every=args.log_every, log_rank=rank,
            verbose=rank == 0, set_epoch=False, prefetch=args.prefetch,
            device=device,
        )
        if rank == 0:
            resumed = (f"resumed from step {report.resumed_step}"
                       if report.resumed_step is not None else "fresh start")
            print(f"[gen {gen}] {resumed}; applied {report.steps_applied} "
                  f"step(s), final step {report.final_step}", flush=True)
        if save_fn is not None:
            save_fn(state, report.final_step, args.epochs, 0)
        _write_launch_counts(gen, rank, report.steps_applied)
    except Preempted:
        hb.stop(deregister=True)
        bootstrap.cleanup()
        sys.exit(PREEMPTED_EXIT_CODE)
    except BaseException:
        # a peer's preemption can surface here as a collective error; if
        # the flag is up, this exit is a preemption too (the supervisor
        # classifies by the initiators' codes)
        if preemption.requested():
            hb.stop(deregister=True)
            sys.exit(PREEMPTED_EXIT_CODE)
        raise
    finally:
        preemption.uninstall()
        if verifier is not None:
            verifier.stop()
    bootstrap.cleanup()
    hb.stop(deregister=True)


def _write_launch_counts(gen: int, rank: int, steps: int) -> None:
    """With ``TPU_SANDBOX_LAUNCH_COUNTS`` set, this rank's kernel launches
    of the generation (the process's whole life: it starts at zero) and
    its steps, as JSON in that directory."""
    out = os.environ.get(ENV_LAUNCH_COUNTS)
    if not out:
        return
    from tpu_sandbox_torch import ops

    path = Path(out) / f"launches-g{gen}-r{rank}.json"
    path.write_text(json.dumps({"generation": int(gen), "rank": rank,
                                "steps": steps,
                                "launches": ops.launch_counts()}))


def _elastic_passthrough(args) -> list[str]:
    """The worker-facing flags, re-serialized for the child processes."""
    passthrough = [
        "-n", str(args.nodes), "-g", str(args.gpus),
        "--epochs", str(args.epochs), "--batch-size", str(args.batch_size),
        "--image-size", str(args.image_size),
        "--synthetic-n", str(args.synthetic_n),
        "--log-every", str(args.log_every), "--dtype", args.dtype,
        "--plan", args.plan, "--opt", args.opt,
    ]
    if args.data_dir:
        passthrough += ["--data-dir", args.data_dir]
    if args.limit_steps:
        passthrough += ["--limit-steps", str(args.limit_steps)]
    if args.ckpt_dir:
        passthrough += ["--ckpt-dir", args.ckpt_dir]
    if args.ckpt_every:
        passthrough += ["--ckpt-every", str(args.ckpt_every)]
    if args.zero:
        passthrough += ["--zero"]
    if args.ckpt_sharded:
        passthrough += ["--ckpt-sharded"]
    if args.ckpt_verify_interval:
        passthrough += ["--ckpt-verify-interval",
                        str(args.ckpt_verify_interval)]
    if args.ckpt_compress:
        passthrough += ["--ckpt-compress"]
    if args.grad_compress != "none":
        passthrough += ["--grad-compress", args.grad_compress]
    if args.no_error_feedback:
        passthrough += ["--no-error-feedback"]
    if args.overlap_grad_sync:
        passthrough += ["--overlap-grad-sync"]
    if args.bucket_mb != 25.0:
        passthrough += ["--bucket-mb", str(args.bucket_mb)]
    if args.prefetch:
        passthrough += ["--prefetch"]
    if args.force_cpu:
        passthrough += ["--force-cpu"]
    return passthrough


def _note_without_ckpt(args) -> None:
    if not args.ckpt_dir:
        print("note: --elastic without --ckpt-dir restarts from step 0 "
              "(pass --ckpt-dir/--ckpt-every to resume where the crash hit)")


def _validate_fault_plan() -> None:
    from tpu_sandbox_torch.runtime.faults import FaultPlan

    try:
        # fail fast here: a malformed plan would otherwise crash every
        # worker at startup and silently burn the whole restart budget
        FaultPlan.from_env()
    except (TypeError, ValueError) as e:
        raise SystemExit(f"invalid TPU_SANDBOX_FAULT_PLAN: {e}") from e


def spawn_elastic(args, world_size: int):
    """Run the ranks under the elastic supervisor: crashes and preemptions
    tear the generation down and relaunch it on a fresh coordinator port;
    the workers resume from the newest valid checkpoint with exact data
    order. Returns the supervisor's ``ElasticResult``."""
    from tpu_sandbox_torch.runtime.supervisor import (
        RestartBudgetExceeded,
        Supervisor,
    )

    _validate_fault_plan()
    _note_without_ckpt(args)
    passthrough = _elastic_passthrough(args)

    def build(gen, kv_port):
        port = bootstrap.find_free_port()  # fresh coordinator port per gen
        base = [*_module_argv(), "--elastic-worker", "--port", port,
                "--kv-port", str(kv_port)] + passthrough
        return [base + ["--rank", str(r)] for r in range(world_size)]

    sup = Supervisor(
        world_size, build,
        max_restarts=args.max_restarts,
        backoff=float(os.environ.get("TPU_SANDBOX_BACKOFF", 1.0)),
        heartbeat_timeout=float(
            os.environ.get("TPU_SANDBOX_WATCHDOG_TIMEOUT", 60.0)),
        grace=float(os.environ.get("TPU_SANDBOX_WATCHDOG_GRACE", 180.0)),
        term_timeout=float(os.environ.get("TPU_SANDBOX_TERM_TIMEOUT", 30.0)),
        extra_env=_root_env(),
    )
    try:
        result = sup.run()
    except RestartBudgetExceeded as e:
        raise SystemExit(str(e))
    if not result.ok:
        # preempted from outside: saved state, clean stop, propagate 75
        sys.exit(result.generations[-1].exit_codes[0] or 0)
    return result


def _root_env() -> dict[str, str]:
    """``PYTHONPATH`` with the package's parent first: agents and ranks
    import the package whatever their working directory."""
    path = os.environ.get("PYTHONPATH")
    return {"PYTHONPATH": _ROOT + (os.pathsep + path if path else "")}


def _module_argv() -> list[str]:
    return [sys.executable, "-m", "tpu_sandbox_torch.mnist_distributed"]


def _agent_config_from_env(args, world_size: int, kv_port: int):
    """AgentConfig from the flags and the environment knobs the supervisor
    honours, plus the agent plane's own (agent heartbeat timeout, lease
    TTL, teardown-ack deadline, relaunch gate)."""
    from tpu_sandbox_torch.runtime.host_agent import AgentConfig

    def knob(name, default):
        return float(os.environ.get(name, default))

    return AgentConfig(
        agent_id=args.agent_id or 0,
        num_agents=args.agents,
        world_size=world_size,
        kv_port=kv_port,
        job_id=args.job_id or os.environ.get("TPU_SANDBOX_JOB_ID", ""),
        max_restarts=args.max_restarts,
        backoff=knob("TPU_SANDBOX_BACKOFF", 1.0),
        heartbeat_timeout=knob("TPU_SANDBOX_WATCHDOG_TIMEOUT", 60.0),
        grace=knob("TPU_SANDBOX_WATCHDOG_GRACE", 180.0),
        term_timeout=knob("TPU_SANDBOX_TERM_TIMEOUT", 30.0),
        agent_timeout=knob("TPU_SANDBOX_AGENT_TIMEOUT", 10.0),
        lease_ttl=knob("TPU_SANDBOX_LEASE_TTL", 3.0),
        ack_timeout=knob("TPU_SANDBOX_ACK_TIMEOUT", 60.0),
        agent_wait=knob("TPU_SANDBOX_AGENT_WAIT", 120.0),
    )


def run_host_agent(args, world_size: int) -> None:
    """Run ONE host agent of an ``--agents N`` job (the process the
    ``AgentLauncher`` spawns, or one started by hand on each host, with
    ``--leader`` hosting the KV store on the first) and exit with its
    verdict: 0, 1, or 75 when the whole job was preempted."""
    from tpu_sandbox_torch.runtime.host_agent import HostAgent
    from tpu_sandbox_torch.runtime.kvstore import KVServer

    if args.agents < 1:
        raise SystemExit("--agent-id requires --agents N (the topology)")
    if not (0 <= args.agent_id < args.agents):
        raise SystemExit(
            f"--agent-id {args.agent_id} out of range for "
            f"--agents {args.agents}")
    server = None
    if args.leader:
        # --kv-bind 0.0.0.0 with TPU_SANDBOX_KV_TOKEN in the environment
        # makes the store reachable off-host (KVServer and KVClient both
        # read the token, so the ranks inherit it)
        server = KVServer(port=int(args.kv_port or 0), bind=args.kv_bind)
        print(f"[agent {args.agent_id}] hosting KV store on "
              f"{args.kv_bind}:{server.port}", flush=True)
        kv_port = server.port
    elif args.kv_port:
        kv_port = int(args.kv_port)
    else:
        raise SystemExit("--agent-id needs --kv-port (or --leader)")
    passthrough = _elastic_passthrough(args)

    def rank_cmd(gen, rank, coord_port):
        return [*_module_argv(), "--elastic-worker", "--port",
                str(coord_port), "--kv-port", str(kv_port), *passthrough,
                "--rank", str(rank)]

    cfg = _agent_config_from_env(args, world_size, kv_port)
    try:
        rc = HostAgent(cfg, rank_cmd, extra_env=_root_env()).run()
    finally:
        if server is not None:
            server.stop()
    sys.exit(rc)


def _agent_argv(args, aid, kv_port, *, job_id: str | None = None
                ) -> list[str]:
    """One host agent's command line; ``job_id`` adds ``--job-id``."""
    argv = [*_module_argv(), "--elastic", "--agents", str(args.agents or 1),
            "--agent-id", str(aid), "--kv-port", str(kv_port)]
    if job_id is not None:
        argv += ["--job-id", job_id]
    return argv + ["--max-restarts", str(args.max_restarts),
                   *_elastic_passthrough(args)]


def spawn_elastic_agents(args, world_size: int) -> None:
    """The cross-host elastic topology on one machine: an AgentLauncher
    owns the KV store and spawns ``--agents N`` HostAgent processes, which
    elect a leader that drives the generations; the launcher replaces any
    agent that dies (a host replaced). Exits with the job's verdict code
    when it failed."""
    from tpu_sandbox_torch.runtime.host_agent import AgentLauncher

    _validate_fault_plan()
    if world_size < args.agents:
        raise SystemExit(
            f"world size {world_size} gives --agents {args.agents} "
            "nothing to run on some hosts (every agent owns >= 1 rank)")
    _note_without_ckpt(args)
    rc = AgentLauncher(
        args.agents, lambda aid, kv_port: _agent_argv(args, aid, kv_port),
        extra_env=_root_env()).run()
    if rc:
        sys.exit(rc)


def cluster_job_spec(args, world_size: int):
    """This run as one tenant of the cluster pool: a ``JobSpec`` of
    ``--agents`` hosts (1 by default) whose agent template re-invokes this
    module, at ``--priority``, under ``--job-id`` (``job0`` by default)."""
    from tpu_sandbox_torch.runtime.scheduler import JobSpec

    job_id = args.job_id or "job0"
    return JobSpec(
        job_id=job_id, hosts=args.agents or 1, world_size=world_size,
        agent_argv=_agent_argv(args, "{agent_id}", "{kv_port}",
                               job_id="{job_id}"),
        priority=args.priority)


def run_cluster_pool(args, world_size: int) -> None:
    """Multi-tenant cluster mode: gang-schedule this training job through
    the durable queue of ``runtime/scheduler.py`` on a pool of ``--pool``
    host slots. The agent topology of ``--agents N``, admitted (and
    possibly queued or preempted) by the scheduler instead of launched
    directly."""
    from tpu_sandbox_torch.runtime.scheduler import ClusterScheduler

    _validate_fault_plan()
    _note_without_ckpt(args)
    spec = cluster_job_spec(args, world_size)
    with ClusterScheduler(args.pool, extra_env=_root_env()) as sched:
        sched.submit(spec)
        states = sched.serve()
    state = states.get(spec.job_id)
    print(f"[cluster] job {spec.job_id!r} finished: {state}", flush=True)
    if state != "done":
        sys.exit(1)


def _cpu_rank_threads(ranks: int) -> None:
    """A CPU rank's intra-op threads: ``OMP_NUM_THREADS`` when it is set
    (one thread a rank makes a CPU run's reductions repeatable under
    load), else its share of the cores."""
    n = os.environ.get("OMP_NUM_THREADS")
    torch.set_num_threads(int(n) if n else max(1, (os.cpu_count() or 1)
                                               // ranks))


def _rank_main(rank: int, world_size: int, args) -> None:
    if args.force_cpu:
        _cpu_rank_threads(args.gpus)
    train(args, rank, world_size, int(os.environ["LOCAL_RANK"]))


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="data-parallel 3000x3000 MNIST training (PyTorch/CUDA "
                    "port)")
    parser.add_argument("-n", "--nodes", type=int, default=1, metavar="N",
                        help="number of nodes (each started with its -nr)")
    parser.add_argument("-g", "--gpus", type=int, default=1,
                        help="number of ranks (GPUs) per node")
    parser.add_argument("-nr", "--nr", type=int, default=0,
                        help="ranking of this node")
    parser.add_argument("--epochs", type=int, default=2, metavar="N",
                        help="number of epochs")
    parser.add_argument("--batch-size", type=int, default=5,
                        help="per-rank batch size (reference :60-61)")
    parser.add_argument("--image-size", type=int, default=IMAGE_SHAPE[0])
    parser.add_argument("--data-dir", type=str, default=None)
    parser.add_argument("--synthetic-n", type=int, default=60000)
    parser.add_argument("--limit-steps", type=int, default=None)
    parser.add_argument("--log-every", type=int, default=100)
    parser.add_argument("--opt", choices=["sgd", "momentum", "adamw"],
                        default="sgd",
                        help="optimizer (default: the reference's plain "
                             "SGD 1e-4; momentum/adamw give --zero real "
                             "state to shard)")
    parser.add_argument("--zero", action="store_true",
                        help="ZeRO-1: shard optimizer state over the data "
                             "axis (same math, 1/N the optimizer memory)")
    parser.add_argument("--plan", choices=["auto", "s2dt", "s2d", "plain"],
                        default="auto",
                        help="ConvNet execution plan, as mnist_onegpu's")
    parser.add_argument("--dtype", choices=["bf16", "fp32"], default="bf16")
    add_checkpoint_cli(parser)
    add_grad_compress_cli(parser)
    add_overlap_cli(parser)
    parser.add_argument("--force-cpu", action="store_true",
                        help="gloo ranks on the CPU instead of one GPU a "
                             "rank over NCCL")
    parser.add_argument("--multiprocess", action="store_true",
                        help="accepted for launch compatibility: ranks are "
                             "always OS processes here")
    add_elastic_cli(parser)
    parser.add_argument("--elastic-worker", action="store_true",
                        help=argparse.SUPPRESS)
    parser.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    parser.add_argument("--port", type=str, default="", help=argparse.SUPPRESS)
    parser.add_argument("--kv-port", type=str, default="",
                        help=argparse.SUPPRESS)
    return parser


def main(argv=None):
    args = build_parser().parse_args(argv)
    world_size = args.gpus * args.nodes                      # reference :123
    if args.elastic_worker:
        return train_elastic_worker(args, world_size)
    if args.agent_id is not None:
        return run_host_agent(args, world_size)
    if args.zero and args.opt == "sgd":
        print(ZERO_SGD_NOTE)                # once, from the launcher
    rank_device(args.gpus - 1, args.force_cpu)      # enough cards, or raise
    if args.elastic and args.pool:
        return run_cluster_pool(args, world_size)
    if args.elastic and args.agents:
        return spawn_elastic_agents(args, world_size)
    if args.elastic:
        return spawn_elastic(args, world_size)
    if world_size == 1:
        return train(args)
    init_method = None
    if args.nodes > 1:
        if "MASTER_PORT" not in os.environ:
            raise SystemExit("-n > 1 needs MASTER_ADDR/MASTER_PORT exported "
                             "identically on every node")
        init_method = f"tcp://{bootstrap.coordinator_address()}"
        if args.gpus == 1:                  # this node's one rank, here
            os.environ["INIT_METHOD"] = init_method
            return train(args, args.nr, world_size)
    spawn(_rank_main, world_size, args, nprocs=args.gpus, node_rank=args.nr,
          init_method=init_method, timeout=TIMEOUT)
    return None


if __name__ == "__main__":
    main()
