"""Transformer-LM training: the port of ``lm_train.py`` (same flags,
defaults and log lines): data parallelism, tensor and expert
parallelism through the compiler-driven engine, sequence and pipeline
parallelism, over one device or over ranks.

    python -m tpu_sandbox_torch.lm_train --flash --steps 60
    python -m tpu_sandbox_torch.lm_train --parallelism sp --devices 4 \
        --attn flash_ring
    python -m tpu_sandbox_torch.lm_train --parallelism pp --devices 4 \
        --n-layers 4 --force-cpu
    python -m tpu_sandbox_torch.lm_train --parallelism tp --devices 4 \
        --dp 2 --force-cpu
    python -m tpu_sandbox_torch.lm_train --devices 2 --grad-compress int8 \
        --overlap-grad-sync --force-cpu

The decoder-only LM of ``models/transformer.py`` on the deterministic
synthetic stream of ``make_batches`` (targets = tokens + 1, 2 or 3 by
position, mod vocab), mean cross-entropy over all tokens, Adam (optax's
``adam``) under the ``--schedule`` with optional ``--clip-norm``, a
``[dp] Step [k/N], Loss: x`` line every ``--log-every`` steps and
``Training complete in:`` at the end; the run fails if the loss did not
decrease. ``--flash`` takes the flash-attention kernels; at ``--vocab``
4096 and up the loss takes the fused CE kernel and the logits stay in the
compute dtype. ``--remat`` recomputes each block in the backward
(``--remat-policy full`` or ``dots``). Runs on ``cuda`` unless
``--force-cpu``; with no card and no ``--force-cpu`` it fails.

``--parallelism sp --devices n`` (n even) starts n ranks, one OS process
each, over a ``{"data": 2, "sp": n // 2}`` mesh (``parallel/
seq_parallel.py``): NCCL ranks with one GPU each, or gloo ranks on the CPU
with ``--force-cpu``. ``--attn`` picks the ring, Ulysses or flash-ring
attention; ``--flash`` is unused there, as in the JAX script. The
pipelines (``parallel/pipeline.py``, ``--microbatches``,
``--circular-chunks``) start their ranks the same way: ``pp`` over
``{"data": 1, "pipe": n}`` (one rank runs in this process), ``pp_sp``
over ``{"data": 2, "pipe": 2, "sp": n // 4}`` (``--flash`` picks the
flash-ring over the ring inside every stage) and ``3d`` over ``{"data":
2, "model": 2, "pipe": n // 4}`` (Megatron stages); they refuse
``--clip-norm``, as the JAX script does. The compiler-driven engine
(``parallel/pjit_engine.py``) runs ``dp`` above one device over
``{"data": n}``, ``tp`` over ``{"data": --dp, "model": n // --dp}`` with
``megatron_rules()`` and ``ep`` over ``{"data": 1, "expert": n}``: the
MoE MLP (``parallel/expert.py``) with n experts, one a rank, and
top-``--router-top-k`` routing; at one rank ``tp`` and ``ep`` run in this
process. ``dp`` with ``--grad-compress bf16|int8`` or
``--overlap-grad-sync`` (``--bucket-mb`` buckets) also runs through the
engine, at one device too, in this process: its gradient mean is the
compressed or bucketed exchange, stateless (no ``--no-error-feedback``
here, as in the JAX script). Outside ``dp`` these flags exit with the
JAX script's refusal. Rank 0 prints the lines. Fewer GPUs than ranks is
an error naming both counts: no rank falls back to the CPU or to a
smaller world.
"""

from __future__ import annotations

import argparse
import os
import time
from dataclasses import dataclass, field
from datetime import timedelta
from typing import Callable

import numpy as np
import torch

from tpu_sandbox_torch.models.transformer import (
    Mlp,
    TransformerConfig,
    TransformerLM,
)
from tpu_sandbox_torch.ops.flash_attention import flash_attention_fn
from tpu_sandbox_torch.ops.losses import FUSED_CE_MIN_CLASSES, cross_entropy_loss
from tpu_sandbox_torch.parallel.expert import MoeMlp
from tpu_sandbox_torch.parallel.launch import spawn
from tpu_sandbox_torch.parallel.pipeline import PipelineParallel
from tpu_sandbox_torch.parallel.pjit_engine import (
    P,
    PjitEngine,
    megatron_rules,
)
from tpu_sandbox_torch.parallel.seq_parallel import SeqParallel
from tpu_sandbox_torch.runtime import bootstrap
from tpu_sandbox_torch.runtime.mesh import make_mesh
from tpu_sandbox_torch.train.optim import Adam, clip_by_global_norm_, lm_schedule
from tpu_sandbox_torch.train.trainer import to_device
from tpu_sandbox_torch.utils.cli import add_grad_compress_cli, add_overlap_cli
from tpu_sandbox_torch.utils.device import exact_fp32, rank_device, resolve_device

#: seconds the spawned ranks may take, rendezvous included
SP_TIMEOUT = 3600.0
#: the --parallelism values that run PipelineParallel
PIPELINES = ("pp", "pp_sp", "3d")
#: the --parallelism values that run PjitEngine, with their rules
PJIT_RULES = {"dp": lambda: [], "tp": megatron_rules,
              "ep": lambda: [(r"w_(up|down)", P("expert", None, None))]}


def make_batches(vocab: int, batch: int, seq_len: int, steps: int, seed: int):
    """Deterministic synthetic LM stream: targets = (tokens + k) % vocab with
    position-dependent k, the JAX script's batches bit for bit."""
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        tokens = rng.integers(0, vocab, size=(batch, seq_len), dtype=np.int32)
        shift = (np.arange(seq_len, dtype=np.int32) % 3) + 1
        targets = ((tokens + shift[None, :]) % vocab).astype(np.int32)
        yield tokens, targets


def synced(args) -> bool:
    """Whether the gradient mean is the compressed or bucketed exchange."""
    return args.grad_compress != "none" or args.overlap_grad_sync


def check_ported(args) -> None:
    """The JAX script's refusal of the compressed and overlapped gradient
    sync outside ``dp`` (lm_train.py:132-140)."""
    p = args.parallelism
    if synced(args) and p != "dp":
        raise SystemExit(
            f"--grad-compress/--overlap-grad-sync only compose with "
            f"--parallelism dp (got {p!r}): other plans let XLA place the "
            "grad collectives")


def make_config(args) -> TransformerConfig:
    """bf16 or fp32 compute over f32 parameters, compute-dtype logits
    where the fused CE takes them (vocab >= 4096)."""
    return TransformerConfig(
        vocab_size=args.vocab, d_model=args.d_model, n_heads=args.n_heads,
        n_layers=args.n_layers, d_ff=args.d_ff, max_len=args.seq_len,
        dtype=torch.bfloat16 if args.dtype == "bf16" else torch.float32,
        remat=args.remat, remat_policy=args.remat_policy,
        n_experts=args.devices if args.parallelism == "ep" else 0,
        router_top_k=args.router_top_k,
        fp32_logits=args.vocab < FUSED_CE_MIN_CLASSES)


def build_model(args, device: torch.device, *, seed: int = 0) -> TransformerLM:
    """The script's LM (``make_config``), flash attention with
    ``--flash``, the MoE MLP under ``ep``."""
    attention_fn = flash_attention_fn() if args.flash else None
    return TransformerLM(
        make_config(args), attention_fn, seed=seed, device=device,
        mlp_cls=MoeMlp if args.parallelism == "ep" else Mlp)


def check_clip_norm(args) -> None:
    if args.clip_norm < 0:
        raise SystemExit(f"--clip-norm must be >= 0, got {args.clip_norm} "
                         "(negative max_norm would sign-flip every update)")


def make_adam(args, params) -> Adam:
    """optax's ``adam`` under ``--schedule`` over ``params``."""
    return Adam(params,
                lm_schedule(args.schedule, args.lr, args.steps, args.warmup))


def make_optimizer(args, model: torch.nn.Module) -> Adam:
    check_clip_norm(args)
    return make_adam(args, model.parameters())


def make_train_step(model: TransformerLM, opt: Adam,
                    clip_norm: float = 0.0) -> Callable:
    """(tokens [B, S], targets [B, S]) -> loss: the mean cross-entropy over
    ``logits.reshape(-1, V)`` (as parallel/pjit_engine.py:310-316), its
    backward, optional global-norm clipping and one Adam update, in place."""
    params = opt.params

    def train_step(tokens: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        model.train()
        logits = model(tokens)
        loss = cross_entropy_loss(logits.reshape(-1, logits.shape[-1]),
                                  targets.reshape(-1))
        del logits
        loss.backward()
        if clip_norm:
            clip_by_global_norm_([p.grad for p in params], clip_norm)
        opt.step()
        return loss.detach()

    return train_step


@dataclass
class LMRun:
    """What ``train`` leaves for a caller: the model, the optimizer, the
    step function, the logged losses and each step's host wall time (the
    device's step time when every step is logged, since the log waits for
    the loss)."""
    model: TransformerLM
    optimizer: Adam
    train_step: Callable
    losses: list = field(default_factory=list)
    step_seconds: list = field(default_factory=list)
    elapsed: timedelta | None = None


def fit(run: LMRun, args, device: torch.device, batch: Callable, *,
        verbose: bool = True) -> LMRun:
    """``args.steps`` steps of ``run.train_step`` on ``make_batches``'
    batches (``batch`` puts each where the step takes it), the JAX
    script's log lines (with ``verbose``) and its check that the loss
    fell."""
    p = args.parallelism
    start = time.monotonic()
    for step, (tokens, targets) in enumerate(
            make_batches(args.vocab, args.batch, args.seq_len, args.steps, 0),
            1):
        t0 = time.monotonic()
        loss = run.train_step(*batch(tokens, targets))
        if step % args.log_every == 0 or step == args.steps:
            loss_v = float(loss)
            run.losses.append(loss_v)
            if verbose:
                print(f"[{p}] Step [{step}/{args.steps}], Loss: {loss_v:.4f}",
                      flush=True)
        run.step_seconds.append(time.monotonic() - t0)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    run.elapsed = timedelta(seconds=time.monotonic() - start)
    if verbose:
        print(f"Training complete in: {run.elapsed}", flush=True)
    if len(run.losses) >= 2 and not run.losses[-1] < run.losses[0]:
        raise SystemExit(
            f"loss did not decrease: {run.losses[0]} -> {run.losses[-1]}")
    return run


def train(args) -> LMRun | None:
    """Train as the JAX script's ``train`` does. ``dp`` on one device
    (and any other plan on one rank but ``sp``) runs here and returns the
    ``LMRun``; over ranks the plans start them and return None when every
    rank exited 0. ``dp`` with the compressed or bucketed sync runs the
    engine, at one rank too."""
    check_ported(args)
    if args.parallelism == "sp":
        return train_sp(args)
    if args.parallelism in PIPELINES:
        return train_pp(args)
    if args.parallelism != "dp" or args.devices != 1 or synced(args):
        return train_pjit(args)
    device = resolve_device("cpu" if args.force_cpu else "cuda")
    if device.type == "cuda":
        exact_fp32()
    model = build_model(args, device)
    opt = make_optimizer(args, model)
    run = LMRun(model, opt, make_train_step(model, opt, args.clip_norm))
    return fit(run, args, device, lambda t, y: to_device(t, y, device))


def train_sp(args) -> None:
    """``--parallelism sp``: the JAX script's checks, then ``--devices``
    ranks (one process each: ``rank_main``) over a ``{"data": 2, "sp": n //
    2}`` mesh."""
    check_clip_norm(args)
    n = args.devices
    if n < 2 or n % 2:
        raise SystemExit("sp needs an even device count (data=2 x sp=n/2)")
    rank_device(n - 1, args.force_cpu)          # enough cards, or exit
    spawn(rank_main, n, args, timeout=SP_TIMEOUT)


def rank_main(rank: int, world_size: int, args) -> LMRun:
    """One rank of any plan but ``dp`` on one device with the plain mean:
    GPU ``LOCAL_RANK`` (NCCL) or the CPU (gloo, with ``--force-cpu``), over
    the mesh of ``args.parallelism``."""
    device = rank_device(int(os.environ.get("LOCAL_RANK", 0)), args.force_cpu)
    if device.type == "cuda":
        exact_fp32()
    elif world_size > 1:
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
    bootstrap.init(None, world_size, rank, device=device)
    try:
        if args.parallelism == "sp":
            mesh, fit_rank = {"data": 2, "sp": world_size // 2}, fit_sp
        elif args.parallelism in PJIT_RULES:
            mesh, fit_rank = pjit_mesh(args), fit_pjit
        else:
            mesh, fit_rank = pp_mesh(args), fit_pp
        return fit_rank(args, make_mesh(mesh), device, verbose=rank == 0)
    finally:
        bootstrap.cleanup()


def fit_sp(args, mesh, device: torch.device, *,
           verbose: bool = True) -> LMRun:
    """This rank's share of ``--parallelism sp`` over ``mesh`` (its 'data'
    and 'sp' axes; the process group already open): ``SeqParallel`` with
    ``--attn``, Adam under ``--schedule`` and ``--clip-norm`` on the mean
    gradients, every rank from the same seed and rank 0's parameters."""
    cfg = make_config(args)
    eng = SeqParallel(
        lambda attn: TransformerLM(cfg, attn, seed=0, device=device),
        lambda params: make_adam(args, params), mesh, attn=args.attn,
        clip_norm=args.clip_norm)
    state = eng.shard_state(eng.init_state())
    run = LMRun(state.model, state.optimizer,
                lambda *b: eng.train_step(state, *b))
    return fit(run, args, device, eng.shard_batch, verbose=verbose)


def pp_mesh(args) -> dict:
    """The mesh of a pipeline at ``--devices``, after the JAX script's
    checks (lm_train.py:175-216), which exit with its messages."""
    n, p = args.devices, args.parallelism
    if p == "pp":
        if args.n_layers % n:
            raise SystemExit(f"pp needs n_layers divisible by {n} devices")
        return {"data": 1, "pipe": n}
    if p == "pp_sp":
        if n % 4:
            raise SystemExit("pp_sp wants devices divisible by 4 "
                             "(mesh data=2 x pipe=2 x sp=n/4)")
        if args.n_layers % 2:
            raise SystemExit("pp_sp needs even n_layers (2 stages)")
        return {"data": 2, "pipe": 2, "sp": n // 4}
    if n % 8:
        raise SystemExit("3d wants devices divisible by 8 (2x2x2 mesh)")
    shape = {"data": 2, "model": 2, "pipe": n // 4}
    if args.n_layers % shape["pipe"] or args.n_heads % 2 or args.d_ff % 2:
        raise SystemExit(
            f"3d at {n} devices needs n_layers % {shape['pipe']} == 0 "
            "and even --n-heads/--d-ff")
    return shape


def train_pp(args) -> LMRun | None:
    """``--parallelism pp|pp_sp|3d``: the JAX script's checks, then
    ``--devices`` ranks (one process each: ``rank_main``); one rank runs
    in this process and returns its ``LMRun``."""
    check_clip_norm(args)
    if args.clip_norm:
        # the stage gradients are rank-local: a per-rank norm would scale
        # the replicated embedding and head gradients differently per rank
        raise SystemExit(
            "--clip-norm is not supported with --parallelism pp/pp_sp/3d "
            "(per-stage norms would diverge); clip under dp/tp/sp/ep")
    pp_mesh(args)                               # the JAX checks, or exit
    n = args.devices
    rank_device(n - 1, args.force_cpu)          # enough cards, or exit
    if n == 1:
        return rank_main(0, 1, args)
    spawn(rank_main, n, args, timeout=SP_TIMEOUT)
    return None


def fit_pp(args, mesh, device: torch.device, *,
           verbose: bool = True) -> LMRun:
    """This rank's share of ``--parallelism pp|pp_sp|3d`` over ``mesh``
    (its 'data' and 'pipe' axes, with 'sp' for pp_sp and 'model' for 3d;
    the process group already open): ``PipelineParallel`` with
    ``--microbatches`` and ``--circular-chunks``, the flash kernels with
    ``--flash`` (the flash-ring under pp_sp), Adam under ``--schedule``,
    every rank from the same seed."""
    attention_fn = flash_attention_fn() if args.flash else None
    options = {
        "pp": dict(attention_fn=attention_fn),
        "pp_sp": dict(seq_axis="sp",
                      seq_attn="flash_ring" if args.flash else "ring"),
        "3d": dict(model_axis="model", attention_fn=attention_fn),
    }[args.parallelism]
    eng = PipelineParallel(
        make_config(args), lambda params: make_adam(args, params), mesh,
        microbatches=args.microbatches,
        circular_chunks=args.circular_chunks, **options)
    state = eng.shard_state(eng.init_state())
    run = LMRun(state.model, state.optimizer,
                lambda *b: eng.train_step(state, *b))
    return fit(run, args, device, eng.shard_batch, verbose=verbose)


def pjit_mesh(args) -> dict:
    """The mesh of ``dp``, ``tp`` or ``ep`` at ``--devices``, after the JAX
    script's checks (lm_train.py:141-166, 218-226), which exit with its
    messages."""
    n, p = args.devices, args.parallelism
    if p == "dp":
        return {"data": n}
    if p == "ep":
        return {"data": 1, "expert": n}
    if args.dp < 1 or n % args.dp:
        raise SystemExit(f"--dp {args.dp} must be >= 1 and divide {n} devices")
    m = n // args.dp
    if args.n_heads % m or args.d_ff % m or args.vocab % m or args.d_model % m:
        raise SystemExit(
            f"tp shards heads, d_ff, vocab and d_model: --n-heads "
            f"{args.n_heads}, --d-ff {args.d_ff}, --vocab {args.vocab}, "
            f"--d-model {args.d_model} must be divisible by {m} "
            "model-parallel ranks")
    return {"data": args.dp, "model": m}


def train_pjit(args) -> LMRun | None:
    """``--parallelism dp`` above one device or with the compressed or
    bucketed sync, ``tp`` and ``ep``: the JAX script's checks, then
    ``--devices`` ranks (one process each: ``rank_main``); one rank runs in
    this process and returns its ``LMRun``."""
    check_clip_norm(args)
    pjit_mesh(args)                             # the JAX checks, or exit
    n = args.devices
    rank_device(n - 1, args.force_cpu)          # enough cards, or exit
    if n == 1:
        return rank_main(0, 1, args)
    spawn(rank_main, n, args, timeout=SP_TIMEOUT)
    return None


def fit_pjit(args, mesh, device: torch.device, *,
             verbose: bool = True) -> LMRun:
    """This rank's share of ``--parallelism dp|tp|ep`` over ``mesh`` (its
    'data' axis, with 'model' for tp and 'expert' for ep; the process group
    already open): ``PjitEngine(task="lm")`` with the plan's rules, the
    flash kernels with ``--flash``, Adam under ``--schedule`` and
    ``--clip-norm`` on the global norm, dp's ``--grad-compress``,
    ``--overlap-grad-sync`` and ``--bucket-mb``, every rank from the same
    seed."""
    eng = PjitEngine(build_model(args, device), lambda params: make_adam(
        args, params), mesh, task="lm",
        rules=PJIT_RULES[args.parallelism](), clip_norm=args.clip_norm,
        grad_compress=args.grad_compress,
        overlap_grad_sync=args.overlap_grad_sync, bucket_mb=args.bucket_mb)
    state = eng.shard_state()
    run = LMRun(state.model, state.optimizer,
                lambda *b: eng.train_step(state, *b))
    return fit(run, args, device, eng.shard_batch, verbose=verbose)


def build_parser() -> argparse.ArgumentParser:
    """The JAX script's flags, one for one."""
    parser = argparse.ArgumentParser(
        description="transformer-LM training (PyTorch/CUDA port)")
    parser.add_argument("--parallelism",
                        choices=["dp", "tp", "sp", "pp", "pp_sp", "ep", "3d"],
                        default="dp")
    parser.add_argument("--dp", type=int, default=1,
                        help="tp only: data-parallel axis size composed "
                             "with model parallelism (devices = dp x tp)")
    parser.add_argument("--devices", type=int, default=1)
    parser.add_argument("--steps", type=int, default=60)
    parser.add_argument("--batch", type=int, default=8)
    parser.add_argument("--seq-len", type=int, default=128)
    parser.add_argument("--vocab", type=int, default=64)
    parser.add_argument("--d-model", type=int, default=64)
    parser.add_argument("--n-heads", type=int, default=4)
    parser.add_argument("--n-layers", type=int, default=2)
    parser.add_argument("--d-ff", type=int, default=128)
    parser.add_argument("--lr", type=float, default=1e-3)
    parser.add_argument("--schedule", choices=["const", "cosine"],
                        default="const")
    parser.add_argument("--warmup", type=int, default=0,
                        help="linear warmup steps (cosine schedule)")
    parser.add_argument("--clip-norm", type=float, default=0.0,
                        help="global-norm gradient clipping (0 = off)")
    parser.add_argument("--microbatches", type=int, default=2,
                        help="pp, pp_sp, 3d: microbatches per step")
    parser.add_argument("--circular-chunks", type=int, default=1,
                        help="pp, pp_sp, 3d: layer chunks per stage (v > 1 "
                             "is the circular schedule)")
    parser.add_argument("--router-top-k", type=int, default=1,
                        help="ep only: 1 = Switch top-1, 2 = GShard top-2")
    parser.add_argument("--log-every", type=int, default=10)
    parser.add_argument("--dtype", choices=["bf16", "fp32"], default="fp32")
    parser.add_argument("--attn", choices=["ring", "ulysses", "flash_ring"],
                        default="ring",
                        help="sp only: the plain K/V ring, the Ulysses "
                             "all-to-all head/sequence swap, or the "
                             "flash-ring on the flash kernels")
    parser.add_argument("--flash", action="store_true",
                        help="use the flash-attention kernels")
    parser.add_argument("--remat-policy", choices=["full", "dots"],
                        default="full",
                        help="with --remat: what the backward recomputes")
    parser.add_argument("--remat", action="store_true",
                        help="recompute each block in the backward")
    parser.add_argument("--force-cpu", action="store_true",
                        help="run on the CPU (the kernels' plain PyTorch "
                             "versions) instead of the GPU")
    # dp only; no --no-error-feedback here: PjitEngine's compressed sync
    # is stateless (no residual to carry), unlike DataParallel's
    add_grad_compress_cli(parser, error_feedback=False)
    # dp only likewise; no --prefetch (synthetic in-memory stream)
    add_overlap_cli(parser, prefetch=False)
    return parser


def main(argv=None):
    return train(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
