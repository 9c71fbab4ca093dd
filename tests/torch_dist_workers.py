"""Rank bodies for the port's multi-process CPU tests (gloo).

Spawned ranks import this module anew, so it imports no ``jax`` and
nothing of the JAX package: only the port, torch and numpy. The tests that
spawn these ranks (``tests/test_torch_{bootstrap,collectives,
data_parallel,ring_attention,flash_ring,seq_parallel,pipeline,
pipeline_parallel,pjit_engine,moe,mpmd}.py``) compute the JAX package's results in their own process and compare. Each rank joins through the ``INIT_METHOD`` that
``tpu_sandbox_torch.parallel.launch.spawn`` sets (a ``FileStore`` under
the test's temporary directory) and saves what it computed to
``out_dir/rank{r}.pt``.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from tpu_sandbox_torch.models import ConvNet, pick_convnet
from tpu_sandbox_torch.models.transformer import Mlp, TransformerConfig, TransformerLM
from tpu_sandbox_torch.ops.flash_attention import flash_attention_fn
from tpu_sandbox_torch.parallel import (
    SeqParallel,
    make_flash_ring_attention,
    make_ring_attention,
    make_ulysses_attention,
)
from tpu_sandbox_torch.parallel.collectives import (
    CollectiveGroup,
    sub_groups,
    world_group,
)
from tpu_sandbox_torch.parallel.data_parallel import DataParallel
from tpu_sandbox_torch.parallel.expert import MoeMlp
from tpu_sandbox_torch.parallel.pipeline import PipelineParallel
from tpu_sandbox_torch.parallel.pjit_engine import P, PjitEngine, megatron_rules
from tpu_sandbox_torch.runtime import bootstrap
from tpu_sandbox_torch.runtime.mesh import make_mesh, submesh
from tpu_sandbox_torch.train import SGD, Adam, AdamW, TrainState
from tpu_sandbox_torch.train.optim import constant_schedule

#: per-rank values, leading dim = 4 ranks (row r is rank r's), all exact in
#: f32 so every summation order gives the same bits
COLLECTIVE_INPUTS = {
    "f32": np.array([3.0, 1.0, 4.0, 1.5], np.float32),
    "f32_2d": np.arange(8.0, dtype=np.float32).reshape(4, 2) * 0.25,
    "i32": np.array([[3, -7], [12, 5], [-1, 0], [8, 9]], np.int32),
    "scatter": np.stack([np.arange(16.0, dtype=np.float32) * (r + 1)
                         for r in range(4)]),
    "a2a": np.arange(32.0, dtype=np.float32).reshape(4, 4, 2),
    "sub": np.array([2.0, 5.0], np.float32),
}
#: (result name, op, input, argument) of every per-rank result
COLLECTIVE_CASES = (
    [(f"all_reduce_{op}_{x}", "all_reduce", x, op)
     for op in ("sum", "mean", "max", "min")
     for x in ("f32", "f32_2d", "i32")]
    + [(f"all_gather_{x}", "all_gather", x, None) for x in ("f32", "i32")]
    + [("reduce_scatter", "reduce_scatter", "scatter", None)]
    + [(f"broadcast_root{r}", "broadcast", "f32_2d", r) for r in (0, 3)]
    + [(f"shift_{o}", "shift", "f32_2d", o) for o in (1, -1, 2)]
    + [("all_to_all", "all_to_all", "a2a", None)]
)
#: what each validation must raise, ``match`` of the JAX test
VALIDATIONS = {
    "op": "op", "put": "divisible", "reduce_scatter": "reduce_scatter",
    "all_to_all": "all_to_all wants", "no_axis": "pass axis",
    "bad_axis": "not in mesh",
}


def _save(out_dir: str, rank: int, out: dict) -> None:
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))


def _error(fn) -> str:
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def collectives_worker(rank: int, world_size: int, out_dir: str) -> None:
    """Every collective on ``COLLECTIVE_INPUTS``, sub-groups on a 2x2 mesh,
    the validations, the bandwidth bench and the topology."""
    torch.set_num_threads(1)
    topo = bootstrap.init(device="cpu")
    try:
        group = world_group()
        out = {"topology": vars(topo), "backend": bootstrap.backend_name(),
               "group": (group.size, group.rank)}
        for name, op, x, arg in COLLECTIVE_CASES:
            block = group.put(COLLECTIVE_INPUTS[x])
            if op == "all_reduce":
                out[name] = group.all_reduce(block, arg)
            elif op in ("broadcast", "shift"):
                out[name] = getattr(group, op)(block, arg)
            elif op == "all_to_all":
                out[name] = group.all_to_all(block[0])
            else:
                out[name] = getattr(group, op)(block)
        group.barrier()
        mesh = make_mesh({"data": 2, "model": 2})
        sub = sub_groups(mesh, "model")
        out["sub_size"] = sub.size
        out["sub"] = sub.all_reduce(sub.put(COLLECTIVE_INPUTS["sub"]))
        # each data row its own group: rank (d, m) adds 10 d + m
        out["sub_rows"] = sub.all_reduce(torch.tensor([10.0 * (rank // 2)
                                                      + rank % 2]))
        out["submesh"] = (submesh(mesh, ["data"]).size(),
                          CollectiveGroup(submesh(mesh, ["model"])).rank)
        out["errors"] = {
            "op": _error(lambda: group.all_reduce(block, "xor")),
            "put": _error(lambda: group.put(np.ones(3))),
            "reduce_scatter": _error(
                lambda: group.reduce_scatter(torch.ones(1, 3))),
            "all_to_all": _error(lambda: group.all_to_all(torch.zeros(3))),
            "no_axis": _error(lambda: CollectiveGroup(mesh)),
            "bad_axis": _error(lambda: CollectiveGroup(mesh, "expert")),
            "mesh_size": _error(lambda: make_mesh({"data": 3})),
        }
        out["bandwidth"] = group.allreduce_bandwidth(nbytes=1 << 16, iters=8)
        _save(out_dir, rank, out)
    finally:
        bootstrap.cleanup()


DP_STEPS, DP_LR, DP_IMAGE = 3, 0.05, 32


def _dp_run(inputs: dict, use_bn: bool, mesh, batches, **dp_options):
    model = ConvNet((DP_IMAGE, DP_IMAGE), device="cpu", use_bn=use_bn)
    model.load_state_dict(inputs["bn" if use_bn else "no_bn"])
    state = TrainState(model, lr=DP_LR)
    dp = DataParallel(model, mesh, **dp_options)
    dp.shard_state(state)
    losses = []
    for images, labels in batches:
        x, y = dp.shard_batch(images, labels)
        losses.append(dp.train_step(state, torch.from_numpy(x),
                                    torch.from_numpy(y).long()))
    return dp, state, torch.stack(losses)


def dp_worker(rank: int, world_size: int, out_dir: str, in_path: str) -> None:
    """``DataParallel`` from the bridged trees of ``in_path`` on its global
    batches: with and without BN, the biased-BN and average-loss cases and
    the first parameter sync."""
    torch.set_num_threads(1)
    bootstrap.init(device="cpu")
    try:
        inputs = torch.load(in_path, weights_only=False)
        mesh = make_mesh({"data": world_size})
        out = {}
        for use_bn in (False, True):
            _, state, losses = _dp_run(inputs, use_bn, mesh,
                                       inputs["batches"])
            out[f"losses_{use_bn}"] = losses
            out[f"state_{use_bn}"] = state.model.state_dict()
        _, _, out["avg_losses"] = _dp_run(inputs, False, mesh,
                                          inputs["batches"][:1],
                                          average_loss=True)
        dp, state, _ = _dp_run(inputs, True, mesh, [inputs["biased"]])
        out["biased_state"] = state.model.state_dict()
        out["unshard_rank1"] = dp.unshard_state(state, rank=1)
        # the first sync: rank 0's parameters win over a perturbed rank's
        model = ConvNet((DP_IMAGE, DP_IMAGE), device="cpu", seed=rank)
        DataParallel(model, mesh).shard_state(TrainState(model))
        out["synced"] = model.state_dict()
        _save(out_dir, rank, out)
    finally:
        bootstrap.cleanup()


def failing_worker(rank: int, world_size: int, seconds: float) -> None:
    """Rank 1 fails at once; the others wait ``seconds`` (to be killed)."""
    if rank == 1:
        raise RuntimeError("rank 1 fails on purpose")
    time.sleep(seconds)


#: the sequence-parallel attentions by name (``make_*(mesh, axis, ...)``)
SP_ATTENTION = {"ring": make_ring_attention, "ulysses": make_ulysses_attention,
                "flash_ring": make_flash_ring_attention}


def sp_attention_worker(rank: int, world_size: int, out_dir: str,
                        in_path: str) -> None:
    """Each case of ``in_path`` (scheme, options, global q, k, v [B, S, H,
    D] and the loss weights w) on a ``{"sp": world_size}`` mesh: this
    rank's shard of the output and of the gradients of sum(out * w) over
    every rank; and the validations (an unknown axis, heads that do not
    split over the ranks)."""
    torch.set_num_threads(1)
    bootstrap.init(device="cpu")
    try:
        inputs = torch.load(in_path, weights_only=False)
        mesh = make_mesh({"sp": world_size})
        out = {}
        for name, (scheme, options, arrays) in inputs["cases"].items():
            fn = SP_ATTENTION[scheme](mesh, "sp", **options)
            q, k, v, w = (torch.from_numpy(a).chunk(world_size, 1)[rank]
                          .contiguous().requires_grad_() for a in arrays)
            o = fn(q, k, v)
            grads = torch.autograd.grad((o.float() * w).sum(), (q, k, v))
            out[name] = {"out": o.detach(), "grads": grads}
        two_heads = torch.zeros((1, 8, 2, 4))
        out["errors"] = {
            scheme: _error(lambda f=f: f(mesh, "nope"))
            for scheme, f in SP_ATTENTION.items()}
        out["errors"]["heads"] = _error(lambda: make_ulysses_attention(
            mesh, "sp")(two_heads, two_heads, two_heads))
        _save(out_dir, rank, out)
    finally:
        bootstrap.cleanup()


#: the SeqParallel cases: the LM, its batch and the learning rates
SP_CFG = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
              max_len=64)
SP_BATCH, SP_SEQ, SP_SGD_LR, SP_ADAM_LR = 4, 32, 0.1, 1e-2
#: Adam's eps in the SeqParallel cases: at optax's 1e-8 the first update
#: is lr * sign(g), which on gradients that are 0 up to rounding (the k
#: bias's: sum_j ds_ij = 0) is noise
SP_ADAM_EPS = 1e-3


def sp_tx(opt: str):
    """The optimizer of a SeqParallel case: optax.sgd(SP_SGD_LR) or
    optax.adam(SP_ADAM_LR, eps=SP_ADAM_EPS)."""
    if opt == "sgd":
        return lambda params: SGD(params, SP_SGD_LR, momentum=0.0)

    def adam(params):
        opt = Adam(params, constant_schedule(SP_ADAM_LR))
        opt.eps = SP_ADAM_EPS
        return opt

    return adam


def seq_parallel_worker(rank: int, world_size: int, out_dir: str,
                        in_path: str) -> None:
    """One ``SeqParallel`` step on a ``{"data": 2, "sp": world_size //
    2}`` mesh from the bridged parameters of ``in_path`` on its global
    batch, for each attention scheme with SGD and with Adam: the loss and
    the parameters after the step; the constructor's validations."""
    torch.set_num_threads(1)
    bootstrap.init(device="cpu")
    try:
        inputs = torch.load(in_path, weights_only=False)
        mesh = make_mesh({"data": 2, "sp": world_size // 2})
        cfg = TransformerConfig(**SP_CFG)

        def ctor(attn):
            return TransformerLM(cfg, attn, seed=rank + 1)

        out = {}
        tokens, targets = inputs["batch"]
        for attn in ("ring", "ulysses", "flash_ring"):
            for opt in ("sgd", "adam"):
                sp = SeqParallel(ctor, sp_tx(opt), mesh, attn=attn)
                state = sp.init_state()
                if rank == 0:       # the others take rank 0's by the sync
                    state.model.load_state_dict(inputs["params"])
                sp.shard_state(state)
                loss = sp.train_step(state, *sp.shard_batch(tokens, targets))
                out[f"{attn}_{opt}"] = {
                    "loss": loss, "params": {
                        k: v.detach().clone()
                        for k, v in state.model.state_dict().items()},
                    "logits": sp.eval_logits(state,
                                             torch.from_numpy(tokens[:1]))}
        out["errors"] = {
            "axis": _error(lambda: SeqParallel(ctor, sp_tx("sgd"),
                                               make_mesh({"data": world_size}))),
            "attn": _error(lambda: SeqParallel(ctor, sp_tx("sgd"), mesh,
                                               attn="dense")),
        }
        _save(out_dir, rank, out)
    finally:
        bootstrap.cleanup()


#: the pipeline cases' LM (tests/test_pipeline.py's CFG) and global batch
PP_CFG = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=4, d_ff=64,
              max_len=64)
PP_BATCH, PP_SEQ = 8, 16
#: the constructor and shard_batch validations of tests/test_pipeline.py
#: (:192-201, :307-330) on 4 ranks: (mesh, config overrides, options);
#: ``attention_fn`` True passes a callable
PP_VALIDATIONS = {
    "chunks_layers": ({"data": 1, "pipe": 4}, {},
                      dict(microbatches=4, circular_chunks=3)),
    "chunks_microbatches": ({"data": 1, "pipe": 4}, dict(n_layers=8),
                            dict(microbatches=2, circular_chunks=2)),
    "chunks_zero": ({"data": 1, "pipe": 4}, {},
                    dict(microbatches=2, circular_chunks=0)),
    "layers": ({"data": 1, "pipe": 4}, dict(n_layers=3),
               dict(microbatches=2)),
    "no_pipe_axis": ({"data": 4}, {}, dict(microbatches=2)),
    "tp_heads": ({"data": 1, "model": 2, "pipe": 2}, dict(n_heads=3),
                 dict(microbatches=2, model_axis="model")),
    "seq_owns_attention": ({"data": 1, "pipe": 2, "sp": 2}, {},
                           dict(microbatches=2, seq_axis="sp",
                                attention_fn=True)),
    "seq_attn": ({"data": 1, "pipe": 2, "sp": 2}, {},
                 dict(microbatches=2, seq_axis="sp", seq_attn="bogus")),
    "shard_batch_sp": ({"data": 1, "pipe": 2, "sp": 2}, {},
                       dict(microbatches=2, seq_axis="sp")),
}
#: bubble_fraction's (S, M, v) grid, n_layers 16; on 4 ranks
PP_BUBBLES = [(s, m, v) for s in (2, 4) for m in (2, 4, 8) for v in (1, 2, 4)]


def _pp_validation(name: str) -> str:
    """The ValueError text of PP_VALIDATIONS[name] ('' if none)."""
    mesh, cfg, options = PP_VALIDATIONS[name]
    options = dict(options)
    if options.get("attention_fn"):
        options["attention_fn"] = lambda q, k, v: q

    def make():
        pp = PipelineParallel(TransformerConfig(**{**PP_CFG, **cfg}),
                              sp_tx("sgd"), make_mesh(mesh), **options)
        if name == "shard_batch_sp":
            bad = np.zeros((4, 15), np.int32)   # S 15 over sp 2
            pp.shard_batch(bad, bad)

    return _error(make)


def _pp_bubble(n_stages: int, microbatches: int, chunks: int):
    """bubble_fraction of a {"data": 4 / S, "pipe": S} engine over 16
    layers, or the constructor's ValueError text."""
    out = []

    def make():
        out.append(PipelineParallel(
            TransformerConfig(**{**PP_CFG, "n_layers": 16}), sp_tx("sgd"),
            make_mesh({"data": 4 // n_stages, "pipe": n_stages}),
            microbatches=microbatches,
            circular_chunks=chunks).bubble_fraction())

    err = _error(make)
    return out[0] if out else err


def pipeline_worker(rank: int, world_size: int, out_dir: str,
                    in_path: str) -> None:
    """Each case of ``in_path`` (mesh, config, engine options, optimizer,
    microbatches, the single-device state dict JAX drew, the global batch):
    ``PipelineParallel`` from that state, one step. Saves this rank's
    coordinates, parameter names and stage row before the step, the loss
    and the merged parameters after it; with ``checks``, also
    ``bubble_fraction`` over PP_BUBBLES and the PP_VALIDATIONS texts."""
    torch.set_num_threads(1)
    bootstrap.init(device="cpu")
    try:
        inputs = torch.load(in_path, weights_only=False)
        out = {}
        for name, case in inputs["cases"].items():
            mesh = make_mesh(case["mesh"])
            pp = PipelineParallel(TransformerConfig(**case["cfg"]),
                                  sp_tx(case["opt"]), mesh,
                                  microbatches=case["microbatches"],
                                  **case["options"])
            state = pp.shard_state(pp.init_state(params=case["params"]))
            res = {"coords": dict(zip(mesh.mesh_dim_names,
                                      mesh.get_coordinate())),
                   "names": sorted(n for n, _ in
                                   state.model.named_parameters()),
                   "row": pp.stage_row(state)}
            res["loss"] = pp.train_step(state,
                                        *pp.shard_batch(*case["batch"]))
            res["merged"] = pp.merged_params(state)
            out[name] = res
        if inputs.get("checks"):
            out["bubbles"] = {k: _pp_bubble(*k) for k in PP_BUBBLES}
            out["errors"] = {k: _pp_validation(k) for k in PP_VALIDATIONS}
        _save(out_dir, rank, out)
    finally:
        bootstrap.cleanup()



def mpmd_spmd_worker(rank: int, world_size: int, out_dir: str,
                     in_path: str) -> None:
    """``PipelineParallel`` over {"data": 1, "pipe": world_size} from the
    state dict of ``in_path``, Adam at its ``lr``, its ``microbatches``,
    ``steps`` steps on one fixed batch: the SPMD twin of the MPMD
    pipeline (tests/test_torch_mpmd.py). Saves the losses and the merged
    parameters."""
    torch.set_num_threads(1)
    bootstrap.init(device="cpu")
    try:
        inputs = torch.load(in_path, weights_only=False)
        lr = inputs["lr"]
        pp = PipelineParallel(
            TransformerConfig(**inputs["cfg"]),
            lambda params: Adam(params, constant_schedule(lr)),
            make_mesh({"data": 1, "pipe": world_size}),
            microbatches=inputs["microbatches"])
        state = pp.shard_state(pp.init_state(params=inputs["params"]))
        batch = pp.shard_batch(*inputs["batch"])
        losses = [float(pp.train_step(state, *batch))
                  for _ in range(inputs["steps"])]
        _save(out_dir, rank, {"losses": losses,
                              "merged": pp.merged_params(state)})
    finally:
        bootstrap.cleanup()

#: the PjitEngine cases' LM (tests/test_moe.py's CFG, dense unless
#: n_experts is set) and global batch; the ConvNet's images (28x28, as
#: tests/test_pjit_engine.py)
PJIT_CFG = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=2, d_ff=64,
                max_len=16)
PJIT_BATCH, PJIT_SEQ, PJIT_STEPS, PJIT_IMAGE = 8, 16, 3, 28
#: the rules of a case by name
PJIT_RULES = {"none": lambda: [], "megatron": megatron_rules,
              "expert": lambda: [(r"w_(up|down)", P("expert", None, None))],
              "fc": lambda: [("fc/kernel", P(None, "model"))],
              "fc_row": lambda: [("fc/kernel", P("model", None))],
              "qkv_only": lambda: [("attn/qkv/kernel",
                                    P(None, None, "model", None))],
              "conv_model": lambda: [("conv1/kernel",
                                      P(None, None, None, "model"))]}
#: the constructor's checks on 4 ranks: (mesh, engine options, model);
#: JAX's ValueErrors word for word, and what the port does not run yet
PJIT_VALIDATIONS = {
    "task": ({"data": 4}, dict(task="speech"), "lm"),
    "batch_axis": ({"data": 4}, dict(batch_axis="model"), "lm"),
    "fsdp_axis": ({"data": 4}, dict(fsdp_axis="model"), "lm"),
    "zero_conflict": ({"data": 2, "model": 2},
                      dict(zero_axis="model", fsdp_axis="data"), "lm"),
    "zero_axis": ({"data": 4}, dict(zero_axis="model"), "lm"),
    "compress_mode": ({"data": 4}, dict(grad_compress="fp8"), "lm"),
    "bucket_mb": ({"data": 4}, dict(bucket_mb=0.0), "lm"),
    "compress_rules": ({"data": 2, "model": 2},
                       dict(grad_compress="int8", rules="megatron"), "lm"),
    "overlap_fsdp": ({"data": 4}, dict(overlap_grad_sync=True,
                                       fsdp_axis="data"), "lm"),
    "compress_spatial": ({"data": 2, "spatial": 2},
                         dict(grad_compress="bf16",
                              input_spec=("data", "spatial")), "image"),
    "compress_bn": ({"data": 4}, dict(grad_compress="int8"), "image_bn"),
    "overlap_bn": ({"data": 4}, dict(overlap_grad_sync=True), "image_bn"),
}
#: what the port refuses with NotImplementedError: (mesh, options, model)
PJIT_UNPORTED = {
    "spatial_width": ({"data": 2, "spatial": 2},
                      dict(input_spec=("data", None, "spatial")), "image"),
    "spatial_lm": ({"data": 2, "spatial": 2},
                   dict(input_spec=("data", "spatial")), "lm"),
    "spatial_fsdp": ({"data": 2, "spatial": 2},
                     dict(input_spec=("data", "spatial"), fsdp_axis="data"),
                     "image"),
    "spatial_gathered": ({"data": 1, "spatial": 2, "model": 2},
                         dict(input_spec=("data", "spatial"),
                              rules="conv_model"), "image"),
    "narrow_band": ({"data": 1, "spatial": 4},
                    dict(input_spec=("data", "spatial"), image_size=(12, 12)),
                    "image"),
    "lower_step": ({"data": 4}, {}, "lm"),
}
#: the image models of the PjitEngine cases: (plan, use_bn); the s2d
#: plans run their fused kernels' CPU versions (ConvNetS2D's fused convs
#: and tails, ConvNetS2DT's fused tails and conv1+tail unit)
PJIT_IMAGE_MODELS = {"image": ("plain", False), "image_bn": ("plain", True),
                     "s2d_bn": ("s2d", True), "s2dt_bn": ("s2dt", True)}


def pjit_tx(opt: str):
    """The optimizer of a PjitEngine case: ``sp_tx``'s sgd and adam,
    ``sgd0`` (rate 0: the step's loss is the objective alone) or
    optax.adamw(1e-3, eps=1e-3)."""
    if opt == "sgd0":
        return lambda params: SGD(params, 0.0, momentum=0.0)
    if opt != "adamw":
        return sp_tx(opt)

    def adamw(params):
        opt = AdamW(params, constant_schedule(1e-3))
        opt.eps = 1e-3
        return opt

    return adamw


def _pjit_model(kind: str, cfg: dict, flash: bool, seed: int,
                image_size: int = PJIT_IMAGE):
    if kind == "lm":
        config = TransformerConfig(**cfg)
        return TransformerLM(config, flash_attention_fn() if flash else None,
                             mlp_cls=MoeMlp if config.n_experts else Mlp,
                             seed=seed)
    plan, use_bn = PJIT_IMAGE_MODELS[kind]
    return pick_convnet(image_size, plan=plan, device="cpu", seed=seed,
                        use_bn=use_bn, fused_tail=True, fused_conv=True)


def _pjit_engine(mesh: dict, options: dict, kind: str, seed: int):
    options = dict(options)
    rules = PJIT_RULES[options.pop("rules", "none")]()
    if "input_spec" in options:
        options["input_spec"] = P(*options["input_spec"])
    options.setdefault("task", "image" if kind != "lm" else "lm")
    return PjitEngine(_pjit_model(kind, PJIT_CFG, False, seed,
                                  (options.get("image_size")
                                   or (PJIT_IMAGE,))[0]),
                      pjit_tx("sgd"), make_mesh(mesh), rules=rules,
                      **options)


def _pjit_refusal(name: str) -> str:
    """The NotImplementedError text of PJIT_UNPORTED[name] ('' if none)."""
    mesh, options, kind = PJIT_UNPORTED[name]

    def make():
        eng = _pjit_engine(mesh, options, kind, 0)
        state = eng.shard_state()
        if name == "lower_step":
            eng.lower_step()
        images = np.zeros((4, PJIT_IMAGE, PJIT_IMAGE, 1), np.float32)
        eng.train_step(state, *eng.shard_batch(images, np.zeros(4, np.int64)))

    try:
        make()
    except NotImplementedError as e:
        return str(e)
    return ""


def pjit_worker(rank: int, world_size: int, out_dir: str,
                in_path: str) -> None:
    """Each case of ``in_path`` (task, mesh, config, rules, engine
    options, optimizer, clipping, the whole state dict JAX drew, the global
    batches): ``PjitEngine`` from that state, one step a batch. Saves the
    losses, the gathered parameters after the steps and this rank's
    parameter and moment shapes and specs; with ``checks``, also the
    PJIT_VALIDATIONS and PJIT_UNPORTED texts."""
    torch.set_num_threads(1)
    bootstrap.init(device="cpu")
    try:
        inputs = torch.load(in_path, weights_only=False)
        out = {}
        for name, case in inputs["cases"].items():
            kind = case["task"] if case["task"] == "lm" else case.get(
                "model", "image")
            options = dict(case.get("options", {}))
            if "input_spec" in options:
                options["input_spec"] = P(*options["input_spec"])
            eng = PjitEngine(
                _pjit_model(kind, case["cfg"], case.get("flash", False),
                            rank + 1, (options.get("image_size")
                                       or (PJIT_IMAGE,))[0]),
                pjit_tx(case["opt"]), make_mesh(case["mesh"]),
                task=case["task"], rules=PJIT_RULES[case["rules"]](),
                clip_norm=case.get("clip_norm", 0.0), **options)
            state = eng.shard_state(case["params"])
            res = {"local": {leaf.name: (tuple(leaf.param.shape), leaf.spec)
                             for leaf in eng.leaves},
                   "moments": {leaf.name: tuple(m.shape) for leaf, m in zip(
                       eng.leaves, getattr(state.optimizer, "mu", []))}}
            res["losses"] = torch.stack([
                eng.train_step(state, *eng.shard_batch(x, y))
                for x, y in case["batches"]])
            res["params"] = eng.full_params(state)
            out[name] = res
        if inputs.get("checks"):
            out["errors"] = {k: _error(lambda k=k: _pjit_engine(
                *PJIT_VALIDATIONS[k], 0)) for k in PJIT_VALIDATIONS}
            out["refusals"] = {k: _pjit_refusal(k) for k in PJIT_UNPORTED}
        _save(out_dir, rank, out)
    finally:
        bootstrap.cleanup()


# -- compressed and bucketed gradient sync ---------------------------------

class RecordingGroup(CollectiveGroup):
    """A ``CollectiveGroup`` that records each sum all-reduce and
    all-to-all it issues: ``(op, numel, dtype name)`` in issue order."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.issued = []

    def sum_(self, t, async_op=False):
        self.issued.append(("sum", t.numel(), str(t.dtype)))
        return super().sum_(t, async_op)

    def all_to_all_start(self, x):
        self.issued.append(("a2a", x.numel(), str(x.dtype)))
        return super().all_to_all_start(x)


def _row(a, rank):
    """Rank ``rank``'s row of ``a``, a tensor of its own (the none mode
    reduces in place)."""
    return None if a is None else torch.from_numpy(a[rank].copy())


def compress_worker(rank: int, world_size: int, out_dir: str,
                    in_path: str) -> None:
    """``in_path``'s cases (every array's leading dim the ranks): each
    ``int8`` case's ``int8_block_pmean`` (mean and new residual), each
    ``bf16`` case's ``CompressedAllReduce("bf16").pmean``, and the
    telescoping run: ``tele`` steps of int8 with error feedback, the
    residual carried."""
    from tpu_sandbox_torch.parallel.collectives import (
        CompressedAllReduce,
        int8_block_pmean,
    )

    torch.set_num_threads(1)
    bootstrap.init(device="cpu")
    try:
        inputs = torch.load(in_path, weights_only=False)
        group = world_group()
        out = {"int8": {}, "bf16": {}}
        for name, (values, residual, block) in inputs["int8"].items():
            out["int8"][name] = int8_block_pmean(
                _row(values, rank), _row(residual, rank), group, world_size,
                block)
        for name, values in inputs["bf16"].items():
            out["bf16"][name] = CompressedAllReduce("bf16").pmean(
                _row(values, rank), group, world_size)[0]
        policy = CompressedAllReduce("int8", block=inputs["tele_block"])
        res, means = torch.zeros(inputs["tele"][0].shape[1:]), []
        for values in inputs["tele"]:
            mean, res = policy.pmean(_row(values, rank), group, world_size,
                                     res)
            means.append(mean)
        out["tele"] = (torch.stack(means), res)
        _save(out_dir, rank, out)
    finally:
        bootstrap.cleanup()


class _TwoLayer(torch.nn.Module):
    """y = (x @ b.kernel) @ a.kernel: the backward lands a's gradient
    before b's, while JAX's flatten order puts a first."""

    def __init__(self):
        super().__init__()
        gen = torch.Generator().manual_seed(0)
        self.a = torch.nn.Module()
        self.b = torch.nn.Module()
        self.a.kernel = torch.nn.Parameter(torch.randn(6, 3, generator=gen))
        self.b.kernel = torch.nn.Parameter(torch.randn(4, 6, generator=gen))

    def forward(self, x):
        return (x @ self.b.kernel) @ self.a.kernel


def buckets_worker(rank: int, world_size: int, out_dir: str,
                   in_path: str) -> None:
    """``sync_buckets`` of ``in_path``'s per-rank gradients and residuals
    (leaves in JAX's flatten order) at its ``bucket_bytes`` in each mode;
    the collectives each issue, through a ``RecordingGroup``; and the
    hooks of ``BucketedSync`` on ``_TwoLayer``: the order the gradients
    land in and the order the buckets issue in."""
    from tpu_sandbox_torch.parallel.buckets import BucketedSync, sync_buckets
    from tpu_sandbox_torch.parallel.collectives import CompressedAllReduce

    torch.set_num_threads(1)
    bootstrap.init(device="cpu")
    try:
        inputs = torch.load(in_path, weights_only=False)
        group = RecordingGroup()
        out = {}
        for mode, policy in inputs["modes"].items():
            grads = [_row(g, rank) for g in inputs["grads"]]
            res = [_row(r, rank) for r in inputs["residuals"]]
            group.issued = []
            means, new_res = sync_buckets(
                grads, group, world_size, CompressedAllReduce(**policy),
                res, inputs["bucket_bytes"])
            out[mode] = {"means": means, "residuals": new_res,
                         "issued": group.issued}
        model = _TwoLayer()
        landed = []
        for name, p in model.named_parameters():
            p.register_post_accumulate_grad_hook(
                lambda p, name=name: landed.append(name))
        hooks = {}
        for mode in ("none", "int8"):
            group.issued, landed[:] = [], []
            sync = BucketedSync([model.a.kernel, model.b.kernel], group,
                                CompressedAllReduce(mode), 1)
            sync.begin()
            x = torch.from_numpy(inputs["x"][rank])
            model(x).square().sum().backward()
            issued_in_backward = list(group.issued)
            sync.finish()
            sync.remove()
            hooks[mode] = {"landed": list(landed),
                           "issued_in_backward": issued_in_backward,
                           "issued": group.issued,
                           "grads": [model.a.kernel.grad.clone(),
                                     model.b.kernel.grad.clone()]}
            model.zero_grad(set_to_none=True)
        out["hooks"] = hooks
        # the hooks hold the sync weakly: dropping the model and its sync
        # frees the parameters by reference counting alone
        import gc
        import weakref
        gc.disable()
        try:
            model = _TwoLayer()
            sync = BucketedSync(list(model.parameters()), group,
                                CompressedAllReduce("none"), 1)
            param = weakref.ref(model.a.kernel)
            del model, sync
            out["freed_without_gc"] = param() is None
        finally:
            gc.enable()
        _save(out_dir, rank, out)
    finally:
        bootstrap.cleanup()


#: the DataParallel extension cases' ConvNet input (normalized synthetic
#: MNIST, as tests/test_grad_compress.py trains) and SGD rate, at which 3
#: steps stay in the loss's smooth regime, with BN too; the compressed
#: cases' rate ("sgd_fine"), at which a code that one framework rounds
#: the other way moves the parameters less than the gradients' own
#: rounding noise, so that later steps quantise the same values
DP_EXT_IMAGE, DP_EXT_LR, DP_EXT_FINE_LR = 28, 0.01, 1e-4
#: (optimizer, DataParallel options); a bucket target of 4096 bytes makes
#: four buckets of the ConvNet's gradients
DP_EXT_BUCKET_MB = 4096 / 2 ** 20
DP_EXT_CASES = {
    "plain_sgd": ("sgd", {}),
    "plain_momentum": ("momentum", {}),
    "plain_adamw": ("adamw", {}),
    "plain_fine": ("sgd_fine", {}),
    "none": ("sgd", dict(grad_compress="none")),
    "zero_momentum": ("momentum", dict(zero=True)),
    "zero_adamw": ("adamw", dict(zero=True)),
    "bf16": ("sgd_fine", dict(grad_compress="bf16")),
    "int8": ("sgd_fine", dict(grad_compress="int8")),
    "int8_noef": ("sgd_fine", dict(grad_compress="int8",
                                   error_feedback=False)),
    "overlap_none": ("sgd", dict(overlap_grad_sync=True,
                                 bucket_mb=DP_EXT_BUCKET_MB)),
    "overlap_int8": ("sgd_fine", dict(grad_compress="int8",
                                      overlap_grad_sync=True,
                                      bucket_mb=DP_EXT_BUCKET_MB)),
    "overlap_zero": ("momentum", dict(zero=True, overlap_grad_sync=True,
                                      bucket_mb=DP_EXT_BUCKET_MB)),
}
#: the cases also run on the 2-rank 'data' groups of a {"data": 2,
#: "pair": 2} mesh, where a sum over two ranks has one order
DP_EXT_PAIR_CASES = ("plain_sgd", "none", "overlap_none")
#: DataParallel's ValueErrors: options (``opt`` "factored" for an
#: optimizer whose state matches no parameter's shape, under zero)
DP_EXT_VALIDATIONS = {
    "bucket_mb": dict(bucket_mb=0.0),
    "bucket_mb_negative": dict(overlap_grad_sync=True, bucket_mb=-1.0),
    "grad_compress": dict(grad_compress="fp8"),
    "factored": dict(zero=True, opt="factored"),
}
DP_EXT_ADAMW_EPS = 1e-3


class _Factored(SGD):
    """An optimizer whose state holds a tensor that matches no
    parameter's shape (an (8,) row factor), as factored moments do."""

    STATE = ("trace", "factor")

    def __init__(self, params, lr):
        super().__init__(params, lr, momentum=0.0)
        self.factor = [torch.zeros(8)]


def dp_ext_optimizer(opt: str, params):
    """optax.sgd (None: the state's own update at ``dp_ext_lr(opt)``), sgd
    with momentum 0.9, adamw(1e-3, eps=DP_EXT_ADAMW_EPS), or
    ``_Factored``."""
    if opt in ("sgd", "sgd_fine"):
        return None
    if opt == "momentum":
        return SGD(params, DP_EXT_LR, momentum=0.9)
    if opt == "factored":
        return _Factored(params, DP_EXT_LR)
    adamw = AdamW(params, constant_schedule(1e-3))
    adamw.eps = DP_EXT_ADAMW_EPS
    return adamw


def dp_ext_lr(opt: str) -> float:
    return DP_EXT_FINE_LR if opt == "sgd_fine" else DP_EXT_LR


def _dp_ext_run(inputs, use_bn, mesh, axis, opt, options):
    model = ConvNet((DP_EXT_IMAGE, DP_EXT_IMAGE), device="cpu",
                    use_bn=use_bn)
    model.load_state_dict(inputs["bn" if use_bn else "no_bn"])
    state = TrainState(model, lr=dp_ext_lr(opt),
                       optimizer=dp_ext_optimizer(opt, model.parameters()))
    dp = DataParallel(model, mesh, axis, **options)
    dp.shard_state(state)
    grad1 = {}
    apply_update = state.apply_update

    def capture(params=None):
        if not grad1:     # step 1's synced gradients, before the update
            grad1.update((n, p.grad.clone()) for n, p in
                         zip(dp.names, dp.params) if p.grad is not None)
        apply_update(params)

    state.apply_update = capture
    losses = []
    for images, labels in inputs["batches"]:
        x, y = dp.shard_batch(images, labels)
        losses.append(dp.train_step(state, torch.from_numpy(x),
                                    torch.from_numpy(y).long()))
    res = state.grad_residual
    return {"losses": torch.stack(losses),
            "state": {k: v.detach().clone()
                      for k, v in model.state_dict().items()},
            "residual": None if res is None else dict(zip(dp.names, res)),
            "grad1": grad1,
            "blocks": {n: tuple(u.shape) for n, u in zip(dp.names,
                                                       dp.updates)}}


def dp_ext_worker(rank: int, world_size: int, out_dir: str,
                  in_path: str) -> None:
    """Each of DP_EXT_CASES from the bridged trees of ``in_path`` on its
    global batches, with and without BN, over all the ranks; the
    DP_EXT_PAIR_CASES on the 2-rank groups; the DP_EXT_VALIDATIONS."""
    torch.set_num_threads(1)
    bootstrap.init(device="cpu")
    try:
        inputs = torch.load(in_path, weights_only=False)
        mesh = make_mesh({"data": world_size})
        out = {}
        for use_bn in (False, True):
            for name, (opt, options) in DP_EXT_CASES.items():
                out[name, use_bn] = _dp_ext_run(inputs, use_bn, mesh, "data",
                                                opt, options)
        pairs = make_mesh({"data": 2, "pair": world_size // 2})
        pair_inputs = dict(inputs, batches=inputs["pair_batches"])
        for name in DP_EXT_PAIR_CASES:
            opt, options = DP_EXT_CASES[name]
            out["pair", name] = _dp_ext_run(pair_inputs, True, pairs, "data",
                                            opt, options)

        def invalid(options):
            options = dict(options)
            opt = options.pop("opt", "sgd")
            model = ConvNet((DP_EXT_IMAGE, DP_EXT_IMAGE), device="cpu",
                            use_bn=False)
            dp = DataParallel(model, mesh, **options)
            dp.shard_state(TrainState(
                model, optimizer=dp_ext_optimizer(opt, model.parameters())))

        out["errors"] = {k: _error(lambda o=o: invalid(o))
                         for k, o in DP_EXT_VALIDATIONS.items()}
        _save(out_dir, rank, out)
    finally:
        bootstrap.cleanup()


def entry_worker(rank: int, world_size: int, out_dir: str,
                 in_path: str) -> None:
    """The entry scripts' own rank bodies on ``in_path``'s cases: each
    case is (script, argv, the whole state dict to start from): every rank
    builds its model as the script does, takes that state (JAX's init,
    bridged), and runs ``mnist_distributed.train`` or
    ``lm_train.rank_main`` over a process group of its own; rank 0's
    printed lines are saved."""
    import contextlib
    import io

    from tpu_sandbox_torch import lm_train, mnist_distributed

    inputs = torch.load(in_path, weights_only=False)
    builders = {"mnist": (mnist_distributed, "pick_convnet"),
                "lm": (lm_train, "build_model")}
    out = {}
    for name, (script, argv, state) in inputs["cases"].items():
        module, attr = builders[script]
        build = getattr(module, attr)

        def seeded(*args, build=build, state=state, **kwargs):
            model = build(*args, **kwargs)
            model.load_state_dict(state)
            return model

        os.environ["INIT_METHOD"] = f"file://{out_dir}/store_{name}"
        setattr(module, attr, seeded)
        log = io.StringIO()
        try:
            with contextlib.redirect_stdout(log):
                args = module.build_parser().parse_args(argv)
                if script == "mnist":
                    torch.set_num_threads(1)
                    module.train(args, rank, world_size, rank)
                else:
                    module.rank_main(rank, world_size, args)
        finally:
            setattr(module, attr, build)
        out[name] = log.getvalue()
    _save(out_dir, rank, out)


GUARD_IMAGE, GUARD_BS = 32, 2


def guard_worker(rank: int, world_size: int, out_dir: str,
                 in_path: str) -> None:
    """The non-finite guard of ``DataParallel.train_step(guard=True)`` under
    ZeRO-1, int8 error feedback, the bucketed sync and AdamW: one good
    step, then a step whose loss is NaN on rank 1 only (every rank must
    skip it and keep its whole state bitwise), then ``train_resumable``
    over batches that are NaN on rank 0 only (every rank must abort on
    the third)."""
    from tpu_sandbox_torch.train import AbortOnAnomaly, train_resumable

    torch.set_num_threads(1)
    bootstrap.init(device="cpu")
    try:
        inputs = torch.load(in_path, weights_only=False)
        model = ConvNet((GUARD_IMAGE, GUARD_IMAGE), device="cpu")
        model.load_state_dict(inputs["init"])
        state = TrainState(model, optimizer=AdamW(
            model.parameters(), constant_schedule(1e-3)))
        dp = DataParallel(model, image_size=(GUARD_IMAGE, GUARD_IMAGE),
                          zero=True, grad_compress="int8",
                          overlap_grad_sync=True, bucket_mb=0.001)
        dp.shard_state(state)

        def batch(i, poison_rank=None):
            x, y = inputs["batches"][i]
            x, y = dp.shard_batch(x, y)
            x = torch.from_numpy(x.copy())
            if rank == poison_rank:
                x[0, 0, 0, 0] = float("nan")
            return x, torch.from_numpy(y).long()

        out = {"first": dp.train_step(state, *batch(0), guard=True)}
        out["before"] = state.host_view()
        out["poisoned"] = dp.train_step(state, *batch(1, poison_rank=1),
                                        guard=True)
        out["after"] = state.host_view()
        bad = [batch(i, poison_rank=0) for i in range(1, 4)]
        try:
            train_resumable(lambda s, x, y: dp.train_step(s, x, y,
                                                          guard=True),
                            state, bad, 1, max_bad_steps=3, verbose=False)
            out["aborted"] = False
        except AbortOnAnomaly as e:
            out["aborted"] = str(e)
        out["end"] = state.host_view()
        _save(out_dir, rank, out)
    finally:
        bootstrap.cleanup()


# -- BN statistics seams under a group -------------------------------------

#: the BN statistics seams held under a 2-rank group against one rank on
#: the whole batch: the fused tails with and without the conv's sums, the
#: fused conv1+tail unit, and the plain chains
BN_SEAMS = ("bn_tail_t", "bn_tail_t_ysums", "bn_tail", "bn_tail_ysums",
            "conv1_tail_t", "grouped_bn", "grouped_bn_t")
#: the StatsGroup's count: the ranks' equal rows times the ranks (a host
#: number), or summed with the statistics (unequal image bands)
BN_SEAM_COUNTS = ("equal", "summed")


def bn_seam(name: str, arrays: dict, group=None) -> dict:
    """One seam's forward and backward on ``arrays`` (numpy, f32) with the
    statistics over ``group`` (a ``StatsGroup``; None: these rows):
    the output, mu and var where the function returns them, and the
    gradients of sum(out * cot)."""
    from tpu_sandbox_torch.models.convnet_s2d import GroupedBN
    from tpu_sandbox_torch.models.convnet_s2d_t import GroupedBNT
    from tpu_sandbox_torch.ops import bn_tail, bn_tail_t, conv1_tail_t

    co, blk = int(arrays["co"]), int(arrays["blk"])
    t = {k: torch.from_numpy(np.ascontiguousarray(v)).requires_grad_(
        k not in ("x", "cot")) for k, v in arrays.items()
        if k not in ("co", "blk")}
    if name.startswith("bn_tail"):
        mod = bn_tail_t if name.startswith("bn_tail_t") else bn_tail
        fn = (mod.fused_bn_relu_pool_t if mod is bn_tail_t
              else mod.fused_bn_relu_pool)
        y = t["y"]
        ysums = None
        if name.endswith("ysums"):
            red = (0, 1, 3) if mod is bn_tail_t else (0, 1, 2)
            yf = y.detach()
            s, ss = yf.sum(dim=red), yf.square().sum(dim=red)
            ysums = ((s[:, None], ss[:, None]) if mod is bn_tail_t
                     else (s[None], ss[None]))
        out, mu, var = fn(y, t["gamma"], t["beta"], co, blk, 1e-5, ysums,
                          group)
        leaves = ("y", "gamma", "beta")
    elif name == "conv1_tail_t":
        out, mu, var = conv1_tail_t.conv1_tail_t(
            t["x"], t["k5"], t["cb"], t["gamma"], t["beta"], co, blk, 1e-5,
            group)
        leaves = ("k5", "cb", "gamma", "beta")
    else:
        bn = (GroupedBN if name == "grouped_bn" else GroupedBNT)(
            co, torch.float32)
        bn.stats_group = group
        with torch.no_grad():
            bn.scale.copy_(t["gamma"])
            bn.bias.copy_(t["beta"])
        out = bn(t["y"])
        mu, var = bn.mean.detach() / 0.1, (bn.var.detach() - 0.9) / 0.1
        t["gamma"], t["beta"] = bn.scale, bn.bias
        leaves = ("y", "gamma", "beta")
    (out * t["cot"]).sum().backward()
    return {"out": out.detach(), "mu": mu.detach(), "var": var.detach(),
            **{f"d{k}": t[k].grad.detach() for k in leaves}}


def bn_seam_worker(rank: int, world_size: int, out_dir: str,
                   in_path: str) -> None:
    """Each seam of ``in_path`` on this rank's block of the batch rows
    (dim 0 of every batched array), the statistics over every rank."""
    from tpu_sandbox_torch.parallel.collectives import StatsGroup

    torch.set_num_threads(1)
    bootstrap.init(device="cpu")
    try:
        inputs = torch.load(in_path, weights_only=False)
        out = {}
        for counts in BN_SEAM_COUNTS:
            group = StatsGroup([world_group()],
                               equal_rows=counts == "equal")
            for name, arrays in inputs.items():
                n = arrays["cot"].shape[0] // world_size
                mine = {k: (v[rank * n:(rank + 1) * n]
                            if k in ("y", "x", "cot") else v)
                        for k, v in arrays.items()}
                out[name, counts] = bn_seam(name, mine, group)
        _save(out_dir, rank, out)
    finally:
        bootstrap.cleanup()
