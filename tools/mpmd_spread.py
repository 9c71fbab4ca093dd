"""The MPMD pipeline's spread on the CPU: JAX's engines against each other,
the port against JAX.

    JAX_PLATFORMS=cpu python tools/mpmd_spread.py [--steps 21]

The setup of ``tests/test_mpmd.py`` and ``tests/test_torch_mpmd.py``
(vocab 64, d 32, 2 heads, 4 layers, d_ff 64, fp32; 2 stages, 4
microbatches, Adam at 1e-2 from the tree JAX drew on one batch [8, 16]).
It prints, as JSON lines:

- ``jax_mpmd_vs_jax_spmd``: JAX's ``MPMDPipeline`` against its SPMD
  ``PipelineParallel`` on a {"data": 1, "pipe": 2} mesh;
- ``port_mpmd_vs_jax_mpmd``: the port's ``MPMDPipeline`` (CPU) against
  JAX's;

each as the leaves that differ, the largest parameter difference outside
the key slices of ``attn.qkv.bias`` and on them (a key bias's gradient is
zero in exact arithmetic, so each engine's rounding noise there is what
Adam normalises into steps of about lr), and the largest loss difference;
then ``programs``: each ``StageProgram`` function of the port against
JAX's on the same numpy inputs, at an even and an uneven split, as its
largest difference over max|JAX| (the forwards; the gradients of ``bwd``,
``loss_grad`` and the five ZB-H1 functions; Adam's updates) and the
loss's relative difference.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from functools import partial
from pathlib import Path

os.environ.setdefault("JAX_PLATFORMS", "cpu")
os.environ.setdefault("XLA_FLAGS",
                      "--xla_force_host_platform_device_count=4")
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import optax  # noqa: E402
import torch  # noqa: E402

from tpu_sandbox.models.transformer import TransformerConfig as JConfig  # noqa: E402
from tpu_sandbox.models.transformer import TransformerLM as JLM  # noqa: E402
from tpu_sandbox.mpmd import MPMDPipeline as JPipeline  # noqa: E402
from tpu_sandbox.mpmd import program as jprogram  # noqa: E402
from tpu_sandbox.parallel.pipeline import PipelineParallel  # noqa: E402
from tpu_sandbox.runtime.mesh import make_mesh  # noqa: E402
from tpu_sandbox_torch.models.transformer import TransformerConfig  # noqa: E402
from tpu_sandbox_torch.mpmd import MPMDPipeline  # noqa: E402
from tpu_sandbox_torch.mpmd.program import StageProgram, stage_params  # noqa: E402
from tpu_sandbox_torch.train.optim import Adam, constant_schedule  # noqa: E402
from tpu_sandbox_torch.utils.bridge import params_from_flax  # noqa: E402

CFG = dict(vocab_size=64, d_model=32, n_heads=2, n_layers=4, d_ff=64,
           max_len=64)
M, LR = 4, 1e-2
SPLITS = {"even": (2, None), "uneven": (3, [2, 1, 1])}


def _batch():
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, 64, size=(8, 16)).astype(np.int32)
    return tokens, ((tokens + 7) % 64).astype(np.int32)


def _state(tree) -> dict:
    return {k: v.numpy() for k, v in params_from_flax(
        {"params": jax.tree.map(np.asarray, tree)}).items()}


def spread(ref: dict, got: dict, ref_losses, got_losses) -> dict:
    """Leaves that differ; the largest difference outside the key-bias
    slices and on them; the largest loss difference."""
    outside = key_bias = 0.0
    differ = 0
    for name, a in ref.items():
        b = got[name]
        differ += int(not np.array_equal(a, b))
        if name.endswith("attn.qkv.bias"):
            key_bias = max(key_bias, float(np.abs(a[1] - b[1]).max()))
            a, b = np.delete(a, 1, 0), np.delete(b, 1, 0)
        outside = max(outside, float(np.abs(a - b).max()))
    return {"leaves": len(ref), "leaves_differ": differ,
            "max_abs_outside_key_bias": outside,
            "max_abs_key_bias": key_bias,
            "max_abs_loss": max(abs(x - y) for x, y in
                                zip(ref_losses, got_losses))}


def pipelines(steps: int) -> None:
    tokens, targets = _batch()
    cfg = JConfig(**CFG)
    mesh = make_mesh({"data": 1, "pipe": 2}, devices=jax.devices()[:2])
    pp = PipelineParallel(cfg, optax.adam(LR), mesh, microbatches=M,
                          donate=False)
    state = pp.init_state(jax.random.key(0), jnp.asarray(tokens))
    flat = pp.merged_params(state)
    sstate = pp.shard_state(state)
    batch = pp.shard_batch(tokens, targets)
    spmd_losses = []
    for _ in range(steps):
        sstate, loss = pp.train_step(sstate, *batch)
        spmd_losses.append(float(loss))
    spmd = _state(pp.merged_params(sstate))
    jpipe = JPipeline(cfg, optax.adam(LR), n_stages=2, microbatches=M,
                      devices=jax.devices()[2:4])
    jpipe.init_from_flat(flat)
    jax_losses = jpipe.train(steps, tokens, targets)
    jmpmd = _state(jpipe.merged_params())
    print(json.dumps({"jax_mpmd_vs_jax_spmd": spread(
        spmd, jmpmd, spmd_losses, jax_losses), "steps": steps}), flush=True)
    port = MPMDPipeline(TransformerConfig(**CFG),
                        lambda ps: Adam(ps, constant_schedule(LR)),
                        n_stages=2, microbatches=M, devices="cpu")
    port.init_from_flat(params_from_flax(
        {"params": jax.tree.map(np.asarray, flat)}))
    port_losses = port.train(steps, tokens, targets)
    ours = {k: v.numpy() for k, v in port.merged_params().items()}
    print(json.dumps({"port_mpmd_vs_jax_mpmd": spread(
        jmpmd, ours, jax_losses, port_losses), "steps": steps}), flush=True)


def _dotted(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_dotted(v, f"{prefix}{k}."))
        else:
            out[f"{prefix}{k}"] = v
    return out


def _named(x) -> dict:
    """{name: array} of a tensor, an array, or a stage tree (the port's
    {part: {dotted name: tensor}} or JAX's {part: nested dict})."""
    if not isinstance(x, dict):
        return {"": x.detach().numpy() if isinstance(x, torch.Tensor)
                else np.asarray(x)}
    return {f"{part}/{k}": (v.detach().numpy()
                            if isinstance(v, torch.Tensor) else v)
            for part, sub in x.items() for k, v in _dotted(sub).items()}


def _rel(got, want) -> float:
    """max |got - want| / max |want| over the leaves of ``want``."""
    got, want = _named(got), _named(want)
    assert sorted(got) == sorted(want)
    return max(float(np.abs(got[k] - b).max())
               / max(float(np.abs(b).max()), 1e-30)
               for k, b in want.items() if b.size)


def programs() -> None:
    tokens = np.zeros((1, 16), np.int32)
    flat = jax.tree.map(np.asarray, JLM(JConfig(**CFG)).init(
        jax.random.key(0), tokens)["params"])
    state = params_from_flax({"params": flat})
    out = {"fwd": 0.0, "grads": 0.0, "updates": 0.0, "loss": 0.0}
    for n, split in SPLITS.values():
        for s in range(n):
            jp = jprogram.StageProgram(JConfig(**CFG), optax.adam(LR), s, n,
                                       M, layer_split=split)
            pp = StageProgram(TransformerConfig(**CFG),
                              lambda ps: Adam(ps, constant_schedule(LR)),
                              s, n, M, device="cpu", layer_split=split)
            jparams = jprogram.stage_params(flat, s, n, layer_split=split)
            params = stage_params(state, s, n, layer_split=split)
            rng = np.random.default_rng(10 * s)
            toks = rng.integers(0, 64, (2, 16)).astype(np.int32)
            x = toks if s == 0 else rng.standard_normal(
                (2, 16, 32)).astype(np.float32)
            g = (rng.standard_normal((2, 16, 32)) * 0.1).astype(np.float32)
            tg = ((toks + 7) % 64).astype(np.int32)
            tx, tgt, tgo = (torch.from_numpy(x).long() if s == 0 else
                            torch.from_numpy(x)), torch.from_numpy(
                tg).long(), torch.from_numpy(g)
            host = partial(jax.tree.map, np.asarray)
            pairs = []
            if s < n - 1:
                out["fwd"] = max(out["fwd"], _rel(
                    pp.fwd(params, tx), np.asarray(jp.fwd(jparams, x))))
                pairs.append((pp.bwd(params, tx, tgo)[0],
                              jp.bwd(jparams, x, g)[0]))
            else:
                lv, *ours = pp.loss_grad(params, tx, tgt)
                jlv, *theirs = jp.loss_grad(jparams, x, tg)
                pairs.append((tuple(ours), tuple(theirs)))
                lv2, gx, st = pp.loss_bwd_input(params, tx, tgt)
                jlv2, jgx, jst = jp.loss_bwd_input(jparams, x, tg)
                out["loss"] = max(out["loss"], *(
                    abs(a.item() - float(b)) / abs(float(b))
                    for a, b in ((lv, jlv), (lv2, jlv2))))
                pairs += [(gx, jgx), (pp.loss_bwd_weight(params, tgt, st),
                                      jp.loss_bwd_weight(jparams, tg, jst))]
            if s == 0:
                pairs.append((pp.bwd_weight_chain(params, tx, tgo),
                              jp.bwd_weight_chain(jparams, x, g)))
            elif s < n - 1:
                gx, st = pp.bwd_input(params, tx, tgo)
                jgx, jst = jp.bwd_input(jparams, x, g)
                pairs += [(gx, jgx), (pp.bwd_weight(params, st),
                                      jp.bwd_weight(jparams, jst))]
            for ours, theirs in pairs:
                if isinstance(ours, tuple):
                    for a, b in zip(ours, theirs):
                        out["grads"] = max(out["grads"], _rel(a, host(b)))
                else:
                    out["grads"] = max(out["grads"], _rel(ours, host(theirs)))
            jgrads = jax.tree.map(
                lambda a: (rng.standard_normal(a.shape) * 0.1).astype(
                    a.dtype), jparams)
            grads = {p: {k: torch.from_numpy(np.asarray(v)) for k, v in
                         _dotted(sub).items()} for p, sub in jgrads.items()}
            jnew, _ = jp.apply_grads(jparams, jp.init_opt_state(jparams),
                                     jgrads)
            new, _ = pp.apply_grads(params, pp.init_opt_state(params),
                                    grads)
            out["updates"] = max(out["updates"], _rel(
                new, jax.tree.map(np.asarray, jnew)))
    print(json.dumps({"programs": out,
                      "of": "max |port - JAX| / max |JAX|"}), flush=True)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=21)
    args = p.parse_args(argv)
    torch.set_num_threads(1)
    jax.config.update("jax_threefry_partitionable", True)
    pipelines(args.steps)
    programs()
    return 0


if __name__ == "__main__":
    sys.exit(main())
