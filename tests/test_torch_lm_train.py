"""The port's LM trainer (tpu_sandbox_torch/lm_train.py and train/optim.py)
== the JAX one: three fp32 Adam steps of the LM from equal weights on
make_batches' batches give the same losses (rtol 1e-5), with the plain
attention and a constant rate, and with flash attention, the cosine
schedule's warmup and global-norm clipping; the schedules' learning rates
and the clipping against optax's; the batches bit for bit; the entry
point's log lines; the JAX script's exits of sequence, pipeline and
compiler-driven parallelism and their refusals without the cards; and
dp's compressed and bucketed sync taking the engine. Their runs over gloo
ranks and --remat's losses: tests/test_torch_lm_entry.py and
tests/test_torch_lm_entry_pp.py."""

import os
import re
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import lm_train as jax_lm_train  # noqa: E402
from tpu_sandbox.models.transformer import TransformerConfig as JaxConfig  # noqa: E402
from tpu_sandbox.models.transformer import TransformerLM as JaxLM  # noqa: E402
from tpu_sandbox.ops.losses import cross_entropy_loss as jax_ce  # noqa: E402
from tpu_sandbox.ops.pallas_attention import flash_attention_fn as jax_flash_fn  # noqa: E402
from tpu_sandbox_torch import lm_train  # noqa: E402
from tpu_sandbox_torch.train import optim  # noqa: E402
from tpu_sandbox_torch.train.trainer import to_device  # noqa: E402
from tpu_sandbox_torch.utils.bridge import params_from_flax  # noqa: E402
from test_torch_lm_entry import PJIT_RUNS  # noqa: E402

FLAGS = ["--vocab", "96", "--d-model", "64", "--n-heads", "2", "--n-layers",
         "2", "--d-ff", "128", "--seq-len", "64", "--batch", "2", "--steps",
         "3"]


def _jax_losses(args):
    """lm_train.py's dp path without the engine: the same model, optax
    chain and loss, jitted per step."""
    cfg = JaxConfig(vocab_size=args.vocab, d_model=args.d_model,
                    n_heads=args.n_heads, n_layers=args.n_layers,
                    d_ff=args.d_ff, max_len=args.seq_len, dtype=jnp.float32)
    model = JaxLM(cfg, attention_fn=jax_flash_fn(interpret=True)
                  if args.flash else None)
    if args.schedule == "cosine":
        lr = optax.warmup_cosine_decay_schedule(
            0.0, args.lr, warmup_steps=args.warmup,
            decay_steps=max(args.steps, args.warmup + 1),
            end_value=args.lr * 0.1)
    else:
        lr = args.lr
    tx = optax.adam(lr)
    if args.clip_norm:
        tx = optax.chain(optax.clip_by_global_norm(args.clip_norm), tx)
    params = model.init(jax.random.key(0),
                        jnp.zeros((1, args.seq_len), jnp.int32))["params"]
    opt_state = tx.init(params)

    @jax.jit
    def step(params, opt_state, tokens, targets):
        def loss_fn(p):
            logits = model.apply({"params": p}, tokens)
            return jax_ce(logits.reshape(-1, logits.shape[-1]),
                          targets.reshape(-1))

        loss, grads = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss

    init = jax.tree.map(np.asarray, params)
    losses = []
    for tokens, targets in jax_lm_train.make_batches(
            args.vocab, args.batch, args.seq_len, args.steps, 0):
        params, opt_state, loss = step(params, opt_state, tokens, targets)
        losses.append(float(loss))
    return init, losses


@pytest.mark.parametrize("extra", [
    [],
    ["--flash", "--schedule", "cosine", "--warmup", "1", "--clip-norm",
     "0.5"],
], ids=["plain-const", "flash-cosine-clip"])
def test_three_adam_steps_match_jax(extra):
    args = lm_train.build_parser().parse_args(FLAGS + extra)
    init, want = _jax_losses(args)
    device = torch.device("cpu")
    model = lm_train.build_model(args, device, seed=1)
    model.load_state_dict(params_from_flax({"params": init}))
    opt = lm_train.make_optimizer(args, model)
    step = lm_train.make_train_step(model, opt, args.clip_norm)
    got = [float(step(*to_device(t, y, device)))
           for t, y in lm_train.make_batches(args.vocab, args.batch,
                                             args.seq_len, args.steps, 0)]
    assert opt.count == 3
    # fp32 both sides, sums in other orders; Adam's first update is about
    # sign(g), so the losses are compared, not the parameters
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_batches_are_the_jax_scripts():
    for (t, y), (jt, jy) in zip(lm_train.make_batches(50, 3, 17, 4, 5),
                                jax_lm_train.make_batches(50, 3, 17, 4, 5)):
        assert t.dtype == jt.dtype and y.dtype == jy.dtype
        np.testing.assert_array_equal(t, jt)
        np.testing.assert_array_equal(y, jy)


@pytest.mark.parametrize("schedule,steps,warmup", [
    ("const", 5, 0), ("cosine", 10, 0), ("cosine", 10, 3), ("cosine", 2, 4),
    ("cosine", 1, 0)])
def test_schedule_learning_rates_match_optax(schedule, steps, warmup):
    lr = 1e-3
    if schedule == "cosine" and warmup > 0:
        want = optax.warmup_cosine_decay_schedule(
            0.0, lr, warmup_steps=warmup,
            decay_steps=max(steps, warmup + 1), end_value=lr * 0.1)
    elif schedule == "cosine":
        want = optax.cosine_decay_schedule(lr, decay_steps=max(steps, 1),
                                           alpha=0.1)
    else:
        want = optax.constant_schedule(lr)
    got = optim.lm_schedule(schedule, lr, steps, warmup)
    counts = range(steps + 3)
    # optax evaluates in f32, the port in Python floats
    np.testing.assert_allclose([got(c) for c in counts],
                               [float(want(c)) for c in counts],
                               rtol=1e-6, atol=1e-12)
    if warmup:
        assert got(0) == 0.0


@pytest.mark.parametrize("max_norm", [0.5, 3.0, 100.0])
def test_clipping_matches_optax_clip_by_global_norm(max_norm):
    rng = np.random.default_rng(4)
    grads = [rng.standard_normal(s).astype(np.float32)
             for s in ((3, 4), (5,), (2, 2, 2))]
    tx = optax.clip_by_global_norm(max_norm)
    want, _ = tx.update([jnp.asarray(g) for g in grads], tx.init(None))
    got = [torch.from_numpy(g.copy()) for g in grads]
    norm = optim.clip_by_global_norm_(got, max_norm)
    np.testing.assert_allclose(
        float(norm), float(optax.global_norm([jnp.asarray(g) for g in grads])),
        rtol=1e-6)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-7)


def _run_entry(*flags):
    return subprocess.run(
        [sys.executable, "-m", "tpu_sandbox_torch.lm_train", *flags],
        cwd=ROOT, env=dict(os.environ), capture_output=True, text=True,
        timeout=300)


def test_entry_script_prints_the_jax_scripts_log_lines():
    proc = _run_entry("--force-cpu", "--steps", "4", "--log-every", "2",
                      "--flash")
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.strip().splitlines()
    assert re.fullmatch(r"\[dp\] Step \[2/4\], Loss: \d+\.\d{4}", lines[0])
    assert re.fullmatch(r"\[dp\] Step \[4/4\], Loss: \d+\.\d{4}", lines[1])
    assert re.fullmatch(r"Training complete in: \d+:\d\d:\d\d(\.\d+)?",
                        lines[2])
    assert len(lines) == 3


def test_entry_script_needs_the_card_or_force_cpu():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present here")
    proc = _run_entry("--steps", "1")
    assert proc.returncode != 0
    assert "CUDA is not available" in proc.stderr


#: (flags, what the run names, the test id of the case): the compressed
#: and bucketed sync under dp
SYNCED = [
    (["--grad-compress", "int8"], "--grad-compress int8", "flags7"),
    (["--grad-compress", "bf16"], "--grad-compress bf16", "flags8"),
    (["--overlap-grad-sync"], "--overlap-grad-sync", "flags9"),
]


@pytest.mark.parametrize("flags,what", [u[:2] for u in SYNCED],
                         ids=[f"{i}-{what}" for _, what, i in SYNCED])
def test_sync_flags_run_dp_through_the_engine(flags, what, monkeypatch):
    """dp with the compressed or bucketed sync runs PjitEngine, at one
    device too (lm_train.py:141-148 builds the engine at any --devices),
    instead of the in-process step that has no sync."""
    seen = []
    monkeypatch.setattr(lm_train, "train_pjit", lambda a: seen.append(a))
    args = lm_train.build_parser().parse_args(["--force-cpu", *flags])
    lm_train.train(args)
    assert seen == [args] and lm_train.synced(args), what


@pytest.mark.parametrize("devices", ["1", "3"])
def test_sp_needs_an_even_device_count(devices):
    """--parallelism sp at an odd device count exits with the JAX script's
    message (data=2 x sp=n/2), before any rank starts."""
    args = lm_train.build_parser().parse_args([
        "--force-cpu", "--parallelism", "sp", "--devices", devices])
    with pytest.raises(SystemExit, match="even device count"):
        lm_train.train(args)


@pytest.mark.parametrize("flags", [
    ["--parallelism", "sp", "--devices", "2", "--grad-compress", "int8"],
    ["--parallelism", "sp", "--devices", "2", "--overlap-grad-sync"],
], ids=["grad-compress", "overlap"])
def test_sp_refuses_what_is_not_ported(flags):
    """The compressed and overlapped sync outside dp: the JAX script's
    refusal, word for word, before any rank starts."""
    args = lm_train.build_parser().parse_args(["--force-cpu", *flags])
    with pytest.raises(SystemExit) as err:
        lm_train.train(args)
    assert str(err.value) == _jax_exit(flags)


def test_sp_entry_needs_the_cards_or_force_cpu():
    """No card and no --force-cpu: the run fails before any rank starts
    (no fallback to gloo ranks on the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present here")
    args = lm_train.build_parser().parse_args([
        "--parallelism", "sp", "--devices", "2", "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lm_train.train(args)


def test_negative_clip_norm_exits_as_the_jax_script_does():
    args = lm_train.build_parser().parse_args(["--force-cpu", "--clip-norm",
                                               "-1"])
    with pytest.raises(SystemExit, match="clip-norm"):
        lm_train.train(args)


def test_parser_has_the_jax_scripts_flags():
    port = {a.dest: a.default for a in lm_train.build_parser()._actions}
    ref = {a.dest: a.default for a in jax_lm_train.build_parser()._actions}
    assert port == ref


def _jax_exit(flags):
    """The JAX script's SystemExit text for ``flags`` (on the CPU)."""
    # start the backend at the conftest's 8 virtual devices first: on a
    # fresh backend the script's ensure_devices would size the CPU client
    # to this case's device count, too few for a later case
    jax.devices()
    args = jax_lm_train.build_parser().parse_args(["--force-cpu", *flags])
    with pytest.raises(SystemExit) as err:
        jax_lm_train.train(args)
    return str(err.value)


@pytest.mark.parametrize("flags", [
    ["--parallelism", "pp", "--devices", "3", "--n-layers", "4"],
    ["--parallelism", "pp_sp", "--devices", "6"],
    ["--parallelism", "pp_sp", "--devices", "4", "--n-layers", "3"],
    ["--parallelism", "3d", "--devices", "4"],
    ["--parallelism", "3d", "--devices", "8", "--n-heads", "3"],
    ["--parallelism", "3d", "--devices", "8", "--n-layers", "3"],
    ["--parallelism", "pp", "--devices", "2", "--clip-norm", "0.5"],
    ["--parallelism", "3d", "--devices", "8", "--clip-norm", "1"],
], ids=["pp-layers", "pp_sp-devices", "pp_sp-layers", "3d-devices",
        "3d-heads", "3d-layers", "pp-clip-norm", "3d-clip-norm"])
def test_pipelines_exit_as_the_jax_script_does(flags):
    """Device counts, layer divisibility and --clip-norm: the JAX script's
    SystemExit, word for word, before any rank starts."""
    args = lm_train.build_parser().parse_args(["--force-cpu", *flags])
    with pytest.raises(SystemExit) as err:
        lm_train.train(args)
    assert str(err.value) == _jax_exit(flags)


def test_pp_needs_the_cards_or_force_cpu():
    """No card and no --force-cpu: the pipeline fails before any rank
    starts, even at one rank."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present here")
    for devices in ("1", "2"):
        args = lm_train.build_parser().parse_args([
            "--parallelism", "pp", "--devices", devices, "--steps", "1"])
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            lm_train.train(args)


@pytest.mark.parametrize("flags", [
    ["--parallelism", "tp", "--devices", "4", "--dp", "3"],
    ["--parallelism", "tp", "--devices", "4", "--dp", "0"],
    ["--parallelism", "tp", "--devices", "4", "--n-heads", "2"],
    ["--parallelism", "tp", "--devices", "2", "--vocab", "63"],
    ["--parallelism", "tp", "--devices", "2", "--grad-compress", "int8"],
    ["--parallelism", "ep", "--devices", "2", "--overlap-grad-sync"],
], ids=["tp-dp", "tp-dp-zero", "tp-heads", "tp-vocab", "tp-grad-compress",
        "ep-overlap"])
def test_pjit_plans_exit_as_the_jax_script_does(flags):
    """tp's divisibility checks and the compressed or overlapped sync
    outside dp: the JAX script's SystemExit, word for word, before any
    rank starts."""
    args = lm_train.build_parser().parse_args(["--force-cpu", *flags])
    with pytest.raises(SystemExit) as err:
        lm_train.train(args)
    assert str(err.value) == _jax_exit(flags)


@pytest.mark.parametrize("plan", sorted(PJIT_RUNS))
def test_pjit_plans_need_the_cards_or_force_cpu(plan):
    """No card and no --force-cpu: the plan fails before any rank starts
    (no fallback to gloo ranks on the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present here")
    args = lm_train.build_parser().parse_args(PJIT_RUNS[plan] + [
        "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        lm_train.train(args)
