"""The data-parallel extensions through the entry scripts: ``python -m
tpu_sandbox_torch.mnist_distributed --force-cpu -g 2`` with ``--zero --opt
adamw``, with ``--grad-compress int8`` and with ``--overlap-grad-sync
--bucket-mb 1``, and ``python -m tpu_sandbox_torch.lm_train --force-cpu
--parallelism dp --devices 2 --grad-compress int8 --overlap-grad-sync``,
against the JAX scripts (mnist_distributed.py, lm_train.py) on the same
synthetic data from the same weights.

Two gloo ranks, spawned once for the module (tests/torch_dist_workers.py
``entry_worker``), run each script's own rank body (``train``,
``rank_main``) from the arguments its parser gives, every rank's model
taking the init the JAX script draws from ``jax.random.key(0)`` (bridged);
the JAX scripts run here on 2 virtual CPU devices. Rank 0 prints the JAX
script's lines, and the losses they print agree within 2e-4 (the last
printed digit, rounded on both sides): fp32 on both sides; at the
scripts' rates (SGD and AdamW at 1e-4, the LM's Adam at 1e-3) an int8
code that the two frameworks round apart moves no printed digit. Also:
the ``--zero``/sgd note printed once, from the launcher, as JAX's;
the flag groups' flags, choices, defaults and help the JAX CLI's; and
the JAX script's SystemExit for the sync flags outside dp.
"""

import contextlib
import io
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_dist_workers import entry_worker
from tpu_sandbox.models import pick_convnet as jax_pick_convnet
from tpu_sandbox.train import TrainState as JaxTrainState
from tpu_sandbox.utils import cli as jax_cli
from tpu_sandbox_torch import lm_train, mnist_distributed
from tpu_sandbox_torch.parallel.launch import spawn
from tpu_sandbox_torch.utils import cli
from tpu_sandbox_torch.utils.bridge import params_from_flax
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import lm_train as jax_lm_train  # noqa: E402
import mnist_distributed as jax_mnist  # noqa: E402

WORLD = 2
MNIST = ["-g", "2", "--force-cpu", "--image-size", "32", "--batch-size",
         "2", "--synthetic-n", "40", "--limit-steps", "4", "--log-every",
         "2", "--epochs", "1", "--dtype", "fp32"]
LM = ["--force-cpu", "--parallelism", "dp", "--devices", "2", "--steps",
      "6", "--log-every", "2", "--seq-len", "32"]
CASES = {
    "zero_adamw": ("mnist", MNIST + ["--zero", "--opt", "adamw"]),
    "int8": ("mnist", MNIST + ["--grad-compress", "int8"]),
    "overlap": ("mnist", MNIST + ["--overlap-grad-sync", "--bucket-mb",
                                  "1"]),
    "lm_int8_overlap": ("lm", LM + ["--grad-compress", "int8",
                                    "--overlap-grad-sync"]),
}
MNIST_LINE = re.compile(r"Rank \[0\], Epoch \[1/1\], Step \[(\d)/4\], "
                        r"Loss: (\d+\.\d{4})")
LM_LINE = re.compile(r"\[dp\] Step \[(\d)/6\], Loss: (\d+\.\d{4})")


def _jax_init(script, argv):
    """The parameters the JAX script starts from: its model, its optax
    state from key(0), bridged."""
    if script == "mnist":
        args = _jax_mnist_args(argv)
        model = jax_pick_convnet(args.image_size, plan=args.plan,
                                 num_classes=10, dtype=jnp.float32)
        sample = jnp.zeros((1, args.image_size, args.image_size, 1))
        tx = jax_mnist.make_optimizer(args)
    else:
        args = jax_lm_train.build_parser().parse_args(argv)
        from tpu_sandbox.models.transformer import TransformerConfig
        from tpu_sandbox.models.transformer import TransformerLM
        cfg = TransformerConfig(vocab_size=args.vocab, d_model=args.d_model,
                                n_heads=args.n_heads, n_layers=args.n_layers,
                                d_ff=args.d_ff, max_len=args.seq_len,
                                dtype=jnp.float32)
        model = TransformerLM(cfg)
        sample = jnp.zeros((1, args.seq_len), jnp.int32)
        import optax
        tx = optax.adam(args.lr)
    state = JaxTrainState.create(model, jax.random.key(0), sample, tx)
    return params_from_flax(jax.tree.map(np.asarray, {
        "params": state.params, "batch_stats": state.batch_stats}))


def _jax_mnist_args(argv):
    """The JAX script's parser is built inside its main(); parse through
    it with sys.argv."""
    parsed = {}

    def capture(args, world_size):
        parsed["args"] = args

    old = sys.argv, jax_mnist.train
    sys.argv, jax_mnist.train = ["mnist_distributed.py", *argv], capture
    try:
        jax_mnist.main()
    finally:
        sys.argv, jax_mnist.train = old
    return parsed["args"]


def _jax_output(script, argv):
    jax.devices()          # the conftest's 8 virtual devices, not 2
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        if script == "mnist":
            args = _jax_mnist_args(argv)
            jax_mnist.train(args, args.gpus * args.nodes)
        else:
            jax_lm_train.train(jax_lm_train.build_parser().parse_args(argv))
    return out.getvalue()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_ext_entry")
    cases = {name: (script, argv, _jax_init(script, argv))
             for name, (script, argv) in CASES.items()}
    torch.save({"cases": cases}, tmp / "inputs.pt")
    spawn(entry_worker, WORLD, str(tmp), str(tmp / "inputs.pt"),
          init_method=f"file://{tmp}/store", timeout=240)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def _losses(text, pattern, steps):
    lines = [ln for ln in text.splitlines() if pattern.fullmatch(ln)]
    assert [int(pattern.fullmatch(ln)[1]) for ln in lines] == steps, text
    return [float(pattern.fullmatch(ln)[2]) for ln in lines]


@pytest.mark.parametrize("name", sorted(CASES))
def test_entry_logs_the_jax_scripts_losses(ranks, name):
    script, argv = CASES[name]
    want = _jax_output(script, argv)
    got = ranks[0][name]
    pattern, steps = ((MNIST_LINE, [2, 4]) if script == "mnist"
                      else (LM_LINE, [2, 4, 6]))
    np.testing.assert_allclose(_losses(got, pattern, steps),
                               _losses(want, pattern, steps), rtol=0,
                               atol=2e-4)
    last = got.strip().splitlines()[-1]
    assert re.fullmatch(r"Training complete in: \d+:\d\d:\d\d(\.\d+)?",
                        last)
    if script == "mnist":
        assert got.splitlines()[0] == want.splitlines()[0]   # the data line
    assert "Rank [" not in ranks[1][name] and "Step [" not in ranks[1][name]


def test_zero_with_sgd_prints_the_jax_note_once(capsys):
    """--zero with the default --opt sgd: the launcher prints JAX's note
    once (JAX mnist_distributed.py:51-64, 657-658), then trains."""
    jax_mnist._zero_sgd_note()
    want = capsys.readouterr().out.strip()
    mnist_distributed.main(["-g", "1", "--force-cpu", "--image-size", "32",
                            "--batch-size", "2", "--synthetic-n", "4",
                            "--limit-steps", "2", "--log-every", "1",
                            "--epochs", "1", "--zero"])
    out = capsys.readouterr().out
    assert want == mnist_distributed.ZERO_SGD_NOTE
    assert out.count(want) == 1 and out.startswith(want)
    assert "Step [2/2]" in out


@pytest.mark.parametrize("group", ["grad_compress", "overlap"])
@pytest.mark.parametrize("variant", [True, False])
def test_flag_groups_are_the_jax_clis(group, variant):
    import argparse

    def actions(module):
        parser = argparse.ArgumentParser()
        if group == "grad_compress":
            module.add_grad_compress_cli(parser, error_feedback=variant)
        else:
            module.add_overlap_cli(parser, prefetch=variant)
        return [(a.option_strings, a.dest, a.default, a.choices, a.help,
                 a.type, a.metavar) for a in parser._actions]

    assert actions(cli) == actions(jax_cli)


def test_mnist_distributed_takes_the_jax_scripts_extension_flags():
    args = mnist_distributed.build_parser().parse_args(
        ["--zero", "--grad-compress", "int8", "--no-error-feedback",
         "--overlap-grad-sync", "--bucket-mb", "2.5", "--prefetch"])
    ref = _jax_mnist_args(["--zero", "--grad-compress", "int8",
                           "--no-error-feedback", "--overlap-grad-sync",
                           "--bucket-mb", "2.5", "--prefetch"])
    for key in ("zero", "grad_compress", "no_error_feedback",
                "overlap_grad_sync", "bucket_mb", "prefetch"):
        assert getattr(args, key) == getattr(ref, key), key


@pytest.mark.parametrize("flags", [
    ["--parallelism", "tp", "--devices", "4", "--dp", "2",
     "--grad-compress", "bf16"],
    ["--parallelism", "pp", "--devices", "2", "--overlap-grad-sync"],
    ["--parallelism", "ep", "--devices", "2", "--grad-compress", "int8",
     "--overlap-grad-sync"],
], ids=["tp-bf16", "pp-overlap", "ep-int8-overlap"])
def test_sync_flags_outside_dp_exit_as_the_jax_script_does(flags):
    jax.devices()
    jargs = jax_lm_train.build_parser().parse_args(["--force-cpu", *flags])
    with pytest.raises(SystemExit) as want:
        jax_lm_train.train(jargs)
    args = lm_train.build_parser().parse_args(["--force-cpu", *flags])
    with pytest.raises(SystemExit) as got:
        lm_train.train(args)
    assert str(got.value) == str(want.value)
