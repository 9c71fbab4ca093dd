"""The LM entry script over gloo ranks (``python -m
tpu_sandbox_torch.lm_train --force-cpu``): sequence parallelism per
``--attn`` and under ``--remat``, the compiler-driven plans (dp over 2
ranks, tp over {"data": 2, "model": 2}, ep with 2 experts), each rank 0
printing the JAX script's lines and the losses of the single-device
function of the same flags; and ``--remat`` logging the losses of the
run without it. Moved out of tests/test_torch_lm_train.py so that a
worker of its own runs them; the module starts its entry runs a few at
a time (``run_entries``) while the references train here."""

import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from tpu_sandbox_torch import lm_train
from tpu_sandbox_torch.ops.losses import cross_entropy_loss
from tpu_sandbox_torch.train.trainer import to_device
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
#: entry runs at once, and the seconds one may take
PARALLEL, LIMIT = 3, 300


def run_entries(runs: dict) -> dict:
    """``python -m tpu_sandbox_torch.lm_train`` with each of ``runs``'
    argv, PARALLEL at a time: name -> CompletedProcess."""
    def one(argv):
        return subprocess.run(
            [sys.executable, "-m", "tpu_sandbox_torch.lm_train", *argv],
            cwd=ROOT, env=dict(os.environ), capture_output=True, text=True,
            timeout=LIMIT)

    with ThreadPoolExecutor(PARALLEL) as pool:
        futures = {name: pool.submit(one, argv)
                   for name, argv in runs.items()}
        return {name: f.result() for name, f in futures.items()}


def log_losses(stdout, p, steps, every):
    """The losses of the JAX script's log lines, which must be all the
    lines: one each ``every`` steps, then the total time."""
    lines = stdout.strip().splitlines()
    pat = rf"\[{p}\] Step \[(\d+)/{steps}\], Loss: (\d+\.\d{{4}})"
    rows = [re.fullmatch(pat, ln) for ln in lines[:-1]]
    assert all(rows), lines
    assert [int(m[1]) for m in rows] == list(range(every, steps + 1, every))
    assert re.fullmatch(r"Training complete in: \d+:\d\d:\d\d(\.\d+)?",
                        lines[-1])
    return [float(m[2]) for m in rows]


SP_FLAGS = ["--force-cpu", "--steps", "6", "--log-every", "2",
            "--seq-len", "32"]
SP_ATTN = ["ring", "ulysses", "flash_ring"]
#: the compiler-driven plans through the entry (SP_FLAGS' LM): dp and tp
#: compute the single-device function, ep the MoE LM's
PJIT_RUNS = {
    "dp": ["--parallelism", "dp", "--devices", "2"],
    "tp": ["--parallelism", "tp", "--devices", "4", "--dp", "2"],
    "ep": ["--parallelism", "ep", "--devices", "2"],
}
#: every entry run of the module: name -> argv
RUNS = {
    **{f"sp_{a}": SP_FLAGS + ["--parallelism", "sp", "--devices", "4",
                             "--attn", a] for a in SP_ATTN},
    "sp_remat": SP_FLAGS + ["--parallelism", "sp", "--devices", "4",
                            "--attn", "flash_ring", "--remat",
                            "--remat-policy", "dots"],
    **{f"pjit_{p}": SP_FLAGS + flags for p, flags in PJIT_RUNS.items()},
}


@pytest.fixture(scope="module")
def entries():
    """The module's entry runs, started in the background: a future of
    ``run_entries(RUNS)``."""
    with ThreadPoolExecutor(1) as pool:
        runs = pool.submit(run_entries, RUNS)
        yield runs             # the references train here meanwhile


@pytest.fixture(scope="module")
def dp_losses():
    """The same flags under --parallelism dp, run here."""
    args = lm_train.build_parser().parse_args(SP_FLAGS)
    return lm_train.train(args).losses


@pytest.mark.parametrize("attn", SP_ATTN)
def test_entry_script_trains_sp_on_four_gloo_ranks(entries, dp_losses,
                                                   attn):
    """``--parallelism sp --devices 4 --force-cpu``: four gloo ranks on a
    {"data": 2, "sp": 2} mesh, rank 0 printing the JAX script's lines; the
    loss falls, and the step is the single-device step's function (the
    mean loss over the global batch, the mean gradient): the printed
    losses are the dp run's within 2e-4 (the last printed digit)."""
    proc = entries.result()[f"sp_{attn}"]
    assert proc.returncode == 0, proc.stderr
    losses = log_losses(proc.stdout, "sp", 6, 2)
    assert losses[-1] < losses[0]
    np.testing.assert_allclose(losses, dp_losses, rtol=0, atol=2e-4)


@pytest.mark.parametrize("policy", ["full", "dots"])
def test_remat_logs_the_losses_of_the_run_without_it(policy):
    """As tests/test_lm_train.py::test_remat_matches_plain: --remat
    changes memory, not the function; here the logged losses are the
    same bits."""
    flags = ["--force-cpu", "--steps", "4", "--log-every", "2",
             "--seq-len", "32"]
    plain = lm_train.train(lm_train.build_parser().parse_args(flags))
    remat = lm_train.train(lm_train.build_parser().parse_args(
        flags + ["--remat", "--remat-policy", policy]))
    assert len(plain.losses) == 2 and remat.losses == plain.losses


def test_entry_script_trains_sp_under_remat(entries, dp_losses):
    """--parallelism sp --remat (the blocks recomputed around the
    flash-ring's collectives, every rank in the same order) logs the dp
    run's losses within 2e-4."""
    proc = entries.result()["sp_remat"]
    assert proc.returncode == 0, proc.stderr
    np.testing.assert_allclose(log_losses(proc.stdout, "sp", 6, 2),
                               dp_losses, rtol=0, atol=2e-4)


def _moe_losses(args):
    """The ep run's function in this process: the MoE LM with
    ``--devices`` experts on the whole batch, the mean CE plus 0.01 times
    the mean load-balance loss, Adam."""
    model = lm_train.build_model(args, torch.device("cpu"))
    opt = lm_train.make_optimizer(args, model)
    losses = []
    for t, y in lm_train.make_batches(args.vocab, args.batch, args.seq_len,
                                      args.steps, 0):
        tokens, targets = to_device(t, y, torch.device("cpu"))
        logits = model(tokens)
        aux = model.aux_losses()
        loss = cross_entropy_loss(logits.reshape(-1, logits.shape[-1]),
                                  targets.reshape(-1)) + (
            0.01 * sum(aux) / len(aux))
        loss.backward()
        opt.step()
        losses.append(loss.item())
    return losses[args.log_every - 1::args.log_every]


@pytest.mark.parametrize("run", sorted(PJIT_RUNS))
def test_entry_script_trains_the_pjit_plans_on_gloo_ranks(entries,
                                                          dp_losses, run):
    """``--force-cpu`` gloo ranks (2, or 4 for tp on {"data": 2, "model":
    2}), rank 0 printing the JAX script's lines; the loss falls, and the
    printed losses are the single-device function's within 2e-4 (the last
    printed digit): dp's for dp and tp, the MoE LM's for ep."""
    flags = SP_FLAGS + PJIT_RUNS[run]
    proc = entries.result()[f"pjit_{run}"]
    assert proc.returncode == 0, proc.stderr
    losses = log_losses(proc.stdout, run, 6, 2)
    assert losses[-1] < losses[0]
    want = dp_losses if run != "ep" else _moe_losses(
        lm_train.build_parser().parse_args(flags))
    np.testing.assert_allclose(losses, want, rtol=0, atol=2e-4)
