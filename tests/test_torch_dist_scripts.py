"""The port's three distributed entry scripts (``python -m
tpu_sandbox_torch.{test_init,allreduce_toy,mnist_distributed}``) with
``--force-cpu`` at world size 2 (gloo), their refused flags, and the
momentum and AdamW updates of ``--opt`` against optax.

The scripts run once for the module, all at the same time, each with a
time limit: ``mnist_distributed -g 2`` (one process spawning two ranks)
and ``-n 2 -nr 0`` / ``-n 2 -nr 1`` (two processes sharing
``MASTER_PORT``, the multi-node form) train the same job and must log the
same losses. The data-parallel extensions', the checkpoints' and the
elastic runs' flags parse (their runs: tests/test_torch_dp_ext_entry.py,
tests/test_torch_elastic_entry.py); the cross-host agent flags are
refused."""

import os
import re
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpu_sandbox_torch import mnist_distributed
from tpu_sandbox_torch.runtime.bootstrap import find_free_port
from tpu_sandbox_torch.train import SGD, AdamW
from tpu_sandbox_torch.train.optim import constant_schedule
from tpu_sandbox_torch.utils.device import rank_device
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
LIMIT = 120
MNIST = ["--force-cpu", "--image-size", "32", "--batch-size", "2",
         "--synthetic-n", "40", "--limit-steps", "4", "--log-every", "2"]
RUNS = {
    "test_init": ["tpu_sandbox_torch.test_init", "--world-size", "2",
                  "--force-cpu"],
    "allreduce_toy": ["tpu_sandbox_torch.allreduce_toy", "-s", "2",
                      "--force-cpu"],
    "mnist": ["tpu_sandbox_torch.mnist_distributed", "-g", "2", *MNIST],
    "mnist_nr0": ["tpu_sandbox_torch.mnist_distributed", "-n", "2", "-nr",
                  "0", *MNIST],
    "mnist_nr1": ["tpu_sandbox_torch.mnist_distributed", "-n", "2", "-nr",
                  "1", *MNIST],
}
LOSS = re.compile(r"^Rank \[0\], Epoch \[(\d)/2\], Step \[(\d)/4\], "
                  r"Loss: (\d+\.\d{4})$")


@pytest.fixture(scope="module")
def runs():
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT")}
    env["OMP_NUM_THREADS"] = "1"
    nodes = {**env, "MASTER_ADDR": "127.0.0.1",
             "MASTER_PORT": find_free_port()}       # shared by the two nodes
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", *argv], cwd=ROOT, text=True,
        env=nodes if name.startswith("mnist_nr") else env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for name, argv in RUNS.items()}
    out = {}
    try:
        for name, p in procs.items():
            stdout, stderr = p.communicate(timeout=LIMIT)
            out[name] = (p.returncode, stdout, stderr)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


@pytest.mark.parametrize("name", sorted(RUNS))
def test_script_exits_0(runs, name):
    code, _, stderr = runs[name]
    assert code == 0, stderr[-3000:]


def test_test_init_prints_the_reference_lines(runs):
    lines = runs["test_init"][1].splitlines()
    assert lines[0] == "test_setup" and lines[-1] == "successful test_setup!"
    for rank in range(2):
        for line in (f"setting up rank={rank} (with world_size=2)",
                     "MASTER_ADDR='127.0.0.1'", "backend='gloo'",
                     f"--> done setting up rank={rank}",
                     f"rank {rank}: all_reduce check 3.0 == 3.0"):
            assert line in lines, line
    assert sum(line.startswith("port='") for line in lines) == 2


def test_allreduce_toy_sums_both_ranks(runs):
    pat = re.compile(r"^rank: (\d), step: (\d+), value: (\d), "
                     r"reduced sum: (\d+)\.$")
    rows = [pat.match(line) for line in runs["allreduce_toy"][1].splitlines()
            if line.startswith("rank: ")]
    assert all(rows) and len(rows) == 20
    by_step: dict = {}
    for m in rows:
        by_step.setdefault(int(m[2]), {})[int(m[1])] = (int(m[3]), int(m[4]))
    assert sorted(by_step) == list(range(1, 11))
    for step, seen in by_step.items():
        (v0, s0), (v1, s1) = seen[0], seen[1]
        assert s0 == s1 == v0 + v1, (step, seen)


def _losses(stdout):
    rows = [LOSS.match(line) for line in stdout.splitlines()
            if line.startswith("Rank [")]
    assert all(rows), stdout
    return [(int(m[1]), int(m[2]), float(m[3])) for m in rows]


def test_mnist_distributed_logs_rank0(runs):
    stdout = runs["mnist"][1]
    assert stdout.count("MNIST IDX files not found; using deterministic "
                        "synthetic MNIST") == 1
    losses = _losses(stdout)
    assert [(e, s) for e, s, _ in losses] == [(1, 2), (1, 4), (2, 2), (2, 4)]
    assert all(np.isfinite(x) for *_, x in losses)
    assert stdout.splitlines()[-1].startswith("Training complete in: ")


def test_two_nodes_train_the_same_job(runs):
    """``-n 2 -nr 0`` logs what ``-g 2`` logs; node 1 logs nothing."""
    assert _losses(runs["mnist_nr0"][1]) == _losses(runs["mnist"][1])
    assert "Rank [" not in runs["mnist_nr1"][1]
    assert "Training complete in:" not in runs["mnist_nr1"][1]


@pytest.mark.parametrize("flag", sorted(mnist_distributed.UNPORTED))
def test_unported_flag_is_refused(flag, capsys):
    argv = [flag] + (["1"] if mnist_distributed.UNPORTED[flag][0] else [])
    with pytest.raises(SystemExit) as exc:
        mnist_distributed.build_parser().parse_args(argv)
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert f"{flag} is not ported yet (ROADMAP queue 1 item" in err


#: the flags of the data-parallel extensions, the checkpoints and the
#: single-host elastic runs, lifted from the refusals: (argv, the parsed
#: value)
LIFTED = {
    "--zero": ([], True), "--grad-compress": (["bf16"], "bf16"),
    "--no-error-feedback": ([], True), "--overlap-grad-sync": ([], True),
    "--bucket-mb": (["4.5"], 4.5),
    "--ckpt-every": (["2"], 2), "--ckpt-dir": (["ck"], "ck"),
    "--resume": ([], True), "--ckpt-sharded": ([], True),
    "--ckpt-verify-interval": (["1.5"], 1.5), "--ckpt-compress": ([], True),
    "--elastic": ([], True), "--elastic-worker": ([], True),
    "--max-restarts": (["5"], 5), "--kv-port": (["4321"], "4321"),
}


@pytest.mark.parametrize("flag", sorted(LIFTED))
def test_lifted_flag_is_parsed(flag):
    argv, value = LIFTED[flag]
    args = mnist_distributed.build_parser().parse_args([flag, *argv])
    assert getattr(args, flag[2:].replace("-", "_")) == value
    assert flag not in mnist_distributed.UNPORTED


def test_no_silent_cpu_fallback(monkeypatch):
    """Without --force-cpu the ranks are GPUs, which must exist, one a
    rank; the message names --force-cpu."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="--force-cpu"):
            rank_device(0)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert rank_device(0) == torch.device("cuda", 0)
    with pytest.raises(SystemExit, match="--force-cpu"):
        rank_device(1)
    assert rank_device(3, force_cpu=True) == torch.device("cpu")


# -- --opt momentum | adamw against optax -------------------------------------

def _tree(seed):
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((3, 4)).astype(np.float32),
            "b": rng.standard_normal(4).astype(np.float32)}


@pytest.mark.parametrize("opt", ["momentum", "adamw"])
def test_optimizer_matches_optax(opt):
    """Five updates of a small tree from the same gradients: optax's
    ``sgd(lr, momentum=0.9)`` or ``adamw(lr)`` (b1 0.9, b2 0.999, eps
    1e-8, weight decay 1e-4), within rtol 1e-6."""
    lr = 0.1
    tx = (optax.sgd(lr, momentum=0.9) if opt == "momentum"
          else optax.adamw(lr))
    params = {k: jnp.asarray(v) for k, v in _tree(0).items()}
    opt_state = tx.init(params)
    torch_params = [torch.nn.Parameter(torch.from_numpy(v.copy()))
                    for v in _tree(0).values()]
    optimizer = (SGD(torch_params, lr, momentum=0.9) if opt == "momentum"
                 else AdamW(torch_params, constant_schedule(lr)))
    for step in range(5):
        grads = _tree(step + 1)
        updates, opt_state = tx.update(
            {k: jnp.asarray(v) for k, v in grads.items()}, opt_state, params)
        params = optax.apply_updates(params, updates)
        for p, g in zip(torch_params, grads.values()):
            p.grad = torch.from_numpy(g)
        optimizer.step()
        for p, key in zip(torch_params, _tree(0)):
            np.testing.assert_allclose(p.detach().numpy(),
                                       np.asarray(params[key]), rtol=1e-6,
                                       atol=1e-7, err_msg=f"{opt} {step}")
            assert p.grad is None
