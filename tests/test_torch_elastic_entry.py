"""``python -m tpu_sandbox_torch.mnist_distributed --force-cpu -g 2`` with
its checkpoint and elastic flags, on 2 gloo ranks a run.

The runs start together, once for the module:

- ``clean`` and ``killed``: ``--elastic --ckpt-dir D --ckpt-every 2``,
  starting from JAX's init (``mnist_distributed.py``'s model and optax
  state from ``key(0)``, written by the JAX package's ``HostCheckpoint``
  as step 0 into D); ``killed`` has a fault plan that SIGKILLs rank 0 at
  step 3. Its supervisor relaunches the generation, which resumes from
  step 2, and the final checkpoint is bitwise ``clean``'s.
- ``preempted``: ``--elastic --ckpt-sharded --zero`` from the same init,
  written by the JAX package's ``ShardedCheckpoint`` as a two-rank step 0
  (each rank's BN replica its own shard); a SIGTERM to rank 1 at step 3:
  every initiator saves and exits 75, which costs no restart, the next
  generation restores each rank's part (``restore_partial``, ZeRO-1's
  blocks refreshed) and ends bitwise where ``clean`` ends (at 2 ranks the
  reduce-scatter's sums are the all-reduce's).
- ``spawned``: the non-elastic ``-g 2 --ckpt-dir E --resume`` from the
  same JAX init in the single-device format: it resumes from step 0 and
  saves rank 0's single-device view, bitwise ``clean``'s final state.

``clean``'s printed losses follow the JAX script's (``mnist_distributed.py``
on 2 virtual CPU devices, jitted) within 2e-4, the last printed digit.
"""

import contextlib
import io
import json
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

from tpu_sandbox.models import pick_convnet as jax_pick_convnet
from tpu_sandbox.train import TrainState as JaxTrainState
from tpu_sandbox.train import checkpoint as jck
from tpu_sandbox_torch.models import pick_convnet
from tpu_sandbox_torch.train import TrainState
from tpu_sandbox_torch.train import checkpoint as ck
from tpu_sandbox_torch.utils.bridge import state_from_leaves, state_template
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import mnist_distributed as jax_mnist  # noqa: E402

LIMIT = 240
TRAIN = ["-g", "2", "--force-cpu", "--image-size", "32", "--batch-size",
         "2", "--synthetic-n", "40", "--limit-steps", "6", "--log-every",
         "2", "--epochs", "1", "--dtype", "fp32"]
ELASTIC = TRAIN + ["--elastic", "--ckpt-every", "2"]
SHARDED = ELASTIC + ["--ckpt-sharded", "--zero"]
KILL = [{"rank": 0, "step": 3, "action": "kill", "target": None}]
TERM = [{"rank": 1, "step": 3, "action": "sigterm", "target": None}]
#: name -> (argv without --ckpt-dir, fault plan, JAX init as step 0 in)
RUNS = {
    "clean": (ELASTIC, None, "host"),
    "killed": (ELASTIC, KILL, "host"),
    "preempted": (SHARDED, TERM, "sharded"),
    "spawned": (TRAIN + ["--ckpt-every", "2", "--resume"], None, "single"),
}
LOSS = re.compile(r"^Rank \[0\], Epoch \[1/1\], Step \[(\d)/6\], "
                  r"Loss: (\d+\.\d{4})$")


def _jax_init_leaves() -> dict:
    """The JAX script's initial state (its model at 32, optax's sgd, key
    0) as flat host leaves."""
    model = jax_pick_convnet(32, plan="auto", num_classes=10,
                             dtype=jnp.float32)
    state = JaxTrainState.create(model, jax.random.key(0),
                                 jnp.zeros((1, 32, 32, 1)), optax.sgd(1e-4))
    return dict(jck._flatten_with_paths(state.host_view())[0])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("elastic")
    init = _jax_init_leaves()
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT")}
    env.update(OMP_NUM_THREADS="1", TPU_SANDBOX_BACKOFF="0.1",
               PYTHONPATH=str(ROOT))
    procs = {}
    for name, (argv, plan, seed) in RUNS.items():
        d = tmp / name
        if seed == "host":
            jck.HostCheckpoint(d).save(init, 0, epoch=0, offset=0)
        elif seed == "sharded":
            spec = {p: "shard0" if p.startswith("batch_stats/") else "rep"
                    for p in init}
            for r in (1, 0):                # rank 0 last: it seals
                local = {p: np.asarray(v)[None] if spec[p] == "shard0"
                         else v for p, v in init.items()}
                assert jck.ShardedCheckpoint(
                    d, rank=r, world_size=2, verbose=False).save(
                    local, spec, 0, epoch=0, offset=0)
        elif seed == "single":
            state = TrainState(pick_convnet((32, 32), num_classes=10,
                                            seed=0, device="cpu"))
            state_from_leaves(state, init)
            ck.save(d, state, step=0)
        run_env = dict(env)
        if plan is not None:
            run_env["TPU_SANDBOX_FAULT_PLAN"] = json.dumps(plan)
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", "tpu_sandbox_torch.mnist_distributed",
             *argv, "--ckpt-dir", str(d)], cwd=ROOT, env=run_env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    out = {}
    try:
        for name, p in procs.items():
            stdout, stderr = p.communicate(timeout=LIMIT)
            out[name] = (p.returncode, stdout, stderr, tmp / name)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return out


def _final(run, template) -> dict:
    """The run's checkpoint of step 6, whatever its format, as leaves."""
    d = run[3]
    if (d / "LAYOUT").exists():
        tree, meta = ck.ShardedCheckpoint(d, rank=0, world_size=1,
                                          verbose=False).restore(template)
    elif (d / "step-00000006").is_dir():
        tree, meta = ck.ShardedCheckpoint(d, rank=0, world_size=2,
                                          verbose=False).restore(template)
    else:
        tree, meta = ck.HostCheckpoint(d).restore(template)
    assert meta["step"] == 6
    return tree


def _template():
    return state_template(TrainState(pick_convnet(
        (32, 32), num_classes=10, seed=0, device="cpu")))


def _assert_same(a: dict, b: dict) -> None:
    """Bitwise equal leaves; a sharded step's per-replica leaf ``[2, ...]``
    is held by its rank-0 replica (what rank 0's npz and the single-device
    view hold)."""
    assert list(a) == list(b)
    for path in a:
        x, y = np.asarray(a[path]), np.asarray(b[path])
        if x.shape == (2, *y.shape):
            x = x[0]
        np.testing.assert_array_equal(x, y, err_msg=path)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_run_exits_0(runs, name):
    code, stdout, stderr, _ = runs[name]
    assert code == 0, stdout[-2000:] + stderr[-3000:]


def test_kill_is_charged_and_resume_is_bitwise(runs):
    stdout = runs["killed"][1]
    assert ("generation 1 failure (culprit rank(s) [0], exit codes [-9, "
            in stdout)
    assert "[gen 2] resumed from step 2; applied 4 step(s), final step 6" \
        in stdout
    assert "1 restart(s) charged, 0 preemption(s)" in stdout
    assert "[gen 1] resumed from step 0; applied 6 step(s), final step 6" \
        in runs["clean"][1]
    template = _template()
    _assert_same(_final(runs["killed"], template),
                 _final(runs["clean"], template))


def test_sigterm_is_an_uncharged_preemption_and_resume_is_bitwise(runs):
    stdout = runs["preempted"][1]
    # every initiator exited 75; a rank still exiting when the first one
    # had gone may be ended by the teardown instead, which does not count
    m = re.search(r"generation 1 preemption \(culprit rank\(s\) "
                  r"\[([\d, ]+)\], exit codes \[([-\d, ]+)\]\)", stdout)
    codes = [int(c) for c in m[2].split(",")]
    assert all(codes[int(r)] == 75 for r in m[1].split(","))
    assert "[gen 2] resumed from step 3; applied 3 step(s), final step 6" \
        in stdout
    assert "0 restart(s) charged, 1 preemption(s)" in stdout
    assert "[gen 1] resumed from step 0; applied" not in stdout  # preempted
    template = _template()
    got = _final(runs["preempted"], template)
    assert got["batch_stats/bn1/mean"].shape[0] == 2     # every replica
    _assert_same(got, _final(runs["clean"], template))


def test_spawned_checkpoints_interoperate_with_the_elastic_ones(runs):
    stdout = runs["spawned"][1]
    assert "resumed from step 0" in stdout
    assert stdout.splitlines()[-1] == "saved checkpoint at step 6"
    template = _template()
    _assert_same(_final(runs["spawned"], template),
                 _final(runs["clean"], template))
    # and mnist_onegpu's restore reads it into a single-device state
    state = TrainState(pick_convnet((32, 32), num_classes=10, seed=0,
                                    device="cpu"))
    ck.restore(runs["spawned"][3], state)
    assert state.step == 6


def _jax_losses() -> list[float]:
    parsed = {}

    def capture(args, world_size):
        parsed["args"] = args

    old = sys.argv, jax_mnist.train
    sys.argv, jax_mnist.train = ["mnist_distributed.py", *TRAIN], capture
    try:
        jax_mnist.main()
    finally:
        sys.argv, jax_mnist.train = old
    out = io.StringIO()
    jax.devices()
    with contextlib.redirect_stdout(out):
        jax_mnist.train(parsed["args"], 2)
    rows = [LOSS.match(x) for x in out.getvalue().splitlines()]
    return [float(m[2]) for m in rows if m]


def test_elastic_losses_follow_the_jax_script(runs):
    rows = [LOSS.match(x) for x in runs["clean"][1].splitlines()]
    got = [float(m[2]) for m in rows if m]
    want = _jax_losses()
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)


def test_checkpoint_and_elastic_flags_are_the_jax_clis():
    """The port's checkpoint group is JAX's (flags, defaults, types, help;
    ``--ckpt-dir``'s help names no orbax, which the port does not write),
    and its elastic group is the single-host part of JAX's."""
    import argparse

    from tpu_sandbox.utils import cli as jax_cli
    from tpu_sandbox_torch.utils import cli

    def actions(add):
        parser = argparse.ArgumentParser()
        add(parser)
        return {a.dest: (a.option_strings, a.default, a.choices, a.type,
                         a.metavar, a.help) for a in parser._actions}

    ours = actions(cli.add_checkpoint_cli)
    theirs = actions(jax_cli.add_checkpoint_cli)
    assert list(ours) == list(theirs)
    for dest in theirs:
        n = 5 if dest == "ckpt_dir" else 6
        assert ours[dest][:n] == theirs[dest][:n], dest
    elastic = actions(cli.add_elastic_cli)
    jax_elastic = actions(jax_cli.add_elastic_cli)
    assert list(elastic) == ["help", "elastic", "max_restarts"]
    assert all(elastic[d] == jax_elastic[d] for d in elastic)
