"""The cross-host elastic plane end to end on the CPU:
``python -m tpu_sandbox_torch.mnist_distributed --force-cpu`` at 28x28,
fp32, the plain plan, 2 gloo ranks a run, from JAX's init (the JAX
script's model and optax state from ``key(0)``, written by the JAX
package's ``HostCheckpoint`` as step 0).

The runs start together, once for the module:

- ``clean``: ``--elastic --agents 2``, two host-agent processes under an
  ``AgentLauncher``, one rank each.
- ``killed``: the same, and leader death: ``kill_agent`` posted to rank
  0's agent (the leader), the command a fault plan's ``kill_agent`` posts.
  The launcher respawns it, the surviving agent wins the lease at term 2
  and tears the generation down, the restart is charged once, and the
  final checkpoint is bitwise ``clean``'s.
- ``pool``: ``--elastic --pool 1 --job-id lo --priority 0``, the job's one
  agent holding both ranks. A priority-1 job is submitted to the pool's
  store: ``lo`` saves and exits 75 uncharged, ``hi`` runs, ``lo`` resumes
  to ``done``, bitwise ``clean``'s final state.

A step at 28x28 takes milliseconds, so the faults are placed by stopping
the ranks (SIGSTOP) once they have installed their SIGTERM handler, and
acting on the stopped job: the store's port is read from an agent's
command line, ``killed``'s rank 1 goes on once agent 0 and its rank are
gone, ``pool``'s ranks once the scheduler's SIGTERM is pending on them.
- ``fleet``: ``python -m tpu_sandbox_torch.serve.replica --fleet chat``
  serves requests queued under ``fleet/chat/`` (and nothing outside it)
  with the tokens of its engine run in this process.

``clean``'s printed losses follow the JAX script's (``mnist_distributed.py``
on 2 virtual CPU devices) within 2e-4, the last printed digit. Every wait
is bounded: a process by ``communicate(timeout=)``, a store or file event
by a deadline.
"""

import contextlib
import io
import json
import os
import re
import signal
import subprocess
import sys
import time
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
from tpu_sandbox_torch.utils.bridge import state_template
from torch_threads import one_torch_thread  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import mnist_distributed as jax_mnist  # noqa: E402

#: seconds any one process or store event may take before the test fails
LIMIT = 120
TRAIN = ["-g", "2", "--force-cpu", "--image-size", "28", "--batch-size",
         "2", "--synthetic-n", "40", "--limit-steps", "6", "--log-every",
         "2", "--epochs", "1", "--dtype", "fp32", "--plan", "plain"]
ELASTIC = TRAIN + ["--elastic", "--ckpt-every", "2"]
#: name -> argv without --ckpt-dir
RUNS = {
    "clean": ELASTIC + ["--agents", "2"],
    "killed": ELASTIC + ["--agents", "2"],
    "pool": ELASTIC + ["--pool", "1", "--job-id", "lo", "--priority", "0"],
}
LOSS = re.compile(r"^Rank \[0\], Epoch \[1/1\], Step \[(\d)/6\], "
                  r"Loss: (\d+\.\d{4})$")
#: the fleet replica's LM and cache (tests/test_torch_serve_replica.py's)
FLEET_CFG = {"model": dict(vocab_size=64, d_model=32, n_heads=4, n_layers=2,
                           d_ff=64, max_len=128),
             "cache": {"num_blocks": 24, "block_size": 4,
                       "max_blocks_per_seq": 8},
             "max_batch": 3, "buckets": [8, 16], "param_seed": 0,
             "timeout": LIMIT}
#: a priority-1 tenant that finishes at once (the pool's second job)
HI_AGENT = """
import importlib.util, json, os, sys
_spec = importlib.util.spec_from_file_location(
    "_kv", os.path.join({root!r}, "tpu_sandbox_torch", "runtime",
                        "kvstore.py"))
_kv = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(_kv)
kv = _kv.for_job(_kv.KVClient(port=int(sys.argv[1])), sys.argv[2])
kv.set("job/done", json.dumps({{"ok": True, "reason": "hi", "summary": "",
                               "restarts": 0, "preemptions": 0,
                               "generations": 1}}))
"""


def _jax_init_leaves() -> dict:
    model = jax_pick_convnet(28, plan="plain", num_classes=10,
                             dtype=jnp.float32)
    state = JaxTrainState.create(model, jax.random.key(0),
                                 jnp.zeros((1, 28, 28, 1)), optax.sgd(1e-4))
    return dict(jck._flatten_with_paths(state.host_view())[0])


def _cmdlines(*needles: str) -> dict[int, list[str]]:
    """pid -> argv of the live processes whose command line holds every
    needle."""
    out = {}
    for proc in Path("/proc").iterdir():
        if not proc.name.isdigit():
            continue
        try:
            argv = (proc / "cmdline").read_bytes().decode().split("\0")
        except OSError:
            continue
        if all(n in argv for n in needles):
            out[int(proc.name)] = argv
    return out


def _signal_mask(pid: int, field: str) -> int:
    for line in Path(f"/proc/{pid}/status").read_text().splitlines():
        if line.startswith(field + ":"):
            return int(line.split()[1], 16)
    return 0


def _until(pred, what: str, limit: float = LIMIT):
    deadline = time.monotonic() + limit
    while time.monotonic() < deadline:
        got = pred()
        if got:
            return got
        time.sleep(0.002)
    raise AssertionError(f"timed out after {limit} s waiting for {what}")


SIGTERM_BIT = 1 << (signal.SIGTERM - 1)


def _stop_ranks(runs: dict) -> dict[str, list[int]]:
    """Stop each run's 2 ranks (``runs``: name -> (process, checkpoint
    dir)) as soon as both have installed their SIGTERM handler: name ->
    the stopped pids."""
    pending, stopped = dict(runs), {}

    def poll():
        for name, (proc, d) in list(pending.items()):
            assert proc.poll() is None, f"{name} ended before its fault"
            ranks = _cmdlines("--elastic-worker", str(d))
            if len(ranks) == 2 and all(_signal_mask(p, "SigCgt")
                                       & SIGTERM_BIT for p in ranks):
                for p in ranks:
                    os.kill(p, signal.SIGSTOP)
                stopped[name] = sorted(ranks)
                del pending[name]
        return not pending

    _until(poll, "the ranks' SIGTERM handlers")
    return stopped


def _agent(d: Path, aid: int) -> tuple[int, int]:
    """(pid, KV port) of agent ``aid`` of the run writing to ``d``."""
    (pid, argv), = [(p, a) for p, a in _cmdlines("--agent-id",
                                                 str(d)).items()
                    if a[a.index("--agent-id") + 1] == str(aid)]
    return pid, int(argv[argv.index("--kv-port") + 1])


def _gone(pid: int) -> bool:
    try:
        return Path(f"/proc/{pid}/status").read_text().split(
            "State:")[1].split()[0] in ("Z", "X")
    except (OSError, IndexError):
        return True


def _kill_leader(d: Path, ranks: list[int]) -> dict:
    """kill_agent to agent 0 of the stopped run; rank 1 goes on once
    agent 0 and its rank 0 are gone."""
    from tpu_sandbox_torch.runtime.faults import agent_cmd_key
    from tpu_sandbox_torch.runtime.kvstore import KVClient

    try:
        pid, kv_port = _agent(d, 0)
        kv = KVClient(port=kv_port)
        kv.set(agent_cmd_key(0), json.dumps({"action": "kill_agent",
                                             "arg": None}))
        kv.close()
        _until(lambda: _gone(pid) and _gone(ranks[0]),
               "agent 0 and its rank to die")
    finally:
        for p in ranks:
            if not _gone(p):
                os.kill(p, signal.SIGCONT)
    return {"agent": pid, "kv_port": kv_port}


def _preempt_pool_job(d: Path, ranks: list[int], tmp: Path) -> dict:
    """Submit ``hi`` to the stopped pool's store; ``lo``'s ranks go on
    once the scheduler's SIGTERM is pending on both."""
    from tpu_sandbox_torch.runtime.kvstore import KVClient
    from tpu_sandbox_torch.runtime.scheduler import JobSpec, submit_job

    try:
        _, kv_port = _agent(d, 0)
        script = tmp / "hi_agent.py"
        script.write_text(HI_AGENT.format(root=str(ROOT)))
        kv = KVClient(port=kv_port)
        submit_job(kv, JobSpec(job_id="hi", hosts=1, world_size=1,
                               agent_argv=[sys.executable, str(script),
                                           "{kv_port}", "{job_id}"],
                               priority=1))
        kv.close()
        _until(lambda: all(_signal_mask(p, "ShdPnd") & SIGTERM_BIT
                           for p in ranks), "the scheduler's SIGTERM")
    finally:
        for p in ranks:
            os.kill(p, signal.SIGCONT)
    return {"kv_port": kv_port}


def _serve_fleet(env) -> dict:
    """A --fleet chat replica against a store of this process: requests
    queued in the fleet's namespace, and a decoy request at the root that
    it must leave alone."""
    from tpu_sandbox_torch.gateway.fleet import fleet_kv
    from tpu_sandbox_torch.runtime.kvstore import KVClient, KVServer
    from tpu_sandbox_torch.serve import replica as R

    rng = np.random.default_rng(5)
    reqs = [(f"r{i}", [int(t) for t in rng.integers(1, 64, size=6 + i)],
             4 + i) for i in range(3)]
    with KVServer() as srv:
        kv = KVClient(port=srv.port)
        chat = fleet_kv(kv, "chat")
        for rid, prompt, n in reqs:
            R.submit_request(chat, rid, prompt, n)
        R.announce_total(chat, len(reqs))
        R.submit_request(kv, "decoy", [1, 2, 3], 2)
        R.announce_total(kv, 1)
        p = subprocess.Popen(
            [sys.executable, "-m", "tpu_sandbox_torch.serve.replica",
             "--config", json.dumps(FLEET_CFG), "--force-cpu", "--fleet",
             "chat", "--tag", "chat-0"], cwd=ROOT,
            env={**env, "TPU_SANDBOX_KV_PORT": str(srv.port)}, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        try:
            stdout, stderr = p.communicate(timeout=LIMIT)
        finally:
            if p.poll() is None:
                p.kill()
                p.wait()
        out = {"code": p.returncode, "stdout": stdout, "stderr": stderr,
               "reqs": reqs,
               "verdicts": {rid: json.loads(chat.try_get(R.k_result(rid))
                                            or b"null")
                            for rid, _, _ in reqs},
               "root_keys": sorted(k for k in kv.keys("serve/")),
               "fleet_keys": len(kv.keys("fleet/chat/serve/"))}
        kv.close()
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("agents")
    init = _jax_init_leaves()
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "TPU_SANDBOX_KV_PORT")}
    env.update(OMP_NUM_THREADS="1", TPU_SANDBOX_BACKOFF="0.1",
               TPU_SANDBOX_LEASE_TTL="1", TPU_SANDBOX_AGENT_TIMEOUT="4",
               TPU_SANDBOX_TERM_TIMEOUT="10", PYTHONPATH=str(ROOT))
    procs = {}
    for name, argv in RUNS.items():
        d = tmp / name
        jck.HostCheckpoint(d).save(init, 0, epoch=0, offset=0)
        procs[name] = subprocess.Popen(
            [sys.executable, "-m", "tpu_sandbox_torch.mnist_distributed",
             *argv, "--ckpt-dir", str(d)], cwd=ROOT, env=env, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
    out = {}
    try:
        stopped = _stop_ranks({n: (procs[n], tmp / n)
                               for n in ("killed", "pool")})
        out["kill"] = _kill_leader(tmp / "killed", stopped["killed"])
        out["preempt"] = _preempt_pool_job(tmp / "pool", stopped["pool"],
                                           tmp)
        out["fleet"] = _serve_fleet(env)
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
    tree, meta = ck.HostCheckpoint(run[3]).restore(template)
    assert meta["step"] == 6
    return tree


def _template():
    return state_template(TrainState(pick_convnet(
        (28, 28), plan="plain", num_classes=10, seed=0, device="cpu")))


def _assert_same(a: dict, b: dict) -> None:
    assert list(a) == list(b)
    for path in a:
        np.testing.assert_array_equal(np.asarray(a[path]),
                                      np.asarray(b[path]), err_msg=path)


@pytest.mark.parametrize("name", sorted(RUNS))
def test_run_exits_0(runs, name):
    code, stdout, stderr, _ = runs[name]
    assert code == 0, stdout[-3000:] + stderr[-3000:]


def test_leader_death_is_charged_once_and_resume_is_bitwise(runs):
    stdout = runs["killed"][1]
    assert "[agent 0] fault: kill_agent" in stdout
    assert "[launcher] agent 0 died (exit -9); respawning [1/16]" in stdout
    assert "[agent 1] elected leader (term 2)" in stdout
    # the survivor's rank lost its peer (or the respawned agent reported
    # its lost rank first): a reported failure tears generation 1 down
    assert re.search(r"\[agent 1\] gen 1: teardown \(agent [01] reported "
                     r"failure", stdout), stdout[-3000:]
    assert "2 generation(s); 1 restart(s) charged, 0 preemption(s)" in stdout
    assert "[launcher] job ok" in stdout
    assert "[gen 2] resumed from step 0; applied 6 step(s), final step 6" \
        in stdout
    clean = runs["clean"][1]
    assert "[agent 0] elected leader (term 1)" in clean
    assert "[gen 1] resumed from step 0; applied 6 step(s), final step 6" \
        in clean
    assert "1 generation(s); 0 restart(s) charged, 0 preemption(s)" in clean
    template = _template()
    _assert_same(_final(runs["killed"], template),
                 _final(runs["clean"], template))


def test_pool_preemption_is_uncharged_and_resume_is_bitwise(runs):
    stdout = runs["pool"][1]
    assert "[cluster] job 'lo' finished: done" in stdout
    # the first admission: the ranks saved and left, the agent reports the
    # job preempted from outside; the readmission relaunches it uncharged
    assert "[scheduler] preempting job 'lo' (priority 0) to admit 'hi' " \
        "(priority 1)" in stdout
    # every initiator exited 75; a rank still exiting when the first one
    # had gone may be ended by the teardown instead, which does not count
    m = re.search(r"gen 1: local outcome preemption \(culprits "
                  r"\[([\d, ]+)\]\)", stdout)
    codes = re.search(r"gen 1: teardown complete, local exit codes "
                      r"\[([-\d, ]+)\]", stdout)
    codes = [int(c) for c in codes[1].split(",")]
    assert m and all(codes[int(r)] == 75 for r in m[1].split(","))
    assert "1 generation(s); 0 restart(s) charged, 1 preemption(s)" \
        in stdout
    assert "[scheduler] job 'hi': done" in stdout
    assert "[scheduler] job 'lo': readmitted" in stdout
    assert "2 generation(s); 0 restart(s) charged, 1 preemption(s)" \
        in stdout
    resumed = re.search(r"\[gen 2\] resumed from step (\d); applied (\d) "
                        r"step\(s\), final step 6", stdout)
    assert resumed and int(resumed[1]) + int(resumed[2]) == 6
    template = _template()
    _assert_same(_final(runs["pool"], template),
                 _final(runs["clean"], template))


def test_fleet_replica_serves_only_its_namespace(runs):
    from tpu_sandbox_torch.serve import Request
    from tpu_sandbox_torch.serve import replica as R

    fleet = runs["fleet"]
    assert fleet["code"] == 0, fleet["stderr"][-3000:]
    assert "[chat-0] done" in fleet["stdout"]
    engine = R._build_engine(FLEET_CFG, torch.device("cpu"))
    for rid, prompt, n in fleet["reqs"]:
        engine.submit(Request(rid=rid, prompt=prompt, max_new_tokens=n))
    engine.run_until_idle()
    for rid, _, _ in fleet["reqs"]:
        v = fleet["verdicts"][rid]
        assert v is not None and v["verdict"] == "ok", rid
        assert v["replica"] == "chat-0"
        assert v["tokens"] == engine.results[rid].tokens, rid
    # the root request plane is untouched: the decoy is still only queued
    assert "serve/result/decoy" not in fleet["root_keys"]
    assert "serve/req/decoy" in fleet["root_keys"]
    assert fleet["fleet_keys"] > 0


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


def test_agent_losses_follow_the_jax_script(runs):
    rows = [LOSS.match(x) for x in runs["clean"][1].splitlines()]
    got = [float(m[2]) for m in rows if m]
    want = _jax_losses()
    assert len(got) == len(want) == 3
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-4)
