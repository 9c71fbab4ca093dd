"""The port's resumable loop (tpu_sandbox_torch/train/trainer.py:
``train_resumable``, ``PreemptionHandler``, ``AbortOnAnomaly``) against
JAX's (tpu_sandbox/train/trainer.py:388-783), and the non-finite guard of
the port's in-place steps.

- From the same init (JAX's ``ConvNet`` from ``key(0)``, bridged) on the
  same batches, one of them NaN-poisoned, uninterrupted and preempted at
  step k then resumed from a ``HostCheckpoint``: the same
  ``ResumableReport`` fields (losses within rtol 1e-4) and the same final
  state within atol 1e-5 of each leaf's largest magnitude (fp32, sums in
  other orders; a conv bias, whose gradient BN cancels, and its momentum
  trace hold rounding noise on both sides and take their collection's
  largest magnitude), at the reference's SGD rate; the port resumed is bitwise the port uninterrupted, and
  steps the same batches in the same order.
- A step with a non-finite loss leaves the whole state bitwise unchanged:
  parameters, BN statistics, optimizer state and step, single-device (with
  and without accumulation) and on 2 gloo ranks under ZeRO-1, int8 error
  feedback and the bucketed sync, where only one rank's loss is NaN
  (spawned once for the module, ``tests/torch_dist_workers.py``'s
  ``guard_worker``). Three in a row raise ``AbortOnAnomaly`` on every rank.
- SIGTERM through the fault injector saves and preempts; a preemption
  announced through the KV store stops a peer.
"""

import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_dist_workers import GUARD_BS, GUARD_IMAGE, guard_worker
from tpu_sandbox.data import normalize as jax_normalize
from tpu_sandbox.data import synthetic_mnist as jax_synthetic_mnist
from tpu_sandbox.models import ConvNet as JaxConvNet
from tpu_sandbox.train import TrainState as JaxTrainState
from tpu_sandbox.train import make_train_step as jax_make_train_step
from tpu_sandbox.train import checkpoint as jck
from tpu_sandbox.train import trainer as jtrainer
from tpu_sandbox_torch.models import ConvNet
from tpu_sandbox_torch.parallel.launch import spawn
from tpu_sandbox_torch.runtime.faults import FaultInjector, FaultPlan
from tpu_sandbox_torch.runtime.kvstore import KVClient, KVServer
from tpu_sandbox_torch.train import (
    SGD,
    AbortOnAnomaly,
    AdamW,
    Preempted,
    PreemptionHandler,
    TrainState,
    make_train_step,
    train_resumable,
)
from tpu_sandbox_torch.train.checkpoint import HostCheckpoint
from tpu_sandbox_torch.train.optim import constant_schedule
from tpu_sandbox_torch.utils.bridge import (
    params_from_flax,
    state_from_leaves,
    state_template,
    state_to_leaves,
)
from torch_threads import one_torch_thread  # noqa: F401

HW = (32, 32)
BATCHES, BS, POISONED, LR = 8, 2, 2, 1e-4   # the reference's rate
CPU = torch.device("cpu")


def _batches():
    images, labels = jax_synthetic_mnist(n=BATCHES * BS, seed=0)
    images = jax_normalize(images)
    out = [(images[i:i + BS].copy(), labels[i:i + BS].astype(np.int32))
           for i in range(0, BATCHES * BS, BS)]
    x, y = out[POISONED]
    out[POISONED] = (np.full_like(x, np.nan), y)
    return out


class Loader:
    def __init__(self, batches):
        self.batches = batches

    def __len__(self):
        return len(self.batches)

    def __iter__(self):
        return iter(self.batches)


class PreemptAt:
    """Injector stub: flip the (programmatic) preemption flag at a step."""

    def __init__(self, handler, step):
        self.handler, self.step = handler, step

    def maybe_fire(self, step):
        if step == self.step:
            self.handler.preempt_now()


@pytest.fixture(scope="module")
def jax_init():
    model = JaxConvNet(dtype=jnp.float32)
    variables = model.init(jax.random.key(0), jnp.zeros((1, *HW, 1)),
                           train=False)
    return model, jax.tree.map(np.asarray, variables)


TXS = {"sgd": lambda: optax.sgd(LR),
       "momentum": lambda: optax.sgd(LR, momentum=0.9)}


def _jax_run(jax_init, opt, tmp, preempt_at=None):
    """JAX's loop: uninterrupted, or preempted at ``preempt_at`` and
    resumed from its HostCheckpoint. -> (report, host leaves)."""
    model, variables = jax_init
    tx = TXS[opt]()
    step = jax_make_train_step(model, tx, image_size=HW, donate=False)

    def fresh():
        return JaxTrainState(
            step=jnp.zeros((), jnp.int32),
            params=jax.tree.map(jnp.asarray, variables["params"]),
            batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
            opt_state=tx.init(variables["params"]))

    hc = jck.HostCheckpoint(tmp)
    template = fresh().host_view()

    def save_fn(state, s, epoch, offset):
        hc.save(state.host_view(), s, epoch=epoch, offset=offset)

    def restore_fn():
        res = hc.restore(template)
        if res is None:
            return None
        tree, meta = res
        return jax.tree.map(jnp.asarray, tree), meta

    kw = dict(save_fn=save_fn, restore_fn=restore_fn, ckpt_every=2,
              log_every=1, verbose=False)
    if preempt_at is not None:
        handler = jtrainer.PreemptionHandler()
        with pytest.raises(jtrainer.Preempted):
            jtrainer.train_resumable(step, fresh(), Loader(_batches()), 1,
                                     preemption=handler,
                                     injector=PreemptAt(handler, preempt_at),
                                     **kw)
    state, report = jtrainer.train_resumable(step, fresh(),
                                             Loader(_batches()), 1, **kw)
    return report, dict(jck._flatten_with_paths(state.host_view())[0])


def _port_state(init, opt):
    model = ConvNet(HW, device="cpu")
    model.load_state_dict(init)
    optimizer = (SGD(model.parameters(), LR, momentum=0.9)
                 if opt == "momentum" else None)
    return TrainState(model, lr=LR, optimizer=optimizer)


def _port_run(init, opt, tmp, preempt_at=None, seq=None):
    """The port's loop, as ``_jax_run``; ``seq`` records the batches each
    applied step took."""
    hc = HostCheckpoint(tmp)

    def run(handler=None, injector=None):
        state = _port_state(init, opt)
        template = state_template(state)
        step = make_train_step(state, image_size=HW, guard=True)

        def step_fn(s, x, y):
            loss, applied = step(x, y)
            if applied and seq is not None:
                seq.append(float(x.sum()))
            return loss, applied

        def restore_fn():
            res = hc.restore(template)
            if res is None:
                return None
            state_from_leaves(state, res[0])
            return state, res[1]

        return train_resumable(
            step_fn, state, Loader(_batches()), 1,
            save_fn=lambda s, n, epoch, offset: hc.save(
                s.host_view(), n, epoch=epoch, offset=offset),
            restore_fn=restore_fn, ckpt_every=2, preemption=handler,
            injector=injector, log_every=1, verbose=False, device=CPU)

    if preempt_at is not None:
        handler = PreemptionHandler()
        with pytest.raises(Preempted) as exc:
            run(handler, PreemptAt(handler, preempt_at))
        assert exc.value.step == preempt_at
    state, report = run()
    return report, state_to_leaves(state)


REPORT = ("resumed_step", "start_epoch", "start_offset", "steps_applied",
          "skipped_nonfinite", "final_step")


@pytest.mark.parametrize("preempt_at", [None, 4], ids=["straight", "preempt4"])
@pytest.mark.parametrize("opt", sorted(TXS))
def test_train_resumable_matches_jax(jax_init, tmp_path, opt, preempt_at):
    jreport, jleaves = _jax_run(jax_init, opt, tmp_path / "jax", preempt_at)
    init = params_from_flax(jax_init[1])
    report, leaves = _port_run(init, opt, tmp_path / "port", preempt_at)
    for field in REPORT:
        assert getattr(report, field) == getattr(jreport, field), field
    assert report.skipped_nonfinite == (1 if preempt_at is None else 0)
    np.testing.assert_allclose(report.losses, jreport.losses, rtol=1e-4)
    assert list(leaves) == list(jleaves)
    for path, want in jleaves.items():
        want = np.asarray(want)
        scale = float(np.max(np.abs(want))) or 1.0
        if path.split("/")[-2:-1] in (["conv1"], ["conv2"]) and \
                path.endswith("/bias"):
            # BN cancels a conv bias's gradient: both sides carry rounding
            # noise there, so it is held to its collection's scale
            coll = path.rsplit("/", 2)[0]
            scale = max(float(np.max(np.abs(np.asarray(v))))
                        for p, v in jleaves.items() if p.startswith(coll))
        np.testing.assert_allclose(leaves[path], want, rtol=0,
                                   atol=1e-5 * scale + 1e-7, err_msg=path)


@pytest.mark.parametrize("preempt_at", [3, 6])
def test_port_resumed_is_bitwise_the_port_uninterrupted(jax_init, tmp_path,
                                                        preempt_at):
    init = params_from_flax(jax_init[1])
    ref_seq, seq = [], []
    _, ref = _port_run(init, "momentum", tmp_path / "a", seq=ref_seq)
    report, got = _port_run(init, "momentum", tmp_path / "b", preempt_at,
                            seq=seq)
    assert report.resumed_step == preempt_at
    assert seq == ref_seq                   # no batch replayed, none skipped
    for path in ref:
        np.testing.assert_array_equal(got[path], ref[path], err_msg=path)


# -- the guard, single device ---------------------------------------------------

@pytest.mark.parametrize("accum_steps", [1, 2])
def test_nonfinite_step_leaves_the_state_bitwise(jax_init, accum_steps):
    """AdamW, BN: one good step, then a batch whose second half is NaN (the
    second microbatch under accumulation): the step reports itself not
    applied and every leaf — step, parameters, BN statistics, count and
    moments — is the bits it was."""
    model = ConvNet(HW, device="cpu")
    model.load_state_dict(params_from_flax(jax_init[1]))
    state = TrainState(model, optimizer=AdamW(model.parameters(),
                                              constant_schedule(1e-3)))
    step = make_train_step(state, image_size=HW, accum_steps=accum_steps,
                           guard=True)
    batches = _batches()
    x, y = (torch.from_numpy(a) for a in batches[0])
    loss, applied = step(x, y.long())
    assert applied and np.isfinite(float(loss))
    before = state.host_view()
    x = torch.from_numpy(batches[1][0].copy())
    x[1:] = float("nan")
    loss, applied = step(x, torch.from_numpy(batches[1][1]).long())
    assert not applied and not np.isfinite(float(loss))
    after = state.host_view()
    assert list(after) == list(before)
    for path in before:
        np.testing.assert_array_equal(after[path], before[path], err_msg=path)
    assert all(p.grad is None for p in model.parameters())


def test_nonfinite_streak_aborts_as_jaxs_does(jax_init):
    init = params_from_flax(jax_init[1])
    state = _port_state(init, "sgd")
    bad = [(np.full_like(x, np.nan), y) for x, y in _batches()]
    step = make_train_step(state, image_size=HW, guard=True)
    with pytest.raises(AbortOnAnomaly, match="3 consecutive"):
        train_resumable(lambda s, x, y: step(x, y), state, Loader(bad), 1,
                        max_bad_steps=3, verbose=False, device=CPU)
    assert state.step == 0


# -- the guard across ranks --------------------------------------------------------

@pytest.fixture(scope="module")
def guard_ranks(tmp_path_factory, jax_init):
    tmp = tmp_path_factory.mktemp("guard")
    images, labels = jax_synthetic_mnist(n=4 * 2 * GUARD_BS, seed=1)
    images = jax_normalize(images)
    n = 2 * GUARD_BS
    torch.save({"init": params_from_flax(jax_init[1]),
                "batches": [(images[i:i + n], labels[i:i + n])
                            for i in range(0, 4 * n, n)]},
               tmp / "inputs.pt")
    assert GUARD_IMAGE == HW[0]
    spawn(guard_worker, 2, str(tmp), str(tmp / "inputs.pt"),
          init_method=f"file://{tmp}/store", timeout=120)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(2)]


def test_nonfinite_rank_skips_the_step_on_every_rank(guard_ranks):
    for r, res in enumerate(guard_ranks):
        assert res["first"][1] is True
        assert res["poisoned"][1] is False, r
        before, after = res["before"], res["after"]
        assert "grad_residual/fc/kernel" in before
        assert "opt_state/0/mu/fc/kernel" in before
        for path in before:
            np.testing.assert_array_equal(after[path], before[path],
                                          err_msg=f"rank {r} {path}")
    # rank 1's loss was NaN, rank 0's finite: both stood still
    assert np.isfinite(float(guard_ranks[0]["poisoned"][0]))
    assert not np.isfinite(float(guard_ranks[1]["poisoned"][0]))


def test_nonfinite_streak_aborts_every_rank(guard_ranks):
    for res in guard_ranks:
        assert "3 consecutive non-finite losses" in res["aborted"]
        for path in res["after"]:
            np.testing.assert_array_equal(res["end"][path], res["after"][path])


# -- preemption ----------------------------------------------------------------------

def test_sigterm_via_fault_injector_saves_and_preempts(jax_init, tmp_path):
    init = params_from_flax(jax_init[1])
    state = _port_state(init, "sgd")
    step = make_train_step(state, image_size=HW, guard=True)
    hc = HostCheckpoint(tmp_path)
    handler = PreemptionHandler().install()
    try:
        with pytest.raises(Preempted):
            train_resumable(
                lambda s, x, y: step(x, y), state, Loader(_batches()), 1,
                save_fn=lambda s, n, e, o: hc.save(s.host_view(), n, epoch=e,
                                                   offset=o),
                ckpt_every=100, preemption=handler,
                injector=FaultInjector(FaultPlan().add(0, 3, "sigterm"), 0),
                verbose=False, device=CPU)
    finally:
        handler.uninstall()
    assert hc.latest_step() == 3
    _, meta = hc.restore(state_template(state))
    # batch 2 was skipped, so the third applied step was batch 4 of 8
    assert (meta["step"], meta["epoch"], meta["offset"]) == (3, 0, 4)


def test_preemption_propagates_through_kv_and_signal_sets_flag_only():
    with KVServer() as srv:
        a = PreemptionHandler(KVClient(port=srv.port))
        b = PreemptionHandler(KVClient(port=srv.port))
        assert not b.requested()
        a.preempt_now()
        assert a.requested() and b.requested()
        a.kv.close()
        b.kv.close()
    handler = PreemptionHandler().install()
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        assert handler.requested()
    finally:
        handler.uninstall()
