"""The port's data parallelism (``tpu_sandbox_torch/parallel/
data_parallel.py``, ``data/loader.py``) on the cases of
``tests/test_data_parallel.py`` that it ports.

Two gloo ranks, spawned once for the module (``tests/torch_dist_workers.py``),
train the plain ConvNet at 32x32 in fp32 from one tree that JAX drew and
the bridge carried over, on the same global batches; JAX's
``DataParallel`` trains the same tree on a 2-device mesh of virtual CPU
devices. Port rank r is JAX's mesh row r. Tolerance: rtol 1e-5 (atol 1e-6
for values near 0) over 3 steps, with and without BN."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_dist_workers import DP_IMAGE, DP_LR, DP_STEPS, dp_worker
from tpu_sandbox.data import ShardedBatchLoader as JaxShardedBatchLoader
from tpu_sandbox.data import synthetic_mnist as jax_synthetic_mnist
from tpu_sandbox.models import ConvNet as JaxConvNet
from tpu_sandbox.parallel import DataParallel as JaxDataParallel
from tpu_sandbox.runtime.mesh import make_mesh as jax_make_mesh
from tpu_sandbox.train import TrainState as JaxTrainState
from tpu_sandbox_torch.data import PrefetchLoader, ShardedBatchLoader
from tpu_sandbox_torch.models import ConvNet
from tpu_sandbox_torch.parallel.data_parallel import DataParallel
from tpu_sandbox_torch.parallel.launch import spawn
from tpu_sandbox_torch.runtime import bootstrap
from tpu_sandbox_torch.runtime.mesh import make_mesh
from tpu_sandbox_torch.train import TrainState, make_train_step
from tpu_sandbox_torch.utils.bridge import params_from_flax
from torch_threads import one_torch_thread  # noqa: F401

WORLD, BS = 2, 2
TOL = dict(rtol=1e-5, atol=1e-6)


def _batches(seed, steps=DP_STEPS):
    rng = np.random.default_rng(seed)
    return [(rng.standard_normal((WORLD * BS, DP_IMAGE, DP_IMAGE, 1),
                                 dtype=np.float32),
             rng.integers(0, 10, WORLD * BS).astype(np.int32))
            for _ in range(steps)]


def _biased():
    """Rank r's images scaled by (r + 1) / 2: per-rank BN statistics must
    differ."""
    images, labels = _batches(7, 1)[0]
    scale = np.repeat((np.arange(WORLD) + 1) / WORLD, BS)
    return (images * scale[:, None, None, None]).astype(np.float32), labels


def _jax_state(use_bn):
    model = JaxConvNet(use_bn=use_bn)
    tx = optax.sgd(DP_LR)
    state = JaxTrainState.create(model, jax.random.key(0),
                                 jnp.zeros((1, DP_IMAGE, DP_IMAGE, 1)), tx)
    return model, tx, state


def _tree(state):
    return params_from_flax(jax.tree.map(np.asarray, {
        "params": state.params, "batch_stats": state.batch_stats}))


@pytest.fixture(scope="module")
def jax_mesh():
    return jax_make_mesh({"data": WORLD}, devices=jax.devices()[:WORLD])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp")
    inputs = {"no_bn": _tree(_jax_state(False)[2]),
              "bn": _tree(_jax_state(True)[2]),
              "batches": _batches(0), "biased": _biased()}
    torch.save(inputs, tmp / "inputs.pt")
    spawn(dp_worker, WORLD, str(tmp), str(tmp / "inputs.pt"),
          init_method=f"file://{tmp}/store", timeout=120)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


def _jax_dp(mesh, use_bn, batches, **options):
    model, tx, state = _jax_state(use_bn)
    dp = JaxDataParallel(model, tx, mesh, donate=False, **options)
    dstate = dp.shard_state(state)
    losses = []
    for images, labels in batches:
        dstate, loss = dp.train_step(dstate, *dp.shard_batch(images, labels))
        losses.append(np.asarray(loss))
    return dp, dstate, np.stack(losses)


@pytest.mark.parametrize("use_bn", [False, True], ids=["no_bn", "bn"])
def test_dp_matches_jax_data_parallel(ranks, jax_mesh, use_bn):
    """3 steps: each rank's losses are JAX's rank row; the parameters and
    each rank's BN statistics are JAX's."""
    _, dstate, losses = _jax_dp(jax_mesh, use_bn, _batches(0))
    want = _tree(dstate)
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res[f"losses_{use_bn}"].numpy(),
                                   losses[:, r], **TOL)
        for name, value in res[f"state_{use_bn}"].items():
            ref = want[name].numpy()
            if name.split(".")[-1] in ("mean", "var"):
                ref = ref[r]                    # rank r's statistics
            np.testing.assert_allclose(value.numpy(), ref, **TOL,
                                       err_msg=f"{name} rank {r}")


def test_dp_matches_single_device_without_bn(ranks):
    """Without BN, 2 ranks of bs 2 are the port's single device on the
    concatenated batch of 4 (the mean of equal shards' means)."""
    model = ConvNet((DP_IMAGE, DP_IMAGE), device="cpu", use_bn=False)
    model.load_state_dict(_tree(_jax_state(False)[2]))
    step = make_train_step(TrainState(model, lr=DP_LR))
    losses = [float(step(torch.from_numpy(x), torch.from_numpy(y).long()))
              for x, y in _batches(0)]
    got = np.mean([res["losses_False"].numpy() for res in ranks], axis=0)
    np.testing.assert_allclose(got, losses, rtol=1e-5)
    for name, value in model.state_dict().items():
        np.testing.assert_allclose(ranks[0]["state_False"][name].numpy(),
                                   value.numpy(), atol=1e-6, err_msg=name)


@pytest.mark.parametrize("use_bn", [False, True], ids=["no_bn", "bn"])
def test_dp_params_stay_replicated(ranks, use_bn):
    for name, value in ranks[0][f"state_{use_bn}"].items():
        if name.split(".")[-1] not in ("mean", "var"):
            assert torch.equal(value, ranks[1][f"state_{use_bn}"][name])


def test_bn_stats_are_per_replica(ranks, jax_mesh):
    """Rank-dependent data: the BN means differ per rank, equal JAX's rank
    rows, and ``unshard_state(rank=1)`` picks rank 1's."""
    _, dstate, _ = _jax_dp(jax_mesh, True, [_biased()])
    want = np.asarray(dstate.batch_stats["bn1"]["mean"])
    means = [res["biased_state"]["bn1.mean"].numpy() for res in ranks]
    assert not np.allclose(means[0], means[1])
    for r in range(WORLD):
        np.testing.assert_allclose(means[r], want[r], **TOL)
        np.testing.assert_array_equal(
            ranks[r]["unshard_rank1"]["batch_stats/bn1/mean"], means[1])
        np.testing.assert_array_equal(
            ranks[r]["unshard_rank1"]["params/conv1/kernel"],
            ranks[1]["biased_state"]["conv1.kernel"].numpy())


def test_dp_loss_is_rank_local(ranks, jax_mesh):
    local = [float(res["losses_False"][0]) for res in ranks]
    assert local[0] != local[1]
    _, _, avg = _jax_dp(jax_mesh, False, _batches(0)[:1], average_loss=True)
    for res in ranks:
        np.testing.assert_allclose(float(res["avg_losses"][0]),
                                   np.mean(local), rtol=1e-6)
        np.testing.assert_allclose(float(res["avg_losses"][0]),
                                   avg[0, 0], rtol=1e-5)


def test_shard_state_broadcasts_rank0_params(ranks):
    """Ranks built from different seeds hold rank 0's parameters after
    ``shard_state``."""
    rank0 = ConvNet((DP_IMAGE, DP_IMAGE), device="cpu", seed=0).state_dict()
    for res in ranks:
        for name, value in res["synced"].items():
            if name.split(".")[-1] not in ("mean", "var"):
                assert torch.equal(value, rank0[name]), name


@pytest.fixture
def one_rank_mesh():
    bootstrap.init(device="cpu")
    yield make_mesh({"data": 1})
    bootstrap.cleanup()


def test_dp_validates_axis(one_rank_mesh):
    model = ConvNet((DP_IMAGE, DP_IMAGE), device="cpu", use_bn=False)
    with pytest.raises(ValueError, match="axis"):
        DataParallel(model, one_rank_mesh, axis="model")


@pytest.mark.parametrize("option", [
    dict(zero=True), dict(grad_compress="int8"), dict(grad_compress="bf16"),
    dict(error_feedback=False), dict(overlap_grad_sync=True),
    dict(bucket_mb=4.0)], ids=lambda o: next(iter(o)))
def test_extension_switches_configure_the_engine(one_rank_mesh, option):
    """Each switch sets what JAX's DataParallel sets (the compression
    policy, ZeRO-1, the overlap and the bucket target), and one step runs
    at one rank: the exact switches give the single-device step bit for
    bit, the compressed ones a finite loss within their rounding."""
    model, tx, _ = _jax_state(False)
    ref = JaxDataParallel(model, tx, jax_make_mesh(
        {"data": 1}, devices=jax.devices()[:1]), donate=False, **option)
    models = [ConvNet((DP_IMAGE, DP_IMAGE), device="cpu", use_bn=False)
              for _ in "ab"]
    dp = DataParallel(models[1], one_rank_mesh, **option)
    assert (dp.compress.mode, dp.compress.block,
            dp.compress.error_feedback) == (
        ref.compress.mode, ref.compress.block, ref.compress.error_feedback)
    assert (dp.zero, dp.overlap, dp.bucket_bytes) == (
        ref.zero, ref.overlap, ref.bucket_bytes)
    single = make_train_step(TrainState(models[0], lr=DP_LR))
    state = dp.shard_state(TrainState(models[1], lr=DP_LR))
    x, y = _batches(3, 1)[0]
    x, y = torch.from_numpy(x), torch.from_numpy(y).long()
    want, got = single(x, y), dp.train_step(state, x, y)
    assert torch.equal(got, want)               # the loss precedes the sync
    exact = dp.compress.mode == "none"
    for name, value in models[0].state_dict().items():
        other = models[1].state_dict()[name]
        if exact:
            assert torch.equal(value, other), name
        else:
            torch.testing.assert_close(other, value, rtol=0, atol=1e-3)


@pytest.mark.parametrize("method", ["lower_step"])
def test_unported_methods_raise(one_rank_mesh, method):
    model = ConvNet((DP_IMAGE, DP_IMAGE), device="cpu", use_bn=False)
    with pytest.raises(NotImplementedError, match="ROADMAP queue 1 item"):
        getattr(DataParallel(model, one_rank_mesh), method)()


@pytest.mark.parametrize("method", ["shard_state_local", "checkpoint_template",
                                    "checkpoint_spec"])
def test_checkpoint_hooks_at_one_rank(one_rank_mesh, method):
    """The sharded-checkpoint hooks under ZeRO-1 with int8 error feedback
    and momentum: ``checkpoint_spec`` gives JAX's kinds leaf for leaf and
    ``checkpoint_template`` JAX's paths and shapes (JAX's engine on one
    virtual device), and ``shard_state_local`` places a saved local view
    into a fresh state bitwise."""
    from tpu_sandbox.train.checkpoint import _flatten_with_paths
    from tpu_sandbox_torch.train import SGD
    from tpu_sandbox_torch.utils.bridge import state_template

    def port():
        model = ConvNet((DP_IMAGE, DP_IMAGE), device="cpu")
        state = TrainState(model, lr=DP_LR, optimizer=SGD(
            model.parameters(), DP_LR, momentum=0.9))
        dp = DataParallel(model, one_rank_mesh, zero=True,
                          grad_compress="int8")
        return state, dp

    state, dp = port()
    template = state_template(state)
    dp.shard_state(state)
    tx = optax.sgd(DP_LR, momentum=0.9)
    jm = JaxConvNet(dtype=jnp.float32)
    jstate = JaxTrainState.create(jm, jax.random.key(0),
                                  jnp.zeros((1, DP_IMAGE, DP_IMAGE, 1)), tx)
    jdp = JaxDataParallel(jm, tx, jax_make_mesh({"data": 1},
                                                devices=jax.devices()[:1]),
                          zero=True, grad_compress="int8")
    if method == "checkpoint_spec":
        want = dict(_flatten_with_paths(
            jdp.checkpoint_spec(jdp.shard_state(jstate)))[0])
        assert dp.checkpoint_spec(state) == want
    elif method == "checkpoint_template":
        want = _flatten_with_paths(jdp.checkpoint_template(
            jstate.host_view()))[0]
        got = dp.checkpoint_template(template)
        assert [(p, tuple(t.shape)) for p, t in got.items()] == [
            (p, np.shape(x)) for p, x in want]
    else:
        torch.manual_seed(0)
        for x in [*state.model.parameters(), *state.model.buffers(),
                  *state.optimizer.trace, *state.grad_residual]:
            x.data.normal_()
        local = dp.host_view(state)
        fresh, fdp = port()
        fdp.shard_state_local(fresh, local, fdp.checkpoint_template(template))
        got = fdp.host_view(fresh)
        assert list(got) == list(local)
        for path in local:
            np.testing.assert_array_equal(got[path], local[path], err_msg=path)


def test_one_rank_step_is_the_single_device_step(one_rank_mesh):
    """At one rank the mean is a sum over one rank divided by 1.0: losses
    and parameters bitwise the single-device trainer's, BN included."""
    models = [ConvNet((DP_IMAGE, DP_IMAGE), device="cpu") for _ in "ab"]
    single = make_train_step(TrainState(models[0], lr=DP_LR))
    state = TrainState(models[1], lr=DP_LR)
    dp = DataParallel(models[1], one_rank_mesh)
    for x, y in _batches(3, 2):
        x, y = torch.from_numpy(x), torch.from_numpy(y).long()
        assert torch.equal(single(x, y), dp.train_step(state, x, y))
    for name, value in models[0].state_dict().items():
        assert torch.equal(value, models[1].state_dict()[name]), name


# -- loaders ---------------------------------------------------------------

@pytest.mark.parametrize("n,bs,replicas", [(64, 4, 8), (30, 4, 4),
                                           (40, 5, 2), (7, 2, 3)])
def test_sharded_loader_equals_jaxs(n, bs, replicas):
    images, labels = jax_synthetic_mnist(n=n, seed=0)
    want = list(JaxShardedBatchLoader(images, labels, bs, replicas))
    loader = ShardedBatchLoader(images, labels, bs, replicas)
    got = list(loader)
    assert len(loader) == len(want) == len(got)
    for (gi, gl), (wi, wl) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        np.testing.assert_array_equal(gl, wl)
    for r in range(replicas):                       # each rank's own view
        view = list(ShardedBatchLoader(images, labels, bs, replicas, rank=r))
        for (vi, vl), (wi, wl) in zip(view, want):
            np.testing.assert_array_equal(vi, wi[r * bs:(r + 1) * bs])
            np.testing.assert_array_equal(vl, wl[r * bs:(r + 1) * bs])


def test_sharded_loader_epochs_follow_set_epoch():
    images, labels = jax_synthetic_mnist(n=30, seed=0)
    jl = JaxShardedBatchLoader(images, labels, 4, 2)
    tl = ShardedBatchLoader(images, labels, 4, 2, rank=1)
    jl.set_epoch(3)
    tl.set_epoch(3)
    for (ti, _), (wi, _) in zip(tl, jl):
        np.testing.assert_array_equal(ti, wi[4:8])
    with pytest.raises(ValueError, match="rank"):
        ShardedBatchLoader(images, labels, 4, 2, rank=2)


def test_prefetch_loader_keeps_order_and_delegates():
    images, labels = jax_synthetic_mnist(n=30, seed=0)
    base = ShardedBatchLoader(images, labels, 4, 2)
    pre = PrefetchLoader(base, depth=2)
    pre.set_epoch(2)
    assert base.epoch == 2 and len(pre) == len(base)
    got = list(pre)
    assert len(got) == len(base)
    for (pi, pl), (bi, bl) in zip(got, base):
        np.testing.assert_array_equal(pi, bi)
        np.testing.assert_array_equal(pl, bl)
    first = next(iter(pre))                 # a consumer that breaks off
    assert first[0].shape == (8, 28, 28)


def test_prefetch_loader_stages_in_the_producer_thread():
    """``stage`` (JAX :143-219) runs on each batch in the producer thread,
    in order, as JAX's does; the trainer's stage puts the batch on its
    device as tensors, labels int64."""
    import threading

    from tpu_sandbox.data.loader import PrefetchLoader as JaxPrefetchLoader
    from tpu_sandbox_torch.train.trainer import to_device

    images, labels = jax_synthetic_mnist(n=30, seed=0)
    seen = []

    def stage(x, y):
        seen.append(threading.current_thread().name)
        return x.sum(), y[:2]

    base = ShardedBatchLoader(images, labels, 4, 2)
    got = list(PrefetchLoader(base, stage=stage))
    want = list(JaxPrefetchLoader(
        JaxShardedBatchLoader(images, labels, 4, 2),
        stage=lambda x, y: (x.sum(), y[:2])))
    assert len(got) == len(want) == len(base)
    for (gs, gl), (ws, wl) in zip(got, want):
        assert gs == ws
        np.testing.assert_array_equal(gl, wl)
    assert set(seen) == {"prefetch-loader"}
    x, y = next(iter(PrefetchLoader(base, stage=lambda x, y: to_device(
        x, y, torch.device("cpu"), non_blocking=True))))
    assert isinstance(x, torch.Tensor) and y.dtype == torch.int64
    np.testing.assert_array_equal(x.numpy(), next(iter(base))[0])


def test_prefetch_loader_raises_the_producers_error():
    class Broken:
        def __len__(self):
            return 3

        def __iter__(self):
            yield np.zeros(1), np.zeros(1)
            raise OSError("disk gone")

    it = iter(PrefetchLoader(Broken()))
    next(it)
    with pytest.raises(OSError, match="disk gone"):
        next(it)
    with pytest.raises(ValueError, match="depth"):
        PrefetchLoader(Broken(), depth=0)
