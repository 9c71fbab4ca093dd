"""The port's data-parallel extensions (tpu_sandbox_torch/parallel/
data_parallel.py: ZeRO-1, ``grad_compress`` none/bf16/int8 with and
without error feedback, ``overlap_grad_sync``) == the JAX package's
``DataParallel`` with the same options.

Four gloo ranks, spawned once for the module (tests/torch_dist_workers.py
``dp_ext_worker``), train the ConvNet at 28x28 in fp32, without BN and
with it, for 3 steps from one tree that JAX drew (carried over by the
weight bridge) on the same global batches of 8 normalized synthetic MNIST
images (tests/test_grad_compress.py's data), SGD at 0.01 (with momentum
0.9 under ZeRO-1) or AdamW at 1e-3; JAX's ``DataParallel`` trains the
same tree on a mesh of 4 virtual CPU devices. Port rank r is JAX's mesh
row r. The overlapped cases take a bucket target of 4096 bytes: four
buckets, three of them a lone leaf.

Bars:
- the exact modes (ZeRO-1 with momentum and with AdamW, ``none``,
  overlap under none and under ZeRO-1): the plain engine's, rtol 1e-5
  (atol 1e-6 near 0) on losses, parameters and each rank's BN statistics;
  under BN the conv biases' true gradient is 0 (BN subtracts the batch
  mean), so their gradients are each framework's rounding noise, which
  AdamW's normalisation turns into updates of up to its rate: there they
  are held within 1e-5;
- bf16 and int8, step 1: the synced gradient, every element, is JAX's
  compressed mean (read from a pass-through transformation chained
  before JAX's SGD): int8 within one shot-2 step of its block and the same
  code in all but 1 % of each leaf's elements, on its own blocks' int8
  grid; bf16 a bf16 value within 4 bf16 roundings of JAX's (the bars of
  tests/test_torch_grad_compress.py, which hold the bare functions);
- bf16 and int8, 3 steps: the compressed mean is JAX's within a few roundings of
  the compressed value (tests/test_torch_grad_compress.py holds that
  element by element), and an element whose sum over ranks lands on a
  rounding boundary takes the neighbouring code, one compressed step
  away, which the next steps carry on. So each leaf of the parameters
  and BN statistics, and the losses, are held to JAX's within twice what
  the compression itself moves JAX's run (max |JAX compressed - JAX
  uncompressed| over the leaf) plus 1e-6, four times for bf16 (gloo's
  ring rounds the bf16 sum at each of its 3 hops and at the end, JAX's
  CPU all-reduce once); the compressed cases train at SGD 1e-4, where a
  code that one framework rounds the other way moves the parameters less
  than the gradients' own rounding noise, so that the next steps quantise
  the same values (at 1e-2 one such code grows into many by step 3, on
  both sides alike, and no element-wise bar holds); the port's compressed
  run must
  differ from its own uncompressed one (the compression ran); and at
  least 99 % of each residual's elements are JAX's within 1e-5 (the rest
  are flipped codes; the share is printed);
- ZeRO-1 equals the port's plain ``DataParallel`` within rtol 1e-6 (atol
  1e-7), JAX's own bar between the two (tests/test_grad_compress.py:237);
- ``grad_compress="none"`` and overlap under none equal the port's plain
  ``DataParallel`` bit for bit on the 2-rank groups of a {"data": 2,
  "pair": 2} mesh, and within rtol 1e-6 (atol 1e-7) at 4 ranks, where the
  order of the ring sum depends on how the buffer is chunked;
- the constructor's and ``shard_state``'s ValueErrors are JAX's word for
  word.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from torch_dist_workers import (
    DP_EXT_ADAMW_EPS,
    DP_EXT_BUCKET_MB,
    DP_EXT_CASES,
    DP_EXT_FINE_LR,
    DP_EXT_IMAGE,
    DP_EXT_LR,
    DP_EXT_PAIR_CASES,
    DP_EXT_VALIDATIONS,
    DP_STEPS,
    dp_ext_worker,
)
from tpu_sandbox.data import synthetic_mnist
from tpu_sandbox.data.mnist import normalize
from tpu_sandbox.models import ConvNet as JaxConvNet
from tpu_sandbox.ops.losses import cross_entropy_loss as jax_cross_entropy
from tpu_sandbox.parallel import DataParallel as JaxDataParallel
from tpu_sandbox.parallel.buckets import plan_buckets as jax_plan_buckets
from tpu_sandbox.parallel.collectives import (
    CompressedAllReduce as JaxCompressedAllReduce,
)
from tpu_sandbox.runtime.mesh import make_mesh as jax_make_mesh
from tpu_sandbox.train import TrainState as JaxTrainState
from tpu_sandbox_torch.parallel.launch import spawn
from tpu_sandbox_torch.utils.bridge import params_from_flax
from torch_threads import one_torch_thread  # noqa: F401

WORLD, BS = 4, 2
EXACT = dict(rtol=1e-5, atol=1e-6)
RESIDUAL_ATOL, RESIDUAL_SHARE = 1e-5, 0.99
SAME = dict(rtol=1e-6, atol=1e-7)
#: the cases held to JAX; the compressed ones against JAX's plain run
JAX_CASES = [name for name in DP_EXT_CASES if name != "plain_momentum"
             and name != "plain_adamw" and name != "plain_sgd"]
COMPRESSED = [name for name in JAX_CASES if "int8" in name or "bf16" in name]


def _batches(seed, n):
    images, labels = synthetic_mnist(n=n * DP_STEPS, seed=seed)
    images = normalize(images).astype(np.float32)
    labels = labels.astype(np.int32)
    return [(images[i * n:(i + 1) * n], labels[i * n:(i + 1) * n])
            for i in range(DP_STEPS)]


def _capture():
    """A pass-through transformation whose state is the last gradient it
    saw: chained before the optimizer, it holds the synced mean."""
    return optax.GradientTransformation(
        lambda params: jax.tree.map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def _tx(opt):
    if opt == "sgd":
        return optax.sgd(DP_EXT_LR)
    if opt == "sgd_fine":
        return optax.chain(_capture(), optax.sgd(DP_EXT_FINE_LR))
    if opt == "momentum":
        return optax.sgd(DP_EXT_LR, momentum=0.9)
    if opt == "adamw":
        return optax.adamw(1e-3, eps=DP_EXT_ADAMW_EPS)
    # state that matches no parameter's shape: an (8,) row factor
    return optax.chain(optax.GradientTransformation(
        lambda params: {"factor": jnp.zeros(8)},
        lambda updates, state, params=None: (updates, state)),
        optax.sgd(DP_EXT_LR))


def _jax_state(use_bn, opt="sgd"):
    model = JaxConvNet(use_bn=use_bn)
    tx = _tx(opt)
    state = JaxTrainState.create(
        model, jax.random.key(0),
        jnp.zeros((1, DP_EXT_IMAGE, DP_EXT_IMAGE, 1)), tx)
    return model, tx, state


def _tree(variables):
    return params_from_flax(jax.tree.map(np.asarray, variables))


@pytest.fixture(scope="module")
def jax_mesh():
    return jax_make_mesh({"data": WORLD}, devices=jax.devices()[:WORLD])


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_ext")
    inputs = {}
    for use_bn, key in ((False, "no_bn"), (True, "bn")):
        state = _jax_state(use_bn)[2]
        inputs[key] = _tree({"params": state.params,
                             "batch_stats": state.batch_stats})
    inputs["batches"] = _batches(0, WORLD * BS)
    inputs["pair_batches"] = _batches(1, 2 * BS)
    torch.save(inputs, tmp / "inputs.pt")
    spawn(dp_ext_worker, WORLD, str(tmp), str(tmp / "inputs.pt"),
          init_method=f"file://{tmp}/store", timeout=240)
    return [torch.load(tmp / f"rank{r}.pt", weights_only=False)
            for r in range(WORLD)]


@pytest.fixture(scope="module")
def jax_results(jax_mesh):
    """Each of JAX_CASES through JAX's DataParallel, with and without BN:
    (losses [steps, ranks], params and every rank's BN statistics by
    name, the residual by name or None, step 1's synced gradient by name
    for the compressed cases or None)."""
    out = {}
    for name in JAX_CASES:
        opt, options = DP_EXT_CASES[name]
        for use_bn in (False, True):
            model, tx, state = _jax_state(use_bn, opt)
            dp = JaxDataParallel(model, tx, jax_mesh, donate=False,
                                 **options)
            dstate = dp.shard_state(state)
            losses, grad1 = [], None
            for images, labels in _batches(0, WORLD * BS):
                dstate, loss = dp.train_step(
                    dstate, *dp.shard_batch(images, labels))
                losses.append(np.asarray(loss))
                if grad1 is None and name in COMPRESSED:
                    grad1 = _tree({"params": dstate.opt_state[0]})
            res = dstate.grad_residual
            out[name, use_bn] = (
                np.stack(losses),
                _tree({"params": dstate.params,
                       "batch_stats": dstate.batch_stats}),
                None if res is None else _tree({"params": res}), grad1)
    return out


def _check_state(got, want, rank, tol, what):
    for name, value in got.items():
        ref = want[name].numpy()
        if name.split(".")[-1] in ("mean", "var"):
            ref = ref[rank]                      # rank r's statistics
        np.testing.assert_allclose(value.numpy(), ref, **tol,
                                   err_msg=f"{what} {name} rank {rank}")


@pytest.mark.parametrize("use_bn", [False, True], ids=["no_bn", "bn"])
@pytest.mark.parametrize("name", sorted(set(JAX_CASES) - set(COMPRESSED)))
def test_three_steps_match_jax_data_parallel(ranks, jax_results, name,
                                             use_bn):
    """Each rank's losses are JAX's rank row; the parameters and each
    rank's BN statistics are JAX's."""
    losses, want, _, _ = jax_results[name, use_bn]
    noise = use_bn and DP_EXT_CASES[name][0] == "adamw"
    for r, res in enumerate(ranks):
        got = res[name, use_bn]
        np.testing.assert_allclose(got["losses"].numpy(), losses[:, r],
                                   **EXACT)
        state = dict(got["state"])
        for leaf in ("conv1.bias", "conv2.bias") if noise else ():
            np.testing.assert_allclose(state.pop(leaf).numpy(),
                                       want[leaf].numpy(), rtol=0, atol=1e-5)
        _check_state(state, want, r, EXACT, name)
        assert got["residual"] is None


def _leaf(tree, name, rank):
    ref = tree[name].numpy()
    return ref[rank] if name.split(".")[-1] in ("mean", "var") else ref


@pytest.mark.parametrize("use_bn", [False, True], ids=["no_bn", "bn"])
@pytest.mark.parametrize("name", sorted(COMPRESSED))
def test_compressed_steps_match_jax_data_parallel(ranks, jax_results, name,
                                                  use_bn):
    """Each rank's losses, parameters and BN statistics within twice the
    compression's own effect on JAX's run; each rank's residual JAX's
    rank row but for flipped codes."""
    losses, want, want_res, _ = jax_results[name, use_bn]
    plain_losses, plain, _, _ = jax_results["plain_fine", use_bn]
    k = 4 if name == "bf16" else 2
    for r, res in enumerate(ranks):
        got = res[name, use_bn]
        bar = k * np.abs(losses[:, r] - plain_losses[:, r]).max() + 1e-6
        assert np.abs(got["losses"].numpy() - losses[:, r]).max() <= bar
        moved = False
        for leaf, value in got["state"].items():
            ref = _leaf(want, leaf, r)
            bar = k * np.abs(ref - _leaf(plain, leaf, r)).max() + 1e-6
            dev = np.abs(value.numpy() - ref).max()
            assert dev <= bar, (name, leaf, r, dev, bar)
            moved |= not torch.equal(
                value, res["plain_fine", use_bn]["state"][leaf])
        assert moved, f"{name}: the port's run is its uncompressed run"
        if want_res is None:
            assert got["residual"] is None
            continue
        assert sorted(got["residual"]) == sorted(want_res)
        for leaf, value in got["residual"].items():
            close = np.abs(value.numpy() - want_res[leaf].numpy()[r]) \
                <= RESIDUAL_ATOL
            print(f"{name} bn={use_bn} rank {r} residual {leaf}: "
                  f"{1 - close.mean():.3%} of the elements differ")
            assert close.mean() >= RESIDUAL_SHARE, (name, leaf, r)


@pytest.fixture(scope="module")
def rank_grads():
    """Each rank's own gradient of step 1 by name, [WORLD, ...], from
    JAX's loss on the rank's rows (the bf16 bar's summed magnitudes)."""
    out = {}
    images, labels = _batches(0, WORLD * BS)[0]
    for use_bn in (False, True):
        model, _, state = _jax_state(use_bn)

        def loss(params, x, y, model=model, state=state):
            variables = {"params": params}
            if state.batch_stats:
                variables["batch_stats"] = state.batch_stats
            logits, _ = model.apply(variables, x, train=True,
                                    mutable=["batch_stats"])
            return jax_cross_entropy(logits, y)

        grad = jax.jit(jax.grad(loss))
        grads = [_tree({"params": grad(
            state.params, images[r * BS:(r + 1) * BS],
            labels[r * BS:(r + 1) * BS])}) for r in range(WORLD)]
        out[use_bn] = {k: np.stack([g[k].numpy() for g in grads])
                       for k in grads[0]}
    return out


def _int8_steps(want, order, policy, spans):
    """One shot-2 int8 step for each element of each leaf: absmax / 127
    of its block of the flat mean its bucket exchanges (the leaves of a
    span concatenated in order; without buckets each leaf alone)."""
    steps = {}
    for a, b in spans:
        names = order[a:b]
        flat = np.concatenate([want[n].reshape(-1) for n in names])
        n = flat.size
        block = policy.block_for(n, WORLD)
        chunk = -(-n // (WORLD * block)) * block
        blocks = np.pad(flat, (0, WORLD * chunk - n)).reshape(-1, block)
        step = np.broadcast_to(np.abs(blocks).max(-1, keepdims=True)
                               / np.float32(127.0), blocks.shape)
        step = step.reshape(-1)[:n]
        for nm in names:
            k = want[nm].size
            steps[nm], step = step[:k].reshape(want[nm].shape), step[k:]
    return steps


@pytest.mark.parametrize("use_bn", [False, True], ids=["no_bn", "bn"])
@pytest.mark.parametrize("name", sorted(COMPRESSED))
def test_first_synced_gradient_is_jaxs_compressed_mean(
        ranks, jax_results, rank_grads, name, use_bn):
    """Step 1's synced gradient, every leaf element by element, against
    JAX's (the state of a pass-through transformation chained before its
    SGD). int8: the port's mean lies on its blocks' int8 grid (each value
    a whole number of absmax / 127), every element is within one shot-2
    step of JAX's, and in each leaf at most 1 % of the elements (or one)
    differ by more than a hundredth of a step, the codes an fp32 sum over
    ranks put on the other side of a rounding boundary (the share is
    printed). bf16: the mean is a bf16 value, within 4 bf16 roundings of
    JAX's (2^-6 times the mean over ranks of |g_r|, as
    tests/test_torch_grad_compress.py holds the bare function). Under BN
    the conv biases' true gradient is 0, so theirs is each framework's
    rounding noise: both are held under 1e-6."""
    want = {k: v.numpy() for k, v in jax_results[name, use_bn][3].items()}
    options = DP_EXT_CASES[name][1]
    policy = JaxCompressedAllReduce(mode=options["grad_compress"])
    order = list(ranks[0][name, use_bn]["grad1"])
    assert sorted(order) == sorted(want)
    if options.get("overlap_grad_sync"):
        spans = jax_plan_buckets([4 * want[n].size for n in order],
                                 int(DP_EXT_BUCKET_MB * 2 ** 20))
        assert any(b - a > 1 for a, b in spans)
    else:
        spans = [(i, i + 1) for i in range(len(order))]
    steps = _int8_steps(want, order, policy, spans)
    noise = {"conv1.bias", "conv2.bias"} if use_bn else set()
    for r, res in enumerate(ranks):
        got = res[name, use_bn]["grad1"]
        for leaf in order:
            g, w = got[leaf].numpy(), want[leaf]
            assert g.shape == w.shape and g.dtype == np.float32, leaf
            if leaf in noise:
                assert np.abs(g).max() <= 1e-6 and np.abs(w).max() <= 1e-6
                continue
            dev = np.abs(g - w)
            if policy.mode == "bf16":
                as_bf16 = torch.from_numpy(g).to(torch.bfloat16).float()
                assert torch.equal(as_bf16, got[leaf]), (name, leaf)
                bound = 2.0 ** -6 * np.abs(rank_grads[use_bn][leaf]).mean(0)
                assert (dev <= bound).all(), (name, leaf, r)
                continue
            step = steps[leaf]
            assert (dev <= step * (1 + 1e-6) + 1e-9).all(), (
                name, leaf, r, float((dev - step).max()))
            off = int((dev > 1e-2 * step).sum())
            print(f"{name} bn={use_bn} rank {r} {leaf}: {off} of "
                  f"{dev.size} elements a code away from JAX's")
            assert off <= max(1, dev.size // 100), (name, leaf, r, off)
        if policy.mode == "int8":
            grid = _int8_steps({n: got[n].numpy() for n in order}, order,
                               policy, spans)
            for leaf in order:
                g, s = got[leaf].numpy(), grid[leaf]
                codes = np.round(g / np.where(s > 0, s, 1))
                assert (np.abs(codes) <= 127).all(), leaf
                assert (np.abs(g - codes * s) <= 1e-5 * s).all(), (
                    name, leaf, "off the int8 grid")


@pytest.mark.parametrize("use_bn", [False, True], ids=["no_bn", "bn"])
@pytest.mark.parametrize("case,plain", [
    ("zero_momentum", "plain_momentum"), ("zero_adamw", "plain_adamw"),
    ("overlap_zero", "plain_momentum"), ("none", "plain_sgd"),
    ("overlap_none", "plain_sgd")])
def test_exact_modes_equal_the_plain_engine(ranks, case, plain, use_bn):
    for res in ranks:
        got, want = res[case, use_bn], res[plain, use_bn]
        np.testing.assert_allclose(got["losses"].numpy(),
                                   want["losses"].numpy(), **SAME)
        for name, value in got["state"].items():
            np.testing.assert_allclose(value.numpy(),
                                       want["state"][name].numpy(), **SAME,
                                       err_msg=f"{case} {name}")


@pytest.mark.parametrize("case", [c for c in DP_EXT_PAIR_CASES
                                  if c != "plain_sgd"])
def test_none_modes_are_the_plain_engine_bitwise_at_two_ranks(ranks, case):
    for res in ranks:
        got, want = res["pair", case], res["pair", "plain_sgd"]
        assert torch.equal(got["losses"], want["losses"])
        for name, value in got["state"].items():
            assert torch.equal(value, want["state"][name]), (case, name)


def test_params_stay_replicated(ranks):
    for key in ranks[0]:
        if key == "errors":
            continue
        for res in ranks[1:]:
            for name, value in res[key]["state"].items():
                if name.split(".")[-1] not in ("mean", "var") and \
                        key[0] != "pair":
                    assert torch.equal(value,
                                       ranks[0][key]["state"][name]), key


def test_zero_updates_each_ranks_dim0_block(ranks):
    """ZeRO-1's blocks: a parameter whose dim 0 the 4 ranks divide is
    updated in a quarter of its rows (the fc kernel, the 16- and 32-wide
    vectors); the conv kernels (dim 0 of 5) and the fc bias (10) whole."""
    fc_rows = (DP_EXT_IMAGE // 4) ** 2 * 32
    blocks = ranks[0]["zero_adamw", True]["blocks"]
    state = ranks[0]["zero_adamw", True]["state"]
    for name, shape in blocks.items():
        full = tuple(state[name].shape)
        if full[0] % WORLD == 0:
            assert shape == (full[0] // WORLD, *full[1:]), name
        else:
            assert shape == full, name
    assert blocks["fc.kernel"] == (fc_rows // WORLD, 10)
    assert blocks["conv1.kernel"] == (5, 5, 1, 16)


def test_residual_carries_only_with_error_feedback(ranks):
    for res in ranks:
        for key, got in res.items():
            if key == "errors":
                continue
            name = key[1] if key[0] == "pair" else key[0]
            feedback = "int8" in name and "noef" not in name
            assert (got["residual"] is not None) == feedback, key
            if feedback:
                assert any(float(v.abs().max()) > 0
                           for v in got["residual"].values())


def _jax_error(name):
    options = dict(DP_EXT_VALIDATIONS[name])
    opt = options.pop("opt", "sgd")
    model, tx, state = _jax_state(False, opt)
    mesh = jax_make_mesh({"data": WORLD}, devices=jax.devices()[:WORLD])
    try:
        JaxDataParallel(model, tx, mesh, donate=False,
                        **options).shard_state(state)
    except ValueError as e:
        return str(e)
    return ""


@pytest.mark.parametrize("name", sorted(DP_EXT_VALIDATIONS))
def test_validations_match_jax(ranks, name):
    want = _jax_error(name)
    assert want
    for res in ranks:
        assert res["errors"][name] == want
