"""The port's checkpoints (tpu_sandbox_torch/train/checkpoint.py) against
the JAX package's (tpu_sandbox/train/checkpoint.py).

- Round trips across the frameworks: a state with random values in every
  leaf, written by one package and restored by the other, comes back
  bitwise, for plain sgd, sgd with momentum, adamw and the int8 residual,
  in ``HostCheckpoint``, a one-rank ``ShardedCheckpoint``, the port's
  single-device format (a sealed one-rank step beside the layout stamp)
  and ``export_params``; the leaf paths of the port's state are those of
  JAX's ``TrainState.host_view()`` (``utils/bridge.py``); a two-rank
  sharded step with per-replica and dim-0 leaves; bf16 leaves.
- The hardening cases of tests/test_resumable.py:255-345,
  test_sharded_checkpoint.py and test_checkpoint_hardening.py on the
  port's classes: sidecars, torn and corrupt steps, quarantine, strict
  explicit steps, ``restore_partial`` as a slice of the full restore, the
  reshard across a world change, the verifier, compression; and the
  single-device format's own: orbax directories refused, the layout
  guard, the periodic saver.
- ``DataParallel``'s checkpoint hooks at one gloo rank.

Everything is numpy on the CPU: no model runs here.
"""

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from tpu_sandbox.train import TrainState as JaxTrainState
from tpu_sandbox.train import checkpoint as jck
from tpu_sandbox_torch.models.convnet_s2d_t import ConvNetS2DT
from tpu_sandbox_torch.parallel.data_parallel import DataParallel
from tpu_sandbox_torch.runtime import bootstrap
from tpu_sandbox_torch.runtime.faults import (
    corrupt_latest_shard,
    corrupt_step_dir,
)
from tpu_sandbox_torch.train import SGD, AdamW, TrainState
from tpu_sandbox_torch.train import checkpoint as ck
from tpu_sandbox_torch.train.optim import constant_schedule
from tpu_sandbox_torch.utils.bridge import (
    params_to_flax,
    state_from_leaves,
    state_template,
    state_to_leaves,
)
from torch_threads import one_torch_thread  # noqa: F401

HW = (32, 32)
OPTS = {"sgd": (None, False), "momentum": ("momentum", False),
        "adamw": ("adamw", False), "int8_residual": (None, True)}
#: what JAX's ``_flatten_with_paths`` names, besides params and stats
OPT_PATHS = {
    "sgd": [],
    "momentum": ["opt_state/0/trace/"],
    "adamw": ["opt_state/0/count", "opt_state/0/mu/", "opt_state/0/nu/"],
    "int8_residual": ["grad_residual/"],
}


def _port_state(opt: str) -> TrainState:
    kind, residual = OPTS[opt]
    model = ConvNetS2DT(HW, device="cpu")
    optimizer = {None: None,
                 "momentum": lambda: SGD(model.parameters(), 1e-4, 0.9),
                 "adamw": lambda: AdamW(model.parameters(),
                                        constant_schedule(1e-4))}[kind]
    state = TrainState(model, optimizer=optimizer() if optimizer else None)
    if residual:
        state.grad_residual = [torch.zeros_like(p) for _, p in sorted(
            model.named_parameters(), key=lambda kv: kv[0].split("."))]
    return state


def _random_leaves(state, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    out = {}
    for path, leaf in state_template(state).items():
        if leaf.shape == ():
            out[path] = np.asarray(rng.integers(1, 1000), np.int32)
        else:
            out[path] = rng.standard_normal(leaf.shape).astype(np.float32)
    return out


def _jax_state(opt: str, leaves: dict | None = None):
    """JAX's TrainState of the same model and optimizer; with ``leaves``
    (flat, JAX's paths) its every leaf takes those values."""
    kind, residual = OPTS[opt]
    variables = params_to_flax(ConvNetS2DT(HW, device="cpu"))
    tx = {None: optax.sgd(1e-4), "momentum": optax.sgd(1e-4, momentum=0.9),
          "adamw": optax.adamw(1e-4)}[kind]
    params = jax.tree.map(jnp.asarray, variables["params"])
    state = JaxTrainState(
        step=jnp.zeros((), jnp.int32), params=params,
        batch_stats=jax.tree.map(jnp.asarray, variables["batch_stats"]),
        opt_state=tx.init(params),
        grad_residual=(jax.tree.map(jnp.zeros_like, params) if residual
                       else None))
    if leaves is None:
        return state
    paths, treedef = jck._flatten_with_paths(state)
    return jax.tree_util.tree_unflatten(
        treedef, [jnp.asarray(leaves[p]) for p, _ in paths])


def _assert_bitwise(got: dict, want: dict) -> None:
    assert list(got) == list(want)
    for path in want:
        g, w = np.asarray(got[path]), np.asarray(want[path])
        assert g.dtype == w.dtype and g.shape == w.shape, path
        np.testing.assert_array_equal(g, w, err_msg=path)


# -- JAX's leaf paths --------------------------------------------------------------

@pytest.mark.parametrize("opt", sorted(OPTS))
def test_leaf_paths_are_jaxs(opt):
    """The port's state flattens to JAX's ``host_view`` paths, in JAX's
    order, with JAX's shapes and dtypes."""
    state = _port_state(opt)
    ours = state.host_view()
    jleaves, _ = jck._flatten_with_paths(_jax_state(opt).host_view())
    assert list(ours) == [p for p, _ in jleaves]
    for path, leaf in jleaves:
        assert ours[path].shape == np.shape(leaf), path
        assert ours[path].dtype == np.asarray(leaf).dtype, path
    extra = [p for p in ours if not p.startswith(("step", "params/",
                                                  "batch_stats/"))]
    families = {p if p == "opt_state/0/count" else
                "/".join(p.split("/")[:3]) + "/" if p.startswith("opt_state")
                else "grad_residual/" for p in extra}
    assert sorted(families) == sorted(OPT_PATHS[opt])


# -- round trips across the frameworks ---------------------------------------------

def _write_jax(fmt, d, host, step):
    if fmt == "host":
        jck.HostCheckpoint(d).save(host, step, epoch=1, offset=2)
    elif fmt in ("sharded", "single"):
        if fmt == "single":
            jck._stamp_layout(Path(d).absolute())
        spec = jax.tree.map(lambda _: "rep", host)
        assert jck.ShardedCheckpoint(d, rank=0, world_size=1,
                                     verbose=False).save(
            host, spec, step, epoch=1, offset=2)


def _read_jax(fmt, d, template):
    if fmt == "host":
        tree, meta = jck.HostCheckpoint(d).restore(template)
    else:
        tree, meta = jck.ShardedCheckpoint(d, rank=0, world_size=1,
                                           verbose=False).restore(template)
    return dict(jck._flatten_with_paths(tree)[0]), meta


@pytest.mark.parametrize("fmt", ["host", "sharded", "single"])
@pytest.mark.parametrize("opt", sorted(OPTS))
def test_jax_written_restores_into_the_port(tmp_path, opt, fmt):
    state = _port_state(opt)
    leaves = _random_leaves(state, seed=1)
    _write_jax(fmt, tmp_path / "ck", _jax_state(opt, leaves).host_view(), 7)
    if fmt == "host":
        tree, meta = ck.HostCheckpoint(tmp_path / "ck").restore(
            state_template(state))
        assert (meta["step"], meta["epoch"], meta["offset"]) == (7, 1, 2)
        state_from_leaves(state, tree)
    elif fmt == "sharded":
        tree, meta = ck.ShardedCheckpoint(
            tmp_path / "ck", rank=0, world_size=1, verbose=False).restore(
            state_template(state))
        assert meta["world_size"] == 1
        state_from_leaves(state, tree)
    else:
        assert ck.latest_step(tmp_path / "ck") == 7
        ck.restore(tmp_path / "ck", state)
    _assert_bitwise(state_to_leaves(state), leaves)


@pytest.mark.parametrize("fmt", ["host", "sharded", "single"])
@pytest.mark.parametrize("opt", sorted(OPTS))
def test_port_written_restores_into_jax(tmp_path, opt, fmt):
    state = _port_state(opt)
    leaves = _random_leaves(state, seed=2)
    state_from_leaves(state, leaves)
    d = tmp_path / "ck"
    if fmt == "host":
        ck.HostCheckpoint(d).save(state.host_view(), 7, epoch=1, offset=2)
    elif fmt == "sharded":
        host = state.host_view()
        assert ck.ShardedCheckpoint(d, rank=0, world_size=1,
                                    verbose=False).save(
            host, {p: "rep" for p in host}, 7, epoch=1, offset=2)
    else:
        assert ck.save(d, state) == int(leaves["step"])
        assert (d / "LAYOUT").read_text().strip() == jck._LAYOUT
    template = _jax_state(opt).host_view()
    got, meta = _read_jax(fmt, d, template)
    _assert_bitwise(got, leaves)


def test_exported_params_cross_both_ways(tmp_path):
    model = ConvNetS2DT(HW, device="cpu")
    rng = np.random.default_rng(3)
    params = jax.tree.map(
        lambda x: rng.standard_normal(x.shape).astype(np.float32),
        params_to_flax(model)["params"])
    sd = jck.export_params(tmp_path / "jax", params, 11, extra={"v": 1})
    ck.load_exported_params(sd, model)
    for name, p in model.named_parameters():
        mod, leaf = name.split(".")
        np.testing.assert_array_equal(p.detach().numpy(), params[mod][leaf])
    back = ck.export_params(tmp_path / "port", model, 12)
    assert back.name == "step-00000012"
    tree = jck.load_exported_params(back, params)
    for mod in params:
        for leaf in params[mod]:
            np.testing.assert_array_equal(tree[mod][leaf], params[mod][leaf])
    manifest = json.loads((back / "MANIFEST.json").read_text())
    assert manifest["exported"] is True and manifest["step"] == 12


def _toy(seed: int, world: int = 2):
    """(per-rank local trees, spec, global template, full) for a toy state:
    a replicated leaf, a dim-0 sharded leaf, a per-replica leaf."""
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((3, 4)).astype(np.float32)
    mom = rng.standard_normal((world * 2, 4)).astype(np.float32)
    bn = rng.standard_normal((world, 5)).astype(np.float32)
    locals_ = [{"w": w, "mom": mom[r * 2:(r + 1) * 2], "bn": bn[r:r + 1]}
               for r in range(world)]
    spec = {"w": "rep", "mom": "shard0", "bn": "shard0"}
    return locals_, spec, {"w": w, "mom": mom, "bn": bn[0]}, {
        "w": w, "mom": mom, "bn": bn}


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_two_rank_sharded_step_crosses(tmp_path, writer):
    """Per-rank shards of one framework reassemble in the other: the dim-0
    blocks concatenated, the per-replica leaf expanded, and each rank's
    ``restore_partial`` its own block."""
    locals_, spec, template, full = _toy(4)
    wmod, rmod = (jck, ck) if writer == "jax" else (ck, jck)
    cks = [wmod.ShardedCheckpoint(tmp_path / "ck", rank=r, world_size=2,
                                  verbose=False, commit_timeout=5.0)
           for r in range(2)]
    for r in (1, 0):                        # rank 0 last: it seals
        assert cks[r].save(locals_[r], spec, 3, epoch=0, offset=3)
    readers = [rmod.ShardedCheckpoint(tmp_path / "ck", rank=r, world_size=2,
                                      verbose=False) for r in range(2)]
    tree, meta = readers[0].restore(template)
    for k in full:
        np.testing.assert_array_equal(np.asarray(tree[k]), full[k])
    for r in range(2):
        part, _ = readers[r].restore_partial(template)
        np.testing.assert_array_equal(part["mom"], locals_[r]["mom"])
        np.testing.assert_array_equal(part["bn"], locals_[r]["bn"])


def test_bf16_leaves_cross_both_ways(tmp_path):
    """bf16 is stored widened to fp32 with its dtype name, on both sides:
    the port gives a torch.bfloat16 tensor back, JAX an ml_dtypes array."""
    t = torch.arange(8, dtype=torch.float32).div(3).to(torch.bfloat16)
    ck.HostCheckpoint(tmp_path / "p").save({"p": t}, 1, epoch=0, offset=1)
    jtree, meta = jck.HostCheckpoint(tmp_path / "p").restore(
        {"p": np.zeros(8, jnp.bfloat16)})
    assert meta["dtypes"] == {"p": "bfloat16"}
    assert jtree["p"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(jtree["p"].astype(np.float32),
                                  t.float().numpy())
    j = np.asarray(jnp.arange(8, dtype=jnp.bfloat16) / 7)
    jck.HostCheckpoint(tmp_path / "j").save({"p": j}, 1, epoch=0, offset=1)
    tree, _ = ck.HostCheckpoint(tmp_path / "j").restore(
        {"p": ck.ShapeDtype((8,))})
    assert tree["p"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tree["p"].float().numpy(),
                                  j.astype(np.float32))


# -- HostCheckpoint hardening (tests/test_resumable.py:255-345) ------------------

def _tree(v):
    return {"w": np.full((3, 2), v, np.float32),
            "nested": {"b": np.arange(4, dtype=np.int32) + int(v)}}


def test_host_roundtrip_prune_and_sidecars(tmp_path):
    hc = ck.HostCheckpoint(tmp_path, keep=2)
    for step in (1, 2, 3):
        hc.save(_tree(step), step, epoch=0, offset=step)
    assert hc.steps() == [2, 3]
    assert sorted(p.name for p in tmp_path.glob("*.sha256")) == [
        "step-00000002.npz.sha256", "step-00000003.npz.sha256"]
    for step in (2, 3):
        assert ck.verify_npz_sidecar(tmp_path / f"step-{step:08d}.npz") \
            is None
    state, meta = hc.restore(_tree(0))
    assert meta == {"step": 3, "epoch": 0, "offset": 3, "dtypes": {}}
    np.testing.assert_array_equal(state["nested"]["b"], _tree(3)["nested"]["b"])


def test_host_corrupt_and_forged_files_fall_back(tmp_path, capsys):
    hc = ck.HostCheckpoint(tmp_path)
    hc.save(_tree(1), 1, epoch=0, offset=1)
    hc.save(_tree(2), 2, epoch=0, offset=2)
    src = ck.HostCheckpoint(tmp_path / "forge").save(_tree(99), 2, epoch=0,
                                                     offset=2)
    (tmp_path / "step-00000002.npz").write_bytes(src.read_bytes())
    state, meta = hc.restore(_tree(0))
    assert meta["step"] == 1
    np.testing.assert_array_equal(state["w"], _tree(1)["w"])
    assert "sha256 mismatch" in capsys.readouterr().out
    assert sorted(p.name for p in tmp_path.glob("*.corrupt")) == [
        "step-00000002.npz.corrupt", "step-00000002.npz.sha256.corrupt"]
    hc.save(_tree(3), 3, epoch=0, offset=3)
    (tmp_path / "step-00000003.npz").write_bytes(b"\xde\xad not a zipfile")
    (tmp_path / "step-00000003.npz.sha256").unlink()
    assert hc.restore(_tree(0))[1]["step"] == 1


def test_host_legacy_file_empty_dir_and_strict_step(tmp_path):
    hc = ck.HostCheckpoint(tmp_path)
    assert hc.restore(_tree(0)) is None
    hc.save(_tree(5), 5, epoch=0, offset=5)
    (tmp_path / "step-00000005.npz.sha256").unlink()
    assert hc.restore(_tree(0))[1]["step"] == 5
    bad = {"w": np.zeros((9, 9), np.float32),
           "nested": {"b": np.zeros(4, np.int32)}}
    with pytest.raises(ValueError, match="shape"):
        hc.restore(bad, step=5)


# -- ShardedCheckpoint hardening (tests/test_sharded_checkpoint.py) ---------------

def _ckpts(directory, world=2, **kw):
    kw.setdefault("commit_timeout", 5.0)
    return [ck.ShardedCheckpoint(directory, rank=r, world_size=world,
                                 verbose=False, **kw) for r in range(world)]


def _save_all(cks, locals_, spec, step, **kw):
    return [c.save(lt, spec, step, epoch=kw.get("epoch", 0),
                   offset=kw.get("offset", 0))
            for c, lt in list(zip(cks, locals_))[::-1]][::-1]


def test_sharded_round_trip_and_manifest(tmp_path):
    locals_, spec, template, full = _toy(0)
    cks = _ckpts(tmp_path / "ck")
    assert _save_all(cks, locals_, spec, 8, epoch=1, offset=3) == [True, True]
    for c in cks:
        tree, meta = c.restore(template)
        for k in full:
            np.testing.assert_array_equal(tree[k], full[k])
        assert (meta["step"], meta["epoch"], meta["offset"],
                meta["world_size"]) == (8, 1, 3, 2)
    sd = cks[0].step_dir(8)
    manifest = json.loads((sd / ck.MANIFEST_NAME).read_text())
    assert manifest["format"] == jck.MANIFEST_FORMAT
    assert [s["rank"] for s in manifest["shards"]] == [0, 1]
    assert ck.verify_step_dir(sd) == []
    with np.load(sd / "shard-00001.npz") as z:
        assert "leaf:w" not in z.files and "leaf:mom" in z.files


def test_sharded_torn_and_corrupt_steps_fall_back(tmp_path):
    locals_, spec, template, full = _toy(2)
    cks = _ckpts(tmp_path / "ck")
    _save_all(cks, locals_, spec, 1)
    _save_all(cks, locals_, spec, 2)
    cks[1].save(locals_[1], spec, 5, epoch=0, offset=0)      # torn: no seal
    hit = corrupt_latest_shard(tmp_path / "ck", rank=1)       # step 2 lies
    assert hit.name == "shard-00001.npz"
    assert any(p.startswith("corrupt:")
               for p in ck.verify_step_dir(cks[0].step_dir(2)))
    with pytest.raises(ValueError, match="failed verification"):
        cks[0].restore(template, step=2)                      # strict
    assert cks[0].step_dir(2).exists()
    tree, meta = cks[1].restore(template)
    assert meta["step"] == 1
    np.testing.assert_array_equal(tree["mom"], full["mom"])
    q = tmp_path / "ck.quarantine"
    assert sorted(p.name for p in q.iterdir()) == ["step-00000002",
                                                   "step-00000005"]


def test_sharded_commit_timeout_and_hook_phases(tmp_path):
    locals_, spec, _, _ = _toy(5)
    lone = ck.ShardedCheckpoint(tmp_path / "a", rank=0, world_size=2,
                                commit_timeout=0.3, verbose=False)
    assert lone.save(locals_[0], spec, 7, epoch=0, offset=0) is False
    assert lone.latest_sealed_step() is None
    cks = _ckpts(tmp_path / "b")
    seen = {0: [], 1: []}
    for r in (1, 0):
        cks[r].save(locals_[r], spec, 3, epoch=0, offset=0,
                    commit_hook=seen[r].append)
    assert seen == {0: ["claimed", "sealing"], 1: ["claimed"]}


def test_sharded_prune_quarantines_old_torn(tmp_path):
    locals_, spec, _, _ = _toy(7)
    cks = _ckpts(tmp_path / "ck", keep=2)
    _save_all(cks, locals_, spec, 1)
    torn = cks[0].step_dir(2)
    torn.mkdir()
    (torn / "shard-00000.npz").write_bytes(b"debris")
    _save_all(cks, locals_, spec, 3)
    _save_all(cks, locals_, spec, 4)
    assert cks[0].sealed_steps() == [3, 4]
    assert not cks[0].step_dir(1).exists() and not torn.exists()
    assert (tmp_path / "ck.quarantine" / torn.name).is_dir()


def test_reshard_partial_restore_and_strictness(tmp_path):
    """At world 4 the reassembly is the global value (a new world re-slices
    it; ``fold_per_replica`` picks replica 0); each rank's partial restore
    is bitwise its slice of it; a changed world refuses the partial path,
    and a rank that reads a rotten shard fails loud."""
    world = 4
    locals_, spec, template, full = _toy(8, world=world)
    cks = _ckpts(tmp_path / "ck", world=world)
    _save_all(cks, locals_, spec, 5, epoch=2, offset=9)
    tree, _ = cks[0].restore(template)
    assert tree["bn"].shape == (world, 5)
    folded = ck.fold_per_replica(tree, template)
    np.testing.assert_array_equal(folded["bn"], full["bn"][0])
    np.testing.assert_array_equal(folded["mom"], full["mom"])
    for r, c in enumerate(cks):
        part, meta = c.restore_partial(template)
        np.testing.assert_array_equal(part["w"], tree["w"])
        np.testing.assert_array_equal(part["mom"],
                                      tree["mom"][r * 2:(r + 1) * 2])
        np.testing.assert_array_equal(part["bn"], tree["bn"][r:r + 1])
        assert (meta["step"], meta["epoch"], meta["offset"]) == (5, 2, 9)
    grown = ck.ShardedCheckpoint(tmp_path / "ck", rank=0, world_size=5,
                                 verbose=False)
    with pytest.raises(ValueError, match="unchanged world size"):
        grown.restore_partial(template)
    corrupt_latest_shard(tmp_path / "ck", rank=1)
    assert cks[0].restore_partial(template)[1]["step"] == 5
    with pytest.raises(ValueError, match="shard 1"):
        cks[1].restore_partial(template)
    assert cks[1].step_dir(5).exists()
    assert ck.ShardedCheckpoint(tmp_path / "none", rank=0, world_size=4,
                                verbose=False).restore_partial(template) \
        is None


def test_verifier_kv_claims_spec_kinds_and_compression(tmp_path):
    from tpu_sandbox_torch.runtime.kvstore import KVClient, KVServer

    locals_, spec, template, full = _toy(9)
    cks = _ckpts(tmp_path / "ck")
    _save_all(cks, locals_, spec, 1)
    _save_all(cks, locals_, spec, 2)
    v = ck.CheckpointVerifier(cks[0], interval=3600)
    assert v.scan_once() == []
    corrupt_latest_shard(tmp_path / "ck", rank=0)
    assert v.scan_once() == [2] and cks[0].sealed_steps() == [1]
    with KVServer() as server:
        kv = KVClient(port=server.port)
        kcks = _ckpts(tmp_path / "kv", kv=kv, generation=2)
        kcks[1].save(locals_[1], spec, 6, epoch=0, offset=0)
        assert kv.keys("ckpt/g2/6/shard_done/") == ["ckpt/g2/6/shard_done/1"]
        kcks[0].save(locals_[0], spec, 6, epoch=0, offset=0)
        assert kv.keys("ckpt/g2/") == []
        kv.close()
    with pytest.raises(ValueError, match="unknown spec kind"):
        ck.ShardedCheckpoint(tmp_path / "x", rank=0, world_size=1,
                             verbose=False).save(
            {"w": np.zeros(2)}, {"w": "diagonal"}, 0, epoch=0, offset=0)
    big = [{"w": np.zeros((64, 64), np.float32), "mom": lt["mom"],
            "bn": lt["bn"]} for lt in locals_]
    plain = _ckpts(tmp_path / "plain")
    packed = _ckpts(tmp_path / "packed", compress=True)
    _save_all(plain, big, spec, 1)
    _save_all(packed, big, spec, 1)
    sizes = [json.loads((c[0].step_dir(1) / ck.MANIFEST_NAME).read_text())
             ["shards"][0] for c in (plain, packed)]
    assert sizes[1]["compressed"] and sizes[1]["bytes"] < sizes[0]["bytes"]
    assert sizes[1]["raw_bytes"] == sizes[0]["raw_bytes"]
    tree, _ = packed[1].restore({**template, "w": big[0]["w"]})
    np.testing.assert_array_equal(tree["mom"], full["mom"])


# -- the single-device format -----------------------------------------------------

def _tiny(v: float) -> TrainState:
    state = _port_state("sgd")
    state_from_leaves(state, {p: np.full(t.shape, v, np.float32)
                              if t.shape else np.asarray(int(v), np.int32)
                              for p, t in state_template(state).items()})
    return state


def test_single_device_quarantine_fallback_and_strict_step(tmp_path):
    ck.save(tmp_path, _tiny(1.0))
    ck.save(tmp_path, _tiny(2.0))
    (tmp_path / "notes.txt").write_text("stray junk")
    assert ck.latest_step(tmp_path) == 2
    corrupt_step_dir(tmp_path / "step-00000002")
    with pytest.raises(ValueError, match="failed verification"):
        ck.restore(tmp_path, _tiny(0.0), step=2)
    assert not (tmp_path.parent / (tmp_path.name + ".quarantine")).exists()
    state = ck.restore(tmp_path, _tiny(0.0))
    assert state.step == 1
    np.testing.assert_array_equal(
        state.model.fc.kernel.detach().numpy(),
        np.full(tuple(state.model.fc.kernel.shape), 1.0, np.float32))
    assert (tmp_path.parent / (tmp_path.name + ".quarantine")
            / "step-00000002").is_dir()
    assert ck.latest_step(tmp_path) == 1
    corrupt_step_dir(tmp_path / "step-00000001")
    with pytest.raises(FileNotFoundError, match=r"no \*valid\* checkpoints"):
        ck.restore(tmp_path, _tiny(0.0))
    with pytest.raises(FileNotFoundError, match="no checkpoint directory"):
        ck.restore(tmp_path / "absent", _tiny(0.0))


def test_orbax_directory_and_unstamped_steps_are_refused(tmp_path):
    """The JAX package's orbax steps are named by number: the port cannot
    read them, says which format it found, and never treats the directory
    as empty. An unstamped directory holding steps trips the layout
    guard."""
    orbax = tmp_path / "orbax"
    (orbax / "4").mkdir(parents=True)
    (orbax / "LAYOUT").write_text(jck._LAYOUT + "\n")
    for call in (lambda: ck.latest_step(orbax),
                 lambda: ck.restore(orbax, _tiny(0.0)),
                 lambda: ck.save(orbax, _tiny(0.0))):
        with pytest.raises(ValueError, match="orbax step directories"):
            call()
    bare = tmp_path / "bare"
    (bare / "step-00000001").mkdir(parents=True)
    with pytest.raises(ValueError, match="layout mismatch"):
        ck.save(bare, _tiny(0.0))
    (bare / "LAYOUT").write_text("fc-row-order=hwc\n")
    with pytest.raises(ValueError, match="layout mismatch"):
        ck.restore(bare, _tiny(0.0))


def test_quarantine_step_and_data_state_sidecars(tmp_path):
    (tmp_path / "ck" / "step-00000005").mkdir(parents=True)
    first = ck.quarantine_step(tmp_path / "ck", 5)
    assert first is not None and first.exists()
    assert ck.quarantine_step(tmp_path / "ck", 5) is None
    ck.save_data_state(tmp_path, 7, epoch=1, offset=3, extra={"note": "x"})
    assert ck.load_data_state(tmp_path, 7) == jck.load_data_state(tmp_path, 7)
    assert ck.load_data_state(tmp_path, 7) == {"step": 7, "epoch": 1,
                                               "offset": 3, "note": "x"}
    assert ck.load_data_state(tmp_path, 99) is None
    (tmp_path / "data_state-7.json").write_text("{not json")
    assert ck.load_data_state(tmp_path, 7) is None


def test_async_saver_copies_at_the_boundary_and_declines_stale_steps(
        tmp_path):
    """The saver's copy is taken when ``save`` is called: a state changed
    right after is not what lands on disk. A step at or below the newest
    one is declined (the trainer's SKIPPED line)."""
    state = _tiny(1.0)
    saver = ck.AsyncSaver(tmp_path)
    assert saver.save(state, 4)
    state_from_leaves(state, {**state.host_view(),
                              "params/fc/kernel": np.zeros(
                                  tuple(state.model.fc.kernel.shape),
                                  np.float32)})
    saver.close()
    assert saver.save(state, 4) is False and saver.save(state, 3) is False
    saver.close()
    restored = ck.restore(tmp_path, _tiny(0.0))
    assert float(restored.model.fc.kernel.detach()[0, 0]) == 1.0
    assert [s for s, _, _ in saver.timings] == [4]


# -- DataParallel's hooks at one rank ---------------------------------------------

@pytest.fixture()
def one_rank():
    bootstrap.init(device="cpu")
    try:
        yield
    finally:
        bootstrap.cleanup()


def test_data_parallel_checkpoint_hooks(one_rank):
    """``host_view`` puts the per-replica leaves behind an axis of 1,
    ``checkpoint_spec`` marks them and the ZeRO-1 rows "shard0",
    ``checkpoint_template`` adds the residual's slot, and a sharded step
    restores through ``shard_state`` and ``shard_state_local`` bitwise."""
    state = _port_state("adamw")
    template = state_template(state)
    dp = DataParallel(state.model, zero=True, grad_compress="int8")
    state_from_leaves(state, _random_leaves(state, seed=5))
    dp.shard_state(state)
    view = dp.host_view(state)
    assert view["batch_stats/bn1/mean"].shape == (1, 16)
    assert view["grad_residual/fc/kernel"].shape == (1, 2048, 10)
    spec = dp.checkpoint_spec(state)
    assert spec["params/fc/kernel"] == "rep" and spec["step"] == "rep"
    assert spec["opt_state/0/count"] == "rep"
    assert spec["opt_state/0/mu/fc/kernel"] == "shard0"   # ZeRO-1 at 1 rank
    assert spec["batch_stats/bn2/var"] == "shard0"
    full = dp.checkpoint_template(template)
    assert full["grad_residual/conv1/kernel"].shape == (5, 5, 1, 16)
    before = state.host_view()
    unshard = dp.unshard_state(state)
    assert not any(p.startswith("grad_residual/") for p in unshard)
    _assert_bitwise(unshard, {p: v for p, v in before.items()
                              if not p.startswith("grad_residual/")})


def test_data_parallel_sharded_restore_paths(one_rank, tmp_path):
    state = _port_state("momentum")
    template = state_template(state)
    dp = DataParallel(state.model, zero=True, grad_compress="int8")
    dp.shard_state(state)
    leaves = _random_leaves(state, seed=6)
    state_from_leaves(state, leaves)
    want = state.host_view()
    sc = ck.ShardedCheckpoint(tmp_path / "ck", rank=0, world_size=1,
                              verbose=False)
    assert sc.save(dp.host_view(state), dp.checkpoint_spec(state), 3,
                   epoch=0, offset=3)
    full = dp.checkpoint_template(template)
    for how in ("full", "partial"):
        fresh = _port_state("momentum")
        fdp = DataParallel(fresh.model, zero=True, grad_compress="int8")
        fdp.shard_state(fresh)
        if how == "full":
            host, meta = sc.restore(full)
            fdp.shard_state(fresh, host, stats_expanded=True)
        else:
            local, meta = sc.restore_partial(full)
            fdp.shard_state_local(fresh, local, full)
        assert meta["offset"] == 3
        _assert_bitwise(fresh.host_view(), want)
        # the optimizer steps ZeRO-1's blocks: they hold the restored rows
        for p, rows, u in zip(fdp.params, fdp.rows, fdp.updates):
            if rows is not None:
                assert torch.equal(u.detach(), p.detach()[rows])


def test_trainer_saves_every_n_steps_and_skips_stale_steps(tmp_path, capsys):
    """``Trainer(ckpt_every=2)`` saves at steps 2 and 4 of its own count;
    into a directory that already holds a later step it prints JAX's
    "checkpoint SKIPPED" line and saves nothing."""
    from tpu_sandbox_torch.train import Trainer

    state = _tiny(1.0)
    state.step = 0
    batches = [(np.zeros((1, 28, 28, 1), np.float32), np.zeros(1, np.int32))
               for _ in range(4)]
    trainer = Trainer(lambda x, y: torch.zeros(()), torch.device("cpu"),
                      log_every=100, ckpt_dir=str(tmp_path / "a"),
                      ckpt_every=2)
    trainer.fit(state, batches, 1)
    assert ck.latest_step(tmp_path / "a") == 4
    assert [s for s, _, _ in trainer.ckpt_timings] == [2, 4]
    out = capsys.readouterr().out
    assert "checkpoint saved at step 2" in out
    ck.save(tmp_path / "b", state, step=9)
    Trainer(lambda x, y: torch.zeros(()), torch.device("cpu"),
            log_every=100, ckpt_dir=str(tmp_path / "b"),
            ckpt_every=2).fit(state, batches, 1)
    assert "checkpoint SKIPPED at step 2" in capsys.readouterr().out
    assert ck._single(Path(tmp_path / "b")).sealed_steps() == [9]
