"""Checkpoint and resume: the port of ``tpu_sandbox/train/checkpoint.py``.

Every format here is numpy's npz, so a step written by either package
restores in the other: a state is the flat ``{path: array}`` that JAX's
``_flatten_with_paths`` makes of a ``TrainState.host_view()`` (``step``,
``params/conv1/kernel``, ``batch_stats/bn1/mean``, ``opt_state/0/...``,
``grad_residual/...``), which ``utils/bridge.py`` maps to and from the
port's ``TrainState``.

- ``save`` / ``restore`` / ``latest_step``: the single-device format. The
  JAX package writes orbax there, which needs jax; the port writes a
  sealed one-rank ``ShardedCheckpoint`` step (``step-XXXXXXXX/`` with its
  manifest, as ``export_params`` writes) beside the ``LAYOUT`` stamp,
  keeping the newest three, which JAX's ``ShardedCheckpoint(...,
  world_size=1).restore`` reads. A directory of orbax's numeric step
  directories is refused with an error naming the format; it never starts
  a fresh run.
- ``AsyncSaver``: the trainer's periodic saver. The state is updated in
  place by the next step, so the saver copies it to the host at the step
  boundary; only the npz write and the SHA-256 run in its thread.
- ``HostCheckpoint`` (rank 0's npz with a SHA-256 sidecar),
  ``ShardedCheckpoint`` (every rank's shard, sealed by rank 0's manifest
  in a two-phase commit over the KV store, or by polling the filesystem
  with ``kv=None``), ``CheckpointVerifier``, ``export_params`` and
  ``load_exported_params``: copies of JAX's, on numpy trees.

A tree is a nested dict (keys sorted, as JAX flattens a dict), list or
tuple of leaves; a flat dict whose keys are the paths is the same tree.
A leaf is a numpy array or a torch tensor: bf16 leaves are stored widened
to fp32 with their dtype name, as JAX's ``_to_savable`` stores its
ml_dtypes, and come back as CPU ``torch.bfloat16`` tensors. A restore
template's leaves need only a ``shape`` (``ShapeDtype``).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import tempfile
import threading
import time
import zipfile
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from tpu_sandbox_torch.runtime.staging import read_npy_header, stream_load_npz

#: Parameter-layout generation stamped into every checkpoint directory.
#: "hcw" = the canonical (h, c, w) fc row order, which the port keeps.
#: Checkpoints written before the stamp existed hold fc rows in (h, w, c)
#: order — same shapes, silently permuted values — so restore refuses them
#: loudly instead of resuming into garbage logits.
_LAYOUT = "fc-row-order=hcw"
_LAYOUT_FILE = "LAYOUT"

#: the single-device format keeps this many sealed steps (orbax's
#: ``max_to_keep`` in the JAX package)
KEEP = 3


class ShapeDtype(NamedTuple):
    """A template leaf without data (``jax.ShapeDtypeStruct``'s role)."""

    shape: tuple
    dtype: object = None


def _shape(leaf) -> tuple:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else np.shape(leaf)


# -- trees ------------------------------------------------------------------

def _is_node(x) -> bool:
    return isinstance(x, (dict, list, tuple)) and not isinstance(
        x, ShapeDtype)


def _flatten_with_paths(tree):
    """``([(path, leaf), ...], unflatten)``: dict keys sorted and joined
    with '/', list and tuple items by index, ``None`` an empty node — the
    paths and order of JAX's ``_flatten_with_paths``."""
    out: list = []

    def walk(node, prefix):
        if node is None:
            return
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{prefix}/{k}" if prefix else str(k))
        elif _is_node(node):
            for i, v in enumerate(node):
                walk(v, f"{prefix}/{i}" if prefix else str(i))
        else:
            out.append((prefix, node))

    walk(tree, "")

    def unflatten(leaves):
        it = iter(leaves)

        def build(node):
            if node is None:
                return None
            if isinstance(node, dict):
                return {k: build(node[k]) for k in sorted(node)}
            if _is_node(node):
                return type(node)(build(v) for v in node)
            return next(it)

        return build(tree)

    return out, unflatten


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of ``tree`` (and the same-shaped ``rest``)."""
    leaves, unflatten = _flatten_with_paths(tree)
    others = [dict(_flatten_with_paths(r)[0]) for r in rest]
    return unflatten([fn(leaf, *(o[p] for o in others))
                      for p, leaf in leaves])


def _to_savable(leaf) -> tuple[np.ndarray, str | None]:
    """npz holds no bf16: store it widened to float32 and remember the
    dtype name (exact: every bf16 value is an fp32 value)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        if t.dtype == torch.bfloat16:
            return t.to("cpu", torch.float32).numpy(), "bfloat16"
        return t.to("cpu").numpy(), None
    arr = np.asarray(leaf)
    if arr.dtype.kind == "V":                  # an ml_dtypes array
        return arr.astype(np.float32), arr.dtype.name
    return arr, None


def _from_savable(arr: np.ndarray, dtype_name: str | None):
    if dtype_name is None:
        return arr
    if dtype_name != "bfloat16":
        raise ValueError(f"leaf dtype {dtype_name!r} has no torch "
                         "counterpart here")
    return torch.from_numpy(np.ascontiguousarray(arr)).to(torch.bfloat16)


def _write_atomic(directory: Path, final: Path, suffix: str, write) -> None:
    """``write(file)`` into a temporary file of ``directory`` renamed onto
    ``final``: a kill mid-write never leaves half a file."""
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=suffix)
    try:
        with os.fdopen(fd, "wb") as f:
            write(f)
        os.replace(tmp, final)
    except BaseException:
        Path(tmp).unlink(missing_ok=True)
        raise


# -- the layout stamp -------------------------------------------------------

def _has_steps(directory: Path) -> bool:
    """Any pre-existing checkpoint content present? Any child directory
    counts; plain files (.gitkeep and friends) don't trip the guard."""
    return directory.is_dir() and any(
        p.is_dir() for p in directory.iterdir()
    )


def _layout_error(directory: Path, found: str) -> ValueError:
    return ValueError(
        f"checkpoint layout mismatch under {directory}: expected "
        f"'{_LAYOUT}', found '{found}'. The directory contains "
        "subdirectories but no layout stamp — either pre-canonical "
        "checkpoints (saved before the (h, c, w) fc row order: same "
        "shapes, silently permuted rows — restoring would corrupt the "
        "model; re-save from the original code or re-permute fc/kernel "
        "rows (h,w,c)->(h,c,w)) or unrecognized subdirectories this "
        "guard conservatively refuses to stamp over (point `directory` "
        "at a dedicated checkpoint dir)."
    )


def _stamp_layout(directory: Path) -> None:
    f = directory / _LAYOUT_FILE
    if f.exists():
        _check_layout(directory)
    elif _has_steps(directory):
        raise _layout_error(directory, "<missing, with existing steps>")
    else:
        directory.mkdir(parents=True, exist_ok=True)
        f.write_text(_LAYOUT + "\n")


def _check_layout(directory: Path) -> None:
    f = directory / _LAYOUT_FILE
    if not f.exists():
        if _has_steps(directory):
            raise _layout_error(directory, "<missing>")
        return
    found = f.read_text().strip()
    if found != _LAYOUT:
        raise _layout_error(directory, found)


def _refuse_orbax(directory: Path) -> None:
    """A directory holding orbax's numeric step directories is the JAX
    package's single-device format, which needs orbax to read."""
    if not directory.is_dir():
        return
    steps = sorted(int(p.name) for p in directory.iterdir()
                   if p.is_dir() and p.name.isdigit())
    if steps:
        raise ValueError(
            f"{directory} holds orbax step directories {steps} (the JAX "
            "package's single-device checkpoint format, written by orbax); "
            "the port reads npz formats only: its own sealed step-XXXXXXXX "
            "directories, HostCheckpoint's step-*.npz and ShardedCheckpoint "
            "steps. Re-save from JAX with ShardedCheckpoint(world_size=1) or "
            "export_params, or pass a fresh --ckpt-dir")


# -- the single-device format -----------------------------------------------

def _single(directory: Path) -> "ShardedCheckpoint":
    return ShardedCheckpoint(directory, rank=0, world_size=1, keep=KEEP,
                             verbose=False)


def _leaves_of(state) -> dict:
    """A ``TrainState``'s host view, or a flat leaves dict as it is."""
    return state if isinstance(state, dict) else state.host_view()


def save(directory: str | os.PathLike, state, step: int | None = None) -> int:
    """Write a checkpoint of ``state`` (a ``TrainState`` or the flat leaves
    of one, e.g. ``DataParallel.unshard_state``); returns its step."""
    d = Path(directory).absolute()
    _refuse_orbax(d)
    _stamp_layout(d)
    leaves = _leaves_of(state)
    step = int(np.asarray(leaves["step"])) if step is None else int(step)
    ok = _single(d).save(leaves, {p: "rep" for p in leaves}, step,
                         epoch=0, offset=0)
    if not ok:
        raise RuntimeError(f"checkpoint of step {step} under {d} did not "
                           "seal")
    return step


def latest_step(directory: str | os.PathLike) -> int | None:
    """The newest sealed step, or None (no directory or no step)."""
    d = Path(directory).absolute()
    _refuse_orbax(d)
    return _single(d).latest_sealed_step()


def restore(directory: str | os.PathLike, state, step: int | None = None):
    """Load the newest *valid* step (or ``step``, strictly) into the
    ``TrainState`` in place and return it. Without ``step`` a torn or
    corrupt step is quarantined to ``<directory>.quarantine/`` and the next
    older one is tried, as JAX's restore does."""
    from tpu_sandbox_torch.utils.bridge import state_from_leaves, state_template

    d = Path(directory).absolute()
    if not d.is_dir():
        raise FileNotFoundError(f"no checkpoint directory at {directory}")
    _refuse_orbax(d)
    _check_layout(d)
    ck = _single(d)
    had = ck.steps_on_disk()
    if not had:
        raise FileNotFoundError(f"no checkpoints under {directory}")
    res = ck.restore(state_template(state), step=step)
    if res is None:
        raise FileNotFoundError(
            f"no *valid* checkpoints under {directory} (all steps "
            "quarantined)")
    state_from_leaves(state, res[0])
    return state


def quarantine_step(directory: str | os.PathLike, step: int) -> Path | None:
    """Move a broken step directory into ``<directory>.quarantine/`` (next
    to, never inside, the checkpoint dir). Concurrent quarantiners race
    benignly: the first rename wins, the rest get None."""
    src = Path(directory).absolute() / _step_dir_name(step)
    qdir = src.parent.with_name(src.parent.name + ".quarantine")
    qdir.mkdir(parents=True, exist_ok=True)
    dst = qdir / src.name
    n = 0
    while dst.exists():
        n += 1
        dst = qdir / f"{src.name}.{n}"
    try:
        os.replace(src, dst)
    except OSError:
        return None
    print(f"checkpoint step {step} is broken; quarantined to {dst}",
          flush=True)
    return dst


# -- data-order sidecars ------------------------------------------------------

def save_data_state(
    directory: str | os.PathLike, step: int, *, epoch: int, offset: int,
    extra: dict | None = None,
) -> Path:
    d = Path(directory).absolute()
    d.mkdir(parents=True, exist_ok=True)
    payload = {"step": int(step), "epoch": int(epoch), "offset": int(offset)}
    payload.update(extra or {})
    final = d / f"data_state-{int(step)}.json"
    _write_atomic(d, final, ".json.tmp",
                  lambda f: f.write(json.dumps(payload).encode()))
    return final


def load_data_state(directory: str | os.PathLike, step: int) -> dict | None:
    f = Path(directory).absolute() / f"data_state-{int(step)}.json"
    if not f.exists():
        return None
    try:
        return json.loads(f.read_text())
    except (OSError, json.JSONDecodeError):
        return None  # sidecar corrupt: caller derives order from the step


class AsyncSaver:
    """The trainer's periodic saver in the single-device format. ``save``
    copies the state to the host at the step boundary (before the next
    update writes over it) and hands the write and its hash to a
    background thread; one write is in flight at a time. ``close()`` waits
    for it and re-raises its error. ``timings`` holds each save's
    ``(step, copy seconds, write seconds)``."""

    def __init__(self, directory: str | os.PathLike, max_to_keep: int = KEEP):
        self.directory = Path(directory).absolute()
        _refuse_orbax(self.directory)
        _stamp_layout(self.directory)
        self._ck = ShardedCheckpoint(self.directory, rank=0, world_size=1,
                                     keep=max_to_keep, verbose=False)
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None
        self.timings: list[tuple[int, float, float]] = []

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err

    def save(self, state, step: int) -> bool:
        """False when the directory already holds a step >= ``step`` (a
        stale directory of an earlier run), as orbax declines it."""
        self.wait()
        latest = self._ck.latest_sealed_step()
        if latest is not None and latest >= step:
            return False
        t0 = time.perf_counter()
        leaves = _leaves_of(state)
        copy_s = time.perf_counter() - t0

        def write():
            t1 = time.perf_counter()
            try:
                if not self._ck.save(leaves, {p: "rep" for p in leaves},
                                     step, epoch=0, offset=0):
                    raise RuntimeError(f"checkpoint of step {step} did not "
                                       "seal")
            except BaseException as e:  # re-raised by wait()
                self._error = e
            self.timings.append((step, copy_s, time.perf_counter() - t1))

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()
        return True

    def close(self) -> None:
        self.wait()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# -- HostCheckpoint: coordination-free save/restore for elastic runs ---------

class HostCheckpoint:
    """Single-writer numpy checkpointing for multi-process runs: rank 0
    writes its host view of the state (the parameters, its own BN
    statistics) as one ``step-<n>.npz`` with an atomic rename and a
    SHA-256 sidecar (``step-<n>.npz.sha256``), and every rank restores by
    reading that file — no cross-process coordination on the path.

    Restore re-hashes the npz against its sidecar before parsing; files
    failing either check are renamed to ``*.corrupt`` (sidecar moved along)
    and the next older step is used. Files without a sidecar still restore
    when they parse."""

    def __init__(self, directory: str | os.PathLike, *, keep: int = 3):
        self.directory = Path(directory).absolute()
        self.keep = keep

    def _path(self, step: int) -> Path:
        return self.directory / f"step-{int(step):08d}.npz"

    def _sidecar(self, step: int) -> Path:
        return self.directory / f"step-{int(step):08d}.npz.sha256"

    def steps(self) -> list[int]:
        if not self.directory.is_dir():
            return []
        out = []
        for p in self.directory.glob("step-*.npz"):
            try:
                out.append(int(p.stem.split("-", 1)[1]))
            except ValueError:
                continue
        return sorted(out)

    def latest_step(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def save(self, local_state, step: int, *, epoch: int, offset: int,
             extra: dict | None = None) -> Path:
        """``local_state``: a host view (``TrainState.host_view``, or any
        tree). Atomic: concurrent readers only ever see complete files."""
        self.directory.mkdir(parents=True, exist_ok=True)
        leaves, _ = _flatten_with_paths(local_state)
        arrays: dict[str, np.ndarray] = {}
        dtypes: dict[str, str] = {}
        for path, leaf in leaves:
            arr, orig = _to_savable(leaf)
            arrays[f"leaf:{path}"] = arr
            if orig is not None:
                dtypes[path] = orig
        meta = {"step": int(step), "epoch": int(epoch),
                "offset": int(offset), "dtypes": dtypes}
        meta.update(extra or {})
        arrays["__meta__"] = np.array(json.dumps(meta))
        _write_atomic(self.directory, self._path(step), ".npz.tmp",
                      lambda f: np.savez(f, **arrays))
        # the sidecar lands AFTER the npz: a crash between the two renames
        # leaves an unverified checkpoint, never a sidecar without bytes
        digest = _sha256_file(self._path(step))
        _write_atomic(self.directory, self._sidecar(step), ".sha256.tmp",
                      lambda f: f.write(
                          f"{digest}  {self._path(step).name}\n".encode()))
        self._prune()
        return self._path(step)

    def _prune(self) -> None:
        for s in self.steps()[: -self.keep]:
            try:
                self._path(s).unlink()
            except OSError:
                pass
            self._sidecar(s).unlink(missing_ok=True)
            (self.directory / f"data_state-{s}.json").unlink(missing_ok=True)

    def _load(self, step: int, template):
        problem = verify_npz_sidecar(self._path(step))
        if problem is not None:
            raise ValueError(problem)
        z = stream_load_npz(self._path(step))
        meta = json.loads(str(z["__meta__"]))
        leaves, unflatten = _flatten_with_paths(template)
        restored = []
        for path, leaf in leaves:
            key = f"leaf:{path}"
            if key not in z:
                raise KeyError(f"checkpoint misses leaf {path!r}")
            arr = _from_savable(z[key], meta["dtypes"].get(path))
            want = _shape(leaf)
            if tuple(arr.shape) != tuple(want):
                raise ValueError(
                    f"leaf {path!r}: checkpoint shape {tuple(arr.shape)} != "
                    f"template shape {want}"
                )
            restored.append(arr)
        return unflatten(restored), meta

    def restore(self, template, step: int | None = None):
        """-> (tree, meta) from the newest *valid* step; ``None`` when the
        directory holds nothing restorable (fresh start). Broken files are
        renamed aside, never deleted — they are evidence."""
        if step is not None:
            return self._load(step, template)
        for s in reversed(self.steps()):
            try:
                return self._load(s, template)
            except Exception as e:
                bad = self._path(s)
                try:
                    os.replace(bad, bad.with_suffix(".npz.corrupt"))
                    print(
                        f"host checkpoint step {s} unreadable ({e!r}); "
                        f"quarantined to {bad.with_suffix('.npz.corrupt')}",
                        flush=True,
                    )
                except OSError:
                    pass  # concurrent restorer won the rename race
                else:
                    side = self._sidecar(s)
                    if side.exists():
                        try:
                            os.replace(side, Path(str(side) + ".corrupt"))
                        except OSError:
                            pass
        return None


def verify_npz_sidecar(path: Path | str) -> str | None:
    """Re-hash ``path`` against its ``.sha256`` sidecar: a problem string
    on mismatch (or an unparseable sidecar), ``None`` when the hash
    matches or no sidecar exists."""
    path = Path(path)
    side = Path(str(path) + ".sha256")
    if not side.exists():
        return None
    try:
        recorded = side.read_text().split()[0]
    except (OSError, IndexError):
        return f"sidecar {side.name} unreadable or empty"
    if len(recorded) != 64 or not all(c in "0123456789abcdef"
                                      for c in recorded.lower()):
        return f"sidecar {side.name} does not contain a sha256 digest"
    actual = _sha256_file(path)
    if actual != recorded:
        return (f"{path.name}: sha256 mismatch — sidecar records "
                f"{recorded[:12]}…, file hashes to {actual[:12]}…")
    return None


# -- ShardedCheckpoint: per-rank shards + manifest + two-phase commit --------
#
#   <dir>/step-00000008/shard-00000.npz   rank 0's leaves
#   <dir>/step-00000008/shard-00001.npz   rank 1's leaves
#   <dir>/step-00000008/MANIFEST.json     the seal (written LAST, atomically)
#   <dir>.quarantine/step-.../            torn/corrupt steps, moved aside
#
# Commit is two-phase over the KV store and timeout-bounded (never a
# barrier, which would wedge on a dead rank):
#   phase 1: every rank writes its shard (tmp+rename), hashes it, and
#            claims ``ckpt/g<gen>/<step>/shard_done/<rank>`` with the hash.
#   phase 2: rank 0 publishes MANIFEST.json (shard list + SHA-256s + data-
#            order meta) only once all claims landed — or gives up at the
#            deadline, leaving the step unsealed.
# A kill at any instant leaves a sealed step or a torn one (no manifest);
# torn steps are quarantined, never restored from and never pruned into.

MANIFEST_NAME = "MANIFEST.json"
MANIFEST_FORMAT = "tpu-sandbox-sharded-ckpt-v1"

#: Leaf placement kinds recorded in the manifest's spec:
#:   "rep"    — replicated; stored once, in rank 0's shard.
#:   "shard0" — sharded on dim 0; each rank stores its block, restore
#:              concatenates blocks in rank order.
SPEC_KINDS = ("rep", "shard0")


def _sha256_file(path: Path) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


def _npz_raw_bytes(path: Path) -> int | None:
    """Uncompressed payload size of an npz from its members' headers; None
    if any header is unreadable."""
    try:
        total = 0
        with zipfile.ZipFile(path) as z:
            for name in z.namelist():
                with z.open(name) as f:
                    shape, _, dtype = read_npy_header(f)
                    total += int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        return total
    except Exception:
        return None


def _step_dir_name(step: int) -> str:
    return f"step-{int(step):08d}"


def _parse_step_dir(p: Path) -> int | None:
    if not p.is_dir() or not p.name.startswith("step-"):
        return None
    tail = p.name.split("-", 1)[1]
    return int(tail) if tail.isdigit() else None


def verify_step_dir(step_dir: str | os.PathLike) -> list[str]:
    """Integrity report for one sharded step directory: ``[]`` means sealed
    and every shard re-hashes to its manifest entry. Problems are prefixed
    ``torn:`` (commit never completed) or ``corrupt:`` (sealed but the
    bytes changed)."""
    sd = Path(step_dir)
    mf = sd / MANIFEST_NAME
    if not mf.exists():
        return ["torn: no manifest (commit never completed)"]
    try:
        manifest = json.loads(mf.read_text())
    except (OSError, ValueError) as e:    # ValueError: not UTF-8, not JSON
        return [f"corrupt: manifest unreadable ({e})"]
    if manifest.get("format") != MANIFEST_FORMAT:
        return [f"corrupt: unknown manifest format {manifest.get('format')!r}"]
    problems = []
    for sh in manifest.get("shards", []):
        f = sd / sh["file"]
        if not f.exists():
            problems.append(f"corrupt: shard {sh['rank']} missing ({sh['file']})")
            continue
        size = f.stat().st_size
        if size != sh["bytes"]:
            problems.append(
                f"corrupt: shard {sh['rank']} is {size} bytes, "
                f"manifest says {sh['bytes']}"
            )
            continue
        digest = _sha256_file(f)
        if digest != sh["sha256"]:
            problems.append(
                f"corrupt: shard {sh['rank']} sha256 {digest[:12]}... != "
                f"manifest {sh['sha256'][:12]}..."
            )
    return problems


def _manifest_meta(manifest: dict) -> dict:
    meta = {k: manifest[k] for k in ("step", "epoch", "offset",
                                     "world_size")}
    for k, v in manifest.items():
        if k not in ("format", "shards", "spec", *meta):
            meta[k] = v
    return meta


def _shard_leaves(f: Path) -> tuple[dict, dict]:
    z = stream_load_npz(f)
    meta = json.loads(str(z["__meta__"]))
    return ({k[len("leaf:"):]: z[k] for k in z if k.startswith("leaf:")},
            meta.get("dtypes", {}))


class ShardedCheckpoint:
    """Every rank persists its own leaves; rank 0 seals the step.

    ``local_tree`` passed to :meth:`save` is this rank's host view of the
    state (full value for replicated leaves, this rank's block for sharded
    ones); ``spec_tree`` mirrors it with "rep" / "shard0" kinds
    (``DataParallel.checkpoint_spec``). Restore reassembles (concatenating
    shard0 blocks in rank order, which also reshards across a world-size
    change) after verifying every shard's SHA-256 against the manifest.

    ``kv=None`` degrades phase 1 to filesystem polling (rank 0 waits for
    all shard files and hashes them itself). ``compress=True`` writes
    zlib-deflated shards; the SHA-256 is over the bytes on disk.
    """

    def __init__(
        self,
        directory: str | os.PathLike,
        *,
        rank: int,
        world_size: int,
        kv=None,
        keep: int = 3,
        commit_timeout: float = 60.0,
        poll: float = 0.02,
        generation: int | str | None = None,
        verbose: bool = True,
        compress: bool = False,
    ):
        if not 0 <= rank < world_size:
            raise ValueError(f"rank {rank} outside world of {world_size}")
        self.directory = Path(directory).absolute()
        self.rank = rank
        self.world_size = world_size
        self.kv = kv
        self.keep = keep
        self.commit_timeout = commit_timeout
        self.poll = poll
        self.generation = str(generation) if generation is not None else "0"
        self.verbose = verbose
        self.compress = compress

    # -- paths / keys ------------------------------------------------------

    def step_dir(self, step: int) -> Path:
        return self.directory / _step_dir_name(step)

    def _shard_name(self, rank: int) -> str:
        return f"shard-{rank:05d}.npz"

    def _claim_key(self, step: int, rank: int) -> str:
        # generation-scoped: a relaunched generation re-reaching this step
        # must gather FRESH claims, not its dead predecessor's
        return f"ckpt/g{self.generation}/{int(step)}/shard_done/{rank}"

    def _log(self, msg: str) -> None:
        if self.verbose:
            print(f"[sharded-ckpt r{self.rank}] {msg}", flush=True)

    # -- step discovery ----------------------------------------------------

    def steps_on_disk(self) -> list[int]:
        if not self.directory.is_dir():
            return []
        out = []
        for p in self.directory.iterdir():
            s = _parse_step_dir(p)
            if s is not None:
                out.append(s)
        return sorted(out)

    def sealed_steps(self) -> list[int]:
        return [
            s for s in self.steps_on_disk()
            if (self.step_dir(s) / MANIFEST_NAME).exists()
        ]

    def latest_sealed_step(self) -> int | None:
        s = self.sealed_steps()
        return s[-1] if s else None

    # -- save (two-phase commit) -------------------------------------------

    def save(
        self,
        local_tree,
        spec_tree,
        step: int,
        *,
        epoch: int,
        offset: int,
        extra: dict | None = None,
        commit_hook=None,
    ) -> bool:
        """Phase 1 on every rank, phase 2 (the seal) on rank 0 only.

        Returns True when this rank's part of the commit completed (rank 0:
        the manifest is sealed; others: shard written and claimed).
        ``commit_hook(phase)`` is the fault-injection window: called with
        "claimed" after this rank's claim, and on rank 0 with "sealing"
        after all claims landed, before the manifest rename."""
        sd = self.step_dir(step)
        sd.mkdir(parents=True, exist_ok=True)
        leaves, _ = _flatten_with_paths(local_tree)
        kinds = dict(_flatten_with_paths(spec_tree)[0])
        arrays: dict[str, np.ndarray] = {}
        dtypes: dict[str, str] = {}
        for path, leaf in leaves:
            kind = kinds[path]
            if kind not in SPEC_KINDS:
                raise ValueError(f"leaf {path!r}: unknown spec kind {kind!r}")
            if kind == "rep" and self.rank != 0:
                continue  # replicated leaves are stored once, by rank 0
            arr, orig = _to_savable(leaf)
            arrays[f"leaf:{path}"] = arr
            if orig is not None:
                dtypes[path] = orig
        arrays["__meta__"] = np.array(json.dumps(
            {"rank": self.rank, "step": int(step), "dtypes": dtypes}
        ))
        final = sd / self._shard_name(self.rank)
        saver = np.savez_compressed if self.compress else np.savez
        _write_atomic(sd, final, ".npz.tmp", lambda f: saver(f, **arrays))
        claim = {
            "rank": self.rank,
            "file": final.name,
            "sha256": _sha256_file(final),
            "bytes": final.stat().st_size,
            "raw_bytes": int(sum(a.nbytes for a in arrays.values())),
            "compressed": bool(self.compress),
        }
        if self.kv is not None:
            self.kv.set_ttl(
                self._claim_key(step, self.rank), json.dumps(claim),
                ttl=max(4 * self.commit_timeout, 60.0),
            )
        if commit_hook is not None:
            commit_hook("claimed")
        if self.rank != 0:
            return True
        shards = self._await_claims(step, own_claim=claim)
        if shards is None:
            self._log(
                f"step {step}: commit deadline ({self.commit_timeout}s) "
                "passed with shard claims missing; leaving the step "
                "UNSEALED (previous sealed step remains the restore point)"
            )
            return False
        if commit_hook is not None:
            commit_hook("sealing")
        manifest = {
            "format": MANIFEST_FORMAT,
            "step": int(step),
            "epoch": int(epoch),
            "offset": int(offset),
            "world_size": self.world_size,
            "shards": shards,
            "spec": {p: k for p, k in kinds.items()},
        }
        manifest.update(extra or {})
        _write_atomic(sd, sd / MANIFEST_NAME, ".json.tmp",  # THE seal
                      lambda f: f.write(json.dumps(manifest,
                                                   indent=1).encode()))
        if self.kv is not None:
            try:
                self.kv.delete_prefix(f"ckpt/g{self.generation}/{int(step)}/")
            except Exception:
                pass  # TTL reaps them anyway
        self._prune()
        return True

    def _await_claims(self, step: int, own_claim: dict) -> list[dict] | None:
        """Rank 0's phase-2 wait: all ranks' claims, or None at the
        deadline. KV-less mode polls the filesystem and hashes the shard
        files itself once they are all renamed into place."""
        deadline = time.monotonic() + self.commit_timeout
        claims: dict[int, dict] = {0: own_claim}
        while True:
            for r in range(1, self.world_size):
                if r in claims:
                    continue
                if self.kv is not None:
                    raw = self.kv.try_get(self._claim_key(step, r))
                    if raw is not None:
                        claims[r] = json.loads(raw)
                else:
                    f = self.step_dir(step) / self._shard_name(r)
                    if f.exists():
                        claims[r] = {
                            "rank": r,
                            "file": f.name,
                            "sha256": _sha256_file(f),
                            "bytes": f.stat().st_size,
                            "raw_bytes": _npz_raw_bytes(f),
                            "compressed": bool(self.compress),
                        }
            if len(claims) == self.world_size:
                return [claims[r] for r in range(self.world_size)]
            if time.monotonic() >= deadline:
                return None
            time.sleep(self.poll)

    # -- restore -----------------------------------------------------------

    def restore(self, template, step: int | None = None):
        """-> (tree, meta) from the newest step that is sealed AND passes
        checksum verification; ``None`` when nothing restorable exists.
        Torn and corrupt steps are quarantined and the next older step is
        tried. An explicit ``step`` is strict: fail loud, quarantine
        nothing."""
        if step is not None:
            problems = verify_step_dir(self.step_dir(step))
            if problems:
                raise ValueError(
                    f"step {step} failed verification: {problems}"
                )
            return self._load(step, template)
        for s in reversed(self.steps_on_disk()):
            problems = verify_step_dir(self.step_dir(s))
            if problems:
                self._quarantine(s, "; ".join(problems))
                continue
            try:
                return self._load(s, template)
            except Exception as e:  # shapes/leaves wrong despite good hashes
                self._quarantine(s, repr(e))
        return None

    def _load(self, step: int, template):
        sd = self.step_dir(step)
        manifest = json.loads((sd / MANIFEST_NAME).read_text())
        spec: dict = manifest["spec"]
        shard_data: list[dict] = []
        shard_dtypes: list[dict] = []
        for sh in sorted(manifest["shards"], key=lambda s: s["rank"]):
            data, dtypes = _shard_leaves(sd / sh["file"])
            shard_data.append(data)
            shard_dtypes.append(dtypes)
        leaves, unflatten = _flatten_with_paths(template)
        restored = []
        for path, tleaf in leaves:
            kind = spec.get(path)
            if kind is None:
                raise KeyError(f"manifest misses leaf {path!r}")
            want = _shape(tleaf)
            if kind == "rep":
                if path not in shard_data[0]:
                    raise KeyError(f"rank-0 shard misses leaf {path!r}")
                arr = _from_savable(
                    shard_data[0][path], shard_dtypes[0].get(path)
                )
                if tuple(arr.shape) != want:
                    raise ValueError(
                        f"leaf {path!r}: checkpoint shape "
                        f"{tuple(arr.shape)} != template shape {want}"
                    )
            else:  # shard0: concatenate rank blocks -> the full global value
                blocks = []
                for r, data in enumerate(shard_data):
                    if path not in data:
                        raise KeyError(f"rank-{r} shard misses leaf {path!r}")
                    blocks.append(np.asarray(
                        _from_savable(data[path], None)))
                arr = _from_savable(np.concatenate(blocks, axis=0),
                                    shard_dtypes[0].get(path))
                # exact match: a ZeRO'd optimizer leaf (global shape is
                # world-independent). (W, *want): a per-replica leaf (BN
                # stats), kept expanded; fold_per_replica picks a replica.
                shape = tuple(arr.shape)
                if shape != want and shape[1:] != want:
                    raise ValueError(
                        f"leaf {path!r}: reassembled shape {shape} matches "
                        f"neither template {want} nor (world, *{want})"
                    )
            restored.append(arr)
        return unflatten(restored), _manifest_meta(manifest)

    def restore_partial(self, template, step: int | None = None):
        """-> (tree, meta) reading only this rank's slice of the step: rank
        0's shard (replicated leaves) plus this rank's own (sharded leaves
        hold the rank's saved block). Requires the manifest's
        ``world_size`` to equal this instance's (``ValueError`` otherwise:
        a changed world needs :meth:`restore`, which reshards). Strict: any
        problem raises and nothing is quarantined. ``step=None`` picks the
        latest sealed step (``None`` when there is none). Checksums are
        verified for exactly the shards read."""
        if step is None:
            step = self.latest_sealed_step()
            if step is None:
                return None
        sd = self.step_dir(step)
        mf = sd / MANIFEST_NAME
        if not mf.exists():
            raise ValueError(f"step {step} is not sealed (no manifest)")
        manifest = json.loads(mf.read_text())
        if manifest.get("format") != MANIFEST_FORMAT:
            raise ValueError(
                f"unknown manifest format {manifest.get('format')!r}"
            )
        if int(manifest["world_size"]) != self.world_size:
            raise ValueError(
                f"partial restore needs an unchanged world size: step "
                f"{step} was written by {manifest['world_size']} ranks, "
                f"this rank is {self.rank} of {self.world_size} — use "
                "restore(), whose full reassembly is what reshards"
            )
        by_rank = {sh["rank"]: sh for sh in manifest["shards"]}
        shard_data: dict[int, dict] = {}
        shard_dtypes: dict[int, dict] = {}
        for r in sorted({0, self.rank}):
            sh = by_rank.get(r)
            if sh is None:
                raise ValueError(f"manifest misses shard for rank {r}")
            f = sd / sh["file"]
            if not f.exists():
                raise ValueError(f"shard {r} missing ({sh['file']})")
            size = f.stat().st_size
            if size != sh["bytes"]:
                raise ValueError(
                    f"shard {r} is {size} bytes, manifest says {sh['bytes']}"
                )
            digest = _sha256_file(f)
            if digest != sh["sha256"]:
                raise ValueError(
                    f"shard {r} sha256 {digest[:12]}... != manifest "
                    f"{sh['sha256'][:12]}..."
                )
            shard_data[r], shard_dtypes[r] = _shard_leaves(f)
        spec: dict = manifest["spec"]
        leaves, unflatten = _flatten_with_paths(template)
        restored = []
        for path, tleaf in leaves:
            kind = spec.get(path)
            if kind is None:
                raise KeyError(f"manifest misses leaf {path!r}")
            src = 0 if kind == "rep" else self.rank
            data = shard_data[src]
            if path not in data:
                raise KeyError(f"rank-{src} shard misses leaf {path!r}")
            arr = _from_savable(data[path], shard_dtypes[src].get(path))
            if kind == "rep" and tuple(arr.shape) != _shape(tleaf):
                raise ValueError(
                    f"leaf {path!r}: checkpoint shape {tuple(arr.shape)} != "
                    f"template shape {_shape(tleaf)}"
                )
            restored.append(arr)
        return unflatten(restored), _manifest_meta(manifest)

    # -- quarantine / prune ------------------------------------------------

    def _quarantine(self, step: int, reason: str) -> Path | None:
        """Move a broken step directory to ``<dir>.quarantine/``. Every
        rank restores concurrently; first rename wins, losers see ENOENT
        and move on."""
        src = self.step_dir(step)
        qdir = self.directory.with_name(self.directory.name + ".quarantine")
        qdir.mkdir(parents=True, exist_ok=True)
        dst = qdir / src.name
        n = 0
        while dst.exists():
            n += 1
            dst = qdir / f"{src.name}.{n}"
        try:
            os.replace(src, dst)
        except OSError:
            return None
        self._log(f"step {step} quarantined to {dst}: {reason}")
        return dst

    def _prune(self) -> None:
        """Keep the newest ``keep`` SEALED steps. Older sealed steps are
        deleted; older torn steps are quarantined, never deleted."""
        sealed = self.sealed_steps()
        if len(sealed) <= self.keep:
            cutoff = sealed[0] if sealed else None
        else:
            cutoff = sealed[-self.keep]
        if cutoff is None:
            return
        for s in self.steps_on_disk():
            if s >= cutoff:
                continue
            if s in sealed:
                shutil.rmtree(self.step_dir(s), ignore_errors=True)
            else:
                self._quarantine(s, "torn step older than the keep window")


def fold_per_replica(tree, template, index: int = 0):
    """Collapse restored per-replica leaves (shape ``(world, *t.shape)``)
    to replica ``index`` so the tree matches the unsharded template — the
    fallback when the world size changed across the restart."""
    return tree_map(
        lambda x, t: x[index] if _shape(x) != _shape(t) else x,
        tree, template,
    )


class CheckpointVerifier:
    """Background bitrot hunter: periodically re-hashes every sealed step
    against its manifest and quarantines any that no longer verify. Runs
    on rank 0 only."""

    def __init__(self, ckpt: ShardedCheckpoint, interval: float = 60.0):
        self.ckpt = ckpt
        self.interval = interval
        self.scans = 0
        self.corrupt_found: list[int] = []
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def scan_once(self) -> list[int]:
        """One synchronous sweep; returns the steps quarantined."""
        bad = []
        for s in self.ckpt.sealed_steps():
            problems = verify_step_dir(self.ckpt.step_dir(s))
            if problems:
                self.ckpt._quarantine(s, "verifier: " + "; ".join(problems))
                bad.append(s)
        self.scans += 1
        self.corrupt_found.extend(bad)
        return bad

    def start(self) -> "CheckpointVerifier":
        if self._thread is not None:
            return self

        def run():
            while not self._stop.wait(self.interval):
                try:
                    self.scan_once()
                except Exception:
                    pass  # a transient FS error must not kill the thread

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()


# -- single-rank export: the train->serve weight handoff ----------------------

def _params_tree(params):
    """A module's parameters as ``{path: tensor}`` (JAX's params paths),
    or the tree as it is."""
    if isinstance(params, torch.nn.Module):
        return {n.replace(".", "/"): p.detach()
                for n, p in params.named_parameters()}
    return params


def export_params(
    directory: str | os.PathLike, params, step: int, *,
    extra: dict | None = None, compress: bool = False,
) -> Path:
    """Seal ``params`` (a tree, or a module's parameters) as a one-rank
    sharded step under ``directory`` and return the sealed step dir.
    Raises when the commit did not complete. Exports are never pruned."""
    tree = _params_tree(params)
    spec = tree_map(lambda _: "rep", tree)
    ck = ShardedCheckpoint(
        directory, rank=0, world_size=1, kv=None,
        keep=1_000_000_000, verbose=False, compress=compress,
    )
    ok = ck.save(tree, spec, int(step), epoch=0, offset=0,
                 extra=dict(extra or {}, exported=True))
    if not ok:
        raise RuntimeError(
            f"export of step {step} under {directory} did not seal"
        )
    return ck.step_dir(int(step))


def load_exported_params(step_dir: str | os.PathLike, template):
    """Restore a sealed single-rank export (strict: checksum-verified,
    fail-loud) into ``template``'s structure and return it. A module as
    ``template`` takes the values into its parameters in place."""
    sd = Path(step_dir).absolute()
    step = _parse_step_dir(sd)
    if step is None:
        raise ValueError(f"{step_dir} is not a step-XXXXXXXX directory")
    ck = ShardedCheckpoint(sd.parent, rank=0, world_size=1, kv=None,
                           verbose=False)
    tree, _meta = ck.restore(_params_tree(template), step=step)
    if isinstance(template, torch.nn.Module):
        with torch.no_grad():
            for n, p in template.named_parameters():
                p.copy_(torch.as_tensor(tree[n.replace(".", "/")]))
        return template
    return tree
