"""Durable model registry: the train->serve handoff ledger. The port's
copy of ``tpu_sandbox/deploy/registry.py``, with the same keys; its
``load_step_params`` places the restored leaves like the template's.

Training tenants publish sealed weight exports here
(``trainer.publish_checkpoint`` -> :func:`publish_version`); the
leader-elected :class:`~tpu_sandbox_torch.deploy.controller.DeployController`
watches the ledger and promotes. Everything lives in the KV store so any
successor controller — and any ops tool — reconstructs the full
deployment state from the store alone:

    deploy/ver/<fleet>             atomic version allocator (``add()``)
    deploy/models/<fleet>/<ver>    version record {ver, step_dir, step,
                                   wall, ...} — the artifact pointer; the
                                   artifact itself is a sealed
                                   ShardedCheckpoint step dir on disk
    deploy/target/<fleet>          the fleet's established version (set
                                   only at the END of a successful
                                   rollout — mid-rollout it still names
                                   the rollback target)
    deploy/ro/<fleet>/<ver>/<kind> rollout decision records + claim-once
                                   markers per phase (kind in rec/claim,
                                   verdict/vclaim, reject/rejclaim,
                                   done/doneclaim) — see controller.py
    deploy/shares/<fleet>          version-pinned canary traffic shares
                                   the gateway routes by (present only
                                   while a canary is live)
    deploy/events/<n>, deploy/tail durable decision log (autoscaler
                                   idiom: ``add`` the tail, set the slot)

``<fleet>`` is the serving fleet's name, or ``default`` for the bare
(unnamed) fleet — the registry always lives at the store ROOT, even when
the serve plane is namespaced under ``fleet/<name>/``, because one
controller watches every fleet.
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path

import numpy as np

K_EVENT_TAIL = "deploy/tail"


def fleet_label(fleet: str) -> str:
    return fleet or "default"


def k_ver_alloc(fleet: str) -> str:
    return f"deploy/ver/{fleet_label(fleet)}"


def k_model(fleet: str, seq: int) -> str:
    """Registry record for version ``seq`` (versions are a per-fleet
    monotone sequence — the param name keeps the claim-key scope
    explicit)."""
    return f"deploy/models/{fleet_label(fleet)}/{int(seq)}"


def k_target(fleet: str) -> str:
    return f"deploy/target/{fleet_label(fleet)}"


def k_ro(fleet: str, seq: int, kind: str) -> str:
    """Rollout phase record/claim for (fleet, version ``seq``)."""
    return f"deploy/ro/{fleet_label(fleet)}/{int(seq)}/{kind}"


def k_shares(fleet: str) -> str:
    return f"deploy/shares/{fleet_label(fleet)}"


def k_event(n: int) -> str:
    return f"deploy/events/{n}"


# -- publishing ---------------------------------------------------------------


def publish_version(kv, step_dir: str | os.PathLike, *, fleet: str = "",
                    step: int | None = None,
                    extra: dict | None = None) -> int:
    """Register a sealed export as the fleet's next version; returns the
    allocated version number. Publication is a pointer write — integrity
    is re-verified by the controller before any replica is told to load
    it, so a corrupt artifact burns a version number, never a replica."""
    sd = Path(step_dir).absolute()
    ver = kv.add(k_ver_alloc(fleet))
    body = {"ver": int(ver), "step_dir": str(sd),
            "step": int(step) if step is not None else None,
            "wall": time.time()}
    body.update(extra or {})
    kv.set(k_model(fleet, ver), json.dumps(body))
    append_event(kv, {"action": "published", "fleet": fleet_label(fleet),
                      "ver": int(ver), "step_dir": str(sd),
                      "wall": time.time()})
    return int(ver)


def registry_versions(kv, fleet: str = "") -> dict[int, dict]:
    """Every registered version record for ``fleet``, keyed by version."""
    prefix = f"deploy/models/{fleet_label(fleet)}/"
    out: dict[int, dict] = {}
    for key in kv.keys(prefix):
        raw = kv.try_get(key)
        if raw is None:
            continue
        try:
            body = json.loads(raw)
            out[int(body["ver"])] = body
        except (ValueError, KeyError):
            continue
    return out


def current_target(kv, fleet: str = "") -> int:
    """The fleet's established version; 0 = boot weights (nothing ever
    promoted)."""
    raw = kv.try_get(k_target(fleet))
    return 0 if raw is None else int(raw)


def read_shares(kv, fleet: str = "") -> dict[int, float] | None:
    """Live canary traffic shares {version: share}, or None when no
    canary is routing."""
    raw = kv.try_get(k_shares(fleet))
    if raw is None:
        return None
    try:
        body = json.loads(raw)
        return {int(v): float(s) for v, s in body.get("shares", {}).items()}
    except (ValueError, AttributeError):
        return None


def rollout_phase(kv, fleet: str, seq: int) -> dict:
    """One rollout's durable phase state: which records/claims exist and
    their payloads — the successor-reconstruction and ops-panel view."""
    out: dict = {"ver": int(seq)}
    for kind in ("rec", "reject", "verdict", "done"):
        raw = kv.try_get(k_ro(fleet, seq, kind))
        out[kind] = None if raw is None else json.loads(raw)
    for kind, claim in (("rec", "claim"), ("reject", "rejclaim"),
                        ("verdict", "vclaim"), ("done", "doneclaim")):
        out[f"{kind}_claimed"] = \
            kv.try_get(k_ro(fleet, seq, claim)) is not None
    return out


def append_event(kv, event: dict) -> int:
    n = kv.add(K_EVENT_TAIL) - 1
    kv.set(k_event(n), json.dumps(event))
    return n


def deploy_events(kv) -> list[dict]:
    """Every deployment decision, in order — the bench/test timeline."""
    out = []
    for n in range(int(kv.try_get(K_EVENT_TAIL) or b"0")):
        raw = kv.try_get(k_event(n))
        if raw is not None:
            out.append(json.loads(raw))
    return out


# -- weight loading (replica side) -------------------------------------------


def as_export_tree(params):
    """The tree an export holds for ``params``: a state dict (dotted keys,
    ``block0.attn.qkv.kernel``) under the paths of JAX's Flax tree
    (``block0/attn/qkv/kernel``), so either package reads the other's
    artifact; any other tree (or a module) as it is."""
    if isinstance(params, dict) and any("." in str(k) for k in params):
        return {str(k).replace(".", "/"): v for k, v in params.items()}
    return params


def _like(arr, tleaf):
    """A restored leaf placed like the template's: a tensor on the
    template's device in its dtype, anything else as restored."""
    import torch

    if isinstance(tleaf, torch.Tensor):
        t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(
            np.ascontiguousarray(arr))
        return t.to(device=tleaf.device, dtype=tleaf.dtype)
    return arr


def load_step_params(step_dir: str | os.PathLike, template):
    """Checksum-verified restore of a registered export into
    ``template``'s structure. Raises on torn/corrupt artifacts — the
    replica treats that as a failed swap, never a partial load.

    Staging is chunk-streamed (``runtime.staging.stream_load_npz`` under
    ``ShardedCheckpoint._load``): each member decompresses straight into
    its preallocated array in bounded chunks instead of ``np.load``'s
    whole-member bytes copy, so a swap's peak host memory is ~one model
    instead of two plus the largest member. The verify-before-touch
    checksum pass is unchanged — bytes on disk are hashed before any
    parse. A state dict template (an engine's weights) reads JAX's paths
    (``as_export_tree``) and gets each leaf back on its device and in its
    dtype."""
    from tpu_sandbox_torch.train.checkpoint import (load_exported_params,
                                                    tree_map)

    tree = as_export_tree(template)
    got = load_exported_params(step_dir, tree)
    if tree is not template:
        return {k: _like(got[k.replace(".", "/")], v)
                for k, v in template.items()}
    if isinstance(template, (dict, list, tuple)):
        return tree_map(_like, got, template)
    return got


# -- registry audit -----------------------------------------------------------


def audit_registry(kv, fleet: str = "") -> dict:
    """Walk one fleet's registry and report, per version: seal status of
    its artifact, lifecycle status (current / candidate / rejected /
    rolled-back / superseded), and whether it is dangling (registered but
    the artifact is gone) or GC-able (superseded, finished, and no longer
    the rollback target). Pure read — the audit never deletes."""
    from tpu_sandbox_torch.train.checkpoint import verify_step_dir

    target = current_target(kv, fleet)
    versions = registry_versions(kv, fleet)
    allocated = int(kv.try_get(k_ver_alloc(fleet)) or b"0")
    missing = sorted(set(range(1, allocated + 1)) - set(versions))
    rows = []
    for seq in sorted(versions):
        rec = versions[seq]
        phase = rollout_phase(kv, fleet, seq)
        sd = Path(rec.get("step_dir", ""))
        dangling = not sd.is_dir()
        problems = [] if dangling else verify_step_dir(sd)
        if seq == target:
            status = "current"
        elif phase["reject"] is not None:
            status = "rejected"
        elif phase["done"] is not None:
            outcome = (phase["done"] or {}).get("outcome")
            status = "rolled_back" if outcome == "rolled_back" \
                else "superseded"
        elif seq > target:
            status = "candidate"
        else:
            status = "superseded"
        # the previous target stays pinned as the live rollback target
        # while any rollout is still unfinished; a finished history makes
        # every non-current, non-candidate version collectable
        gc_able = status in ("superseded", "rolled_back", "rejected") \
            and seq != target
        rows.append({"ver": seq, "status": status,
                     "step_dir": str(sd), "dangling": dangling,
                     "sealed": (not dangling) and not problems,
                     "problems": problems, "gc_able": gc_able})
    return {"fleet": fleet_label(fleet), "target": target,
            "allocated": allocated, "missing_records": missing,
            "versions": rows}


def audited_fleets(kv) -> list[str]:
    """Fleet labels with any registry state — the audit's scan scope."""
    fleets = {k.split("/")[2] for k in kv.keys("deploy/models/")
              if k.count("/") >= 3}
    fleets |= {k.split("/")[2] for k in kv.keys("deploy/ver/")
               if k.count("/") >= 2}
    return sorted(fleets)
