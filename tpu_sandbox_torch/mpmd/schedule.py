"""Leader-driven global schedules: 1F1B and ZB-H1 op lists per stage,
plus measurement-driven plan selection. A copy of
``tpu_sandbox/mpmd/schedule.py`` (which imports no jax): the same op
lists, simulator, autotuner and plan keys and JSON.

The leader computes every stage's op list once and publishes it (KV for
the distributed path, direct handoff in-process); stages execute their
list mechanically — all cross-stage coordination is the transport's
blocking slot waits, so the schedule needs no per-tick control messages.

1F1B: stage ``i`` runs ``min(M, S - 1 - i)`` warmup forwards, then
alternates F/B until forwards are spent, then drains backwards. Same
bubble as GPipe — ``(S-1)/(M+S-1)`` — but in-flight activations are
bounded by S instead of M, which is what lets a stage stash at most
``S - i`` microbatch inputs regardless of M.

ZB-H1 (arxiv 2401.10241, the memory-neutral variant): the backward is
split into B (grad-input — the upstream cotangent, all the downstream
stage is waiting for) and W (grad-weight — nobody waits for it until
the optimizer). Each stage holds ``min(M, S-1-stage)`` W passes in
reserve through the steady phase and spends one after each drain-phase
B, so the tail bubble of 1F1B — idle waits between late cotangents —
is filled with weight-grad work instead. Same activation stash bound
as 1F1B; the extra state is the per-reserved-W (input, cotangent)
pair.

Values are schedule-independent: every F/B/W is a pure program on
shipped inputs, so any topological order of the dependency dag gives
bitwise identical grads *for a fixed set of programs*. Reordering is
free; changing the programs is not — the ZB split's per-layer backward
agrees with the fused backward only to float32 ulps (its weight grads
are taken apart from the chain, so their reductions group differently),
so parity across schedule KINDS is held at tolerance while replay after
a fault,
which re-runs the same programs in a different interleaving, still
lands bitwise on the unfaulted state.

``autotune_plan`` closes the measurement loop: the per-stage ``stage:op``
timings the driver records (the same numbers the flight-recorder spans
carry) feed a small dependency-exact simulator, and the plan — schedule
kind × microbatch count — with the best predicted step time wins.
"""

from __future__ import annotations

import json


def one_f_one_b(stage: int, n_stages: int,
                microbatches: int) -> list[tuple[str, int]]:
    """The stage's op list: [("F", mb) | ("B", mb), ...]."""
    if not 0 <= stage < n_stages:
        raise ValueError(f"stage {stage} not in [0, {n_stages})")
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")
    warmup = min(microbatches, n_stages - 1 - stage)
    ops: list[tuple[str, int]] = [("F", m) for m in range(warmup)]
    nf, nb = warmup, 0
    while nb < microbatches:
        if nf < microbatches:
            ops.append(("F", nf))
            nf += 1
        ops.append(("B", nb))
        nb += 1
    return ops


def zb_h1(stage: int, n_stages: int,
          microbatches: int) -> list[tuple[str, int]]:
    """The stage's ZB-H1 op list: [("F", m) | ("B", m) | ("W", m), ...].

    B is grad-input only (ships the cotangent upstream), W is
    grad-weight. ``min(M, S-1-stage)`` W passes are deferred into the
    drain phase — one after each drain B, filling the wait for the next
    cotangent — and any excess W runs in the steady phase so the
    deferred-state bound matches 1F1B's stash bound."""
    if not 0 <= stage < n_stages:
        raise ValueError(f"stage {stage} not in [0, {n_stages})")
    if microbatches < 1:
        raise ValueError(f"microbatches must be >= 1, got {microbatches}")
    warmup = min(microbatches, n_stages - 1 - stage)
    ops: list[tuple[str, int]] = [("F", m) for m in range(warmup)]
    nf, nb = warmup, 0
    pending: list[int] = []
    while nb < microbatches:
        if nf < microbatches:
            ops.append(("F", nf))
            nf += 1
        ops.append(("B", nb))
        pending.append(nb)
        nb += 1
        if nf < microbatches:
            # steady: keep `warmup` weight passes in reserve for the
            # drain; run the excess now (bounds deferred state)
            while len(pending) > warmup:
                ops.append(("W", pending.pop(0)))
        elif pending:
            # drain: one reserved W after each B fills the gap while
            # the next cotangent is still in flight downstream
            ops.append(("W", pending.pop(0)))
    while pending:
        ops.append(("W", pending.pop(0)))
    return ops


SCHEDULE_KINDS = ("1f1b", "zb_h1")


def ops_for(kind: str, stage: int, n_stages: int,
            microbatches: int) -> list[tuple[str, int]]:
    if kind == "1f1b":
        return one_f_one_b(stage, n_stages, microbatches)
    if kind == "zb_h1":
        return zb_h1(stage, n_stages, microbatches)
    raise ValueError(f"unknown schedule kind {kind!r} "
                     f"(have {SCHEDULE_KINDS})")


def max_in_flight(ops: list[tuple[str, int]]) -> int:
    """Peak number of microbatches forwarded but not yet released —
    the stage's activation-stash bound (S - stage for 1F1B). Under a
    split backward the stash is held through B and released at W."""
    has_w = {m for op, m in ops if op == "W"}
    live = peak = 0
    for op, m in ops:
        if op == "F":
            live += 1
        elif (op == "W") or (op == "B" and m not in has_w):
            live -= 1
        peak = max(peak, live)
    return peak


def bubble_fraction(n_stages: int, microbatches: int) -> float:
    """(S-1)/(M+S-1): idle fraction of the synchronous schedule; same
    formula as ``PipelineParallel.bubble_fraction`` at v=1."""
    return (n_stages - 1) / (microbatches + n_stages - 1)


# -- measured schedules ------------------------------------------------------

def simulate_step(op_lists: dict[int, list[tuple[str, int]]],
                  op_costs: dict[int, dict[str, float]], *,
                  ship_s: float = 0.0) -> dict:
    """Dependency-exact step simulation: each stage executes its op list
    sequentially; F_m@s waits on F_m@(s-1), B_m@s waits on B_m@(s+1)
    (plus ``ship_s`` wire latency per hop), W is stage-local. Returns
    the predicted makespan and per-stage busy/bubble — the same
    ``1 - compute/wall`` gauge the driver measures online.

    ``op_costs[stage]`` maps op -> seconds, with "B" the grad-input
    cost, "W" grad-weight, and "A" the once-per-step optimizer apply.
    For fused-backward (1F1B) lists pass the fused cost as "B".
    """
    n_stages = len(op_lists)
    t = {s: 0.0 for s in range(n_stages)}
    busy = {s: 0.0 for s in range(n_stages)}
    fin: dict[tuple, float] = {}
    idx = {s: 0 for s in range(n_stages)}
    remaining = sum(len(v) for v in op_lists.values())
    while remaining:
        progressed = False
        for s in range(n_stages):
            ops = op_lists[s]
            while idx[s] < len(ops):
                op, m = ops[idx[s]]
                if op == "F" and s > 0:
                    ready = fin.get(("F", s - 1, m))
                    if ready is None:
                        break
                    ready += ship_s
                elif op == "B" and s < n_stages - 1:
                    ready = fin.get(("B", s + 1, m))
                    if ready is None:
                        break
                    ready += ship_s
                else:
                    ready = 0.0  # W, stage-0 F, last-stage B: no wait
                dur = float(op_costs[s].get(op, 0.0))
                t[s] = max(t[s], ready) + dur
                fin[(op, s, m)] = t[s]
                busy[s] += dur
                idx[s] += 1
                remaining -= 1
                progressed = True
        if not progressed:
            raise RuntimeError("op lists deadlock: unsatisfiable dependency")
    for s in range(n_stages):
        a = float(op_costs[s].get("A", 0.0))
        t[s] += a
        busy[s] += a
    makespan = max(t.values())
    bubbles = {s: (1.0 - busy[s] / makespan) if makespan > 0 else 0.0
               for s in range(n_stages)}
    return {
        "step_seconds": makespan,
        "busy_seconds": busy,
        "bubble_by_stage": bubbles,
        "bubble_mean": sum(bubbles.values()) / n_stages,
        "bubble_max": max(bubbles.values()),
    }


def autotune_plan(op_costs: dict[int, dict[str, float]], *, n_stages: int,
                  measured_microbatches: int,
                  candidates=(2, 4, 8, 16),
                  kinds=SCHEDULE_KINDS, ship_s: float = 0.0) -> dict:
    """Pick (schedule kind, microbatch count) from measured per-stage op
    timings. ``op_costs`` is per-op seconds at ``measured_microbatches``
    (e.g. the driver's recorded ``stage:op`` medians); candidate M
    rescales them by ``measured_microbatches / M`` — per-op work is
    linear in microbatch size at fixed global batch. Returns the winning
    plan plus every candidate's prediction, so the bench receipt shows
    the whole frontier, not just the argmin."""
    if not candidates:
        raise ValueError("no microbatch candidates")
    rows = []
    for kind in kinds:
        for m_count in candidates:
            scale = measured_microbatches / m_count
            costs = {}
            for s in range(n_stages):
                c = {k: float(v) * scale for k, v in op_costs[s].items()
                     if k != "A"}
                if kind == "1f1b":
                    # fused backward: one op paying both halves
                    c["B"] = c.get("B", 0.0) + c.get("W", 0.0)
                    c.pop("W", None)
                c["A"] = float(op_costs[s].get("A", 0.0))
                costs[s] = c
            ops = {s: ops_for(kind, s, n_stages, m_count)
                   for s in range(n_stages)}
            sim = simulate_step(ops, costs, ship_s=ship_s)
            rows.append({"kind": kind, "microbatches": m_count,
                         "predicted_step_s": round(sim["step_seconds"], 6),
                         "predicted_bubble": round(sim["bubble_mean"], 6)})
    best = min(rows, key=lambda r: (r["predicted_step_s"],
                                    r["predicted_bubble"]))
    return {"kind": best["kind"], "microbatches": best["microbatches"],
            "predicted": best, "candidates": rows}


# -- leader publication (distributed path) ----------------------------------

def plan_key(prefix: str) -> str:
    return f"{prefix}/plan" if prefix else "mpmd/plan"


def publish_plan(kv, *, n_stages: int, microbatches: int, steps: int,
                 seed: int, prefix: str = "mpmd", kind: str = "1f1b",
                 layer_split=None, extra: dict | None = None) -> dict:
    """The leader's one-shot schedule publication: each stage reads its
    own op list and the run geometry from a single durable key, so a
    relaunched stage host rejoins the SAME global schedule (the plan,
    like the queue, outlives any process). ``kind`` picks the schedule
    family, ``layer_split`` the (possibly uneven) per-stage layer
    counts; ``extra`` rides along for run config the stages must agree
    on (model, optimizer, batch)."""
    plan = {
        "n_stages": n_stages,
        "microbatches": microbatches,
        "steps": steps,
        "seed": seed,
        "kind": kind,
        "layer_split": list(layer_split) if layer_split else None,
        "ops": {str(s): ops_for(kind, s, n_stages, microbatches)
                for s in range(n_stages)},
    }
    plan.update(extra or {})
    kv.set(plan_key(prefix), json.dumps(plan))
    return plan


def fetch_plan(kv, *, prefix: str = "mpmd", timeout: float = 60.0) -> dict:
    import time
    deadline = time.monotonic() + timeout
    raw = kv.try_get(plan_key(prefix))
    while raw is None:
        if time.monotonic() >= deadline:
            raise TimeoutError("no schedule plan published")
        time.sleep(0.01)
        raw = kv.try_get(plan_key(prefix))
    plan = json.loads(raw)
    plan["ops"] = {int(k): [tuple(op) for op in v]
                   for k, v in plan["ops"].items()}
    plan.setdefault("kind", "1f1b")
    plan.setdefault("layer_split", None)
    return plan
