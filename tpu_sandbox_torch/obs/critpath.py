"""Critical-path attribution over merged traces: where did the time go?
The port's copy of ``tpu_sandbox/obs/critpath.py``: the same segments,
the same profile schema and bytes, so either package's profiles load in
the other.

Input is the merged, clock-calibrated record list from
:mod:`tpu_sandbox_torch.obs.collect` (each record carries ``uts``, unified
seconds). For every request chain this module:

1. finds the **terminal** record (the ``verdict`` instant, a
   ``door:*``/``shed:*`` terminal, or — for a chain that never finished —
   the latest record) and walks parent links back to the root, giving
   the causal critical path;
2. **sweeps** the request's wall-clock interval and attributes every
   elementary sub-interval to a named segment: the deepest covering span
   on the path (or a direct child of a path span — ``prefill`` refines
   ``admit``) wins; uncovered gaps are named by their causal neighbours
   (``enqueue`` → ``claim`` is ``queue_wait``, the targeted-queue wait),
   overlapped against process-level ``swap:pause`` spans (a weight swap
   stalls every resident request on that engine), and anything still
   unexplained lands in ``unattributed``. Attribution therefore sums to
   the wall-clock *exactly*; the contract (`coverage ≥ 0.95`) is on how
   little of it is ``unattributed``;
3. emits a **blame** segment per request — the largest attributed
   segment — so a SHED or deadline-missed request names the span that
   ate its budget.

Run-level aggregation (:func:`aggregate`) keeps per-request samples per
segment so :func:`compare_profiles` (the engine behind
``tpu_sandbox_torch/tools/tracediff.py``) can gate on a quantile-paired
**median of ratios** rather than means — one straggler request must not flag a
regression, and a real 20% decode slowdown must.

MPMD runs get the same treatment at stage granularity:
:func:`bubble_fractions` derives per-stage, per-step pipeline bubble
from the ``stage:op`` / ``stage:step`` spans that an MPMD stage worker
emits (the JAX package's MPMD stage workers; the port has no MPMD
runtime yet), independently of the online ``mpmd.bubble_fraction``
gauge the worker publishes, to be cross-checked against the analytic
``(S-1)/(M+S-1)``.

:func:`publish_profile` pushes a profile's segment shares through the
tsdb ring (static gauge names, segment as a label — GL-O402/O403) so
``tpu_sandbox_torch/tools/fleetop.py`` can render a live where-time-goes
panel.
"""

from __future__ import annotations

import json
import statistics

from tpu_sandbox_torch.obs import tsdb
from tpu_sandbox_torch.obs.metrics import MetricsRegistry
from tpu_sandbox_torch.obs.record import Recorder

#: profile schema tag — bump on any change to the aggregate layout
PROFILE_SCHEMA = "tpu-sandbox.critpath/1"

#: span name (or ``family`` for ``family:<x>`` names) -> segment
SEGMENT_OF_SPAN = {
    "submit": "submit",         # client-side submit RPC round trip
    "route": "route",           # gateway routing decision
    "door": "door",             # terminal door shed (door:<reason>)
    "enqueue": "enqueue",       # KV queue write
    "claim": "claim",           # replica claim + request fetch
    "admit": "admit",           # engine admission bookkeeping
    "prefill": "prefill",       # prefill compute (child of admit)
    "decode": "decode",         # decode steps, admit -> retire
    "publish": "publish",       # verdict publish (KV write)
    "ship": "wire_ship",        # KV wire ship (disagg / remote cache)
    "swap": "swap_pause",       # swap:pause — weight-swap stall
}

#: (segment before, segment after) -> name for the uncovered gap between
GAP_SEGMENTS = {
    ("enqueue", "claim"): "queue_wait",      # targeted/shared queue wait
    ("submit", "claim"): "queue_wait",       # enqueue span lost/torn
    ("claim", "admit"): "engine_queue",      # engine waiting deque
    ("claim", "decode"): "engine_queue",
    ("claim", "shed"): "engine_queue",       # shed straight off the queue
    ("decode", "publish"): "publish_wait",   # retire -> publisher pump
    ("decode", "verdict"): "publish_wait",
    ("decode", "shed"): "publish_wait",
    ("publish", "verdict"): "publish_wait",
}

#: process-level spans that stall resident requests without being part
#: of any request's causal chain — matched into gaps by process key
STALL_SPANS = {"swap": "swap_pause"}

#: the coverage contract: at most 5% of a request's wall may stay
#: unattributed for the request to count as fully explained
COVERAGE_TARGET = 0.95


def _segment_of(name: str) -> str | None:
    """Map a span name to its segment; ``family:<value>`` names key on
    the family prefix (``door:infeasible`` -> ``door``)."""
    if name in SEGMENT_OF_SPAN:
        return SEGMENT_OF_SPAN[name]
    fam = name.split(":", 1)[0]
    return SEGMENT_OF_SPAN.get(fam)


def _family(name: str) -> str:
    return name.split(":", 1)[0]


def _end(r: dict) -> float:
    return float(r["uts"]) + float(r.get("dur", 0.0))


# -- per-request critical path ------------------------------------------------


def request_traces(merged: list[dict]) -> dict[str, str]:
    """rid -> trace id, discovered from the ``rid`` stamped into span
    args at submit time (first trace to mention a rid wins)."""
    out: dict[str, str] = {}
    for r in merged:
        rid = (r.get("args") or {}).get("rid")
        if rid is not None and r.get("trace") and rid not in out:
            out[rid] = r["trace"]
    return out


def _terminal(records: list[dict]) -> dict:
    """The record the path walk starts from: the chain's verdict instant
    if one landed, else a terminal door/shed record, else whatever
    happened last (an open request — still attributable up to its last
    observed event)."""
    for want in ("verdict", "door", "shed"):
        cands = [r for r in records if _family(r.get("name", "")) == want]
        if cands:
            return max(cands, key=_end)
    return max(records, key=_end)


def critical_path(records: list[dict]) -> list[dict]:
    """The causal chain from the terminal record back to the root,
    returned root-first. A dangling parent (torn log) truncates the walk
    there — the path is still valid from that point on."""
    if not records:
        return []
    by_span = {r["span"]: r for r in records if r.get("span")}
    path = []
    node = _terminal(records)
    seen = set()
    while node is not None and id(node) not in seen:
        seen.add(id(node))
        path.append(node)
        parent = node.get("parent")
        node = by_span.get(parent) if parent else None
    path.reverse()
    return path


def attribute_request(records: list[dict],
                      stalls: list[dict] | None = None) -> dict | None:
    """Attribute one request chain's wall-clock to named segments.

    ``records`` is every merged record of one trace; ``stalls`` is the
    run's process-level stall spans (``swap:pause``), matched into this
    request's gaps by process key. Returns the per-request attribution
    dict, or None for traces with no usable records."""
    spans = [r for r in records if r.get("ph") == "X"]
    if not records or not (spans or
                           any(r.get("ph") == "i" for r in records)):
        return None
    path = critical_path(records)
    if not path:
        return None
    path_ids = {r.get("span") for r in path if r.get("span")}
    # one level of refinement: a direct child of a path span carves its
    # parent's time into a finer segment (prefill inside admit)
    cover = list(path) + [
        r for r in spans
        if r.get("parent") in path_ids and r.get("span") not in path_ids]
    # depth orders nesting for deepest-wins; the path is causally ordered
    # already, refinement children sit one deeper than their parent
    depth = {id(r): i for i, r in enumerate(path)}
    for r in cover:
        if id(r) not in depth:
            depth[id(r)] = depth.get(
                id(next((p for p in path
                         if p.get("span") == r.get("parent")), path[-1])),
                len(path)) + 1

    t0 = min(float(r["uts"]) for r in path)
    t1 = max(_end(r) for r in path)
    wall = t1 - t0
    rid = next(((r.get("args") or {}).get("rid") for r in records
                if (r.get("args") or {}).get("rid") is not None), None)
    terminal = _terminal(records)
    term_name = terminal.get("name", "?")
    outcome = "ok"
    if _family(term_name) in ("door", "shed"):
        outcome = term_name
    elif term_name == "verdict":
        v = (terminal.get("args") or {}).get("verdict", "ok")
        outcome = "ok" if str(v).lower() == "ok" else f"shed:{v}"
    else:
        outcome = "open"

    segments: dict[str, float] = {}
    if wall <= 0.0:
        return {"rid": rid, "trace": records[0].get("trace"),
                "wall_s": 0.0, "segments": {}, "coverage": 1.0,
                "outcome": outcome, "blame": None, "procs": []}

    intervals = [(max(float(r["uts"]), t0), min(_end(r), t1), r)
                 for r in cover if r.get("ph") == "X"]
    intervals = [iv for iv in intervals if iv[1] > iv[0]]
    procs = sorted({r.get("pkey", "?") for r in cover})
    my_stalls = [(float(s["uts"]), _end(s), _segment_of(s.get("name", "")))
                 for s in (stalls or []) if s.get("pkey") in procs]

    bounds = sorted({t0, t1}
                    | {b for lo, hi, _ in intervals for b in (lo, hi)})
    for lo, hi in zip(bounds, bounds[1:]):
        if hi <= lo:
            continue
        covering = [r for ilo, ihi, r in intervals if ilo <= lo and ihi >= hi]
        if covering:
            winner = max(covering,
                         key=lambda r: (depth[id(r)], float(r["uts"])))
            seg = _segment_of(winner.get("name", "")) or "unattributed"
        else:
            prev = max((r for ilo, ihi, r in intervals if ihi <= lo),
                       key=lambda r: _end(r), default=None)
            nxt = min((r for ilo, ihi, r in intervals if ilo >= hi),
                      key=lambda r: float(r["uts"]), default=None)
            before = _segment_of(prev.get("name", "")) if prev else None
            after = _family(term_name) if nxt is None \
                else _segment_of(nxt.get("name", ""))
            seg = GAP_SEGMENTS.get((before, after))
            if seg is None:
                seg = "unattributed"
            if seg == "unattributed" or seg in ("queue_wait", "engine_queue",
                                                "publish_wait"):
                # a weight swap overlapping the gap explains (part of)
                # it; the unoverlapped remainder keeps the gap's name so
                # the pieces still sum to the wall exactly
                cursor = lo
                for slo, shi, sseg in sorted(my_stalls):
                    a, b = max(slo, cursor), min(shi, hi)
                    if b > a:
                        if a > cursor:
                            segments[seg] = segments.get(seg, 0.0) \
                                + (a - cursor)
                        segments[sseg] = segments.get(sseg, 0.0) + (b - a)
                        cursor = b
                if cursor > lo:
                    rem = hi - cursor
                    if rem > 0:
                        segments[seg] = segments.get(seg, 0.0) + rem
                    continue
        segments[seg] = segments.get(seg, 0.0) + (hi - lo)

    unattr = segments.get("unattributed", 0.0)
    coverage = 1.0 - unattr / wall
    attributed = {k: v for k, v in segments.items() if k != "unattributed"}
    blame = max(attributed, key=attributed.get) if attributed else None
    return {
        "rid": rid,
        "trace": records[0].get("trace"),
        "wall_s": wall,
        "segments": {k: segments[k] for k in sorted(segments)},
        "coverage": coverage,
        "outcome": outcome,
        "blame": blame,
        "procs": procs,
    }


def analyze(merged: list[dict]) -> dict:
    """Every request chain in a merged trace, attributed, plus the
    run-level profile. The unit tools/benches call."""
    from tpu_sandbox_torch.obs.collect import trace_chains
    chains = trace_chains(merged)
    stalls = [r for r in merged
              if r.get("ph") == "X"
              and _family(r.get("name", "")) in STALL_SPANS]
    rid_to_trace = request_traces(merged)
    requests = []
    for rid, trace in sorted(rid_to_trace.items()):
        recs = chains.get(trace)
        if not recs:
            continue
        req = attribute_request(recs, stalls)
        if req is not None:
            requests.append(req)
    return {"requests": requests, "profile": aggregate(requests)}


# -- aggregation --------------------------------------------------------------


def aggregate(requests: list[dict]) -> dict:
    """Fold per-request attributions into the run profile: per-segment
    totals, shares, and the sorted per-request samples tracediff pairs
    by quantile; blame counts over non-ok requests; a per-proc segment
    breakdown (the fleet/stage view)."""
    segs: dict[str, list[float]] = {}
    by_proc: dict[str, dict[str, float]] = {}
    blames: dict[str, int] = {}
    walls = []
    n_ok = 0
    for req in requests:
        walls.append(req["wall_s"])
        if req["outcome"] == "ok":
            n_ok += 1
        elif req.get("blame"):
            blames[req["blame"]] = blames.get(req["blame"], 0) + 1
        for seg, s in req["segments"].items():
            segs.setdefault(seg, []).append(s)
        # charge the request's segments to its serving process (the
        # non-gateway, non-client proc if any — where claim/decode ran)
        serving = next(
            (p for p in req.get("procs", ())
             if not p.startswith(("gateway", "client", "bench", "test"))),
            req.get("procs", ["?"])[0] if req.get("procs") else "?")
        slot = by_proc.setdefault(serving, {})
        for seg, s in req["segments"].items():
            slot[seg] = slot.get(seg, 0.0) + s
    total_wall = sum(walls)
    segments = {}
    for seg in sorted(segs):
        samples = sorted(round(s, 9) for s in segs[seg])
        tot = sum(samples)
        segments[seg] = {
            "total_s": round(tot, 9),
            "share": round(tot / total_wall, 6) if total_wall else 0.0,
            "n": len(samples),
            "median_s": round(statistics.median(samples), 9),
            "samples": samples,
        }
    covs = [r["coverage"] for r in requests]
    return {
        "schema": PROFILE_SCHEMA,
        "requests": len(requests),
        "ok": n_ok,
        "wall_s_total": round(total_wall, 9),
        "wall_s_median": round(statistics.median(walls), 9) if walls else 0.0,
        "coverage_min": round(min(covs), 6) if covs else 1.0,
        "coverage_mean": round(sum(covs) / len(covs), 6) if covs else 1.0,
        "segments": segments,
        "blame": {k: blames[k] for k in sorted(blames)},
        "by_proc": {p: {k: round(v, 9) for k, v in sorted(d.items())}
                    for p, d in sorted(by_proc.items())},
    }


def format_profile(profile: dict) -> str:
    """The where-time-goes table, largest segment first."""
    lines = [f"critpath profile: {profile['requests']} requests "
             f"({profile['ok']} ok), wall "
             f"{profile['wall_s_total'] * 1e3:.1f}ms total, "
             f"coverage min {profile['coverage_min']:.1%} "
             f"mean {profile['coverage_mean']:.1%}"]
    segs = sorted(profile["segments"].items(),
                  key=lambda kv: -kv[1]["total_s"])
    for seg, s in segs:
        lines.append(f"  {seg:<14} {s['share']:>7.1%}  "
                     f"{s['total_s'] * 1e3:>10.2f}ms total  "
                     f"{s['median_s'] * 1e3:>9.3f}ms median  n={s['n']}")
    if profile.get("blame"):
        lines.append("  blame (non-ok requests): " + ", ".join(
            f"{seg}={n}" for seg, n in profile["blame"].items()))
    return "\n".join(lines)


# -- regression compare (the tracediff engine) --------------------------------


def compare_profiles(a: dict, b: dict, *, threshold: float = 0.10,
                     min_ms: float = 0.5, min_share: float = 0.01) -> dict:
    """Segment-by-segment compare of two run profiles, robust to
    stragglers: per segment the two runs' per-request samples are paired
    by quantile (both sorted, index-matched over the shorter run) and
    the **median of the pairwise ratios** is the segment's ratio. A
    segment regresses when that ratio exceeds ``1 + threshold`` AND the
    median grew by at least ``min_ms`` AND the segment carries at least
    ``min_share`` of either run's wall — the noise floor that keeps a
    2µs route jitter from failing a build."""
    rows = []
    regressions = []
    names = sorted(set(a["segments"]) | set(b["segments"]))
    for seg in names:
        sa = a["segments"].get(seg, {}).get("samples", [])
        sb = b["segments"].get(seg, {}).get("samples", [])
        share = max(a["segments"].get(seg, {}).get("share", 0.0),
                    b["segments"].get(seg, {}).get("share", 0.0))
        med_a = statistics.median(sa) if sa else 0.0
        med_b = statistics.median(sb) if sb else 0.0
        if sa and sb:
            n = min(len(sa), len(sb))
            qa = [sa[int(i * (len(sa) - 1) / max(1, n - 1))]
                  for i in range(n)] if n > 1 else [statistics.median(sa)]
            qb = [sb[int(i * (len(sb) - 1) / max(1, n - 1))]
                  for i in range(n)] if n > 1 else [statistics.median(sb)]
            ratios = sorted(y / x for x, y in zip(qa, qb) if x > 0)
            ratio = statistics.median(ratios) if ratios else None
        else:
            ratio = None
        grew_ms = (med_b - med_a) * 1e3
        regressed = (ratio is not None and ratio > 1.0 + threshold
                     and grew_ms >= min_ms and share >= min_share)
        row = {"segment": seg, "median_a_ms": round(med_a * 1e3, 4),
               "median_b_ms": round(med_b * 1e3, 4),
               "ratio": None if ratio is None else round(ratio, 4),
               "share": round(share, 4), "regressed": regressed}
        rows.append(row)
        if regressed:
            regressions.append(seg)
    wall_ratio = None
    if a.get("wall_s_median") and b.get("wall_s_median"):
        wall_ratio = round(b["wall_s_median"] / a["wall_s_median"], 4)
    return {"segments": rows, "regressions": regressions,
            "wall_ratio": wall_ratio,
            "threshold": threshold, "min_ms": min_ms,
            "min_share": min_share}


def format_compare(cmp: dict) -> str:
    lines = [f"{'segment':<14} {'a (ms)':>10} {'b (ms)':>10} "
             f"{'ratio':>7} {'share':>6}  verdict"]
    for row in cmp["segments"]:
        verdict = "REGRESSED" if row["regressed"] else (
            "-" if row["ratio"] is None else
            ("improved" if row["ratio"] < 0.97 else "ok"))
        lines.append(
            f"{row['segment']:<14} {row['median_a_ms']:>10.3f} "
            f"{row['median_b_ms']:>10.3f} "
            f"{row['ratio'] if row['ratio'] is not None else '-':>7} "
            f"{row['share']:>6.1%}  {verdict}")
    if cmp["wall_ratio"] is not None:
        lines.append(f"wall median ratio: {cmp['wall_ratio']}")
    lines.append(
        f"{len(cmp['regressions'])} regression(s)"
        + (f": {', '.join(cmp['regressions'])}" if cmp["regressions"]
           else "")
        + f"  (threshold {cmp['threshold']:.0%}, floor "
          f"{cmp['min_ms']}ms / {cmp['min_share']:.0%} share)")
    return "\n".join(lines)


def save_profile(profile: dict, path: str) -> None:
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(profile, fh, sort_keys=True, separators=(",", ":"))
        fh.write("\n")


def load_profile(path: str) -> dict:
    """A saved profile JSON, or a trace dir to analyze on the fly."""
    import os
    if os.path.isdir(path):
        from tpu_sandbox_torch.obs.collect import load_merged
        return analyze(load_merged(path))["profile"]
    with open(path, "r", encoding="utf-8") as fh:
        profile = json.load(fh)
    if profile.get("schema") != PROFILE_SCHEMA:
        raise ValueError(
            f"unknown critpath profile schema {profile.get('schema')!r} "
            f"(want {PROFILE_SCHEMA})")
    return profile


# -- MPMD bubble accounting ---------------------------------------------------


def bubble_fractions(merged: list[dict]) -> dict:
    """Per-stage, per-step pipeline bubble derived offline from the
    stage-worker spans: a step's bubble is the fraction of its
    ``stage:step`` wall NOT covered by that stage's ``stage:op`` compute
    spans. This is the trace-side cross-check for the online
    ``mpmd.bubble_fraction`` gauge (same numerator, measured instead of
    reported) and for the analytic ``(S-1)/(M+S-1)``."""
    steps: dict[tuple[int, int], float] = {}
    compute: dict[tuple[int, int], float] = {}
    for r in merged:
        if r.get("ph") != "X":
            continue
        args = r.get("args") or {}
        if r.get("name") == "stage:step":
            key = (int(args.get("stage", -1)), int(args.get("step", -1)))
            steps[key] = steps.get(key, 0.0) + float(r.get("dur", 0.0))
        elif r.get("name") == "stage:op":
            key = (int(args.get("stage", -1)), int(args.get("step", -1)))
            compute[key] = compute.get(key, 0.0) + float(r.get("dur", 0.0))
    per_step = []
    per_stage: dict[int, list[float]] = {}
    for (stage, step), wall in sorted(steps.items()):
        if wall <= 0:
            continue
        bubble = max(0.0, 1.0 - compute.get((stage, step), 0.0) / wall)
        per_step.append({"stage": stage, "step": step,
                         "bubble": round(bubble, 6)})
        per_stage.setdefault(stage, []).append(bubble)
    stage_means = {s: round(sum(v) / len(v), 6)
                   for s, v in sorted(per_stage.items())}
    all_b = [row["bubble"] for row in per_step]
    return {
        "per_step": per_step,
        "per_stage": stage_means,
        "mean": round(sum(all_b) / len(all_b), 6) if all_b else None,
    }


# -- tsdb publication ---------------------------------------------------------


def publish_profile(kv, profile: dict, *, proc: str = "critpath",
                    top: int = 12) -> int:
    """Push a profile's segment breakdown through the tsdb ring so
    ``fleetop`` renders it live: static gauge names, the segment riding
    a bounded label (the segment vocabulary is the fixed set above).
    Returns the number of series written."""
    reg = MetricsRegistry()
    segs = sorted(profile["segments"].items(),
                  key=lambda kv_: -kv_[1]["total_s"])[:top]
    for seg, s in segs:
        reg.gauge("critpath.segment.share",
                  labels={"seg": seg}).set(s["share"])
        reg.gauge("critpath.segment.ms",
                  labels={"seg": seg}).set(s["median_s"] * 1e3)
    reg.gauge("critpath.coverage").set(profile["coverage_mean"])
    flusher = tsdb.TimeSeriesFlusher(
        kv, proc=proc, registry=reg, recorder=Recorder(None))
    return flusher.flush()
