"""fleetop — live ops console for the health plane. The port's copy of
the repo's ``tools/fleetop.py``: the same panels from the same keys.

Connects to the cluster KV store and renders, from durable state alone
(no process needs to cooperate):

- fleet health gauges from the tsdb ring (queue depth, replica count,
  goodput, recorder drops) and the per-series producer list;
- the where-time-goes panel: the live critical-path segment breakdown
  published by ``obs/critpath.publish_profile`` and the per-stage MPMD
  ``mpmd.bubble_fraction`` gauges, when either is present;
- per-replica occupancy and SLO burn: the TTL'd load reports next to
  each replica's shed/done burn rate over the recent window, with
  replicas currently excluded from routing (active ``replica_burn``)
  flagged;
- the deployment panel: per-replica serving version, each fleet's
  rollout phase, live canary shares, and the last verdict/rollback from
  the durable decision log;
- active alerts (the TTL'd condition flags control planes act on) and
  the most recent durable alert records;
- postmortem pointers: the ``tracecat`` invocation that reconstructs
  the causal timeline around each recent alert.

    python -m tpu_sandbox_torch.tools.fleetop --port 5999
        One shot: render and exit.

    python -m tpu_sandbox_torch.tools.fleetop --port 5999 --watch 2
        Clear-screen refresh every 2 s until interrupted.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

from tpu_sandbox_torch.obs import health, tsdb
from tpu_sandbox_torch.runtime.kvstore import KVClient
from tpu_sandbox_torch.serve.replica import read_load_reports

#: fleet gauges worth a headline line when any process publishes them
FLEET_GAUGES = (
    "sched.queue.depth", "sched.running", "autoscale.replicas",
    "serve.goodput", "obs.recorder.dropped",
)

#: trailing window for the burn columns, in fine buckets
BURN_BUCKETS = 12


def _fmt_num(v) -> str:
    if v is None:
        return "-"
    f = float(v)
    return str(int(f)) if f == int(f) else f"{f:.3f}"


def _burn_by_proc(kv) -> dict[str, tuple[float, float, float | None]]:
    """proc -> (shed, done, burn rate) over the trailing window."""
    shed_rows = tsdb.read_series(kv, "engine.shed")
    done_rows = tsdb.read_series(kv, "engine.done")
    newest = max((r["bucket"] for r in shed_rows + done_rows), default=0)
    since = newest - BURN_BUCKETS + 1
    shed = tsdb.window_sum(shed_rows, since_bucket=since, per_proc=True)
    done = tsdb.window_sum(done_rows, since_bucket=since, per_proc=True)
    out = {}
    for proc in sorted(set(shed) | set(done)):
        s, d = shed.get(proc, 0.0), done.get(proc, 0.0)
        rate = s / (s + d) if s + d > 0 else None
        out[proc] = (s, d, rate)
    return out


def _series_labels(series: str) -> dict[str, str]:
    """``name{seg=route,proc=x}`` -> {"seg": "route", ...}."""
    if "{" not in series or not series.endswith("}"):
        return {}
    body = series[series.index("{") + 1:-1]
    out = {}
    for pair in body.split(","):
        if "=" in pair:
            k, v = pair.split("=", 1)
            out[k] = v
    return out


def _latest_by_label(rows: list[dict], label: str) -> dict[str, float]:
    """Newest gauge value per distinct value of ``label`` across all
    producers (fleet-wide view: last writer wins per label value)."""
    best: dict[str, dict] = {}
    for r in rows:
        if r["kind"] == "counter":
            continue
        key = _series_labels(r["series"]).get(label, "?")
        cur = best.get(key)
        if cur is None or r["bucket"] >= cur["bucket"]:
            best[key] = r
    return {k: float(v["v"]) for k, v in best.items()}


def _critpath_panel(kv, lines) -> None:
    """Where time goes: the live segment breakdown published by
    ``obs/critpath.publish_profile`` plus the per-stage pipeline bubble
    the MPMD stage workers publish online."""
    shares = _latest_by_label(
        tsdb.read_series(kv, "critpath.segment.share"), "seg")
    bubbles = _latest_by_label(
        tsdb.read_series(kv, "mpmd.bubble_fraction"), "stage")
    if not shares and not bubbles:
        return
    lines.append("")
    lines.append("where time goes:")
    if shares:
        ms = _latest_by_label(
            tsdb.read_series(kv, "critpath.segment.ms"), "seg")
        for seg, share in sorted(shares.items(), key=lambda kv_: -kv_[1]):
            med = ms.get(seg)
            lines.append(
                f"  {seg:<14} {share:>6.1%} of request wall"
                + ("" if med is None else f"   median {med:.3f}ms"))
        cov = tsdb.latest_value(tsdb.read_series(kv, "critpath.coverage"))
        if cov is not None:
            lines.append(f"  attribution coverage {float(cov):.1%}")
    if bubbles:
        lines.append("  mpmd bubble: " + "  ".join(
            f"stage{stage}={frac:.3f}"
            for stage, frac in sorted(bubbles.items())))


def _deploy_panel(kv, reports, lines, now) -> None:
    """Continuous-deployment state, reconstructed from the registry alone:
    per-fleet target version, the active rollout's phase, live canary
    shares, the latest canary verdict, and the most recent rollback."""
    from tpu_sandbox_torch.deploy.registry import (
        audited_fleets, current_target, deploy_events, fleet_label,
        read_shares, registry_versions, rollout_phase,
    )

    fleets = audited_fleets(kv)
    lines.append("")
    lines.append("deployment:")
    if not fleets:
        lines.append("  no registry state")
        return
    events = deploy_events(kv)
    for fleet in fleets:
        target = current_target(kv, fleet)
        versions = registry_versions(kv, fleet)
        active = None
        for seq in sorted(versions, reverse=True):
            ph = rollout_phase(kv, fleet, seq)
            if ph["rec"] is not None and ph["done"] is None \
                    and ph["reject"] is None:
                active = ph
                break
        if active is None:
            phase_desc = "idle"
        else:
            verdict = active["verdict"]
            if verdict is None:
                phase_desc = f"v{active['ver']} canary"
            else:
                phase_desc = (f"v{active['ver']} converging "
                              f"(canary {verdict.get('outcome', '?')})")
        lines.append(f"  fleet {fleet}: target v{target}, "
                     f"{len(versions)} registered, rollout {phase_desc}")
        shares = read_shares(kv, fleet)
        if shares:
            lines.append("    canary shares: " + ", ".join(
                f"v{v}={s:.0%}" for v, s in sorted(shares.items())))
        label = fleet_label(fleet)
        last_verdict = next(
            (e for e in reversed(events)
             if e.get("fleet") == label
             and e.get("action") in ("canary_fail", "promoted")), None)
        if last_verdict is not None:
            age = now - float(last_verdict.get("wall", now))
            lines.append(f"    last canary verdict: "
                         f"{last_verdict['action']} v"
                         f"{last_verdict.get('ver', '?')} "
                         f"({age:.0f}s ago)")
        last_rb = next(
            (e for e in reversed(events)
             if e.get("fleet") == label
             and e.get("action") == "rolled_back"), None)
        if last_rb is not None:
            age = now - float(last_rb.get("wall", now))
            lines.append(f"    last rollback: v{last_rb.get('ver', '?')} "
                         f"-> v{last_rb.get('target', '?')} "
                         f"({age:.0f}s ago)")


def render(kv, *, now: float | None = None, max_alerts: int = 8) -> str:
    """The whole console as one string — pure so tests can assert on it
    and ``--watch`` can diff it."""
    now = time.time() if now is None else now
    lines = [f"fleetop @ {time.strftime('%H:%M:%S', time.localtime(now))}"]

    # -- fleet gauges --------------------------------------------------------
    lines.append("")
    lines.append("fleet:")
    shown = 0
    for name in FLEET_GAUGES:
        rows = tsdb.read_series(kv, name)
        if not rows:
            continue
        val = tsdb.latest_value(rows)
        procs = sorted({r["proc"] for r in rows})
        lines.append(f"  {name:<24} {_fmt_num(val):>10}   "
                     f"({len(procs)} producer"
                     f"{'s' if len(procs) != 1 else ''})")
        shown += 1
    series = tsdb.list_series(kv)
    lines.append(f"  {len(series)} live series from "
                 f"{len({p for p, _ in series})} processes"
                 if series else "  no time series published yet")

    # -- per-replica occupancy + burn ---------------------------------------
    reports = read_load_reports(kv)
    burns = _burn_by_proc(kv)
    excluded = health.active_subjects(kv, "replica_burn")
    lines.append("")
    lines.append("replicas:")
    tags = sorted(set(reports) | set(burns))
    if not tags:
        lines.append("  none reporting")
    else:
        lines.append(f"  {'tag':<16} {'ver':>5} {'queue':>6} {'active':>7} "
                     f"{'shed':>6} {'done':>6} {'burn':>7}  routing")
        for tag in tags:
            rep = reports.get(tag, {})
            # load reports key on the raw tag; the tsdb proc name is the
            # same tag with '/' flattened (see ReplicaWorker)
            s, d, rate = burns.get(
                tag, burns.get(tag.replace("/", "-"), (0.0, 0.0, None)))
            routing = "EXCLUDED" if (
                tag in excluded or tag.replace("/", "-") in excluded
            ) else "ok"
            lines.append(
                f"  {tag:<16} {_fmt_num(rep.get('ver')):>5} "
                f"{_fmt_num(rep.get('queue_depth')):>6} "
                f"{_fmt_num(rep.get('active')):>7} {_fmt_num(s):>6} "
                f"{_fmt_num(d):>6} "
                f"{('-' if rate is None else f'{rate:.1%}'):>7}  {routing}")

    _critpath_panel(kv, lines)

    _deploy_panel(kv, reports, lines, now)

    # -- alerts --------------------------------------------------------------
    active = health.active_alerts(kv)
    lines.append("")
    lines.append(f"active alerts ({len(active)}):")
    for a in active:
        lines.append(f"  [{a.get('rule', '?')}] {a.get('subject', '?')} "
                     f"window={a.get('window_idx', '?')}")
    if not active:
        lines.append("  none")

    recent = health.alerts(kv)[-max_alerts:]
    lines.append("")
    lines.append(f"recent alert records (last {len(recent)}):")
    for a in recent:
        age = now - float(a.get("wall", now))
        lines.append(f"  {age:7.1f}s ago  [{a.get('rule', '?')}] "
                     f"{a.get('subject', '?')}")
    if not recent:
        lines.append("  none")

    # -- postmortem pointers -------------------------------------------------
    trace_dir = os.environ.get("TPU_SANDBOX_TRACE_DIR", "")
    if recent:
        lines.append("")
        if trace_dir:
            oldest = now - float(recent[0].get("wall", now)) + 5.0
            lines.append("postmortem: python -m "
                         "tpu_sandbox_torch.tools.tracecat "
                         f"{trace_dir} --last {max(oldest, 5.0):.0f}s")
        else:
            lines.append("postmortem: set TPU_SANDBOX_TRACE_DIR and rerun "
                         "with tracing to get causal timelines")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="fleetop", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--host", default="127.0.0.1",
                    help="KV store host (default 127.0.0.1)")
    ap.add_argument("--port", type=int, required=True,
                    help="KV store port")
    ap.add_argument("--watch", type=float, metavar="SECONDS", default=None,
                    help="refresh every N seconds until interrupted")
    args = ap.parse_args(argv)

    kv = KVClient(args.host, args.port)
    if args.watch is None:
        print(render(kv))
        return 0
    try:
        while True:
            out = render(kv)
            sys.stdout.write("\x1b[2J\x1b[H" + out + "\n")
            sys.stdout.flush()
            time.sleep(args.watch)
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())
