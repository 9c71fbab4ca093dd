"""tracecat — merge flight-recorder logs and render them. The port's
copy of the repo's ``tools/tracecat.py``: the same flags and output.

Reads a directory of per-process recorder JSONL files (written wherever
``TPU_SANDBOX_TRACE_DIR`` pointed), merges them onto one clock via the
KV-sequencer calibration, and renders one of:

    python -m tpu_sandbox_torch.tools.tracecat LOGDIR --out trace.json
        Chrome/Perfetto trace-event JSON. Open at https://ui.perfetto.dev
        (or chrome://tracing): one track per process, spans nested,
        fault injections as instant events.

    python -m tpu_sandbox_torch.tools.tracecat LOGDIR --rid r0007
        Per-request waterfall: every span of that request's trace,
        ordered and indented by causal depth. Spans on the request's
        critical path are marked ``*``; spans whose parent never landed
        (leaked span, torn log) carry an ``[orphan]`` tag. A where-did-
        the-time-go segment line follows the waterfall.

    python -m tpu_sandbox_torch.tools.tracecat LOGDIR --critpath [FILE]
        Run-level critical-path profile: where the run's request time
        went, segment by segment (obs/critpath.py). With FILE, also
        write the profile JSON — the input ``tpu_sandbox_torch.tools.tracediff``
        gates
        on.

    python -m tpu_sandbox_torch.tools.tracecat LOGDIR --last 10s
        Postmortem: causally-ordered text timeline of the final N
        seconds before the logs went quiet — kills, lease expiries,
        scavenge requeues, in order, across every process.

With no mode flag it prints a summary: processes, record counts,
dropped (torn/corrupt) lines, trace chains and their integrity.
"""

from __future__ import annotations

import argparse
import json
import sys

from tpu_sandbox_torch.obs import collect, critpath


def _parse_seconds(text: str) -> float:
    text = text.strip().lower()
    if text.endswith("s"):
        text = text[:-1]
    return float(text)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tracecat", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("logdir", help="directory of recorder *.jsonl files")
    ap.add_argument("--out", metavar="FILE",
                    help="write merged Chrome trace-event JSON here")
    ap.add_argument("--rid", metavar="RID",
                    help="print the waterfall for one request id")
    ap.add_argument("--trace", metavar="TRACE_ID",
                    help="print the waterfall for one trace id")
    ap.add_argument("--critpath", metavar="FILE", nargs="?", const="-",
                    help="print the run's critical-path profile; with "
                         "FILE, also write the profile JSON for "
                         "tracediff")
    ap.add_argument("--last", metavar="DUR",
                    help="print the postmortem timeline of the final "
                         "window, e.g. --last 10s")
    args = ap.parse_args(argv)

    stats: dict = {}
    logs = collect.load_dir(args.logdir, stats)
    if not logs:
        print(f"no recorder logs under {args.logdir}", file=sys.stderr)
        return 1
    offsets = collect.clock_offsets(logs)
    merged = collect.merge(logs, offsets)

    did_something = False
    if args.out:
        trace = collect.to_chrome_trace(merged)
        with open(args.out, "w", encoding="utf-8") as fh:
            json.dump(trace, fh)
        print(f"wrote {len(trace['traceEvents'])} events to {args.out} "
              f"(open at https://ui.perfetto.dev)")
        did_something = True
    if args.rid or args.trace:
        rows = collect.request_waterfall(merged, rid=args.rid,
                                         trace=args.trace)
        if not rows:
            print("no matching trace", file=sys.stderr)
            return 1
        trace_id = rows[0]["trace"]
        records = [r for r in merged if r.get("trace") == trace_id]
        crit = {r.get("span") for r in critpath.critical_path(records)
                if r.get("span")}
        print(collect.format_waterfall(rows, crit=crit))
        stalls = [r for r in merged if r.get("ph") == "X"
                  and r.get("name", "").startswith("swap:")]
        req = critpath.attribute_request(records, stalls)
        if req is not None:
            segs = sorted(req["segments"].items(), key=lambda kv: -kv[1])
            print(f"  critical path ({req['outcome']}, "
                  f"wall {req['wall_s'] * 1e3:.3f}ms, coverage "
                  f"{req['coverage']:.1%}): " + ", ".join(
                      f"{seg}={s * 1e3:.3f}ms" for seg, s in segs))
            if req["outcome"] != "ok" and req.get("blame"):
                print(f"  blame: {req['blame']}")
        did_something = True
    if args.critpath:
        result = critpath.analyze(merged)
        print(critpath.format_profile(result["profile"]))
        if args.critpath != "-":
            critpath.save_profile(result["profile"], args.critpath)
            print(f"wrote profile to {args.critpath}")
        did_something = True
    if args.last:
        window = collect.last_window(merged, _parse_seconds(args.last))
        print(collect.format_timeline(window))
        did_something = True

    if not did_something:
        print(f"{len(logs)} process logs, {len(merged)} records, "
              f"{stats.get('dropped_records', 0)} dropped lines")
        for key in sorted(logs):
            print(f"  {key}: {len(logs[key])} records "
                  f"(offset {offsets.get(key, 0.0):+.6f}s)")
        chains = collect.trace_chains(merged)
        ok = sum(1 for recs in chains.values()
                 if collect.chain_check(recs)["connected"])
        print(f"{len(chains)} traces, {ok} fully connected")
    return 0


if __name__ == "__main__":
    sys.exit(main())
