"""tracediff — gate a run's critical-path profile against a baseline.
The port's copy of the repo's ``tools/tracediff.py``: the same flags,
output and exit codes.

Compares two runs segment-by-segment (gateway route, queue wait,
prefill, decode, publish, …) and exits nonzero when a segment regressed
significantly — the perf gate a bench or CI job puts after its workload.

    python -m tpu_sandbox_torch.tools.tracediff BASELINE CANDIDATE
        Each argument is either a critpath profile JSON (written by
        ``tracecat --critpath FILE`` or the bench archive hook) or a raw
        trace directory, which is analyzed on the fly.

    python -m tpu_sandbox_torch.tools.tracediff A B --threshold 0.10 --min-ms 0.5
        A segment REGRESSES when its quantile-paired median-of-ratios
        exceeds 1 + threshold AND its median grew by at least --min-ms
        AND it carries at least --min-share of either run's wall. The
        median of ratios — not a ratio of means — is the point: one
        straggler request cannot fail the build, a distribution-wide 20%
        decode slowdown will.

Exit status: 0 clean, 1 regression(s), 2 bad input.
"""

from __future__ import annotations

import argparse
import json
import sys

from tpu_sandbox_torch.obs import critpath


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="tracediff", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("baseline", help="profile JSON or trace dir (the "
                                     "run to compare against)")
    ap.add_argument("candidate", help="profile JSON or trace dir (the "
                                      "run under test)")
    ap.add_argument("--threshold", type=float, default=0.10,
                    help="relative growth that counts as a regression "
                         "(default 0.10 = +10%%)")
    ap.add_argument("--min-ms", type=float, default=0.5,
                    help="noise floor: ignore segments whose median "
                         "grew less than this many ms (default 0.5)")
    ap.add_argument("--min-share", type=float, default=0.01,
                    help="noise floor: ignore segments carrying less "
                         "than this share of wall (default 0.01)")
    ap.add_argument("--json", action="store_true",
                    help="emit the comparison as JSON instead of a table")
    args = ap.parse_args(argv)

    try:
        base = critpath.load_profile(args.baseline)
        cand = critpath.load_profile(args.candidate)
    except (OSError, ValueError) as e:
        print(f"tracediff: {e}", file=sys.stderr)
        return 2

    cmp = critpath.compare_profiles(
        base, cand, threshold=args.threshold,
        min_ms=args.min_ms, min_share=args.min_share)
    if args.json:
        print(json.dumps(cmp, sort_keys=True))
    else:
        print(critpath.format_compare(cmp))
    return 1 if cmp["regressions"] else 0


if __name__ == "__main__":
    sys.exit(main())
