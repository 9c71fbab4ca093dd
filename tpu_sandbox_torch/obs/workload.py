"""The canonical replayable workload trace: what arrived, when, and how
it ended — the input half of a serving run, separated from how the fleet
handled it. The port's copy of ``tpu_sandbox/obs/workload.py``: the same
schema and the same canonical bytes.

ROADMAP item 6's cluster twin replays these against a simulated fleet;
for that to mean anything the export must be (a) derivable from any
merged flight-recorder trace, (b) schema-versioned so a twin built next
quarter refuses a trace it cannot interpret, and (c) **canonical**: the
same logical workload always serializes to the same bytes, so traces
diff cleanly and a parse → re-export round trip is the identity.

One record per request:

- ``t_s``       arrival relative to the first request, seconds (6 dp)
- ``rid``       the request id
- ``tenant``    traffic owner — fleets are single-tenant today, so this
                carries the fleet label until a real tenancy axis lands
- ``fleet``     serving fleet label
- ``chain``     deepest prefix-chain block hash (the routing key — two
                requests sharing it share a cacheable prefix)
- ``prompt_tokens`` / ``decode_tokens``  size of the ask and the answer
- ``outcome``   ``ok`` | ``door:<reason>`` | ``shed:<reason>`` | ``open``
- ``deadline_s``  the SLO the client attached, when it attached one

All fields come from span args the gateway and engine already stamp
(``route`` carries ``plen``/``chain``/``fleet``/``deadline_s``;
``decode`` carries ``tokens``; the terminal verdict carries the
outcome), so export is a pure function of the merged record list.
"""

from __future__ import annotations

import json
import random

from tpu_sandbox_torch.obs import critpath

#: bump on any field change; loaders hard-reject unknown versions
SCHEMA = "tpu-sandbox.workload/1"

_FIELDS = ("t_s", "rid", "tenant", "fleet", "chain",
           "prompt_tokens", "decode_tokens", "outcome", "deadline_s")


def from_trace(merged: list[dict], *, source: str = "") -> dict:
    """Derive the workload trace from a merged record list. Requests are
    ordered by (arrival, rid) — the replay order — so the export is
    deterministic for a given trace."""
    rid_to_trace = critpath.request_traces(merged)
    by_trace: dict[str, list[dict]] = {}
    for r in merged:
        t = r.get("trace")
        if t:
            by_trace.setdefault(t, []).append(r)
    rows = []
    t_first = None
    for rid, trace in rid_to_trace.items():
        recs = by_trace.get(trace, [])
        submit = next((r for r in recs if r.get("name") == "submit"), None)
        route = next((r for r in recs if r.get("name") == "route"), None)
        arrival = float((submit or (recs[0] if recs else {})).get("uts", 0.0))
        if t_first is None or arrival < t_first:
            t_first = arrival
        rargs = (route.get("args") or {}) if route else {}
        decode = next((r for r in recs if r.get("name") == "decode"), None)
        term = critpath._terminal(recs) if recs else {}
        outcome = "open"
        name = term.get("name", "")
        fam = critpath._family(name)
        if fam in ("door", "shed"):
            outcome = name
        elif name == "verdict":
            v = str((term.get("args") or {}).get("verdict", "ok"))
            outcome = "ok" if v.lower() == "ok" else f"shed:{v}"
        fleet = str(rargs.get("fleet", "default"))
        deadline = rargs.get("deadline_s")
        rows.append({
            "t_s": arrival,  # absolute for now; rebased below
            "rid": str(rid),
            "tenant": fleet,
            "fleet": fleet,
            "chain": str(rargs.get("chain", "")),
            "prompt_tokens": int(rargs.get("plen", 0)),
            "decode_tokens": int((decode.get("args") or {}).get("tokens", 0))
            if decode else 0,
            "outcome": outcome,
            "deadline_s": None if deadline is None
            else round(float(deadline), 6),
        })
    base = t_first or 0.0
    for row in rows:
        row["t_s"] = round(row["t_s"] - base, 6)
    rows.sort(key=lambda r: (r["t_s"], r["rid"]))
    return {"schema": SCHEMA, "source": source, "requests": rows}


def synthesize(seed: int, n: int, *, duration_s: float = 1.0,
               fleet: str = "", n_chains: int = 4,
               prompt_tokens: tuple[int, int] = (12, 48),
               decode_tokens: tuple[int, int] = (4, 16),
               deadline_s: float | None = None) -> dict:
    """A seeded canonical workload: ``n`` arrivals over ``duration_s``,
    each tagged with one of ``n_chains`` shared prefix chains (so a
    replayed fleet has real prefix-affinity structure to route on). Same
    seed, same trace, byte for byte — the chaos harness replays these
    against a live fleet and compares audits across runs, which only
    means something if the input side is pinned. Outcomes are ``open``:
    a synthesized trace records what arrives, not how a fleet will
    answer it."""
    rng = random.Random(seed)
    rows = []
    for i in range(n):
        rows.append({
            "t_s": round(rng.uniform(0.0, duration_s), 6),
            "rid": f"c{seed}-r{i:04d}",
            "tenant": fleet or "default",
            "fleet": fleet or "default",
            "chain": f"chain{rng.randrange(n_chains)}",
            "prompt_tokens": rng.randint(*prompt_tokens),
            "decode_tokens": rng.randint(*decode_tokens),
            "outcome": "open",
            "deadline_s": deadline_s,
        })
    rows.sort(key=lambda r: (r["t_s"], r["rid"]))
    # rebase so the first arrival is t=0, like a from_trace export
    base = rows[0]["t_s"] if rows else 0.0
    for row in rows:
        row["t_s"] = round(row["t_s"] - base, 6)
    return {"schema": SCHEMA, "source": f"synthesized:seed={seed}",
            "requests": rows}


def dumps(trace: dict) -> str:
    """Canonical bytes: sorted keys, compact separators, one trailing
    newline. ``loads(dumps(t))`` then ``dumps`` again is byte-identical
    — floats were already rounded at build time and JSON round-trips
    them exactly."""
    _validate(trace)
    return json.dumps(trace, sort_keys=True, separators=(",", ":")) + "\n"


def loads(text: str) -> dict:
    trace = json.loads(text)
    _validate(trace)
    return trace


def save(trace: dict, path: str) -> None:
    with open(path, "w", encoding="utf-8") as fh:
        fh.write(dumps(trace))


def load(path: str) -> dict:
    with open(path, "r", encoding="utf-8") as fh:
        return loads(fh.read())


def replay_order(trace: dict) -> list[dict]:
    """Requests in arrival order — what a twin feeds its open-loop
    load generator. Already the storage order; re-sorted here so a hand-edited
    trace still replays correctly."""
    return sorted(trace["requests"], key=lambda r: (r["t_s"], r["rid"]))


def _validate(trace: dict) -> None:
    if not isinstance(trace, dict) or trace.get("schema") != SCHEMA:
        raise ValueError(
            f"unknown workload schema {trace.get('schema')!r} "
            f"(this reader understands {SCHEMA})")
    for i, row in enumerate(trace.get("requests", ())):
        missing = [f for f in _FIELDS if f not in row]
        if missing:
            raise ValueError(f"request[{i}] missing fields {missing}")
        if not isinstance(row["t_s"], (int, float)) or row["t_s"] < 0:
            raise ValueError(f"request[{i}] bad arrival {row['t_s']!r}")
