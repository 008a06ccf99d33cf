"""`python -m jax_mapping_torch.obs` — the postmortem CLI.

Port of the JAX package's `obs/__main__.py`, with its subcommands (pure
stdlib, fast start; only `cost-ledger` imports torch). The dumps and
streams are the same format in both packages, so either CLI reads either
package's dumps.

    diff A.json B.json     Trace-diff two flight-recorder dumps (or raw
                           {"events": [...], "spans": [...]} documents)
                           from two same-seed runs; prints the first
                           divergence point per stream. Exit 0 when
                           identical, 1 on divergence, 2 on usage.
    export DUMP [-o OUT]   Convert a flight-recorder dump to a Chrome-
                           trace/Perfetto JSON (default OUT:
                           DUMP + ".trace.json").
    critical-path DUMP [BASELINE]
                           Walk a dump's `pipeline` section (the
                           latency ledger's completed-revision records,
                           obs/pipeline.py) and report the per-revision
                           scan→served critical path — which hop
                           (fuse / notify / encode / deliver) dominated
                           each revision, aggregate hop shares, and the
                           slowest revisions. With BASELINE, diff the
                           two runs' records through obs/diff.py
                           normalization (hop durations and the
                           dominance they imply are volatile; the
                           deterministic structure — revision, tick,
                           tenant sequence — must match for two
                           same-seed runs). Exit 0 identical/ok, 1 on
                           structural divergence, 2 on usage/no
                           records.
    cost-ledger [-o OUT] [--budget JSON] [--device DEV]
                           Drive the canonical compile-budget scenario
                           (analysis/compilebudget.py measure_scenario)
                           under the dispatch profiler on DEV (default cuda),
                           collect the cost ledger (FLOPs, bytes per
                           entry point and variant) and print it as
                           JSON (or write it to OUT). With --budget,
                           cross-check it against that compile budget:
                           exit 1 on violations.

Postmortem workflow: a chaos gate fails -> the
recorder auto-dumped to the checkpoint dir -> `diff` the failing run's
dump against a green same-seed run's to get the first divergent
transition instead of a grid diff.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

from jax_mapping_torch.obs.diff import diff_dumps
from jax_mapping_torch.obs.export import dump_to_chrome


def _load(path: str) -> dict:
    with open(path) as f:
        doc = json.load(f)
    if not isinstance(doc, dict):
        raise ValueError(f"{path}: expected a JSON object")
    return doc


def _critical_path(dump_path: str, baseline_path: Optional[str]) -> int:
    """The critical-path analyzer (see module docstring)."""
    from jax_mapping_torch.obs.diff import VOLATILE_FIELDS, diff_streams
    from jax_mapping_torch.obs.pipeline import HOPS, RECORD_VOLATILE
    recs = _load(dump_path).get("pipeline") or []
    if not recs:
        print("no pipeline records in dump (ledger absent, or no "
              "revision completed a client delivery)", file=sys.stderr)
        return 2
    dominant = {}
    hop_total = {}
    for r in recs:
        dominant[r.get("critical")] = \
            dominant.get(r.get("critical"), 0) + 1
        for hop, ms in (r.get("hops_ms") or {}).items():
            hop_total[hop] = hop_total.get(hop, 0.0) + ms
    total = sum(hop_total.values()) or 1.0
    print(f"{len(recs)} completed revision(s), "
          f"{len({r.get('tenant', '') for r in recs})} tenant "
          f"namespace(s)")
    print("hop shares (summed hop time; dominant = revisions this hop "
          "was the critical one):")
    for hop in list(HOPS) + sorted(set(hop_total) - set(HOPS)):
        if hop not in hop_total:
            continue
        print(f"  {hop:<8} {hop_total[hop]:>10.1f} ms "
              f"({100.0 * hop_total[hop] / total:5.1f}%)  "
              f"dominant in {dominant.get(hop, 0)} revision(s)")
    slowest = sorted(recs, key=lambda r: -r.get("total_ms", 0.0))[:5]
    print("slowest revisions (scan→served):")
    for r in slowest:
        tenant = r.get("tenant") or "-"
        print(f"  rev {r.get('revision')} (tenant {tenant}, tick "
              f"{r.get('tick')}): {r.get('total_ms', 0.0):.1f} ms, "
              f"critical hop = {r.get('critical')}")
    if baseline_path is None:
        return 0
    base = _load(baseline_path).get("pipeline") or []
    div = diff_streams(recs, base,
                       ignore=tuple(VOLATILE_FIELDS)
                       + tuple(RECORD_VOLATILE))
    if div is None:
        print("baseline: structurally identical (same revision/tick/"
              "tenant sequence; hop timings are volatile by design)")
        return 0
    print("baseline: " + div.describe())
    return 1


def _cost_ledger(out: Optional[str], budget: Optional[str],
                 device: str) -> int:
    """The cost-ledger subcommand (see module docstring)."""
    import contextlib

    from jax_mapping_torch._util import resolve_device
    from jax_mapping_torch.obs.ledger import run_cost_ledger
    try:
        resolve_device(device)          # no card: say so, no fallback
    except RuntimeError as ex:
        print(f"cost-ledger: {ex}", file=sys.stderr)
        return 2
    # The stack logs bring-up lines to stdout: keep stdout one document.
    with contextlib.redirect_stdout(sys.stderr):
        measured, profiler, ledger = run_cost_ledger(device=device)
    doc = {"measured": measured, "recompiles": profiler.recompiles(),
           "dispatch": profiler.snapshot(), "ledger": ledger.snapshot()}
    viol = []
    if budget is not None:
        viol = ledger.cross_check(budget)
        doc["violations"] = viol
    text = json.dumps(doc, indent=1, sort_keys=True)
    if out:
        with open(out, "w") as f:
            f.write(text + "\n")
        print(f"wrote {out} ({len(doc['ledger'])} entry points)")
    else:
        print(text)
    for line in viol:
        print(line, file=sys.stderr)
    return 1 if viol else 0


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(
        prog="python -m jax_mapping_torch.obs",
        description="observability postmortem tools (trace-diff, "
                    "Perfetto export)")
    sub = p.add_subparsers(dest="cmd", required=True)
    d = sub.add_parser("diff", help="first divergence of two same-seed "
                                    "event/span streams")
    d.add_argument("a")
    d.add_argument("b")
    e = sub.add_parser("export", help="flight-recorder dump -> Chrome-"
                                      "trace/Perfetto JSON")
    e.add_argument("dump")
    e.add_argument("-o", "--out", default=None)
    c = sub.add_parser("cost-ledger",
                       help="FLOPs/bytes per entry point of the "
                            "canonical scenario")
    c.add_argument("-o", "--out", default=None)
    c.add_argument("--budget", default=None, metavar="JSON")
    c.add_argument("--device", default="cuda")
    k = sub.add_parser("critical-path",
                       help="per-revision scan→served critical path "
                            "from a dump's pipeline records")
    k.add_argument("dump")
    k.add_argument("baseline", nargs="?", default=None)
    try:
        args = p.parse_args(argv)
    except SystemExit as ex:
        return 2 if ex.code not in (0, None) else 0

    try:
        if args.cmd == "diff":
            res = diff_dumps(_load(args.a), _load(args.b))
            for stream in ("events", "spans"):
                div = res[stream]
                if div is None:
                    print(f"{stream}: identical")
                else:
                    print(f"{stream}: " + div.describe())
            return 0 if res["identical"] else 1
        if args.cmd == "export":
            out = args.out or (args.dump + ".trace.json")
            doc = dump_to_chrome(_load(args.dump))
            with open(out, "w") as f:
                json.dump(doc, f)
            print(f"wrote {out} ({len(doc['traceEvents'])} events)")
            return 0
        if args.cmd == "critical-path":
            return _critical_path(args.dump, args.baseline)
        if args.cmd == "cost-ledger":
            return _cost_ledger(args.out, args.budget, args.device)
    except (OSError, ValueError, KeyError) as ex:
        print(f"error: {ex}", file=sys.stderr)
        return 2
    return 2


if __name__ == "__main__":
    sys.exit(main())
