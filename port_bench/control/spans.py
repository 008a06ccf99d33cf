"""The port's own stage spans in a traced run of a cell, beside the
harness's ranges over the same layers.

    python3 -m port_bench.control.spans --workload <cell> \
        --seconds <s> --seeds <n> [<n> ...] [--out <file>]

runs the cell once a seed with the trace on, keeps the profiler's trace
and reads the port's spans from it (`harness/spans.py`). One JSON line a
seed:

- `metrics`: the run's per-layer metrics, as the benchmark prints them;
- `span_device_ms`, `span_idle_ms`: each span's device work and the
  device idle inside it, in ms a profiled tick;
- `span_metrics`: the matcher's parts (`match.field`, `match.search`,
  `match.refine`), the idle inside `tick.match` and `tick.frontier`, and
  the idle inside an entry span but inside no stage span;
- `vs_ranges`: the program's spans over the harness's ranges of the same
  layers, in %;
- `key_share`: by the port's counters, and by the key flags of the same
  ticks (both over every tick of the process);
- `ticks`: the profiled and the unprofiled ticks' mean ms, and the
  window's tick p50;
- `waits_per_tick`: the device copies (DtoH, HtoD) and synchronising
  calls a profiled tick, by the innermost span they lie in.
"""

import argparse
import json
import statistics
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent.parent

#: Span -> the harness range it is held to, and the ratio's name.
PAIRS = (("tick.match", "match.device_ms_per_tick"),
         ("tick.fuse", "fuse.device_ms_per_tick"),
         ("tick.frontier", "frontier.device_ms_per_tick"))


def _ms(values):
    return statistics.fmean(values) if values else None


def _pct(a, b):
    return None if a is None or not b else 100.0 * a / b


def report(out: dict, run, reading, keys: list) -> dict:
    """The line of one traced run (see the module's docstring)."""
    from jax_mapping_torch.utils.profiling import global_metrics

    from port_bench.harness import spans as S
    n = run.profiled_ticks
    dev = {k: S.device_ms_per_tick(reading, k, n)
           for k in sorted(reading.device)} if reading else {}
    idle = {k: S.idle_ms_per_tick(reading, [k], n)
            for k in sorted(reading.host)} if reading else {}
    m = {k: v["value"] for k, v in out["metrics"].items()}
    parts = [dev.get(k) for k in ("match.field", "match.search",
                                  "match.refine")]
    span_metrics = {
        "match.field.device_ms_per_tick": parts[0],
        "match.search.device_ms_per_tick": parts[1],
        "match.refine.device_ms_per_tick": parts[2],
        "match.device_idle_ms_per_tick": idle.get("tick.match"),
        "frontier.device_idle_ms_per_tick": idle.get("tick.frontier"),
        "tick.unstaged_idle_ms_per_tick":
            S.unstaged_idle_ms_per_tick(reading, n)}
    vs = {f"{s}/{r}": _pct(dev.get(s), m.get(r)) for s, r in PAIRS}
    vs["match.parts/match.device_ms_per_tick"] = _pct(
        sum(parts) if None not in parts else None,
        m.get("match.device_ms_per_tick"))
    sim = [dev.get("tick.sim"), dev.get("tick.motion")]
    vs["tick.sim+tick.motion/sim.device_ms_per_tick"] = _pct(
        sum(x or 0.0 for x in sim), m.get("sim.device_ms_per_tick"))
    counts = global_metrics.counters
    matched = counts.get("tick.scans_matched")
    flags = sum(int(k.sum()) for k in keys)
    robots = sum(k.numel() for k in keys)
    ms = [t["ms"] for t in run.ticks]
    return {
        "metrics": m, "span_device_ms": dev, "span_idle_ms": idle,
        "span_metrics": span_metrics, "vs_ranges": vs,
        "key_share": {
            "counters": _pct(counts.get("tick.scans_fused"), matched),
            "key_flags": _pct(flags, robots),
            "scans_matched": matched, "robot_ticks": robots},
        "ticks": {"profiled": n, "profiled_mean_ms": _ms(ms[:n]),
                  "unprofiled": len(ms) - n,
                  "unprofiled_mean_ms": _ms(ms[n:]),
                  "p50_ms": out["window"]["tick_ms_p50"]},
        "waits_per_tick": {k: {w: c / n for w, c in v.items()}
                           for k, v in sorted(reading.waits.items())}
        if reading and n else {},
        "correct": out["correct"], "device": out["device"]}


def runs(cell, registry, seeds, seconds: float, device: str = "cuda"):
    """Yield the line of each seed's traced run of `cell`."""
    from jax_mapping_torch.models import fleet as FL

    from port_bench.harness import driver, spans, trace
    box, keys = {}, []
    read_trace, result, sense = trace.read_trace, driver._result, \
        FL._tick_sense

    def keep_spans(path, names):
        box["spans"] = spans.read_spans(path)
        return read_trace(path, names)

    def keep_run(run, *rest):
        box["run"] = run
        return result(run, *rest)

    def keep_keys(*a, **kw):
        out = sense(*a, **kw)
        keys.append(out.is_key)         # summed after the run: no sync
        return out

    trace.read_trace, driver._result, FL._tick_sense = \
        keep_spans, keep_run, keep_keys
    try:
        for seed in seeds:
            box.clear()
            out = driver.run_cell(cell, registry, seed, seconds, True,
                                  time.perf_counter(), device=device)
            yield {"workload": cell.name, "seed": seed,
                   "card": driver.card(),
                   **report(out, box["run"], box.get("spans"), keys)}
    finally:
        trace.read_trace, driver._result, FL._tick_sense = \
            read_trace, result, sense


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    import torch

    from port_bench.harness.registry import Registry
    if not torch.cuda.is_available():
        print("spans: needs a CUDA device", file=sys.stderr)
        return 2
    registry = Registry(ROOT / "BENCHMARK.json")
    cell = registry.cell(args.workload)
    sink = open(args.out, "a") if args.out else None
    try:
        for line in runs(cell, registry, args.seeds, args.seconds):
            text = json.dumps(line)
            print(text, flush=True)
            if sink:
                print(text, file=sink, flush=True)
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
