"""The readings the limits of `correct` are set from: for each seed, the
program's numbers against the reference and the control's.

    python3 -m port_bench.control.readings --workload <cell> \
        --seconds <s> --seeds <n> [<n> ...] [--out <file>]

runs the cell once a seed, in one process, with a short window, and for
every kept tick also steps the control (the reference with the matcher's
correlations in bfloat16, below the configuration's float32 with TF32
off) and compares it with the reference. One JSON line a seed: `program`
and `control`, each number's worst over the run's checked ticks, and
`correct` and `control_correct`, each the harness's own comparison of
those numbers with the configuration's limits (the control's is
expected false). The benchmark's own runs never run the control.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from port_bench.harness import driver
    from port_bench.harness.registry import Registry
    import torch
    if not torch.cuda.is_available():
        print("readings: needs a CUDA device", file=sys.stderr)
        return 2
    registry = Registry(ROOT / "BENCHMARK.json")
    cell = registry.cell(args.workload)
    sink = open(args.out, "a") if args.out else None
    try:
        for seed in args.seeds:
            t0 = time.perf_counter()
            out = driver.run_cell(cell, registry, seed, args.seconds,
                                  False, t0, control=True)
            limits = cell.config["limits"]
            line = json.dumps({
                "workload": args.workload, "seed": seed,
                "correct": out["correct"],
                "control_correct": driver.passes(out["control"], limits),
                "program": {k: v["value"] for k, v in out["checks"].items()},
                "control": out["control"], "window": out["window"],
                "metrics": {k: v["value"]
                            for k, v in out["metrics"].items()}})
            print(line, flush=True)
            if sink:
                print(line, file=sink, flush=True)
    finally:
        if sink:
            sink.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
