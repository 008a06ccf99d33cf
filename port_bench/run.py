"""Run one cell of the benchmark and print its result line.

    python3 -m port_bench.run --workload <cell> --seed <n> \
        --seconds <s> --trace <0|1>

from the root of a checkout. The last line of standard output is the
result: `correct`, `attempted`, `failed`, `metrics` (the cell's end-to-end
metrics, or with `--trace 1` its per-layer metrics), `device` and, traced,
`breakdown`; then `checks`, each number compared with its limit, which
also close standard error. The line before it gives the card (name,
power limit, clocks). The run exits non-zero, with no
result line, without a CUDA device, with fewer cards than the cell asks
for, or when the run has loaded JAX or the JAX package.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from port_bench.harness import driver, guard
    from port_bench.harness.registry import Registry
    registry = Registry(ROOT / "BENCHMARK.json")
    cell = registry.cell(args.workload)
    import torch
    need = int(cell.spec.get("chips", 1))
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < need:
        print(f"port_bench: needs {need} CUDA device(s), found {have}",
              file=sys.stderr)
        return 2
    out = driver.run_cell(cell, registry, args.seed, args.seconds,
                          bool(args.trace), T_START)
    bad = guard.forbidden_loaded()
    if bad:
        print(f"port_bench: the run loaded {bad}", file=sys.stderr)
        return 3
    print(json.dumps({"card": driver.card()}))
    driver.emit(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
