"""tick_p95_ms: the 95th percentile over every tick of the window, each
timed on the host from the entry's call until its wheel targets are on
the host (the 10 Hz control deadline the robots feel)."""

from port_bench.harness import stats


def read(run):
    if not run.ticks:
        return None
    return stats.p95([t["ms"] for t in run.ticks])
