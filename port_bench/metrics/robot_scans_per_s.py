"""robot_scans_per_s: LiDAR scans of active robots carried through whole
ticks (sensed, gated, matched, fused, planned, wheel targets on the
host), summed over the window, over the window's seconds."""

from port_bench.harness import stats


def read(run):
    if not run.ticks or run.window_s <= 0:
        return None
    return stats.rate(sum(t["carried"] for t in run.ticks), run.window_s)
