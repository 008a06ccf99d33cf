"""Shared arithmetic of the metric readers (`metrics/<name>.py`).

A reader returns a number, or None when the run gave it nothing to read
(no trace, no call of its functions); the harness then leaves the metric
out of the result line."""

from __future__ import annotations

from typing import Callable, Optional

from port_bench.harness import costs, stats


def range_ms_per_tick(run, name: str) -> Optional[float]:
    """Device time launched inside range `name` over the profiled ticks
    (the union of its spans, so overlapping streams count once), in ms a
    tick."""
    r = run.reading
    if r is None or not run.profiled_ticks:
        return None
    spans = r.range_spans.get(name)
    if not spans:
        return None
    return stats.union_length(spans) / 1e3 / run.profiled_ticks


def roofline(run, name: str, cost: Callable) -> Optional[float]:
    """Least time over measured device time, in %, for the calls of range
    `name` in the profiled ticks: sum over calls of the larger of bytes
    over the memory bandwidth and operations over the float32 rate, over
    the device seconds those calls launched."""
    r = run.reading
    calls = run.captures.get(name) or []
    if r is None or not calls:
        return None
    seconds = r.range_seconds.get(name, 0.0)
    if seconds <= 0.0:
        return None
    least = sum(costs.least_seconds(*cost(c)) for c in calls)
    return 100.0 * least / seconds

