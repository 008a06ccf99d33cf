"""The arithmetic of the end-to-end metrics and of the trace."""

from __future__ import annotations

import statistics
from typing import Iterable, List, Sequence, Tuple


def rate(work: float, seconds: float) -> float:
    """Work over the whole window's seconds."""
    return work / seconds


def p95(values: Sequence[float]) -> float:
    """The 95th percentile of every value (inclusive quantiles, so one
    value gives itself)."""
    if len(values) == 1:
        return float(values[0])
    return statistics.quantiles(values, n=20, method="inclusive")[18]


def union_length(spans: Iterable[Tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals: overlaps once."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def gaps(spans: Iterable[Tuple[float, float]], start: float,
         end: float) -> List[Tuple[float, float]]:
    """The idle intervals of [start, end] that no span covers."""
    out, cur = [], start
    for s, e in sorted(spans):
        if s > cur:
            out.append((cur, min(s, end)))
        cur = max(cur, e)
        if cur >= end:
            break
    if cur < end:
        out.append((cur, end))
    return [(s, e) for s, e in out if e > s]
