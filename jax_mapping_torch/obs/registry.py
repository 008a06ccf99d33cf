"""Declarative Prometheus exposition — the `/metrics` assembly as data.

A copy of the JAX package's `obs/registry.py` (pure Python): the port's
`bridge/http_api.py` renders `/metrics` through it.

The HTTP plane's `/metrics` used to be ~200 lines of hand-interleaved
f-strings in `bridge/http_api.py`: every new subsystem appended its own
`lines += [...]` block, ordering and formatting were implicit in code
flow, and nothing could enumerate "what metrics does this server
export". This module replaces that with a registry of declared metric
FAMILIES: each family is `(name, type, collect)` where `collect`
returns the family's samples (or None to omit it this render — the
conditional-subsystem pattern), and multi-family sources share one
consistent snapshot (e.g. everything under the HTTP stats lock).

The render contract is BYTE-compatibility: registration order is
exposition order, values are pre-formatted strings, so the refactored
`/metrics` reproduces the historical document exactly for every family
that existed before it (pinned by tests) — dashboards and scrape
configs survive the refactor untouched. New families (bus subscription
health, stage-latency histograms, obs counters) append after the
historical tail.

Helpers `histogram_samples`/`summary_samples` encode the exposition
shapes the repo uses (cumulative `_bucket{le=}` lines + `_sum`/`_count`;
the `_ms` summary family) so a new histogram cannot get the cumulative
sum wrong in one hand-rolled copy.
"""

from __future__ import annotations

import threading
from typing import Callable, Iterable, List, NamedTuple, Optional, Tuple

#: One sample line: (suffix appended to the family name — labels and/or
#: a `_bucket`/`_sum`/`_count` series suffix — and the pre-formatted
#: value string).
Sample = Tuple[str, str]


class Family(NamedTuple):
    """One `# TYPE` block: header + its sample lines."""

    name: str
    mtype: str                        # counter | gauge | histogram | summary
    samples: Tuple[Sample, ...]


class MetricsRegistry:
    """Ordered registry of metric sources.

    A *source* is a callable returning an iterable of `Family` (or
    None/() to emit nothing) — one source may emit several families
    from one consistent snapshot. `family(...)` is the single-family
    convenience. `render()` walks sources in registration order.
    """

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._sources: List[Callable[[], Optional[Iterable[Family]]]] = []

    def add_source(self, fn: Callable[[], Optional[Iterable[Family]]]
                   ) -> "MetricsRegistry":
        with self._lock:
            self._sources.append(fn)
        return self

    def family(self, name: str, mtype: str,
               collect: Callable[[], Optional[Iterable[Sample]]]
               ) -> "MetricsRegistry":
        """Declare one family; `collect` returns its samples, or None
        to omit the whole family (absent subsystem)."""
        def src() -> Optional[Iterable[Family]]:
            samples = collect()
            if samples is None:
                return None
            return (Family(name, mtype, tuple(samples)),)
        return self.add_source(src)

    def render(self) -> str:
        with self._lock:
            sources = list(self._sources)
        lines: List[str] = []
        for src in sources:
            for fam in (src() or ()):
                lines.append(f"# TYPE {fam.name} {fam.mtype}")
                for suffix, value in fam.samples:
                    lines.append(f"{fam.name}{suffix} {value}")
        return "\n".join(lines) + "\n"


def histogram_samples(edges, counts, total, count,
                      le_fmt: Callable[[float], str] = str,
                      sum_fmt: str = "{:.6f}") -> List[Sample]:
    """Cumulative `_bucket{le=}` lines + `+Inf` + `_sum`/`_count` from
    per-bucket counts (`counts` has len(edges)+1 entries, the last the
    overflow bucket)."""
    out: List[Sample] = []
    cum = 0
    for le, n in zip(edges, counts):
        cum += n
        out.append((f'_bucket{{le="{le_fmt(le)}"}}', str(cum)))
    out.append(('_bucket{le="+Inf"}', str(cum + counts[-1])))
    out.append(("_sum", sum_fmt.format(total)))
    out.append(("_count", str(count)))
    return out


def summary_samples(count, total, fmt: str = "{:.3f}") -> List[Sample]:
    """The repo's `_count`/`_sum` summary shape (stage `_ms` families)."""
    return [("_count", str(count)), ("_sum", fmt.format(total))]


def labeled_histogram_samples(labels: str, edges, counts, total, count,
                              le_fmt: Callable[[float], str] = str,
                              sum_fmt: str = "{:.6f}") -> List[Sample]:
    """`histogram_samples` with a fixed label set on every series —
    ONE histogram family sliced by label (the devprof per-function
    dispatch family: `..._bucket{fn="x",le="0.001"}`) instead of a
    family per slice. `labels` is the pre-rendered inner label string
    (e.g. `fn="jax_mapping.ops.grid.fuse_scans_window"`)."""
    out: List[Sample] = []
    cum = 0
    for le, n in zip(edges, counts):
        cum += n
        out.append((f'_bucket{{{labels},le="{le_fmt(le)}"}}', str(cum)))
    out.append((f'_bucket{{{labels},le="+Inf"}}',
                str(cum + counts[-1])))
    out.append((f"_sum{{{labels}}}", sum_fmt.format(total)))
    out.append((f"_count{{{labels}}}", str(count)))
    return out
