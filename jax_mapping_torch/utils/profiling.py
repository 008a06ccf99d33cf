"""Tracing, per-stage timing, and counters — the observability subsystem.

The reference has none of this: its diagnostics are bare prints and the
rclpy logger (SURVEY.md §5 "Tracing / profiling: none"); throughput was
judged by watching RViz. The port needs real instrumentation
because device work is asynchronous — wall-clock around a launch measures
the enqueue, not the kernel. Three tools:

  * `device_trace(dir)` — context manager around `torch.profiler` for
    host and CUDA traces viewable in TensorBoard/Perfetto;
  * `span(name)` — a named stage of the port's own code, an annotation in
    that trace while a profiler records and a no-op otherwise;
  * `StageTimer` — named wall-clock stages with count/mean/EWMA/max, for
    host-side loops (brain tick, mapper tick, HTTP handlers);
  * `Counters` — monotonic event counters (scans fused, drops, matches,
    loop closures) with atomic increment.

`global_metrics` is the process-wide registry the bridge nodes feed and the
HTTP `/metrics` endpoint serves (the reference's `/status` grown into a
proper metrics surface).
"""

from __future__ import annotations

import bisect
import contextlib
import threading
import time
from typing import Dict, Iterator, Optional, Tuple


class Counters:
    """Thread-safe monotonic counters.

    The fleet and megabatch ticks count here, from values the host
    already holds (no device read): `fleet.ticks`, `megabatch.ticks`,
    `megabatch.lanes_rerun`, `tick.scans_matched`, `tick.scans_fused`,
    `tick.loop_attempts`, `tick.loops_closed` and `tick.scans_refused`
    (scans re-fused after a closure)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counts: Dict[str, int] = {}

    def inc(self, name: str, by: int = 1) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + by

    def get(self, name: str) -> int:
        with self._lock:
            return self._counts.get(name, 0)

    def snapshot(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._counts)


#: Fixed log-spaced latency bucket edges (seconds): 0.25 ms doubling up
#: to ~8.2 s, + one overflow bucket. FIXED (not per-stage adaptive) so
#: histograms from two runs — or two same-seed chaos twins — are
#: directly comparable bucket-for-bucket, the FPGA-2D-LiDAR-SLAM
#: paper's stage-level pipeline-accounting idea applied host-side.
HIST_EDGES_S: Tuple[float, ...] = tuple(0.00025 * (2 ** k)
                                        for k in range(16))


class _Stage:
    __slots__ = ("count", "total_s", "ewma_s", "max_s", "buckets")

    def __init__(self) -> None:
        self.count = 0
        self.total_s = 0.0
        self.ewma_s = 0.0
        self.max_s = 0.0
        #: Per-bucket (non-cumulative) counts; [-1] is overflow.
        self.buckets = [0] * (len(HIST_EDGES_S) + 1)


class StageTimer:
    """Named wall-clock stages: `with timer.stage("fuse"): ...`.

    EWMA (alpha=0.1) gives a live rate estimate that survives startup
    outliers (first-jit compile); max catches stalls; the fixed
    log-bucket histogram (HIST_EDGES_S) is what p50/p99 dashboards and
    the `/metrics` `jax_mapping_stage_*_seconds` families read — an
    EWMA alone cannot answer "what fraction of ticks missed the
    control period".
    """

    def __init__(self, alpha: float = 0.1) -> None:
        self._lock = threading.Lock()
        self._stages: Dict[str, _Stage] = {}
        self.alpha = alpha

    @contextlib.contextmanager
    def stage(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.observe(name, time.perf_counter() - t0)

    def observe(self, name: str, dt_s: float) -> None:
        """Record one already-measured duration against a stage — the
        entry point for code that times a region itself (the
        incremental frontier pipeline's recompute, devprof dispatch
        attribution) but must still report through the ONE stage
        mechanism (`/metrics` summary + fixed log-bucket histogram
        families) instead of a hand-built gauge."""
        with self._lock:
            st = self._stages.setdefault(name, _Stage())
            st.count += 1
            st.total_s += dt_s
            st.max_s = max(st.max_s, dt_s)
            st.ewma_s = (dt_s if st.count == 1
                         else (1 - self.alpha) * st.ewma_s
                         + self.alpha * dt_s)
            # bisect_left: first edge >= dt, i.e. `le` semantics;
            # past the last edge lands in the overflow bucket.
            st.buckets[bisect.bisect_left(HIST_EDGES_S, dt_s)] += 1

    def snapshot(self) -> Dict[str, Dict[str, float]]:
        with self._lock:
            return {
                name: {
                    "count": st.count,
                    "sum_ms": 1e3 * st.total_s,
                    "mean_ms": 1e3 * st.total_s / max(st.count, 1),
                    "ewma_ms": 1e3 * st.ewma_s,
                    "max_ms": 1e3 * st.max_s,
                } for name, st in self._stages.items()
            }

    def histograms(self) -> Dict[str, Dict[str, object]]:
        """Per-stage fixed log-bucket histograms: {"edges_s": ...,
        "buckets": per-bucket counts (last = overflow), "sum_s",
        "count"} — the MetricsRegistry's stage-histogram source."""
        with self._lock:
            return {
                name: {
                    "edges_s": HIST_EDGES_S,
                    "buckets": list(st.buckets),
                    "sum_s": st.total_s,
                    "count": st.count,
                } for name, st in self._stages.items()
            }


class Metrics:
    """Process-wide bundle: counters + stage timers."""

    def __init__(self) -> None:
        self.counters = Counters()
        self.stages = StageTimer()

    def snapshot(self) -> dict:
        return {"counters": self.counters.snapshot(),
                "stages": self.stages.snapshot()}


global_metrics = Metrics()

#: torch.autograd.profiler, bound on the first span so that importing
#: this module imports no torch.
_profiler = None
_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A named stage of the port: `with span("tick.match"): ...`.

    While a `torch.profiler` records in this process, the span is a
    `record_function` range, an annotation in the profiler's own trace
    on its clock: device work launched inside it is attributed to it by
    the launch's correlation id. Otherwise it is a shared no-op context,
    after one read of the flag that the profiler sets when it starts
    (entering `record_function` with nothing recording costs ~100 times
    that read). Names are dotted `<layer>.<stage>` names; the profiler
    keeps the spans in memory and writes them out with its trace
    (`device_trace`)."""
    global _profiler
    if _profiler is None:
        import torch.autograd.profiler as _profiler
    if not _profiler._is_profiler_enabled:
        return _NO_SPAN
    return _profiler.record_function(name)


@contextlib.contextmanager
def device_trace(log_dir: str) -> Iterator[Optional[str]]:
    """torch.profiler trace (CPU and, with a card, CUDA activity) around
    a block, written on exit to `<log_dir>/device_trace.pt.trace.json`: a
    Chrome trace that Perfetto and TensorBoard's PyTorch profiler plugin
    both load. The port's `span`s inside the block are in it as
    `user_annotation` events (the fleet and megabatch tick's stages
    `tick.*`, the matcher's `match.field` / `match.search` /
    `match.refine`, the frontier stage's `frontier.*`, and with the
    dispatch profiler installed each entry point by its name). Yields the
    log dir, or None if the profiler could not start (it must never take
    the control loop down)."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = None
    try:
        prof = profile(activities=acts)
        prof.__enter__()
    except Exception:                               # noqa: BLE001
        prof = None
    try:
        yield log_dir if prof is not None else None
    finally:
        if prof is not None:
            try:
                prof.__exit__(None, None, None)
                os.makedirs(log_dir, exist_ok=True)
                prof.export_chrome_trace(
                    os.path.join(log_dir, "device_trace.pt.trace.json"))
            except Exception:                       # noqa: BLE001
                pass
