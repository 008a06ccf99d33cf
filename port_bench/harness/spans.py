"""The port's own spans in a profiler trace.

The port marks its stages with `utils.profiling.span`, a
`record_function` range while a profiler records: the entry spans
`fleet.tick` and `plane.tick` (and `megabatch.tick` inside the latter),
the tick's stages `tick.*`, `megabatch.read`, `megabatch.rerun` and
`plane.health`, the matcher's `match.field`, `match.search` and
`match.refine`, and the frontier stage's `frontier.*`. In an exported
trace they are the main thread's `user_annotation` events whose names do
not carry the harness's prefix.

`read_spans` gives, for each span name, the device work launched inside
it (by the launch's correlation id, with the sweep the harness ranges
use in `trace.read_trace`), its host intervals, the device's idle
intervals in the window, and the copies and synchronising calls made
inside it. The functions below it are the per-layer arithmetic.
"""

from __future__ import annotations

import json
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from port_bench.harness import stats, trace

Spans = List[Tuple[float, float]]

#: The spans around a whole call of a cell's entry.
ENTRY = ("fleet.tick", "plane.tick")
#: The spans of the tick's stages other than `tick.*`.
STAGES = ("megabatch.read", "megabatch.rerun", "plane.health")
#: Runtime calls that wait for the device.
_SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
               "cudaEventSynchronize")


def is_stage(name: str) -> bool:
    return name.startswith("tick.") or name in STAGES


@dataclass
class SpanReading:
    """The program's spans in the profiled window (times in us)."""

    #: Span name -> device (start, end) of the work launched inside it.
    device: Dict[str, Spans] = field(default_factory=dict)
    #: Span name -> the host intervals it was open.
    host: Dict[str, Spans] = field(default_factory=dict)
    #: The window's intervals in which no device work ran.
    idle: Spans = field(default_factory=list)
    #: Innermost span name -> {"DtoH", "HtoD", "sync"} -> count: the
    #: copies launched inside it and its calls that wait for the device.
    waits: Dict[str, Dict[str, int]] = field(default_factory=dict)


def _owners(launches: Sequence[Tuple[float, object, int]],
            opened: Dict[object, list]) -> Dict[int, List[tuple]]:
    """For each launch (time, thread, index), the (start, end, name)
    intervals of `opened` (per thread, sorted) that hold it."""
    owner: Dict[int, List[tuple]] = {}
    ptr: Dict[object, int] = defaultdict(int)
    active: Dict[object, list] = defaultdict(list)
    for ts, tid, i in sorted(launches, key=lambda x: x[0]):
        lst = opened.get(tid, [])
        while ptr[tid] < len(lst) and lst[ptr[tid]][0] <= ts:
            active[tid].append(lst[ptr[tid]])
            ptr[tid] += 1
        active[tid] = [a for a in active[tid] if a[1] >= ts]
        owner[i] = list(active[tid])
    return owner


def _innermost(held: List[tuple]) -> str:
    return max(held, key=lambda a: a[0])[2] if held else "none"


def read_spans(path: str) -> Optional[SpanReading]:
    """The program's spans of an exported trace; None when it holds no
    harness window or no device work."""
    with open(path) as f:
        ev = trace._events(json.load(f))
    win = [e for e in ev if e.get("cat") == "user_annotation"
           and e.get("name") == trace.PREFIX + trace.WINDOW]
    dev = [e for e in ev if e.get("cat") in trace._DEVICE_CATS
           and e.get("name") not in trace._PROFILER_OWN]
    if not win or not dev:
        return None
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    main = win[0].get("tid")
    dev = [e for e in dev if w0 <= float(e["ts"]) <= w1]
    ann = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                  str(e["name"])) for e in ev
                 if e.get("cat") == "user_annotation"
                 and e.get("tid") == main
                 and not str(e.get("name", "")).startswith(trace.PREFIX))
    out = SpanReading()
    for s, e, name in ann:
        out.host.setdefault(name, []).append((s, e))
        out.device.setdefault(name, [])
    launches = {}
    for e in ev:
        if e.get("cat") in trace._LAUNCH_CATS and \
                "correlation" in e.get("args", {}):
            launches[e["args"]["correlation"]] = (float(e["ts"]),
                                                  e.get("tid"))
    order = [launches[e["args"]["correlation"]] + (i,)
             for i, e in enumerate(dev)
             if e.get("args", {}).get("correlation") in launches]
    owner = _owners(order, {main: ann})
    waits: Dict[str, Dict[str, int]] = defaultdict(
        lambda: {"DtoH": 0, "HtoD": 0, "sync": 0})
    for i, e in enumerate(dev):
        held = owner.get(i, [])
        for _, _, name in held:
            out.device[name].append((float(e["ts"]),
                                     float(e["ts"]) + float(e["dur"])))
        kind = next((k for k in ("DtoH", "HtoD")
                     if k in str(e.get("name", ""))), None)
        if e.get("cat") == "gpu_memcpy" and kind:
            waits[_innermost(held)][kind] += 1
    calls = [(float(e["ts"]), main, i) for i, e in enumerate(ev)
             if e.get("cat") in trace._LAUNCH_CATS and e.get("tid") == main
             and e.get("name") in _SYNC_CALLS and w0 <= float(e["ts"]) <= w1]
    for i, held in _owners(calls, {main: ann}).items():
        waits[_innermost(held)]["sync"] += 1
    out.waits = dict(waits)
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in dev]
    out.idle = stats.gaps(spans, w0, w1)
    return out


# ----------------------------------------------------------- arithmetic

def _merge(spans: Iterable[Tuple[float, float]]) -> Spans:
    """Sorted disjoint intervals covering `spans`."""
    out: Spans = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _intersect(a: Spans, b: Spans) -> Spans:
    """Intersection of two sorted disjoint interval lists."""
    out, i, j = [], 0, 0
    while i < len(a) and j < len(b):
        s, e = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if s < e:
            out.append((s, e))
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return out


def _subtract(a: Spans, b: Spans) -> Spans:
    """The parts of sorted disjoint `a` outside sorted disjoint `b`."""
    out = []
    for s, e in a:
        for bs, be in b:
            if be <= s or bs >= e:
                continue
            if bs > s:
                out.append((s, bs))
            s = max(s, be)
            if s >= e:
                break
        if s < e:
            out.append((s, e))
    return out


def device_ms_per_tick(r: Optional[SpanReading], name: str,
                       ticks: int) -> Optional[float]:
    """The union of the device work launched inside span `name`, in ms a
    profiled tick; None when the span never ran or launched nothing."""
    if r is None or not ticks or not r.device.get(name):
        return None
    return stats.union_length(r.device[name]) / 1e3 / ticks


def idle_ms_per_tick(r: Optional[SpanReading], names: Sequence[str],
                     ticks: int, outside: Sequence[str] = ()
                     ) -> Optional[float]:
    """Device idle time while the host was inside one of the spans
    `names` and inside none of `outside`, in ms a profiled tick; None
    when none of `names` ran."""
    if r is None or not ticks:
        return None
    inside = _merge(s for n in names for s in r.host.get(n, []))
    if not inside:
        return None
    held = _intersect(_merge(r.idle), inside)
    held = _subtract(held, _merge(s for n, v in r.host.items()
                                  if n in outside for s in v))
    return sum(e - s for s, e in held) / 1e3 / ticks


def unstaged_idle_ms_per_tick(r: Optional[SpanReading],
                              ticks: int) -> Optional[float]:
    """Device idle while the host was inside an entry span but inside no
    stage span: the idle that no stage explains."""
    if r is None:
        return None
    return idle_ms_per_tick(r, ENTRY, ticks,
                            outside=[n for n in r.host if is_stage(n)])
