"""What the traced run adds: `record_function` ranges around the port's
layer functions, counters of calls and host syncs, and the reading of
the profiler's trace.

A range is opened by a wrapper the harness puts on a module attribute of
the port (`"package.module:function"`), so every call that looks the
function up through its module passes through it; the port's own files
are not touched. Device work belongs to every harness range the host
thread was inside when it launched that work, which the trace tells by
the launch's correlation id: a kernel's time is attributed by who
launched it, not by its name.
"""

from __future__ import annotations

import importlib
import json
import warnings
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

from port_bench.harness.stats import gaps, union_length

#: Prefix of the harness's range names in the trace.
PREFIX = "pb:"
#: The range around the profiled ticks.
WINDOW = "window"
#: The range around each call of the cell's entry.
TICK = "tick"

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
#: Device-side records of the profiler's own buffer handling.
_PROFILER_OWN = ("Activity Buffer Request", "Buffer Flush")


def resolve(target: str):
    """(module, attribute) of "package.module:function", or None when the
    module or the function no longer exists."""
    modname, _, attr = target.partition(":")
    try:
        mod = importlib.import_module(modname)
    except ImportError:
        return None
    if not callable(getattr(mod, attr, None)):
        return None
    return mod, attr


class Patches:
    """Wrappers on module attributes, removed on exit."""

    def __init__(self):
        self._undo: List[Tuple[object, str, object]] = []

    def wrap(self, target: str, make: Callable) -> bool:
        """Replace the function at `target` by make(original); False when
        it does not exist."""
        found = resolve(target)
        if found is None:
            return False
        mod, attr = found
        orig = getattr(mod, attr)
        self._undo.append((mod, attr, orig))
        setattr(mod, attr, make(orig))
        return True

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        for mod, attr, orig in reversed(self._undo):
            setattr(mod, attr, orig)
        self._undo.clear()
        return False


def counter(counts: Dict[str, int], key: str) -> Callable:
    """A wrapper maker that counts calls under `key`."""
    def make(fn):
        def counted(*args, **kwargs):
            counts[key] = counts.get(key, 0) + 1
            return fn(*args, **kwargs)
        return counted
    return make


def ranged(name: str, capture: Optional[Callable] = None,
           records: Optional[list] = None, armed=lambda: True) -> Callable:
    """A wrapper maker that runs the function inside the range
    `PREFIX + name`; with `capture`, while `armed()`, it also appends
    capture(args, kwargs) to `records` (the shapes and the small inputs a
    roofline needs)."""
    import torch

    def make(fn):
        def wrapped(*args, **kwargs):
            if capture is not None and armed():
                records.append(capture(args, kwargs))
            with torch.profiler.record_function(PREFIX + name):
                return fn(*args, **kwargs)
        return wrapped
    return make


def _is_sync(w) -> bool:
    """A warning of PyTorch's CUDA sync debug mode that flags a
    synchronising call (not its one-time notice)."""
    msg = str(w.message)
    return "synchroniz" in msg and "prototype feature" not in msg


class SyncCount:
    """PyTorch's CUDA sync debug mode over a block; `n` counts the
    synchronising calls the block made."""

    def __init__(self, torch, armed: bool = True):
        self.torch, self.armed = torch, armed
        self.n = 0

    def __enter__(self):
        if not self.armed:              # no card: nothing synchronises
            return self
        self._cm = warnings.catch_warnings(record=True)
        self._rec = self._cm.__enter__()
        warnings.simplefilter("always")
        self._mode = self.torch.cuda.get_sync_debug_mode()
        self.torch.cuda.set_sync_debug_mode("warn")
        return self

    def __exit__(self, *exc):
        if not self.armed:
            return False
        try:
            self.torch.cuda.set_sync_debug_mode(self._mode)
        finally:
            self.n = sum(_is_sync(w) for w in self._rec)
            self._cm.__exit__(*exc)
        return False


@dataclass
class TraceReading:
    """The profiled window, read from the trace (times in seconds)."""

    window_s: float
    busy_s: float
    #: Range name -> device (start, end) spans launched inside it (us).
    range_spans: Dict[str, List[Tuple[float, float]]] = field(
        default_factory=dict)
    #: Range name -> summed device seconds launched inside it.
    range_seconds: Dict[str, float] = field(default_factory=dict)
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)

    def range_union_s(self, name: str) -> Optional[float]:
        spans = self.range_spans.get(name)
        return None if spans is None else union_length(spans) / 1e6


def _events(trace) -> list:
    ev = trace["traceEvents"] if isinstance(trace, dict) else trace
    return [e for e in ev if e.get("ph") == "X"]


def read_trace(path: str, names) -> Optional[TraceReading]:
    """Read an exported chrome trace: the window, the device's busy
    time in it, each harness range's device spans, the top device ops and
    the longest idle gaps named by what the host was in. None when the
    trace holds no window range or no device work."""
    with open(path) as f:
        ev = _events(json.load(f))
    ann = [e for e in ev if e.get("cat") == "user_annotation"
           and str(e.get("name", "")).startswith(PREFIX)]
    win = [e for e in ann if e["name"] == PREFIX + WINDOW]
    dev = [e for e in ev if e.get("cat") in _DEVICE_CATS
           and e.get("name") not in _PROFILER_OWN]
    if not win or not dev:
        return None
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    main_tid = win[0].get("tid")
    dev = [e for e in dev if w0 <= float(e["ts"]) <= w1]
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"])) for e in dev]
    launches = {}
    for e in ev:
        if e.get("cat") in _LAUNCH_CATS and "correlation" in e.get("args",
                                                                   {}):
            launches[e["args"]["correlation"]] = (float(e["ts"]),
                                                  e.get("tid"))
    # Active harness ranges at each launch, by a sweep over time.
    by_tid = defaultdict(list)
    for a in ann:
        s = float(a["ts"])
        by_tid[a.get("tid")].append((s, s + float(a["dur"]),
                                     a["name"][len(PREFIX):]))
    for v in by_tid.values():
        v.sort()
    order = sorted(
        (launches[e["args"]["correlation"]] + (i,) for i, e in enumerate(dev)
         if e.get("args", {}).get("correlation") in launches),
        key=lambda x: x[0])
    owner: Dict[int, set] = {}
    ptr = defaultdict(int)
    active = defaultdict(list)
    for ts, tid, i in order:
        lst = by_tid.get(tid, [])
        while ptr[tid] < len(lst) and lst[ptr[tid]][0] <= ts:
            active[tid].append(lst[ptr[tid]])
            ptr[tid] += 1
        active[tid] = [a for a in active[tid] if a[1] >= ts]
        owner[i] = {a[2] for a in active[tid]}
    range_spans = {n: [] for n in names}
    range_sec = {n: 0.0 for n in names}
    for i, e in enumerate(dev):
        for n in owner.get(i, ()):
            if n in range_spans:
                range_spans[n].append(spans[i])
                range_sec[n] += float(e["dur"]) / 1e6
    ops = defaultdict(float)
    for e in dev:
        ops[str(e["name"])] += float(e["dur"]) / 1e6
    top_ops = sorted(ops.items(), key=lambda kv: -kv[1])[:10]
    host = [e for e in ev if e.get("tid") == main_tid
            and e.get("cat") in ("cpu_op", "user_annotation") + _LAUNCH_CATS]
    idle = sorted(gaps(spans, w0, w1), key=lambda g: g[0] - g[1])[:10]
    named = [(_host_state(host, (s + e) / 2), (e - s) / 1e6)
             for s, e in idle]
    return TraceReading(window_s=(w1 - w0) / 1e6,
                        busy_s=union_length(spans) / 1e6,
                        range_spans=range_spans, range_seconds=range_sec,
                        device_ops=[(n[:120], v) for n, v in top_ops],
                        idle_gaps=named)


def _host_state(host: list, t: float) -> str:
    """What the host thread was in at time t (a gap's middle): the
    innermost harness range and the innermost operation or runtime call."""
    rng, op = None, None
    for e in host:
        s = float(e["ts"])
        if s <= t <= s + float(e["dur"]):
            name = str(e["name"])
            if name.startswith(PREFIX):
                if rng is None or s >= rng[0]:
                    rng = (s, name[len(PREFIX):])
            elif op is None or s >= op[0]:
                op = (s, name)
    return f"{rng[1] if rng else 'harness'}/{op[1][:60] if op else 'python'}"
