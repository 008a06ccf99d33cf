"""Run one cell: set-up, the measured window, the trace, the check.

The flow of a run, whatever the cell:

1. set-up: build the port's kernels (once per checkout, in the port's
   fixed build directory), make the inputs from the seed, let the entry
   build the program's state (the traffic's preroll, a mission caught
   mid-way), run the traffic's warm-up ticks, and make host room for
   the kept ticks; `setup_s` runs from the process's start to the first
   timed tick;
2. the window: ticks back to back for `--seconds`, finishing the tick in
   flight; each tick is timed on the host from the call until its wheel
   targets are on the host. A counter on the loop-closure branch marks
   the ticks that verify a loop. Kept for the check, each copied to the
   host as it ends (so the device holds only what the program holds):
   the window's first tick, its first verifying tick, and for each time
   drawn from the seed the first tick from then on in which a robot keys
   a scan;
3. with `--trace 1`: the harness ranges are on for the whole window, the
   profiler for its first `trace_seconds`, and host syncs are counted
   around every call of the entry;
4. the window's peak memory is read, the program's state is dropped,
   and the reference steps from each kept state; the numbers it gives
   decide `correct`, each against the configuration's limit.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional

from port_bench.harness import trace
from port_bench.harness.inputs import make_inputs
from port_bench.harness.registry import Cell, Registry

#: Counts the loop-closure branch: a tick that calls it verifies a loop.
VERIFY_TARGET = "jax_mapping_torch.models.fleet:_close_loops"


class RunContext:
    """What a run knows, for its entry and its metric readers."""

    def __init__(self, torch, device, cell: Cell, seed: int,
                 seconds: float, traced: bool):
        self.torch, self.device, self.cell = torch, device, cell
        self.seed, self.seconds, self.traced = seed, seconds, traced
        self.config = cell.config
        self.cfg = build_config(_port_config(), cell.config)
        self.resolution_m = float(cell.traffic["world"]["resolution_m"])
        self.inputs = make_inputs(cell.traffic, seed,
                                  int(cell.config["missions"]),
                                  self.cfg.fleet.n_robots)
        self.patches = trace.Patches()
        self.counts: Dict[str, int] = {}
        self.ticks: List[dict] = []
        self.window_s = 0.0
        self.setup_s = 0.0
        self.profiled_ticks = 0
        self.capturing = False
        self.captures: Dict[str, list] = {}
        self.syncs: List[int] = []
        self.reading: Optional[trace.TraceReading] = None
        self.trace_path: Optional[str] = None
        self.peak_window_bytes: Optional[int] = None
        self.tmp = tempfile.mkdtemp(prefix="port_bench_")


def _port_config():
    from jax_mapping_torch import config as C
    return C


def build_config(C, spec: dict):
    """The SlamConfig a configuration file states, in config module C's
    types: `base` ("default" or "tiny_config"), then each section of
    `slam` replaced key by key."""
    base = spec.get("base", "default")
    robots = int(spec["robots"])
    cfg = C.tiny_config(robots) if base == "tiny_config" else C.SlamConfig()
    for sec, vals in spec.get("slam", {}).items():
        if isinstance(vals, dict):
            cfg = dataclasses.replace(cfg, **{sec: dataclasses.replace(
                getattr(cfg, sec), **vals)})
        else:
            cfg = dataclasses.replace(cfg, **{sec: vals})
    if cfg.fleet.n_robots != robots:
        raise ValueError(f"config states {robots} robots, the SlamConfig "
                         f"{cfg.fleet.n_robots}")
    return cfg


def _install_ranges(run: RunContext, metrics: list) -> List[str]:
    """Wrap every target the metric readers name; returns the range
    names. A target that no longer exists is skipped, and its metric
    then finds nothing to read."""
    names = [trace.TICK]
    entry = run.config["entry"]
    for mod in metrics:
        for name, targets in getattr(mod, "RANGES", {}).items():
            if isinstance(targets, dict):
                targets = targets.get("*", []) + targets.get(entry, [])
            cap = getattr(mod, "CAPTURE", {}).get(name)
            recs = run.captures.setdefault(name, [])
            for t in targets:
                run.patches.wrap(t, trace.ranged(
                    name, cap, recs, armed=lambda: run.capturing))
            names.append(name)
    return sorted(set(names))


def card() -> dict:
    """The card's name, power limit and clocks, from nvidia-smi."""
    q = "name,power.limit,clocks.sm,clocks.max.sm,clocks.mem"
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={q}", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out = f"nvidia-smi failed: {e}"
    return {"nvidia_smi": q, "reading": out}


def run_cell(cell: Cell, registry: Registry, seed: int, seconds: float,
             traced: bool, t_start: float, device: str = "cuda",
             control: bool = False) -> dict:
    """One run of `cell`; returns the result line's object (and, with
    `control`, the control's numbers under "control")."""
    import torch
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    if on_card:
        from jax_mapping_torch.ops import _cuda
        _cuda.build_all()
    run = RunContext(torch, dev, cell, seed, seconds, traced)
    metrics = {m["name"]: registry.metric(m["name"])
               for m in cell.end_to_end + cell.per_layer}
    entry = registry.entry(run.config["entry"]).Entry(run)
    failed_run = None
    try:
        with run.patches:
            run.patches.wrap(VERIFY_TARGET,
                             trace.counter(run.counts, "verify"))
            entry.setup()
            for _ in range(int(cell.traffic["warmup_ticks"])):
                entry.step()
                entry.read()
            entry.reserve(len(run.inputs.check_at) + 2)
            if on_card:
                torch.cuda.synchronize()
            run.setup_s = time.perf_counter() - t_start
            range_names = (_install_ranges(run, [metrics[m["name"]]
                                                 for m in cell.per_layer])
                           if traced else [])
            if on_card:
                torch.cuda.reset_peak_memory_stats()
            failed_run = _window(run, entry, range_names)
            if on_card:
                torch.cuda.synchronize()
                run.peak_window_bytes = torch.cuda.max_memory_allocated()
        samples = entry.samples()
        entry.release()
        if on_card:
            torch.cuda.empty_cache()
        if traced and run.trace_path:
            run.reading = trace.read_trace(run.trace_path, range_names)
        checks = entry.check(samples, control=control)
    finally:
        shutil.rmtree(run.tmp, ignore_errors=True)
    return _result(run, cell, metrics, checks, failed_run, on_card)


def passes(numbers: dict, limits: dict) -> bool:
    """Whether every compared number is within its limit."""
    return all(numbers[k] <= limits[k] for k in limits)


def _window(run: RunContext, entry, range_names) -> Optional[str]:
    """The measured window; returns what a tick raised, or None."""
    torch = run.torch
    traced = run.traced
    on_card = run.device.type == "cuda"
    prof = None
    trace_s = float(run.cell.traffic["trace_seconds"])
    if traced:
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if on_card:
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()                    # its start-up before the window
    flags = []
    due = [a * run.seconds for a in run.inputs.check_at]
    verifying_kept = False
    if traced:
        win = torch.profiler.record_function(trace.PREFIX + trace.WINDOW)
        win.__enter__()
        run.capturing = True
    t0 = time.perf_counter()
    k = 0
    error = None
    while True:
        v0 = run.counts.get("verify", 0)
        ts = time.perf_counter()
        try:
            if traced:
                with torch.profiler.record_function(
                        trace.PREFIX + trace.TICK), \
                        trace.SyncCount(torch, on_card) as sc:
                    entry.step()
                run.syncs.append(sc.n)
            else:
                entry.step()
            offered, carried, flag = entry.read()
        except Exception as e:          # a tick that raised fails its scans
            error = f"{type(e).__name__}: {e}"
            run.ticks.append({"ms": (time.perf_counter() - ts) * 1e3,
                              "offered": entry.offered(), "carried": 0,
                              "verifying": False})
            break
        te = time.perf_counter()
        verifying = run.counts.get("verify", 0) > v0
        run.ticks.append({"ms": (te - ts) * 1e3, "offered": offered,
                          "carried": carried, "verifying": verifying})
        flags.append(flag)
        keyed = bool(due) and ts - t0 >= due[0] and entry.keyed()
        if keyed:
            due.pop(0)
        if (k == 0 or keyed or (verifying and not verifying_kept)) \
                and entry.room():
            entry.keep(k)
            verifying_kept = verifying_kept or verifying
        k += 1
        if prof is not None and te - t0 >= trace_s:
            _stop_profile(run, prof, win, k)
            prof = None
        if te - t0 >= run.seconds:
            break
    run.window_s = time.perf_counter() - t0
    if prof is not None:                # the window ended first
        _stop_profile(run, prof, win, k)
    ok = torch.stack(flags).tolist() if flags else []
    for tick, good in zip(run.ticks, ok):
        if not good:
            tick["carried"] = 0
    return error


def _stop_profile(run: RunContext, prof, win, ticks: int) -> None:
    """Close the profiled window after `ticks` ticks and export its
    trace."""
    run.capturing = False
    win.__exit__(None, None, None)
    if run.device.type == "cuda":
        run.torch.cuda.synchronize()
    prof.stop()
    run.profiled_ticks = ticks
    run.trace_path = os.path.join(run.tmp, "trace.json")
    prof.export_chrome_trace(run.trace_path)


def _result(run: RunContext, cell: Cell, metrics: dict, checks: dict,
            error: Optional[str], on_card: bool) -> dict:
    torch = run.torch
    attempted = sum(t["offered"] for t in run.ticks)
    failed = attempted - sum(t["carried"] for t in run.ticks)
    wanted = cell.per_layer if run.traced else cell.end_to_end
    values = {}
    for m in wanted:
        v = metrics[m["name"]].read(run)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    limits = cell.config["limits"]
    numbers = checks["program"]
    passed = error is None and passes(numbers, limits)
    device = {"platform": "gpu" if on_card else "cpu",
              "kind": (torch.cuda.get_device_name(run.device)
                       if on_card else "cpu"),
              "count": 1,
              "memory_peak_bytes": run.peak_window_bytes or 0}
    out = {"correct": bool(passed), "attempted": attempted,
           "failed": failed, "metrics": values, "device": device}
    if run.traced and run.reading is not None:
        device["busy_s"] = run.reading.busy_s
        device["window_s"] = run.reading.window_s
        out["breakdown"] = {
            "device_ops": [list(x) for x in run.reading.device_ops],
            "idle_gaps": [list(x) for x in run.reading.idle_gaps]}
    ms = sorted(t["ms"] for t in run.ticks)
    out["window"] = {"ticks": len(run.ticks),
                     "tick_ms_p50": ms[len(ms) // 2] if ms else None,
                     "tick_ms_max": ms[-1] if ms else None,
                     "verifying_ticks": sum(t["verifying"] for t in run.ticks),
                     "window_s": run.window_s, "setup_s": run.setup_s,
                     "checked": checks.get("checked")}
    if "control" in checks:
        out["control"] = checks["control"]
    out["checks"] = {k: {"value": numbers[k], "limit": limits[k]}
                     for k in limits}
    if error is not None:
        out["checks"]["tick_error"] = {"value": error, "limit": None}
    return out


def emit(out: dict, log=sys.stderr, stream=sys.stdout) -> None:
    """Each compared number beside its limit as the last lines of
    standard error, and the result as the last line of standard
    output."""
    for k, v in out["checks"].items():
        print(f"check {k}: {v['value']} (limit {v['limit']})", file=log)
    log.flush()
    print(json.dumps(out), file=stream)
    stream.flush()
