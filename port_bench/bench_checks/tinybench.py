"""A benchmark defined only here, for the CPU checks: tiny
configurations (the port's `tiny_config`) and a tiny traffic mix, in a
folder of their own that the harness searches before its own."""

from __future__ import annotations

import json
import time
from pathlib import Path

from port_bench.harness import driver
from port_bench.harness.registry import REPO, Registry

LIMITS = {"pose_gap_m": 0, "grid_gap": 0, "scan_gap_m": 0,
          "value_gap": 1e-4, "mismatches": 0}

CONFIGS = {
    "tiny2": {"entry": "fleet_step", "missions": 1, "robots": 2,
              "base": "tiny_config", "slam": {}, "limits": LIMITS},
    "tinyplane": {"entry": "controlplane", "missions": 3, "robots": 2,
                  "base": "tiny_config",
                  "slam": {"tenancy": {"enabled": True, "lane_health": True,
                                       "journal": True,
                                       "prewarm_on_admit": False}},
                  "limits": LIMITS},
}

TRAFFIC = {"tinyrooms": {
    "world": {"kind": "rooms_wide_doors", "size_cells": 256,
              "resolution_m": 0.05, "door_m": 1.0},
    "preroll": {"keys": 12, "step_m": 0.1,
                "clearance_m": 0.3},
    "noise_ticks": 64, "warmup_ticks": 1, "trace_seconds": 0.5,
    "check_ticks": 2}}


def write(root: Path) -> Registry:
    """Write the tiny benchmark under `root`; its registry."""
    for sub, files in (("configs", CONFIGS), ("traffic", TRAFFIC)):
        (root / sub).mkdir(parents=True, exist_ok=True)
        for name, body in files.items():
            (root / sub / f"{name}.json").write_text(json.dumps(body))
    bench = json.loads((REPO / "BENCHMARK.json").read_text())
    bench["workloads"] = [
        {"name": f"{c}.rooms", "config": c, "traffic": "tinyrooms",
         "chips": 1, "why": "CPU check"} for c in CONFIGS]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return Registry(root / "BENCHMARK.json", roots=[root])


def run(registry: Registry, cell: str, seed: int = 5,
        seconds: float = 1.0, traced: bool = False,
        control: bool = False) -> dict:
    return driver.run_cell(registry.cell(cell), registry, seed, seconds,
                           traced, time.perf_counter(), device="cpu",
                           control=control)
