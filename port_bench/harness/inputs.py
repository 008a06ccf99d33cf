"""The one traffic generator: a traffic file's parameters and the seed
make every input a run hands to the program and to the reference.

A traffic file (`traffic/<name>.json`) holds:

* `world`: the generator (`kind`, one of `WORLDS`) and its arguments;
  mission m's world is made with seed `seed + m`;
* `preroll`: the mission each run starts from (`harness/preroll.py`);
* `noise_ticks`: how many ticks of (R, 2) wheel-noise normals to make
  for each mission (a longer run reuses them from the start);
* `warmup_ticks`: ticks run in set-up before the window, at least one
  (the host buffers for the kept ticks take the shapes of its output);
* `trace_seconds`: how long the traced run profiles, from the window's
  start;
* `check_ticks`: how many ticks, besides the window's first tick and its
  first verifying tick, are checked against the reference: times drawn
  from the seed
  over the window's first 90%, each marking the first tick from then on
  in which a robot keys a scan.

The program's fresh state puts the robots on the port's 0.5 m ring at
the world's centre, with ring radii from uniforms drawn from the seed;
the preroll then moves the mission on.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import numpy as np
import torch

from port_bench.harness import worlds as W

WORLDS = {
    "rooms_wide_doors": lambda a, seed: W.rooms_wide_doors(
        a["size_cells"], a["resolution_m"], door_m=a["door_m"], seed=seed),
}


@dataclass
class Inputs:
    worlds: List[np.ndarray]     # (H, W) bool, one a mission
    resolution_m: float
    uniforms: torch.Tensor       # (M, R) spawn-radius uniforms, CPU
    normals: torch.Tensor        # (T, M, R, 2) wheel-noise normals, CPU
    check_at: List[float]        # window shares at which a check is due

    def noise(self, k: int) -> torch.Tensor:
        """The (M, R, 2) normals of tick k (counted from set-up's first)."""
        return self.normals[k % self.normals.shape[0]]


def make_inputs(traffic: dict, seed: int, missions: int,
                robots: int) -> Inputs:
    if int(traffic["warmup_ticks"]) < 1:
        raise ValueError("a traffic mix runs at least one warm-up tick")
    w = traffic["world"]
    make = WORLDS[w["kind"]]
    worlds = [make(w, int(seed) + m) for m in range(missions)]
    g = torch.Generator().manual_seed(int(seed))
    uniforms = torch.rand((missions, robots), generator=g)
    normals = torch.randn((traffic["noise_ticks"], missions, robots, 2),
                          generator=g)
    at = torch.rand(int(traffic["check_ticks"]), generator=g,
                    dtype=torch.float64) * 0.9
    return Inputs(worlds=worlds, resolution_m=float(w["resolution_m"]),
                  uniforms=uniforms, normals=normals,
                  check_at=sorted(float(a) for a in at))
