"""Scenario engine: dynamic worlds, rendezvous fleet merges, lifelong
missions.

Port of the JAX package's `scenarios` package. Scenarios are scripted the
way faults are — seeded, windowed, refcount-composed FaultPlan events —
so a dynamic world is just more chaos on the same deterministic step
clock:

* `dynamics.WorldDynamics` — scripted mutable ground truth (doors that
  open and close, seeded moving crowd blobs), composed on the host,
  injected through the `door_close` / `crowd` FaultPlan kinds at the
  SimNode boundary, which uploads the composed world to its device when
  it changes; the decaying mapper (DecayConfig) heals the stale evidence
  they leave.
* `rendezvous.RendezvousMerger` — two fleets with unknown relative origin
  detect their map overlap, verify the implied rigid transform by streak,
  and merge grids and pose graphs into one world.
* `lifelong` — deterministic day-long soak driving: door cycles, crowd
  churn, supervisor mapper restarts with bounded checkpoint retention,
  one MissionReport to assert on.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from jax_mapping_torch.config import SlamConfig
from jax_mapping_torch.scenarios.dynamics import (  # noqa: F401
    DoorSpec, WorldDynamics, doors_from_dicts,
)
from jax_mapping_torch.scenarios.lifelong import (  # noqa: F401
    MissionReport, day_plan, run_lifelong_mission,
)
from jax_mapping_torch.scenarios.rendezvous import (  # noqa: F401
    RendezvousMerger, merge_fleets, merged_frontier_assignment,
    se2_apply, se2_from_pair, transform_state,
)


def launch_scenario_stack(cfg: SlamConfig, world: np.ndarray,
                          doors=(), world_res_m: Optional[float] = None,
                          seed: int = 0, **launch_kwargs):
    """`launch_sim_stack` with the world made scriptable: builds the
    stack (on `device`, the CUDA card unless the caller asks for another),
    then arms a `WorldDynamics` over the SAME world bitmap with the given
    door registry (dicts from the world generators or DoorSpecs) and the
    launch seed (crowd paths derive from it). With no events ever fired
    the composed world equals the base world and the sim uploads nothing:
    the scenario wiring is inert."""
    from jax_mapping_torch.bridge.launch import launch_sim_stack
    st = launch_sim_stack(cfg, world, world_res_m=world_res_m,
                          seed=seed, **launch_kwargs)
    dyn = WorldDynamics(world, st.sim.world_res_m,
                        doors=doors_from_dicts(doors), seed=seed)
    st.sim.attach_world_dynamics(dyn)
    return st
