"""Lifelong missions: sim-accelerated day-long soaks under continuous
chaos.

A lifelong session is not a longer mission — it is a mission where
EVERYTHING cycles: doors open and close (`door_close` windows), crowds
pass through (`crowd` windows), the mapper dies and resumes from
checkpoint (supervisor restarts, bounded generation retention), and the
map must keep healing (DecayConfig) instead of fossilizing its first
hour. This module is the deterministic driver for such sessions: one
seeded scenario+chaos schedule (`day_plan`), one launch wrapper that
arms the world dynamics (`launch_scenario_stack`, in the package init),
and one mission runner returning the artifacts soak gates assert on
(`run_lifelong_mission`). Two same-seed missions are bit-identical —
the FaultPlan determinism contract extended to the world itself.

Port of the JAX package's `scenarios/lifelong.py`: the same schedule, the
same mission loop and the same report, read from the port's stack (the
final grid is copied from the stack's device; `slo_alerts` come from the
port's flight recorder, `world_series` from the port mapper's
`world_status()`).
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from jax_mapping_torch.config import SlamConfig
from jax_mapping_torch.resilience.faultplan import FaultEvent, FaultPlan


def day_plan(mission_steps: int, door_names: Sequence[str],
             n_crowds: int = 1, door_cycle: int = 60,
             crowd_cycle: int = 90, kill_steps: Sequence[int] = (),
             start: int = 10) -> List[FaultEvent]:
    """A deterministic 'day': every door cycles closed/open on a
    staggered `door_cycle` cadence, crowds churn through on
    `crowd_cycle`, and the mapper is killed at each of `kill_steps`
    (the supervisor restarts it from checkpoint). Pure scheduling —
    no RNG; the FaultPlan seed only matters if callers append
    random_plan events on top."""
    events: List[FaultEvent] = []
    for k, name in enumerate(door_names):
        first = start + k * (door_cycle // max(1, len(door_names)))
        for t in range(first, max(first + 1, mission_steps - 5),
                       door_cycle):
            events.append(FaultEvent(step=t, kind="door_close",
                                     name=name,
                                     duration=door_cycle // 2))
    for c in range(n_crowds):
        first = start + 15 + c * (crowd_cycle // max(1, n_crowds))
        for t in range(first, max(first + 1, mission_steps - 5),
                       crowd_cycle):
            events.append(FaultEvent(step=t, kind="crowd", robot=c,
                                     duration=crowd_cycle // 3,
                                     value=0.25))
    for t in kill_steps:
        events.append(FaultEvent(step=int(t), kind="kill_node",
                                 name="jax_mapper"))
    return events


@dataclasses.dataclass
class MissionReport:
    """What a soak gate asserts on — everything host-side numpy."""

    grid: np.ndarray                 # final shared log-odds map
    plan_log: List[tuple]            # the FaultPlan's (step, desc) log
    n_mapper_restarts: int
    n_scans_fused: int
    n_decay_passes: int
    n_world_updates: int
    map_revision: int
    restart_epoch: int
    checkpoint_files: List[str]      # basenames in the checkpoint dir
    health_transitions: List[tuple]
    #: Flight-recorder postmortem dumps THIS mission wrote (basenames
    #: in the checkpoint dir — supervisor restarts, watchdog
    #: divergence; obs/recorder.py). The first artifact to read after
    #: a failed soak gate: `python -m jax_mapping_torch.obs diff` two
    #: same-seed missions' dumps for the first divergent transition.
    postmortem_dumps: List[str] = dataclasses.field(default_factory=list)
    #: SLO alert transitions THIS mission fired (obs/slo.py `slo_alert`
    #: flight events past the mission's event mark): (tick, objective,
    #: state) tuples, state "firing"/"clear" — empty when no SLO engine
    #: was armed. Deterministic fields, so two same-seed missions
    #: report identical alert schedules (the chaos-determinism
    #: contract extended to alerting).
    slo_alerts: List[tuple] = dataclasses.field(default_factory=list)
    #: Traveled-distance axis (bounded-memory soaks): total
    #: ground-truth path length over the fleet and per robot,
    #: chunk-sampled every `sample_every` steps — the x-axis the
    #: constant-device-bytes gate plots against (a lifelong corridor
    #: mission must show memory FLAT while distance grows).
    distance_traveled_m: float = 0.0
    distance_per_robot_m: List[float] = dataclasses.field(
        default_factory=list)
    #: One sample per chunk: {step, distance_m} plus — when the stack
    #: runs a windowed world — the store's live footprint
    #: (device_window_bytes, host_tiles, spill_tiles, away_tiles,
    #: origin_tile). Deterministic fields only: two same-seed missions
    #: report identical series, eviction/spill schedules included.
    world_series: List[dict] = dataclasses.field(default_factory=list)

    def known_cells(self, thresh: float = 0.5) -> int:
        return int((np.abs(self.grid) > thresh).sum())

    def peak_device_window_bytes(self) -> int:
        """Max device-resident window bytes across the series (0 when
        the mission was not windowed) — the constant-memory gate's
        subject: flat vs `distance_traveled_m` or the window leaks."""
        return max((s.get("device_window_bytes", 0)
                    for s in self.world_series), default=0)


def _mission_dumps(recorder, ev_mark: int):
    """Basenames of the dumps THIS mission triggered, derived from the
    recorder's `postmortem_dump` events past the mission's starting
    event mark — NOT from `n_dumps`/`dumps`, which advance only when a
    dump's (possibly async — mapper divergence dumps write on a
    one-shot thread) disk write completes: a count-window would miss a
    final-steps divergence dump still in flight and could attribute a
    previous mission's late write to this one. Events stamp at snapshot
    time on the triggering thread, so the window is exact; bounded by
    the event ring (a >capacity mission loses its earliest, by
    design)."""
    return [e["path"] for e in recorder.events_since(ev_mark)
            if e["kind"] == "postmortem_dump"]


def run_lifelong_mission(cfg: SlamConfig, world: np.ndarray, doors,
                         events: Sequence[FaultEvent], steps: int,
                         seed: int, checkpoint_dir: Optional[str],
                         n_robots: int = 2,
                         sample_every: int = 10,
                         goal_script: Optional[
                             Sequence[Tuple[int, float, float]]] = None,
                         device=None) -> MissionReport:
    """Drive one deterministic lifelong mission end-to-end and report.

    Boots the scenario stack (world dynamics armed, supervisor +
    checkpoint cadence when `checkpoint_dir` is given), attaches the
    schedule as ONE FaultPlan (world kinds and process chaos are the
    same mechanism), runs `steps`, and collects the assertion surface.
    Determinism anchor: same (cfg, world, doors, events, seed, steps)
    → bit-identical report.grid and plan_log.

    The run is CHUNKED every `sample_every` steps to accumulate the
    traveled-distance axis and (windowed stacks) the world-footprint
    series — chunked `run_steps` is step-for-step identical to one
    call (the fault plan and supervisor tick on the step index), so
    the sampling changes no mission bit.

    `goal_script` is an optional sequence of `(step, x, y)` entries
    (map metres) published on `/goal_pose` — the operator goal
    ingress, addressing robot 0 — at the first chunk boundary at or
    after `step` (exact when `step` is a multiple of `sample_every`).
    A scripted patrol pins the TRAJECTORY to the step clock: manual
    goals override frontier assignment in the brain, so the path no
    longer depends on frontier-auction tie-breaks, which on symmetric
    courses sit within float noise of each other and are therefore
    the one mission input same-seed determinism cannot pin across
    processes (XLA CPU codegen may vary per process; within one
    process the contract holds regardless).

    `device` is the stack's device (None: the CUDA card)."""
    from jax_mapping_torch.bridge.messages import Pose2D
    from jax_mapping_torch.obs.recorder import flight_recorder
    from jax_mapping_torch.scenarios import launch_scenario_stack
    # Event mark, not a dump count: `postmortem_dump` events stamp at
    # snapshot time on the triggering thread, so the window stays exact
    # when a dump's disk write is asynchronous.
    ev_mark = flight_recorder.mark()
    st = launch_scenario_stack(cfg, world, doors=doors,
                               n_robots=n_robots, realtime=False,
                               seed=seed, checkpoint_dir=checkpoint_dir,
                               device=device)
    try:
        st.brain.start_exploring()
        st.brain.reconnect_period_s = 0.0
        plan = FaultPlan(list(events), seed=seed)
        st.attach_fault_plan(plan)
        dist = np.zeros(n_robots)
        prev_xy = st.sim.truth_poses()[:, :2].copy()
        series: List[dict] = []
        script = sorted(goal_script or [], key=lambda e: int(e[0]))
        goal_pub = (st.bus.publisher("/goal_pose") if script else None)
        si = 0
        done = 0
        chunk = max(1, int(sample_every))
        while done < steps:
            while si < len(script) and int(script[si][0]) <= done:
                _, gx, gy = script[si]
                goal_pub.publish(Pose2D(x=float(gx), y=float(gy)))
                si += 1
            k = min(chunk, steps - done)
            st.run_steps(k)
            done += k
            cur_xy = st.sim.truth_poses()[:, :2].copy()
            dist += np.linalg.norm(cur_xy - prev_xy, axis=1)
            prev_xy = cur_xy
            entry = {"step": done, "distance_m": float(dist.sum())}
            ws = st.mapper.world_status() \
                if hasattr(st.mapper, "world_status") else None
            if ws is not None:
                entry.update(
                    device_window_bytes=int(ws["device_window_bytes"]),
                    host_tiles=int(ws["host_tiles"]),
                    away_tiles=int(ws["away_tiles"]),
                    spill_tiles=(int(ws["spill"]["tiles"])
                                 if ws.get("spill") else 0),
                    origin_tile=[int(v) for v in ws["origin_tile"]])
            series.append(entry)
        # Revision BEFORE content (the C1 ordering doctrine): a stamp
        # read after the grid could pair new content with an older
        # revision's successor and misreport the mission's final state.
        final_revision = st.mapper.map_revision
        grid = st.mapper.merged_grid().cpu().numpy().copy()
        files = []
        if checkpoint_dir:
            # Files only: the flight recorder's `postmortem/` subdir
            # (obs/) shares the checkpoint dir but is not a generation.
            files = sorted(os.path.basename(p) for p in
                           glob.glob(os.path.join(checkpoint_dir, "*"))
                           if os.path.isfile(p))
        return MissionReport(
            grid=grid,
            plan_log=list(plan.log),
            n_mapper_restarts=(st.supervisor.n_restarts("jax_mapper")
                               if st.supervisor is not None else 0),
            n_scans_fused=st.mapper.n_scans_fused,
            n_decay_passes=st.mapper.n_decay_passes,
            n_world_updates=st.sim.n_world_updates,
            map_revision=final_revision,
            restart_epoch=st.mapper.restart_epoch,
            checkpoint_files=files,
            health_transitions=(list(st.health.transitions)
                                if st.health is not None else []),
            postmortem_dumps=_mission_dumps(flight_recorder, ev_mark),
            slo_alerts=[(e.get("tick"), e.get("objective"),
                         e.get("state"))
                        for e in flight_recorder.events_since(ev_mark)
                        if e["kind"] == "slo_alert"],
            distance_traveled_m=float(dist.sum()),
            distance_per_robot_m=[float(d) for d in dist],
            world_series=series,
        )
    finally:
        st.shutdown()
