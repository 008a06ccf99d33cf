"""Launch composition: assemble the simulated mission stack.

Port of the JAX package's `bridge/launch.py`. `launch_sim_stack` is the
equivalent of running both of the reference's launch files (the Pi's
LiDAR driver + static TF, the PC's SLAM + brain) against a simulated
world: one call wires the sim node, the brain, the mapper, the planner,
the fleet health registry, the supervisor and the recovery manager onto
one bus and returns a running stack with an explicit shutdown. The
stack's device work (sim physics and raycasts, the brain tick, every
SLAM step, the frontier publish and the planner) runs on `device`: the
CUDA card unless the caller asks for another.

`checkpoint_dir` arms the supervisor's auto-checkpoint cadence
(`Stack.save_auto_checkpoint`, `io/checkpoint.py`) and the mapper's
resume from it after a restart; with `cfg.world.windowed` the mapper
keeps the bounded-memory world (`world/store.py`), whose evicted tiles
spill under `checkpoint_dir/world_spill` and whose window manifest rides
beside each checkpoint.

`depth_cam=True` adds the depth-camera stack: the sim node renders a
depth image per robot a step, a `VoxelMapperNode` fuses them into the
shared voxel grid at the mapper's corrected poses, and the planner plans,
and the mapper's frontier auction runs, on the 2D map overlaid with the
voxel map's obstacle slice. Its grid and keyframe ring ride beside each
auto-checkpoint as the voxel and keyframe sidecars.

`http_port` serves the HTTP API (`bridge/http_api.py`, `Stack.api`) on
that port (0 picks a free one) from a thread of its own: the management
plane's routes, the tile serving and `/map-events`.

`cfg.obs.enabled` arms the obs tier's host half: a `Tracer` seeded with
the launch seed rides the bus (deterministic span ids), the
`PipelineLedger` stamps each revision's freshness waypoints, and an
`SloEngine` evaluates the declared objectives once a mapper tick; the
mapper, the HTTP API and the flight recorder get all three. An attached
`FaultPlan` (`Stack.attach_fault_plan`) fires on `run_steps`' step clock.

Not ported yet, and refused with NotImplementedError naming the ROADMAP
item rather than silently dropped: the obs tier's device half, the
dispatch profiler (`cfg.obs.devprof.enabled`), the warm-restart tier
(`cfg.cold_start.enabled`) and the tenancy control plane
(`cfg.tenancy.enabled`). So is the staged warm-up ladder of a mapper
restart, which pre-warms compiled entry points: the port's restart
rebuilds and resumes the mapper at once (`Stack.restart_mapper`).
A windowed stack with the planner is refused too: the JAX package's
planner plans with the logical grid config on the mapper's window-sized
grid, in the wrong frame (ROADMAP re-anchor note).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional, Set

import numpy as np
import torch

from jax_mapping_torch._util import resolve_device
from jax_mapping_torch.bridge.brain import ThymioBrain, robot_ns
from jax_mapping_torch.bridge.bus import Bus
from jax_mapping_torch.bridge.driver import SimulatedThymioDriver
from jax_mapping_torch.bridge.http_api import MapApiServer
from jax_mapping_torch.bridge.mapper import MapperNode
from jax_mapping_torch.bridge.messages import Header, TransformStamped
from jax_mapping_torch.bridge.node import Executor
from jax_mapping_torch.bridge.planner import PlannerNode
from jax_mapping_torch.bridge.sim_node import SimNode
from jax_mapping_torch.bridge.tf import TfTree
from jax_mapping_torch.bridge.voxel_mapper import VoxelMapperNode
from jax_mapping_torch.config import SlamConfig
from jax_mapping_torch.obs.recorder import flight_recorder
from jax_mapping_torch.recovery import RecoveryManager
from jax_mapping_torch.resilience.health import FleetHealth
from jax_mapping_torch.resilience.supervisor import Supervisor

#: Laser mount height from the reference's static TF
#: (`pi_hardware.launch.py:26-30`).
LASER_MOUNT_Z_M = 0.12


@dataclasses.dataclass
class Stack:
    """A running stack; fields are live objects."""

    cfg: SlamConfig
    bus: Bus
    tf: TfTree
    driver: SimulatedThymioDriver
    sim: SimNode
    brain: ThymioBrain
    mapper: MapperNode
    executor: Executor
    device: torch.device
    planner: Optional[PlannerNode] = None    # when cfg.planner.enabled
    health: Optional[FleetHealth] = None     # shared degraded-mode registry
    supervisor: Optional[Supervisor] = None  # heartbeat watch + restarts
    recovery: Optional[RecoveryManager] = None   # estimator guardrails
    voxel_mapper: Optional[VoxelMapperNode] = None   # when depth_cam
    api: Optional[MapApiServer] = None       # when http_port is given
    fault_plan: Optional[object] = None      # attached FaultPlan, if any
    #: Causal tracing (obs/trace.Tracer) when ObsConfig.enabled; the same
    #: object rides bus.tracer (span export, /trace).
    tracer: Optional[object] = None
    #: Pipeline latency ledger (obs/pipeline.PipelineLedger) when
    #: ObsConfig.enabled: per-revision scan→served waypoint stamps.
    pipeline: Optional[object] = None
    #: Freshness SLO engine (obs/slo.SloEngine) when ObsConfig.enabled and
    #: objectives are declared; evaluated once a mapper tick.
    slo: Optional[object] = None
    #: Auto-checkpoint file the supervisor saves to and the mapper
    #: resumes from ("" = no checkpoint_dir, no auto-checkpointing).
    auto_checkpoint_path: str = ""
    #: Where the windowed world's evicted tiles spill ("" = host LRU
    #: only); a restarted mapper reopens the same spill file.
    world_spill_dir: str = ""
    _killed: Set[str] = dataclasses.field(default_factory=set)
    _steps_run: int = 0

    def run_steps(self, n: int) -> None:
        """Faster-than-realtime: drive physics+brain+mapper loops directly,
        n sensor ticks (realtime=False stacks only). The planner keeps its
        cadence RATIO (one plan per period_s of simulated control time).

        An attached FaultPlan fires before each step on the step index;
        the supervisor ticks once per step AFTER the nodes, so a node
        killed at step k misses its k-th beat and the dead-declaration
        countdown starts the same step."""
        steps_per_plan = max(1, round(self.cfg.planner.period_s
                                      * self.cfg.robot.control_rate_hz))
        for _ in range(n):
            if self.fault_plan is not None:
                self.fault_plan.apply(self, self._steps_run)
            self.sim.step()
            if "thymio_brain" not in self._killed:
                self.brain.update_loop()
            if "jax_mapper" not in self._killed:
                self.mapper.tick()
            if self.voxel_mapper is not None:
                self.voxel_mapper.tick()
            self._steps_run += 1
            if self.planner is not None \
                    and self._steps_run % steps_per_plan == 0:
                self.planner.tick()
            if self.supervisor is not None:
                self.supervisor.tick()

    def attach_fault_plan(self, plan) -> None:
        """Arm a FaultPlan: `run_steps` applies it on the step clock."""
        self.fault_plan = plan

    def kill_node(self, name: str) -> None:
        """Destroy a node mid-mission (FaultPlan `kill_node`): timers
        cancelled, subscriptions closed, its stepped tick skipped. The
        supervisor notices the silent heartbeat and restarts it."""
        node = {"thymio_brain": self.brain,
                "jax_mapper": self.mapper}.get(name)
        if node is None:
            raise ValueError(f"kill_node: unknown node {name!r}")
        self._killed.add(name)
        node.destroy()

    def save_auto_checkpoint(self) -> None:
        """The supervisor's checkpoint hook: snapshot the mapper to
        `auto_checkpoint_path` (the previous generation rotates to
        `.prev`). A windowed mapper's `.world` manifest rotates in
        LOCKSTEP: a fallback to the `.prev` states must re-anchor from
        the manifest saved with them. With the depth-camera stack, the
        voxel grid and the keyframe ring are written beside it as the
        voxel and keyframe sidecars."""
        from jax_mapping_torch.io.checkpoint import (
            clear_world_sidecar, previous_checkpoint_path, save_checkpoint,
            save_keyframe_sidecar, save_voxel_sidecar, save_world_sidecar,
            world_sidecar_path)
        os.makedirs(os.path.dirname(self.auto_checkpoint_path),
                    exist_ok=True)
        world = self.mapper.world
        if world is not None:
            wp = world_sidecar_path(self.auto_checkpoint_path)
            if os.path.exists(wp):
                os.replace(wp, world_sidecar_path(
                    previous_checkpoint_path(self.auto_checkpoint_path)))
        save_checkpoint(
            self.auto_checkpoint_path, self.mapper.snapshot_states(),
            config_json=self.cfg.to_json(),
            retain_generations=self.cfg.resilience
            .checkpoint_retain_generations)
        if world is not None:
            save_world_sidecar(self.auto_checkpoint_path,
                               world.checkpoint_payload(),
                               config_json=self.cfg.to_json())
        else:
            clear_world_sidecar(self.auto_checkpoint_path)
        if self.voxel_mapper is not None:
            save_voxel_sidecar(self.auto_checkpoint_path,
                               self.voxel_mapper.snapshot_grid(),
                               config_json=self.cfg.to_json())
            save_keyframe_sidecar(self.auto_checkpoint_path,
                                  self.voxel_mapper.snapshot_keyframes(),
                                  config_json=self.cfg.to_json())

    def restart_mapper(self) -> None:
        """The supervisor's mapper restarter: rebuild the MapperNode,
        resume it from the newest intact auto-checkpoint generation
        (`load_checkpoint_with_fallback`), re-anchor each robot's chain at
        the BRAIN's live pose (odometry kept integrating while the mapper
        was down), and swap it into the executor and the planner. With no
        intact checkpoint the map restarts blank at the same anchors.

        Windowed, the window re-anchors from the checkpoint's `.world`
        manifest before the states install, and the brain's world-frame
        anchors move into the window frame; a missing, corrupt or drifted
        manifest degrades to the boot origin with a
        `world_sidecar_degraded` flight event. The JAX package's staged
        warm-up (pre-warming compiled entry points while serving the old
        epoch) is not ported (ROADMAP A.9g): the restart is immediate."""
        n = self.mapper.n_robots
        old = self.mapper
        old.destroy()
        states, used_path = None, None
        if self.auto_checkpoint_path:
            from jax_mapping_torch.io.checkpoint import (
                CheckpointCorrupt, load_checkpoint_with_fallback)
            try:
                states, _cfg_json, used_path = \
                    load_checkpoint_with_fallback(
                        self.auto_checkpoint_path,
                        old.checkpoint_template())
            except (FileNotFoundError, CheckpointCorrupt):
                states = None                # no intact generation: blank
        new = MapperNode(self.cfg, self.bus, tf=self.tf, n_robots=n,
                         health=self.health, recovery=self.recovery,
                         pipeline=self.pipeline, slo=self.slo,
                         device=self.device,
                         spill_dir=self.world_spill_dir or None)
        new.restart_epoch = old.restart_epoch + 1
        flight_recorder.record("restart_epoch", node="jax_mapper",
                               epoch=new.restart_epoch,
                               resumed_from_checkpoint=states is not None)
        anchors = np.array(self.brain.poses, np.float32)
        if states is not None:
            payload = None
            if new.world is not None:
                from jax_mapping_torch.io.checkpoint import \
                    load_world_sidecar
                try:
                    payload = load_world_sidecar(
                        used_path, running_config_json=self.cfg.to_json())
                except Exception as e:       # noqa: BLE001
                    flight_recorder.record(
                        "world_sidecar_degraded", node="jax_mapper",
                        error=f"{type(e).__name__}: {e}")
            new.resume(states, payload, anchors)
        else:
            _anchor(new, anchors)
        self.mapper = new
        self.executor.nodes = [new if nd is old else nd
                               for nd in self.executor.nodes]
        if self.planner is not None:
            self.planner.mapper = new
            if self.planner.voxel_mapper is not None:
                new.frontier_grid_provider = self.planner._planning_grid
                new.frontier_grid_key_provider = self.planner.overlay_key
        if self.voxel_mapper is not None:
            # The voxel node survives the restart, its map with it; it
            # follows the new node's corrections and graph from here.
            self.voxel_mapper.mapper = new
        if self.api is not None:
            # Rebuilds the serving bundle around the new node: its tile
            # stores and revision listener closed over the old one.
            self.api.rebind_mapper(new)
        self._killed.discard("jax_mapper")

    def shutdown(self) -> None:
        if self.api is not None:
            self.api.shutdown()
        self.executor.shutdown()


def _anchor(mapper: MapperNode, poses: np.ndarray) -> None:
    """Start every robot's chain at its row of `poses` (R, 3): one copy
    to the mapper's device."""
    dev_poses = torch.as_tensor(np.asarray(poses, np.float32),
                                device=mapper.device)
    for i, st in enumerate(mapper.states):
        mapper.states[i] = st._replace(pose=dev_poses[i])


def _refuse_unported(cfg: SlamConfig) -> None:
    refused = [
        (cfg.world.windowed and cfg.planner.enabled, "cfg.world.windowed "
         "with cfg.planner.enabled: the JAX package's planner plans with "
         "the logical grid config on the mapper's window-sized grid, in "
         "the wrong frame (ROADMAP re-anchor note); disable the planner "
         "for a windowed stack"),
        (cfg.obs.devprof.enabled, "cfg.obs.devprof.enabled: the dispatch "
         "profiler and the cost ledger (obs/devprof.py, obs/ledger.py), "
         "the obs tier's device half, are not ported yet (ROADMAP "
         "A.9f2)"),
        (cfg.cold_start.enabled, "cfg.cold_start.enabled: the warm-restart "
         "tier (io/compile_cache.py, resilience/warmup.py) is not ported "
         "yet (ROADMAP A.9g)"),
        (cfg.tenancy.enabled, "cfg.tenancy.enabled: the tenancy control "
         "plane (tenancy/controlplane.py) is not ported yet (ROADMAP A.9h)"),
    ]
    for on, what in refused:
        if on:
            raise NotImplementedError(f"launch_sim_stack: {what}")


def launch_sim_stack(cfg: SlamConfig, world: np.ndarray,
                     world_res_m: Optional[float] = None,
                     n_robots: int = 1, http_port: Optional[int] = None,
                     realtime: bool = False,
                     drop_prob: float = 0.0, seed: int = 0,
                     depth_cam: bool = False,
                     checkpoint_dir: Optional[str] = None,
                     device=None) -> Stack:
    """Boot the whole graph on `device` (None: the CUDA card, raising
    without one; the CPU only when asked). realtime=False leaves timers
    idle so callers step deterministically via `Stack.run_steps`;
    realtime=True spins the executor thread. `seed` seeds the bus's loss
    weather, the fleet's spawn radii and wheel noise, and the
    supervisor's jitter, and the tracer's ids. `http_port` serves the HTTP
    API (0: a free port, `Stack.api.port`)."""
    _refuse_unported(cfg)
    dev = resolve_device(device)
    res = world_res_m if world_res_m is not None else cfg.grid.resolution_m
    tracer = pipeline = slo = None
    if cfg.obs.enabled:
        # Causal tracing: deterministic trace ids from (this seed, topic,
        # per-topic publish seq). The freshness tier rides the same gate;
        # the SLO engine exists only when objectives are declared.
        # enabled=False constructs none of them.
        from jax_mapping_torch.obs.pipeline import PipelineLedger
        from jax_mapping_torch.obs.slo import SloEngine
        from jax_mapping_torch.obs.trace import Tracer
        tracer = Tracer(seed=seed, capacity=cfg.obs.trace_ring)
        pipeline = PipelineLedger()
        if cfg.obs.slo:
            slo = SloEngine(cfg.obs.slo, pipeline=pipeline)
    # The always-on flight recorder follows the newest stack; its dumps
    # go to the checkpoint dir's `postmortem/` (None: events only) and
    # carry the tracer's spans and the ledger's records when armed.
    flight_recorder.configure(
        dump_dir=(os.path.join(checkpoint_dir, "postmortem")
                  if checkpoint_dir else None),
        tracer=tracer, capacity=cfg.obs.recorder_ring, pipeline=pipeline)
    bus = Bus(domain_id=cfg.domain_id, drop_prob=drop_prob, seed=seed,
              tracer=tracer)
    tf = TfTree()
    for i in range(n_robots):
        ns = robot_ns(i, n_robots)
        tf.set_static_transform(TransformStamped(
            header=Header(frame_id=f"{ns}base_link"),
            child_frame_id=f"{ns}base_laser", z=LASER_MOUNT_Z_M))

    driver = SimulatedThymioDriver(n_robots=n_robots)
    sim = SimNode(cfg, bus, driver, world, res, tf=tf,
                  rate_hz=cfg.robot.control_rate_hz, seed=seed,
                  realtime=realtime, device=dev, depth_cam=depth_cam)
    health = (FleetHealth(cfg.resilience, n_robots)
              if cfg.resilience.enabled else None)
    recovery = None
    if cfg.recovery.enabled and health is not None:
        # The guardrails act through the health ladder (coast, LED,
        # frontier reassignment), so they require resilience.
        recovery = RecoveryManager(cfg.recovery, n_robots, robot=cfg.robot)
    brain = ThymioBrain(cfg, bus, driver, tf=tf, n_robots=n_robots,
                        health=health, recovery=recovery, device=dev)
    # Start calibrated: the odom frame origin is the boot pose, so the
    # robots' maps line up from the first scan.
    brain.poses = sim.truth_poses().copy()
    # The windowed world's spill tier lives under the checkpoint dir, so
    # tiles evicted before a mapper restart rehydrate after it.
    world_spill_dir = (os.path.join(checkpoint_dir, "world_spill")
                       if checkpoint_dir and cfg.world.windowed else "")
    mapper = MapperNode(cfg, bus, tf=tf, n_robots=n_robots, health=health,
                        recovery=recovery, pipeline=pipeline, slo=slo,
                        device=dev,
                        spill_dir=world_spill_dir or None)
    _anchor(mapper, brain.poses)

    voxel_mapper = None
    if depth_cam:
        voxel_mapper = VoxelMapperNode(cfg, bus, tf=tf, n_robots=n_robots,
                                       mapper=mapper)

    planner = None
    if cfg.planner.enabled:
        planner = PlannerNode(cfg, bus, mapper=mapper, brain=brain,
                              voxel_mapper=voxel_mapper, health=health)
        if planner.voxel_mapper is not None:
            # One map for assignment and planning: the auction must not
            # assign frontiers whose corridors only the 3D overlay knows
            # are blocked; the overlay's key lets the incremental publish
            # keep its tiles while only the 2D map moves.
            mapper.frontier_grid_provider = planner._planning_grid
            mapper.frontier_grid_key_provider = planner.overlay_key

    supervisor = None
    if cfg.resilience.enabled:
        # Ticks at the control rate, like run_steps' one tick a step.
        supervisor = Supervisor(cfg.resilience, bus, seed=seed,
                                tick_period_s=1.0
                                / cfg.robot.control_rate_hz)

    api = None
    if http_port is not None:
        api = MapApiServer(bus, brain=brain, port=http_port,
                           mapper=mapper, voxel_mapper=voxel_mapper,
                           planner=planner, health=health,
                           supervisor=supervisor, recovery=recovery,
                           pipeline=pipeline, slo=slo,
                           lock_timeout_s=cfg.resilience.http_lock_timeout_s)
        api.serve_thread()

    nodes = [sim, brain, mapper] + \
        ([voxel_mapper] if voxel_mapper is not None else []) + \
        ([planner] if planner is not None else []) + \
        ([supervisor] if supervisor is not None else [])
    executor = Executor(nodes)
    stack = Stack(cfg=cfg, bus=bus, tf=tf, driver=driver, sim=sim,
                  brain=brain, mapper=mapper, executor=executor, device=dev,
                  planner=planner, health=health, supervisor=supervisor,
                  recovery=recovery, world_spill_dir=world_spill_dir,
                  voxel_mapper=voxel_mapper, api=api, tracer=tracer,
                  pipeline=pipeline, slo=slo)
    if supervisor is not None:
        # The brain has no restarter: its driver link and poses cannot be
        # rebuilt; its death is declared and exported.
        supervisor.register("thymio_brain")
        supervisor.register("jax_mapper", stack.restart_mapper)
        if checkpoint_dir is not None:
            stack.auto_checkpoint_path = os.path.join(
                checkpoint_dir, "auto_checkpoint.npz")
            supervisor.attach_checkpointer(stack.save_auto_checkpoint)
    if realtime:
        executor.spin_thread()
    return stack
