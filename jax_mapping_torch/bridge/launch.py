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

`cfg.obs.devprof.enabled` arms the obs tier's device half: a
`DispatchProfiler` (`obs/devprof.py`) wraps the package's entry points
process-wide once the stack is built (after any launch-time warm-up),
and the HTTP API exports it (`/status.perf`, the `jax_mapping_device_*`
families). `cfg.cold_start.enabled` arms the warm-restart tier: a
`CompileCacheManager` (`io/compile_cache.py`) under
`cold_start.cache_dir` (else `<checkpoint_dir>/compile_cache`) holds the
kernel build cache and the signature manifest, and a launch-time
`StagedWarmup` pre-warms the manifest's signatures. A mapper restart
always goes through the staged warm-up (`Stack.restart_mapper`): while
it restores and pre-warms, the HTTP API answers from the prior epoch with
`state=warming`.

`cfg.tenancy.enabled` adds the tenancy control plane
(`tenancy/controlplane.py`, `Stack.tenancy`) beside the stack, on its
device, with the stack's compile cache, dispatch profiler and pipeline
ledger and its checkpoints under `<checkpoint_dir>/tenants`; the HTTP API
serves it (`/status.tenancy`, `/tiles?tenant=`, the
`jax_mapping_tenant_*` families), `save_auto_checkpoint` checkpoints its
live tenants, and `Stack.crash_controlplane` (the `controlplane_crash`
fault) rebuilds it from its journal.

Refused with NotImplementedError rather than silently dropped: a
windowed stack with the planner: the JAX package's planner plans with the
logical grid config on the mapper's window-sized grid, in the wrong frame
(ROADMAP re-anchor note).
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
    #: Mission multi-tenancy control plane
    #: (tenancy/controlplane.TenantControlPlane) when
    #: TenancyConfig.enabled: megabatched missions beside this stack.
    tenancy: Optional[object] = None
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
    #: Dispatch profiler (obs/devprof.DispatchProfiler) when
    #: ObsConfig.devprof.enabled — wraps the entry points process-wide;
    #: shutdown() uninstalls so a later stack can own the wrappers.
    devprof: Optional[object] = None
    #: Warm-restart storage tier (io/compile_cache.CompileCacheManager)
    #: when ColdStartConfig.enabled: the kernel build cache, the
    #: signature manifest, the cache_wipe fault boundary.
    compile_cache: Optional[object] = None
    #: The staged warm-up state machine (resilience/warmup.StagedWarmup)
    #: of restart_mapper's restore -> warm -> ready ladder; made on the
    #: first restart when launch did not make one.
    warmup: Optional[object] = None
    #: Called with the stack DURING the warming stage of a staged
    #: restart (serving still answering from the prior epoch with
    #: state=warming). Exceptions are contained; the restart proceeds.
    warmup_hook: Optional[object] = None
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
        if self.tenancy is not None:
            self.tenancy.checkpoint_all()

    def crash_controlplane(self) -> dict:
        """Kill the tenancy control plane and rebuild it from its journal
        and checkpoints (the `controlplane_crash` FaultPlan kind): the
        in-memory registry is dropped, a NEW plane replays
        snapshot+journal through `restore()`, and the API swaps to it —
        the same tenant set comes back with every epoch advanced. Returns
        the restore report."""
        old = self.tenancy
        if old is None:
            raise ValueError("crash_controlplane: no tenancy plane "
                             "on this stack")
        old.checkpoint_all()
        from jax_mapping_torch.tenancy import TenantControlPlane
        plane = TenantControlPlane(
            self.cfg, world_res_m=old.world_res_m,
            checkpoint_dir=old.checkpoint_dir,
            compile_cache=self.compile_cache, devprof=self.devprof,
            pipeline=self.pipeline, device=self.device)
        report = plane.restore()
        self.tenancy = plane
        if self.api is not None:
            self.api.tenancy = plane
        return report

    def restart_mapper(self) -> None:
        """The supervisor's mapper restarter, a STAGED warm-up: rebuild the
        MapperNode, resume it from the newest intact auto-checkpoint
        generation (`load_checkpoint_with_fallback`), pre-warm the entry
        points in priority order (`resilience/warmup.py`), and only then
        swap it into the executor, the planner and the API — which is
        what re-admits it (the supervisor's fresh heartbeat grace starts
        when this returns). While it restores and warms, the API answers
        from the OLD node's last epoch with `state=warming` instead of
        blocking. Each robot's chain re-anchors at the BRAIN's live pose
        (odometry kept integrating while the mapper was down). With no
        intact checkpoint the map restarts blank at the same anchors.

        Windowed, the window re-anchors from the checkpoint's `.world`
        manifest before the states install, and the brain's world-frame
        anchors move into the window frame; a missing, corrupt or drifted
        manifest degrades to the boot origin with a
        `world_sidecar_degraded` flight event."""
        if self.warmup is None:
            from jax_mapping_torch.resilience.warmup import StagedWarmup
            self.warmup = StagedWarmup(cache=self.compile_cache,
                                       devprof=self.devprof,
                                       device=self.device)
        wu = self.warmup
        if self.api is not None:
            self.api.set_warming(True)
        try:
            self._restart_mapper_staged(wu)
        finally:
            if self.api is not None:
                self.api.set_warming(False)
        wu.mark_ready()

    def _restart_mapper_staged(self, wu) -> None:
        n = self.mapper.n_robots
        old = self.mapper
        old.destroy()
        wu.begin_restore()
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
        # Pre-warm BEFORE the new node enters service, fusion first; an
        # in-process restart finds every signature warm. The profiler
        # re-baselines inside prewarm.
        wu.begin_warming()
        wu.prewarm(self.devprof.signatures() if self.devprof is not None
                   else {})
        if self.warmup_hook is not None:
            # Observe the degraded-serving window (prior epoch content,
            # state=warming) from inside it.
            try:
                self.warmup_hook(self)
            except Exception:                # noqa: BLE001
                import traceback
                traceback.print_exc()
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

    def save_compile_snapshots(self) -> dict:
        """Write the signature manifest of every (entry point, captured
        signature) the dispatch profiler observed, and the loaded kernel
        libraries, into the warm-restart tier. Explicit only (CLI,
        tests, the smoke); needs both the tier and the profiler, else
        reports an empty pass."""
        if self.compile_cache is None or self.devprof is None:
            return {"n_saved": 0, "n_failed": 0, "n_uncallable": 0,
                    "n_libraries": 0, "names": []}
        return self.compile_cache.save_aot(self.devprof.signatures())

    def shutdown(self) -> None:
        if self.api is not None:
            self.api.shutdown()
        self.executor.shutdown()
        if self.compile_cache is not None:
            # The build directory is process-global: the next stack owns
            # it. (The warm pool installs no wrapper to take off.)
            self.compile_cache.disable()
        if self.devprof is not None:
            # After the HTTP plane and executor stop: no worker thread is
            # mid-dispatch through a wrapper being unbound.
            self.devprof.uninstall()


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
    compile_cache = None
    if cfg.cold_start.enabled:
        # The build cache attaches before anything builds a kernel, so
        # every library this launch builds lands in it. Failures degrade
        # to the default build directory, never block the launch.
        cache_root = cfg.cold_start.cache_dir or (
            os.path.join(checkpoint_dir, "compile_cache")
            if checkpoint_dir else "")
        if cache_root:
            from jax_mapping_torch.io.compile_cache import \
                CompileCacheManager
            compile_cache = CompileCacheManager(
                cfg.cold_start, cache_root, config_json=cfg.to_json(),
                device=dev)
            compile_cache.enable()
            compile_cache.evict_lru()
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
    devprof = None
    if cfg.obs.devprof.enabled:
        # Built here, INSTALLED at the end of launch, after the
        # launch-time warm-up, so that its baseline holds what the
        # warm-up dispatched. enabled=False builds nothing.
        from jax_mapping_torch.obs.devprof import DispatchProfiler
        devprof = DispatchProfiler(cfg.obs.devprof, tracer=tracer)
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
                           devprof=devprof, pipeline=pipeline, slo=slo,
                           lock_timeout_s=cfg.resilience.http_lock_timeout_s)
        api.serve_thread()

    nodes = [sim, brain, mapper] + \
        ([voxel_mapper] if voxel_mapper is not None else []) + \
        ([planner] if planner is not None else []) + \
        ([supervisor] if supervisor is not None else [])
    executor = Executor(nodes)
    warmup = None
    if compile_cache is not None:
        # Launch-time staged warm-up (a resume process): pre-warm the
        # manifest's signatures through the build cache BEFORE devprof
        # installs, so that the profiler's baseline holds them (a warm
        # boot must not report its cold-start repayment as recompiles).
        from jax_mapping_torch.resilience.warmup import StagedWarmup
        warmup = StagedWarmup(cache=compile_cache, devprof=devprof,
                              device=dev)
        if cfg.cold_start.prewarm_on_launch:
            warmup.begin_warming()
            warmup.prewarm()
            warmup.mark_ready()
    if devprof is not None:
        devprof.install()
    stack = Stack(cfg=cfg, bus=bus, tf=tf, driver=driver, sim=sim,
                  brain=brain, mapper=mapper, executor=executor, device=dev,
                  planner=planner, health=health, supervisor=supervisor,
                  recovery=recovery, world_spill_dir=world_spill_dir,
                  voxel_mapper=voxel_mapper, api=api, tracer=tracer,
                  pipeline=pipeline, slo=slo, devprof=devprof,
                  compile_cache=compile_cache, warmup=warmup)
    if cfg.tenancy.enabled:
        # The control plane beside the bridge stack, sharing its
        # warm-restart tier and dispatch profiler. enabled=False builds
        # nothing.
        from jax_mapping_torch.tenancy import TenantControlPlane
        stack.tenancy = TenantControlPlane(
            cfg, world_res_m=res,
            checkpoint_dir=(os.path.join(checkpoint_dir, "tenants")
                            if checkpoint_dir else None),
            compile_cache=compile_cache, devprof=devprof,
            pipeline=pipeline, device=dev)
        if api is not None:
            api.tenancy = stack.tenancy
    if api is not None and (compile_cache is not None
                            or warmup is not None):
        # /status `cold_start`: cache counters, pool stats, the warm-up
        # report (a closure over the stack, so a later staged restart's
        # state shows live).
        api.coldstart_status = lambda: {
            "cache": (stack.compile_cache.status()
                      if stack.compile_cache is not None else None),
            "warmup": (stack.warmup.snapshot()
                       if stack.warmup is not None else None),
        }
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
