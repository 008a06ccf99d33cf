"""Configuration for the PyTorch port: the slice of `SlamConfig` that the
fleet tick, the SLAM step, the planner, the voxel path, the recovery
path, the tenant megabatch and the simulated mission stack read, with
the JAX package's field names and defaults.

The dataclasses are frozen, so a config is hashable and can key caches.
`SlamConfig.from_json` accepts the JSON that the JAX package's
`SlamConfig.to_json()` writes and ignores the sections this package does
not have yet, so one config text builds both sides of a parity test.

`align_rows` / `align_cols` keep their TPU values (8 / 128): patch
origins are snapped to them (`ops/grid.patch_origin`), so changing them
would move every patch and every fused cell.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
from typing import Any, Dict, Optional, Tuple


def _frozen(cls):
    return dataclasses.dataclass(frozen=True)(cls)


@_frozen
class GridConfig:
    """Occupancy-grid geometry and the log-odds inverse sensor model."""

    size_cells: int = 4096
    resolution_m: float = 0.05
    patch_cells: int = 640
    max_range_m: float = 12.0
    align_rows: int = 8
    align_cols: int = 128
    logodds_free: float = -0.40
    logodds_occ: float = 0.85
    logodds_min: float = -4.0
    logodds_max: float = 4.0
    occ_threshold: float = 0.5
    free_threshold: float = -0.5
    hit_tolerance_cells: float = 1.0
    # Selects the JAX package's fusion engine. The port's scattered folds
    # always stream (`ops/fuse_kernel.stream_fold`); a shared-patch window
    # goes through kernel K5 when True and through K4 plus `apply_patch`
    # when False. Both give the same grid.
    fused_fusion: bool = True

    @property
    def extent_m(self) -> float:
        return self.size_cells * self.resolution_m

    @property
    def origin_m(self) -> Tuple[float, float]:
        """World coordinate of cell (0, 0)'s corner; the grid is centred."""
        half = self.extent_m / 2.0
        return (-half, -half)

    @property
    def max_range_cells(self) -> float:
        return self.max_range_m / self.resolution_m

    def contains_m(self, x: float, y: float) -> bool:
        """True when world point (x, y) lies on the grid: finite and
        inside the half-open extent [origin, origin + extent) on both
        axes. The goal-ingress predicate of the brain and the planner."""
        if not (math.isfinite(x) and math.isfinite(y)):
            return False
        ox, oy = self.origin_m
        span = self.extent_m
        return ox <= x < ox + span and oy <= y < oy + span


@_frozen
class ScanConfig:
    """LaserScan geometry of the LD06: beams padded to a static length."""

    n_beams: int = 360
    padded_beams: int = 512
    angle_min_rad: float = 0.0
    angle_increment_rad: float = 2.0 * math.pi / 360.0
    counterclockwise: bool = True
    invalid_range_m: float = 10.0
    range_min_m: float = 0.02
    range_max_m: float = 12.0


@_frozen
class RobotConfig:
    """Differential-drive Thymio II model with explicit units."""

    speed_coeff_m_per_unit_s: float = 0.0003027
    wheel_base_m: float = 0.0935
    cruise_speed_units: int = 100
    rotation_speed_units: int = 50
    ir_threshold: int = 1800
    lidar_warn_dist_m: float = 0.25
    lidar_stop_dist_m: float = 0.40
    swerve_inner_units: int = -10
    control_rate_hz: float = 10.0
    motor_limit_units: int = 600
    motor_lag_tau_s: float = 0.15
    # Read by nothing on the fleet path: `sim.thymio.step_fleet` is called
    # there with its own default noise fraction, as in the JAX package.
    speed_noise_frac: float = 0.05


@_frozen
class MatcherConfig:
    """Correlative scan-matcher search windows and gates."""

    search_half_extent_m: float = 0.5
    coarse_step_m: float = 0.05
    fine_step_m: float = 0.01
    coarse_angle_half_rad: float = 0.349
    coarse_angle_step_rad: float = 0.0349
    fine_angle_step_rad: float = 0.00349
    smear_cells: int = 2
    min_response: float = 0.1
    distance_variance_penalty_m2: float = 0.5
    angle_variance_penalty_rad2: float = 1.0
    min_distance_penalty: float = 0.5
    min_angle_penalty: float = 0.9
    # A TPU-only knob of the JAX package; the port always scores in f32.
    coarse_bf16: bool = True
    pruned: bool = True
    bnb_topk: int = 64
    bnb_leaf_topk: int = 16
    bnb_levels: int = 0
    min_travel_m: float = 0.1
    min_heading_rad: float = 0.1


@_frozen
class LoopClosureConfig:
    """Loop-closure gating and the fixed-capacity pose graph."""

    enabled: bool = True
    search_radius_m: float = 3.0
    min_chain_size: int = 10
    response_coarse: float = 0.35
    response_fine: float = 0.45
    loop_window_m: float = 8.0
    coarse_downsample: int = 4
    max_poses: int = 1024
    max_edges: int = 4096
    gn_iters: int = 8
    damping: float = 1e-3
    cross_robot: bool = True


@_frozen
class FrontierConfig:
    """Frontier detection, clustering, cost-to-go and assignment."""

    downsample: int = 4
    cluster_downsample: int = 4
    max_clusters: int = 64
    min_cluster_cells: int = 4
    label_prop_iters: int = 96
    bfs_iters: int = 512
    obstacle_aware: bool = True
    exact_bfs: bool = False
    mg_levels: int = 3
    mg_refine_iters: int = 8
    seek_assigned: bool = True
    planned_goals: bool = False
    waypoint_lookahead: int = 2
    seek_ttl_s: float = 5.0
    incremental: bool = True
    crop_pad: int = 32
    pose_skip_m: float = 0.05
    warm_start: bool = True
    warm_extra_iters: int = 4
    decay_aware: bool = False
    stale_bonus: float = 0.3


@_frozen
class AnalysisConfig:
    """Canonical scenario of the compile budget (`obs/ledger.py`
    `measure_scenario`, the JAX package's `analysis/compilebudget.py`):
    a deterministic tiny-config stack drive whose per-entry-point variant
    counts the committed `obs/compile_budget.json` pins. Not part of
    `SlamConfig`: it configures the measurement, not the stack."""

    budget_n_robots: int = 2
    budget_world_cells: int = 96      # plank_course arena edge
    budget_steps: int = 16            # exploration steps driven
    budget_seed: int = 3
    # Tenant counts stepped through `megabatch_step` at the micro_config
    # mission shape: 5 and 6 share the 6-bucket, so exactly two variants.
    budget_tenant_counts: Tuple[int, ...] = (3, 5, 6)


@_frozen
class FleetConfig:
    """Multi-robot scaling."""

    n_robots: int = 8
    batch_scans: int = 16
    mesh_fleet: int = 1
    mesh_space: int = 1


@_frozen
class PlannerConfig:
    """Goal-seeded path planning on the first-level coarse grid
    (`ops/planner.py`): a cost-to-go field seeded at the goal, greedy
    descent from the robot, and a lookahead waypoint to steer at."""

    enabled: bool = True
    period_s: float = 1.0             # replan cadence
    # Descent bound in first-level coarse cells; also the path's length.
    max_path_len: int = 256
    lookahead_cells: int = 4          # waypoint distance along the path
    waypoint_ttl_s: float = 3.0
    # Goal-seeded field bound: each unit is one doubled min-plus sweep.
    bfs_iters: int = 512
    frontier_waypoints: bool = True
    use_voxel_obstacles: bool = True
    # Height band (metres above the floor) whose occupied voxels block.
    voxel_z_min_m: float = 0.05
    voxel_z_max_m: float = 0.30


@_frozen
class VoxelConfig:
    """3D log-odds voxel grid, laid out (Z, Y, X); update patches span the
    full Z extent, so patch origins are 2D (y0, x0) like the 2D grid's.

    `patch_cells` must satisfy patch/2 - align_x/2 >= max_range_m /
    resolution_m (the coverage contract, `ops/voxel._check_patch_coverage`):
    origin alignment can shift a patch up to align_x/2 cells off centre.
    `align_y` / `align_x` keep the JAX package's values (8 / 128), since
    they decide where every patch lands.
    """

    size_x_cells: int = 1024
    size_y_cells: int = 1024
    size_z_cells: int = 64
    resolution_m: float = 0.05
    patch_cells: int = 384
    max_range_m: float = 5.0          # the depth camera's trust horizon
    align_y: int = 8
    align_x: int = 128
    logodds_free: float = -0.40
    logodds_occ: float = 0.85
    logodds_min: float = -4.0
    logodds_max: float = 4.0
    occ_threshold: float = 0.5
    free_threshold: float = -0.5
    hit_tolerance_cells: float = 1.0  # half-width of the occupied shell
    # Depth keyframes the SLAM-coupled voxel mapper keeps for re-fusing
    # after loop closures, for the whole fleet.
    keyframe_cap: int = 256

    @property
    def extent_m(self) -> Tuple[float, float, float]:
        return (self.size_x_cells * self.resolution_m,
                self.size_y_cells * self.resolution_m,
                self.size_z_cells * self.resolution_m)

    @property
    def origin_m(self) -> Tuple[float, float, float]:
        """World coordinate of voxel (0, 0, 0)'s corner: centred in x/y,
        z from the ground plane."""
        ex, ey, _ = self.extent_m
        return (-ex / 2.0, -ey / 2.0, 0.0)


@_frozen
class DepthCamConfig:
    """Pinhole depth camera: optical z forward, x right, y down; depth is z
    along the optical axis, and a reading of exactly 0 means no return (it
    carves nothing)."""

    width_px: int = 160
    height_px: int = 120
    hfov_rad: float = 1.5010          # ~86 degrees
    range_min_m: float = 0.2
    range_max_m: float = 5.0
    mount_height_m: float = 0.25      # camera z above the ground
    mount_pitch_rad: float = 0.0      # > 0 tilts the optical axis up

    @property
    def fx(self) -> float:
        return (self.width_px / 2.0) / math.tan(self.hfov_rad / 2.0)

    @property
    def fy(self) -> float:
        return self.fx                # square pixels

    @property
    def cx(self) -> float:
        return self.width_px / 2.0 - 0.5

    @property
    def cy(self) -> float:
        return self.height_px / 2.0 - 0.5


@_frozen
class RecoveryConfig:
    """Estimator guardrails (the `recovery` package): the divergence
    watchdog's score and hysteresis, the quarantine and wide-window
    relocalization gates, and the anti-stuck ladder. Watchdog thresholds
    count mapper observations; anti-stuck thresholds count control
    ticks."""

    enabled: bool = True
    # -- divergence watchdog -------------------------------------------------
    # Key observations before a rejected match is charged (an empty map
    # rejects legitimately at bootstrap).
    min_keyscans: int = 5
    # score = decay * score + (1 - decay) * bad, with
    # bad = agreement_weight * min(1, (1 - agreement) / deficit_scale)
    #     + match_weight * (1 - matched)             [key steps only]
    #     + cov_weight * min(1, cov_trace / cov_scale_m2).
    score_decay: float = 0.7
    match_weight: float = 0.5
    agreement_weight: float = 0.5
    agreement_deficit_scale: float = 0.35
    cov_weight: float = 0.1
    cov_scale_m2: float = 0.05
    # `diverge_persist_steps` consecutive observations at or above the
    # threshold declare divergence.
    diverge_threshold: float = 0.4
    diverge_persist_steps: int = 3
    # -- quarantine + relocalization ----------------------------------------
    quarantine_cap: int = 64
    # A re-anchor is verified by `reloc_consecutive` consecutive accepted
    # matches with at least this response whose poses agree within the
    # consistency radii, each scan agreeing with the map at its pose.
    reloc_min_response: float = 0.35
    reloc_consecutive: int = 2
    reloc_consistency_m: float = 0.2
    reloc_consistency_rad: float = 0.25
    reloc_min_agreement: float = 0.8
    # -- anti-stuck recovery ladder -----------------------------------------
    # Stuck: commanded motion on >= stuck_commanded_frac of the window's
    # ticks, yet net displacement under stuck_displacement_frac of the
    # distance the commands should have produced.
    stuck_window_ticks: int = 30
    stuck_displacement_frac: float = 0.25
    stuck_commanded_frac: float = 0.6
    min_commanded_units: int = 20
    # Rungs: rotate, backup, blacklist; a re-detection within the
    # escalation memory climbs one rung.
    rotate_recovery_ticks: int = 12
    backup_recovery_ticks: int = 10
    escalation_memory_ticks: int = 90
    blacklist_ttl_ticks: int = 300


@_frozen
class ResilienceConfig:
    """Fleet supervision and graceful degradation (`resilience/`): the
    degraded-mode ladder the brain, mapper and planner consult, and the
    supervisor's restart policy. Staleness thresholds count control
    ticks, the deterministic time base of stepped runs."""

    enabled: bool = True
    # Control ticks without a scan before a robot coasts on odometry
    # (NO_LIDAR), and before it is declared DEAD (its frontier work is
    # reassigned).
    lidar_silent_ticks: int = 10
    dead_after_ticks: int = 30
    # Supervisor ticks without a heartbeat before a node is declared
    # dead; the restart backoff (supervisor ticks) and its seeded jitter.
    supervisor_missed_beats: int = 3
    restart_backoff_base_steps: int = 2
    restart_backoff_max_steps: int = 64
    restart_backoff_jitter: float = 0.25
    # Auto-checkpoint cadence in steps (0: off) and generations kept.
    checkpoint_every_steps: int = 50
    checkpoint_retain_generations: int = 2
    # The mapper rejects (does not install) a step whose fused evidence
    # agrees with the map less than this: a garbage burst must not
    # overwrite known-good map.
    window_agreement_reject: float = 0.02
    # Bounded lock wait of the HTTP plane before answering 503.
    http_lock_timeout_s: float = 2.0


@_frozen
class ColdStartConfig:
    """Warm-restart tier (`io/compile_cache.py`, `resilience/warmup.py`):
    the kernel build cache under `cache_dir` (else
    `<checkpoint_dir>/compile_cache`), bounded to `max_cache_bytes`; a
    manifest of the dispatched signatures (`aot_snapshots`) that a
    resumed process pre-warms; the staged warm-up at launch
    (`prewarm_on_launch`). `enabled=False` builds none of it; a mapper
    restart still goes through the staged warm-up."""

    enabled: bool = False
    cache_dir: str = ""
    max_cache_bytes: int = 256 * 1024 * 1024
    aot_snapshots: bool = True
    prewarm_on_launch: bool = True


@_frozen
class DecayConfig:
    """Map healing for changing worlds: every `every_n_ticks` mapper
    ticks one pass multiplies every cell's log-odds by `factor` and
    clamps it to +-`evidence_cap` (`ops/grid.decay_grid`). `enabled=False`
    runs no pass."""

    enabled: bool = False
    every_n_ticks: int = 20
    factor: float = 0.92
    evidence_cap: float = 2.0


@_frozen
class DevProfConfig:
    """Dispatch profiling of the port's entry points (`obs/devprof.py`):
    host time a call, call counts, compiled variants (new signature keys)
    and their signatures, up to `max_signatures_per_fn`, for the cost
    ledger and the warm-up; `device:<fn>` spans with `trace_spans`; the
    card's allocator watermarks with `memory_stats`. `enabled=False`
    builds nothing."""

    enabled: bool = False
    capture_signatures: bool = True
    max_signatures_per_fn: int = 8
    trace_spans: bool = False
    memory_stats: bool = True


@_frozen
class SloObjective:
    """One freshness or latency objective, evaluated by the SLO engine
    (`obs/slo.py`) once a mapper tick when `ObsConfig.enabled`."""

    name: str = ""
    metric: str = "scan_to_served_p99_ms"
    threshold: float = 250.0
    max_silent_ticks: int = 0
    fast_window_ticks: int = 20
    slow_window_ticks: int = 120
    fast_burn: float = 0.5
    slow_burn: float = 0.25


@_frozen
class ObsConfig:
    """Observability. The flight recorder (`obs/recorder.py`) is always on
    and sized by `recorder_ring`; `enabled` arms causal tracing (a ring of
    `trace_ring` spans), the pipeline ledger and, with `slo` objectives
    declared, the SLO engine. `devprof` arms the obs tier's device half,
    the dispatch profiler, on its own gate."""

    enabled: bool = False
    trace_ring: int = 65536
    recorder_ring: int = 4096
    devprof: DevProfConfig = DevProfConfig()
    slo: Tuple[SloObjective, ...] = ()


@_frozen
class ServingConfig:
    """Tiled delta-map distribution (`serving/`, `bridge/http_api.py`):
    the mapper's map revision and dirty-tile marks, and the `/tiles`,
    `/voxel-tiles` and `/map-events` routes."""

    enabled: bool = True
    # Tile edge in cells at every pyramid level; divides grid.size_cells.
    tile_cells: int = 256
    # Overview pyramid depth including level 0 (full resolution).
    pyramid_levels: int = 3
    # Per-client event queue bound (`/map-events`).
    event_queue_depth: int = 4
    # Cap on one long-poll wait or event stream, seconds.
    event_wait_max_s: float = 30.0
    # zlib level of tile PNGs.
    png_compress_level: int = 6


@_frozen
class WorldConfig:
    """Bounded-memory robocentric world store (`world/store.py`). With
    `windowed` the mapper's device grid is the window
    (`world.store.window_slam_config`) over a logical lattice of
    `grid.size_cells`, and each tenant lane's grid is the window, not the
    logical extent."""

    windowed: bool = False
    # Window edge in serving tiles: the device grid is
    # (window_tiles * serving.tile_cells)^2 cells.
    window_tiles: int = 8
    # Recentring hysteresis, in tiles from the window's edge.
    margin_tiles: int = 1
    # Host LRU capacity, in evicted tiles.
    host_tile_budget: int = 256
    # Governor watermarks, as fractions of host_tile_budget.
    host_high_watermark: float = 0.75
    host_critical_watermark: float = 0.92
    # Disk spill directory; "" means no disk tier.
    spill_dir: str = ""
    # Downsampling factor of spilled tiles under pressure.
    retention_coarsen: int = 2


@_frozen
class TenancyConfig:
    """Mission multi-tenancy: the tenant megabatch (`tenancy/megabatch.py`,
    many independent missions stacked on a leading tenant axis and ticked
    as one launch chain), the lane-health ladder
    (`tenancy/lanehealth.py`) and the control plane that admits,
    suspends, resumes, evicts, quarantines, journals and restores
    missions (`tenancy/controlplane.py`, `tenancy/journal.py`)."""

    enabled: bool = False
    # Capacity ceiling `bucket_capacity` refuses past.
    max_tenants: int = 64
    # Serve capacities only from the bit-exact bucket ladder
    # (`megabatch.EXACT_BUCKETS`); False serves {2^k} u {3 * 2^(k-1)}.
    bit_exact_buckets: bool = True
    # Control plane: pre-warm a bucket before admission; checkpoint on
    # eviction.
    prewarm_on_admit: bool = True
    checkpoint_on_evict: bool = True
    # Compute the per-tenant health word in the megabatch step: bit 0
    # non-finite pose or grid delta, bit 1 a pose jump over
    # pose_jump_max_m, bit 2 an accepted key match under match_floor.
    lane_health: bool = False
    pose_jump_max_m: float = 0.5
    # 0.0 disables the match-floor bit.
    match_floor: float = 0.0
    # Consecutive flagged ticks before a suspect lane is quarantined.
    quarantine_persist_ticks: int = 2
    # Re-admission probe cadence (ticks after quarantine) and budget.
    readmit_probe_ticks: int = 8
    max_readmit_probes: int = 3
    # Control plane: lifecycle journal, its compaction period, and the
    # bound on concurrent admissions (0: unbounded).
    journal: bool = False
    journal_compact_every: int = 64
    admission_queue_max: int = 0


_SECTIONS = {
    "grid": GridConfig, "scan": ScanConfig, "robot": RobotConfig,
    "matcher": MatcherConfig, "loop": LoopClosureConfig,
    "frontier": FrontierConfig, "fleet": FleetConfig,
    "planner": PlannerConfig, "voxel": VoxelConfig,
    "depthcam": DepthCamConfig, "resilience": ResilienceConfig,
    "recovery": RecoveryConfig, "serving": ServingConfig,
    "world": WorldConfig, "decay": DecayConfig, "obs": ObsConfig,
    "cold_start": ColdStartConfig, "tenancy": TenancyConfig,
}

#: Top-level scalar fields of `SlamConfig`.
_SCALARS = ("mode", "map_publish_period_s", "tf_publish_period_s",
            "domain_id")


def _env_domain_id() -> int:
    """ROS_DOMAIN_ID from the environment, 42 when unset or malformed."""
    try:
        return int(os.environ.get("ROS_DOMAIN_ID", "42"))
    except ValueError:
        return 42


@_frozen
class SlamConfig:
    """The sections the fleet tick, the SLAM step, the planner, the voxel
    path, the recovery path, the tenant megabatch and the mission stack
    read, plus the operating mode and the stack's publish periods."""

    grid: GridConfig = GridConfig()
    scan: ScanConfig = ScanConfig()
    robot: RobotConfig = RobotConfig()
    matcher: MatcherConfig = MatcherConfig()
    loop: LoopClosureConfig = LoopClosureConfig()
    frontier: FrontierConfig = FrontierConfig()
    fleet: FleetConfig = FleetConfig()
    planner: PlannerConfig = PlannerConfig()
    voxel: VoxelConfig = VoxelConfig()
    depthcam: DepthCamConfig = DepthCamConfig()
    resilience: ResilienceConfig = ResilienceConfig()
    recovery: RecoveryConfig = RecoveryConfig()
    serving: ServingConfig = ServingConfig()
    world: WorldConfig = WorldConfig()
    decay: DecayConfig = DecayConfig()
    obs: ObsConfig = ObsConfig()
    cold_start: ColdStartConfig = ColdStartConfig()
    tenancy: TenancyConfig = TenancyConfig()
    mode: str = "mapping"
    map_publish_period_s: float = 5.0         # slam_config.yaml:25
    tf_publish_period_s: float = 0.1          # slam_config.yaml:24
    # The bus's domain (ROS_DOMAIN_ID, 42 by default).
    domain_id: int = dataclasses.field(default_factory=_env_domain_id)

    def replace(self, **kw: Any) -> "SlamConfig":
        return dataclasses.replace(self, **kw)

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2, sort_keys=True)

    @staticmethod
    def from_json(text: str) -> "SlamConfig":
        """Build from a JSON config; sections and top-level keys this
        package does not model are ignored."""
        raw: Dict[str, Any] = json.loads(text)
        # ObsConfig nests a dataclass and a tuple of them; rebuild both so
        # the config stays frozen and hashable.
        obs = dict(raw.get("obs", {}))
        if isinstance(obs.get("devprof"), dict):
            obs["devprof"] = DevProfConfig(**obs["devprof"])
        if isinstance(obs.get("slo"), (list, tuple)):
            obs["slo"] = tuple(SloObjective(**o) if isinstance(o, dict)
                               else o for o in obs["slo"])
        raw = {**raw, "obs": obs}
        kw: Dict[str, Any] = {name: cls(**raw.get(name, {}))
                              for name, cls in _SECTIONS.items()}
        kw.update({k: raw[k] for k in _SCALARS if k in raw})
        return SlamConfig(**kw)


def tiny_config(n_robots: int = 2) -> SlamConfig:
    """Small static shapes for CPU tests."""
    return SlamConfig(
        grid=GridConfig(size_cells=256, patch_cells=128, max_range_m=3.0,
                        align_rows=8, align_cols=8),
        scan=ScanConfig(n_beams=90, padded_beams=128, range_max_m=3.0,
                        angle_increment_rad=2.0 * math.pi / 90.0),
        matcher=MatcherConfig(search_half_extent_m=0.25),
        loop=LoopClosureConfig(max_poses=64, max_edges=256, gn_iters=4,
                               coarse_downsample=2),
        frontier=FrontierConfig(downsample=2, max_clusters=16,
                                label_prop_iters=24, bfs_iters=64),
        fleet=FleetConfig(n_robots=n_robots, batch_scans=4),
        # patch/2 - align/2 = 28 cells = 1.4 m >= the 1.2 m trust horizon.
        voxel=VoxelConfig(size_x_cells=128, size_y_cells=128,
                          size_z_cells=16, patch_cells=64, max_range_m=1.2,
                          align_y=8, align_x=8),
        depthcam=DepthCamConfig(width_px=40, height_px=30,
                                range_max_m=1.2),
        # Short staleness horizons, so a short mission walks the whole
        # degrade -> dead -> rejoin ladder.
        resilience=ResilienceConfig(lidar_silent_ticks=8,
                                    dead_after_ticks=20,
                                    supervisor_missed_beats=3,
                                    restart_backoff_base_steps=2,
                                    restart_backoff_max_steps=16,
                                    checkpoint_every_steps=25),
        # Short watchdog and anti-stuck horizons, so a short mission walks
        # the whole diverge -> relocalize -> re-admit ladder.
        recovery=RecoveryConfig(min_keyscans=2,
                                score_decay=0.5,
                                diverge_threshold=0.4,
                                diverge_persist_steps=2,
                                quarantine_cap=32,
                                reloc_consecutive=2,
                                stuck_window_ticks=12,
                                stuck_displacement_frac=0.25,
                                rotate_recovery_ticks=6,
                                backup_recovery_ticks=5,
                                escalation_memory_ticks=40,
                                blacklist_ttl_ticks=80),
        # 4 x 4 tiles over the 256^2 grid.
        serving=ServingConfig(tile_cells=64, pyramid_levels=3,
                              event_wait_max_s=5.0),
    )


def micro_config(n_robots: int = 1) -> SlamConfig:
    """Smallest legal static shapes (24-cell patch, 64 padded beams)."""
    return SlamConfig(
        grid=GridConfig(size_cells=64, patch_cells=24, max_range_m=0.4,
                        align_rows=8, align_cols=8),
        scan=ScanConfig(n_beams=36, padded_beams=64, range_max_m=0.4,
                        angle_increment_rad=2.0 * math.pi / 36.0),
        matcher=MatcherConfig(search_half_extent_m=0.05,
                              coarse_angle_half_rad=0.0698,
                              coarse_angle_step_rad=0.0349,
                              fine_angle_step_rad=0.0175,
                              fine_step_m=0.025),
        loop=LoopClosureConfig(max_poses=32, max_edges=128, gn_iters=2,
                               min_chain_size=6, loop_window_m=2.0,
                               coarse_downsample=2),
        frontier=FrontierConfig(downsample=2, cluster_downsample=2,
                                max_clusters=8, min_cluster_cells=2,
                                label_prop_iters=16, bfs_iters=32,
                                mg_levels=2, mg_refine_iters=4),
        fleet=FleetConfig(n_robots=n_robots, batch_scans=1),
        # 4 x 4 tiles over the 64^2 grid.
        serving=ServingConfig(tile_cells=16, pyramid_levels=2,
                              event_wait_max_s=5.0),
    )


def configs_equivalent(json_a: Optional[str],
                       json_b: Optional[str]) -> bool:
    """Semantic config-drift comparison for checkpoint guards: both sides
    parsed through `SlamConfig.from_json` (defaults for absent sections
    and fields) and compared as dataclasses, so a checkpoint written
    before a section existed still loads. `mode`, `obs`, `cold_start`
    and `tenancy` shape no state and are left out of the comparison.
    Unparseable or different configs are not equivalent."""
    if json_a == json_b:
        return True
    if json_a is None or json_b is None:
        return False
    try:
        a = SlamConfig.from_json(json_a)
        b = SlamConfig.from_json(json_b)
        neutral = dict(mode="mapping", obs=ObsConfig(),
                       cold_start=ColdStartConfig(),
                       tenancy=TenancyConfig())
        return a.replace(**neutral) == b.replace(**neutral)
    except (TypeError, ValueError, KeyError, AttributeError):
        return False


def ensure_valid_mode(cfg: SlamConfig) -> None:
    if cfg.mode not in ("mapping", "localization"):
        raise ValueError(f"unknown SlamConfig.mode {cfg.mode!r} "
                         "(mapping | localization)")


def sign_extend_16bit(raw):
    """Thymio motor speeds arrive as unsigned 16-bit; negative speeds wrap
    (`if rl > 32767: rl -= 65536`, vectorised). Python ints, numpy arrays
    and torch tensors of any integer dtype; arrays come back as int32."""
    if isinstance(raw, (int, float)):
        return raw - 65536 if raw > 32767 else raw
    import numpy as np
    if isinstance(raw, np.ndarray):
        arr = raw.astype(np.int32)
        return np.where(arr > 32767, arr - 65536, arr)
    import torch
    arr = torch.as_tensor(raw).to(torch.int32)
    return torch.where(arr > 32767, arr - 65536, arr)
