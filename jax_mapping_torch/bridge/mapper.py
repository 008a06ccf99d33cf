"""Mapper node: the slam_toolbox replacement in the node graph.

Port of the JAX package's `bridge/mapper.py`. Subscribes `/scan`
(Best-Effort) + `/odom`, runs gate → correlative match → pose-graph
insert → loop closure → grid fusion on the stack's device
(`models.slam`), publishes `/map` every `map_publish_period_s`,
`/frontiers` each tick, and the `map->odom` correction TF.

One shared grid for the whole fleet: per-robot `SlamState`s carry poses,
graphs and scan rings, their `.grid` fields all alias the shared tensor
(the step functions are pure, so aliasing is safe), and each robot's step
reads the shared map and its result becomes the new shared map. After
any loop closure the shared map is re-fused from every robot's key-scan
ring.

The tick keeps the JAX node's structure: drain, sort by stamp, the
degraded-mode gate, windows of `max(2, fleet.batch_scans)` scans through
`slam_step_window` and the remainder through `slam_step`, the agreement
gate, the watchdog and quarantine feed, decay, and the frontier publish
with the dead-robot and blacklist post-passes. Where the device meets the
host:

* the tick's queued scans go up in ONE host-to-device copy for the whole
  fleet (`_upload_scan_ranges`);
* everything the host needs from a step — the diag's flags, agreement,
  covariance and matcher counters, the new pose, the touched-tile box,
  and for a single step the sub-gate `scan_agreement` — comes back in ONE
  copy (`_read_step`), computed on the device first (the box's host
  inputs are filled in on the device, never copied up);
* the frontier publish stacks the fleet's poses on the device in the
  same lock section that takes the grid, the map revision and the tile
  revisions (so a pose never pairs with a map no writer produced), and
  reads them in one copy that the tick's correction TFs reuse.

So a tick's host syncs are the steps' own (`models/slam.py`: one a
non-key step, a few a key step) plus one a step, one for the scans'
upload, one for the poses, and the publish's.

With `cfg.world.windowed` the node keeps the bounded-memory world
(`world/store.py`): its device config is the window-sized
`window_slam_config`, poses live in the robocentric window frame, and
`_maybe_shift_window` recentres the window at the top of a tick (one
more read of the poses). Every publish boundary adds `world.offset_xy()`
back (world = window + offset); the dirty-tile and revision lattices
cover the logical extent.

With `frontier_grid_provider` wired (launch does it beside a voxel
mapper), the frontier auction runs on the planner's voxel-overlaid
planning grid (`_frontier_basis`), keyed for the incremental pipeline by
`frontier_grid_key_provider`.

With the obs tier armed (launch passes the bus's `Tracer`, the
`PipelineLedger` and the `SloEngine`), each tick is one `mapper.tick`
span, each installed scan one `mapper.fuse` span parented on the scan's
bus-delivery context, each revision's install and notify waypoints are
stamped into the ledger, and the SLO engine evaluates once a tick after
the body. All of it is host bookkeeping: with `enabled=False` none of it
is constructed and the node does exactly what it did without.
"""

from __future__ import annotations

import functools
import math
import threading
import time
from typing import List, NamedTuple, Optional

import numpy as np
import torch

from jax_mapping_torch._util import resolve_device
from jax_mapping_torch.bridge.brain import robot_ns
from jax_mapping_torch.bridge.bus import Bus
from jax_mapping_torch.bridge.messages import (
    FrontierArray, Header, LaserScan, Odometry, TransformStamped,
    occupancy_from_logodds,
)
from jax_mapping_torch.bridge.node import Node
from jax_mapping_torch.bridge.odom_pairing import OdomPairer
from jax_mapping_torch.bridge.qos import QoSProfile, qos_map, qos_sensor_data
from jax_mapping_torch.bridge.tf import TfTree
from jax_mapping_torch.config import SlamConfig
from jax_mapping_torch.models import slam as S
from jax_mapping_torch.obs.recorder import flight_recorder
from jax_mapping_torch.ops import frontier as F
from jax_mapping_torch.ops import fuse_kernel as FK
from jax_mapping_torch.ops import grid as G
from jax_mapping_torch.ops.odometry import twist_to_wheel_units
from jax_mapping_torch.resilience.supervisor import Heartbeater
from jax_mapping_torch.utils import global_metrics as M


class StepRead(NamedTuple):
    """The host's copy of one step's results (`MapperNode._read_step`)."""

    matched: bool
    closed: bool
    agreement: float              # diag.window_agreement
    key_added: bool
    cov: np.ndarray               # (3,) float32
    candidates: int
    prune_ratio: float
    pose: np.ndarray              # (3,) float32, the step's new estimate
    box: Optional[tuple]          # touched serving tiles, or None
    scan_agreement: Optional[float]   # sub-gate sample (single steps)


def _to_device(tree, dev):
    """A SlamState (or any NamedTuple of tensors / arrays) on `dev`."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_to_device(x, dev) for x in tree))
    return torch.as_tensor(tree, device=dev)


class MapperNode(Node):
    """Device-resident SLAM behind the reference's topic contract."""

    def __init__(self, cfg: SlamConfig, bus: Bus,
                 tf: Optional[TfTree] = None, n_robots: int = 1,
                 tick_period_s: Optional[float] = None, health=None,
                 recovery=None, pipeline=None, slo=None, device=None,
                 spill_dir: Optional[str] = None):
        super().__init__("jax_mapper", bus, tf)
        self.device = resolve_device(device)
        #: Causal tracing: the bus's Tracer or None, set before any
        #: subscription exists (`_scan_cb` captures each scan's delivery
        #: context, so a queued scan's fuse span chains to its publish).
        self._tracer = getattr(bus, "tracer", None)
        #: Pipeline latency ledger (obs/pipeline.py) or None: each
        #: revision's enqueued → installed → notified waypoints. None adds
        #: not even a clock read.
        self._pipeline = pipeline
        #: Freshness SLO engine (obs/slo.py) or None: evaluated once a
        #: tick, after the body.
        self._slo = slo
        #: Bounded-memory world (world/store.py) or None. Windowed, the
        #: node's device config is the window-sized one, and `full_cfg`
        #: keeps the logical extent (the tile lattice, the /map origin).
        self.full_cfg = cfg
        self.world = None
        if cfg.world.windowed:
            from jax_mapping_torch.world.store import WorldStore
            self.world = WorldStore(cfg, spill_dir=spill_dir)
            cfg = self.world.cfg
        self.cfg = cfg
        self.n_robots = n_robots
        self._tick_no = 0
        #: Per-robot monotone fuse-span keys (deterministic; see
        #: _emit_fuse_spans).
        self._fuse_no = [0] * n_robots
        self._state_lock = threading.Lock()
        # One grid for the fleet; every state's .grid aliases it.
        self.shared_grid = G.empty_grid(cfg.grid, self.device)
        self.states = [
            S.init_state(cfg, device=self.device)._replace(
                grid=self.shared_grid)
            for _ in range(n_robots)]
        #: Per-robot state generation: bumped whenever a robot's state is
        #: replaced out-of-band (/initialpose, restore), so in-flight
        #: steps do not install over the replacement.
        self._state_gen = [0] * n_robots
        #: Per-robot (estimated pose, paired odom pose) at the last
        #: INSTALLED step (host numpy); None until a step installs.
        self._correction = [None] * n_robots
        #: Imported map prior (seed_map_prior): backfills the cells no
        #: live key scan covers after a loop-closure ring re-fusion.
        self._map_prior = None
        #: Incremental publish pipeline (ops/frontier_incremental.py),
        #: built lazily; a geometry rejection latches the full-recompute
        #: fallback.
        self._frontier_pipeline = None
        self._frontier_pipeline_failed = False
        self._pairer = OdomPairer(n_robots)
        #: Per-robot covariance diag of the last ACCEPTED match.
        self._last_cov = [None] * n_robots
        #: Odometry-scale calibration accumulators (see _finish_step).
        self._calib_decay = 0.995
        self._calib_odo = [0.0] * n_robots
        self._calib_slam = [0.0] * n_robots
        self._calib_n = [0] * n_robots
        self._prev_matched = [False] * n_robots
        #: Per-robot queued (scan, delivery context, enqueue stamp)
        #: triples (see _scan_cb).
        self._scan_q: List[List] = [[] for _ in range(n_robots)]
        self._prev_paired: List[Optional[Odometry]] = [None] * n_robots
        #: Shared degraded-mode registry (resilience/health.py) or None.
        self._health = health
        #: Estimator guardrails (recovery/manager.py) or None.
        self._recovery = recovery
        #: Per-robot quarantined (scan, odom) evidence while diverged —
        #: buffered, never fused; bounded by RecoveryConfig.quarantine_cap.
        self._quarantine: List[List] = [[] for _ in range(n_robots)]
        self.n_scans_quarantined = 0
        self.n_quarantine_overflow = 0
        self.n_relocalizations = 0
        #: Stamp of the newest scan accepted for fusion, per robot: an
        #: older scan arrived late and is rejected.
        self._last_accepted_stamp = [-float("inf")] * n_robots
        #: Serving: a monotonic map revision bumped on every grid-content
        #: mutation + a dirty-tile mask and per-tile last-dirty revisions
        #: (the frontier pipeline's and the pyramid caches' keys).
        self._serving_enabled = cfg.serving.enabled
        self.map_revision = 0
        self.restart_epoch = 0
        #: Map-healing clock (DecayConfig): mapper ticks since boot.
        self._decay_ticks = 0
        self.n_decay_passes = 0
        #: Leaf lock for the dirty-tile mask (always taken inside
        #: `_state_lock` when both are held).
        self._dirty_lock = threading.Lock()
        self._dirty_tiles: Optional[np.ndarray] = None
        self._tile_rev: Optional[np.ndarray] = None
        if self._serving_enabled:
            # The lattice is the LOGICAL extent: windowed, the markers
            # translate window tiles through the store's origin.
            size = self.full_cfg.grid.size_cells
            if size % cfg.serving.tile_cells:
                raise ValueError(
                    f"ServingConfig.tile_cells={cfg.serving.tile_cells} "
                    f"does not divide grid.size_cells={size}")
            nt = size // cfg.serving.tile_cells
            self._dirty_tiles = np.zeros((nt, nt), bool)
            self._tile_rev = np.zeros((nt, nt), np.int64)
        #: Optional callable giving the log-odds grid the frontier
        #: auction runs on (launch wires the planner's voxel-overlaid
        #: planning grid); None = the shared 2D map. Called as
        #: provider(lo, revision) with this node's own snapshot, so the
        #: publish's poses and grid stay paired.
        self.frontier_grid_provider = None
        #: Its companion: the provider output's ingredient that the tile
        #: revisions do not track (the voxel overlay's revision). The
        #: incremental pipeline drops its cached tiles when it moves; a
        #: provider without one forces a full recompute every publish.
        self.frontier_grid_key_provider = None
        self._match_candidates = [0] * n_robots
        self._match_prune_ratio = [0.0] * n_robots
        #: Revision listeners, called from the tick thread outside every
        #: mapper lock.
        self._revision_listeners: List = []
        self._last_notified_revision = 0
        self._last_recorded_revision = 0
        self.n_scans_fused = 0
        self.n_scans_dropped_unpaired = 0
        self.n_scans_rejected_stale = 0
        self.n_windows_rejected_low_agreement = 0
        self.n_loops_closed = 0
        self.n_windows_fused = 0
        self.n_low_agreement_windows = 0

        self.map_pub = self.create_publisher("/map", qos_map)
        self.map_updates_pub = self.create_publisher("/map_updates")
        self.frontiers_pub = self.create_publisher("/frontiers")
        self.pose_pub = self.create_publisher("/pose")
        for i in range(n_robots):
            ns = robot_ns(i, n_robots)
            self.create_subscription(
                f"{ns}scan", functools.partial(self._scan_cb, i),
                qos_sensor_data)
            self.create_subscription(
                f"{ns}odom", functools.partial(self._odom_cb, i),
                QoSProfile(depth=50))
        # RViz SetInitialPose: relocalize robot 0's SLAM estimate.
        self.create_subscription("/initialpose", self._initialpose_cb)

        period = tick_period_s if tick_period_s is not None \
            else 1.0 / cfg.robot.control_rate_hz
        self.graph_pub = self.create_publisher("/graph")
        # Heartbeat for the Supervisor.
        self._heartbeater = Heartbeater(self)
        self.create_timer(period, self.tick)
        self.create_timer(cfg.map_publish_period_s, self.publish_map)
        self.create_timer(cfg.map_publish_period_s, self.publish_graph)
        self._last_map_stamp = 0.0

    # -- callbacks ----------------------------------------------------------

    def _initialpose_cb(self, msg) -> None:
        pose = [float(msg.x), float(msg.y), float(msg.theta)]
        if self.world is not None:
            # Asserted poses arrive in world coordinates; the chain lives
            # in the window frame.
            off = self.world.offset_xy()
            pose[0] -= float(off[0])
            pose[1] -= float(off[1])
        self.reset_robot_pose(0, pose)
        M.counters.inc("mapper.initialpose_resets")

    def reset_robot_pose(self, i: int, pose) -> None:
        """Re-anchor robot i's chain at an asserted pose, keeping the map
        (slam_toolbox's localization reset): a fresh chain whose
        last_key_pose forces an immediate key scan, aliasing the shared
        grid. Serves the SetInitialPose tool and the relocalizer."""
        pose = torch.as_tensor(np.asarray(pose, np.float32),
                               device=self.device)
        with self._state_lock:
            fresh = S.init_state(self.cfg, pose0=pose, device=self.device)
            self.states[i] = fresh._replace(grid=self.shared_grid)
            self._state_gen[i] += 1
            self._prev_paired[i] = None
            self._prev_matched[i] = False
            self._correction[i] = None

    # -- serving surface ------------------------------------------------------

    def _mark_dirty_patch(self, xy) -> None:
        """Mark the serving tiles a fusion patch centred near world point
        `xy` may have touched (caller holds `_state_lock`); a conservative
        superset padded by the origin alignment."""
        if self._dirty_tiles is None:
            return
        g = self.cfg.grid
        half = (g.patch_cells / 2.0
                + max(g.align_rows, g.align_cols) / 2.0 + 8.0)
        col = (xy[0] - g.origin_m[0]) / g.resolution_m
        row = (xy[1] - g.origin_m[1]) / g.resolution_m
        t = self.cfg.serving.tile_cells
        nt = self._dirty_tiles.shape[0]
        off_r, off_c = self._window_origin()
        r0 = min(nt - 1, max(0, int((row - half) // t) + off_r))
        r1 = min(nt - 1, max(0, int((row + half) // t) + off_r))
        c0 = min(nt - 1, max(0, int((col - half) // t) + off_c))
        c1 = min(nt - 1, max(0, int((col + half) // t) + off_c))
        with self._dirty_lock:
            self._dirty_tiles[r0:r1 + 1, c0:c1 + 1] = True
            self._tile_rev[r0:r1 + 1, c0:c1 + 1] = self.map_revision

    def _mark_dirty_box(self, box) -> None:
        """Mark an inclusive [tr0, tr1] x [tc0, tc1] serving-tile box dirty
        (caller holds `_state_lock`; `box` is host ints computed on the
        device by `fuse_kernel.touched_tile_box`)."""
        if self._dirty_tiles is None:
            return
        # Window tiles -> the logical lattice.
        off_r, off_c = self._window_origin()
        tr0, tr1, tc0, tc1 = box
        tr0, tr1, tc0, tc1 = tr0 + off_r, tr1 + off_r, tc0 + off_c, \
            tc1 + off_c
        with self._dirty_lock:
            self._dirty_tiles[tr0:tr1 + 1, tc0:tc1 + 1] = True
            self._tile_rev[tr0:tr1 + 1, tc0:tc1 + 1] = self.map_revision

    def _window_origin(self) -> tuple:
        """The window's origin on the logical tile lattice; (0, 0) when
        not windowed."""
        return (0, 0) if self.world is None else self.world.origin_tile

    def _world_shift3(self) -> np.ndarray:
        """(3,) float32 window -> world translation of a pose: the
        store's offset; zeros when not windowed."""
        if self.world is None:
            return np.zeros(3, np.float32)
        return np.array([*self.world.offset_xy(), 0.0], np.float32)

    def _touched_box(self, i: int, state, travel_cells: int):
        """Device-computed touched-tile bounds (4,) of an install of robot
        i's step ending at `state.pose`, or None when the fused path or
        serving is off. Covers the previous installed estimate and the
        new one with the fusion's exact patch geometry, padded by the
        window's odometric path-length bound."""
        if not self._serving_enabled or not self.cfg.grid.fused_fusion:
            return None
        new_xy = state.pose[:2]
        prev = self._correction[i]
        # The host values are filled in on the device: a copy from the
        # host would wait for the stream.
        prev_xy = new_xy if prev is None else torch.stack(
            [new_xy.new_full((), float(v)) for v in prev[0][:2]])
        pts = torch.stack([prev_xy, new_xy]).to(torch.float32)
        pad = torch.full((), travel_cells, dtype=torch.int32,
                         device=self.device)
        return FK.touched_tile_box(self.cfg.grid, self.cfg.serving.tile_cells,
                                   pts, pad)

    def _mark_dirty_all(self) -> None:
        """Whole-map mutation (closure ring re-fuse, restore, prior seed,
        decay). Caller holds `_state_lock`."""
        if self._dirty_tiles is not None:
            with self._dirty_lock:
                self._dirty_tiles[:] = True
                self._tile_rev[:] = self.map_revision

    def region_revision(self, row0: int, col0: int,
                        span_cells: int) -> Optional[int]:
        """Newest `map_revision` whose mutation marked any serving tile
        intersecting the cell rectangle [row0, row0+span) x [col0,
        col0+span): the relocalizer's pyramid-cache key. None when
        revision tracking is off."""
        if self._tile_rev is None:
            return None
        t = self.cfg.serving.tile_cells
        nt = self._tile_rev.shape[0]
        # Callers pass window-local cells (the pyramids are built on the
        # device grid): translate onto the logical lattice.
        off_r, off_c = self._window_origin()
        r0 = min(nt - 1, max(0, row0 // t + off_r))
        r1 = min(nt - 1, max(0, (row0 + span_cells - 1) // t + off_r))
        c0 = min(nt - 1, max(0, col0 // t + off_c))
        c1 = min(nt - 1, max(0, (col0 + span_cells - 1) // t + off_c))
        with self._dirty_lock:
            return int(self._tile_rev[r0:r1 + 1, c0:c1 + 1].max())

    def serving_revision(self) -> int:
        """Current map revision (lock-free read)."""
        return self.map_revision

    def serving_snapshot(self):
        """(revision, shared grid, dirty-tile hint); the hint mask is
        consumed (copied and cleared) atomically with the grid."""
        with self._state_lock:
            rev = self.map_revision
            grid = self.shared_grid
            hint = None
            if self._dirty_tiles is not None:
                with self._dirty_lock:
                    hint = self._dirty_tiles.copy()
                    self._dirty_tiles[:] = False
        return rev, grid, hint

    def world_status(self) -> Optional[dict]:
        """The bounded-memory world's status with its offset; None when
        not windowed."""
        if self.world is None:
            return None
        body = self.world.status()
        off = self.world.offset_xy()
        body["offset_m"] = [float(off[0]), float(off[1])]
        return body

    def destroy(self) -> None:
        super().destroy()
        if self.world is not None:
            # Release the spill file: a restarted node reopens the same
            # file, and two live writers would interleave frames.
            self.world.close()

    def add_revision_listener(self, fn) -> None:
        """Register fn(revision): called from the tick thread after the
        tick's installs, outside every mapper lock."""
        self._revision_listeners.append(fn)

    def _notify_revision_listeners(self) -> None:
        if not self._serving_enabled:
            return
        rev = self.map_revision
        if self._pipeline is not None and rev > 0:
            # Notify waypoint: the revision is now fanned to listeners
            # (idempotent for revisions already marked).
            self._pipeline.notified(rev)
        if rev != self._last_recorded_revision:
            self._last_recorded_revision = rev
            flight_recorder.record("map_revision", revision=rev)
        if rev == self._last_notified_revision or \
                not self._revision_listeners:
            return
        self._last_notified_revision = rev
        for fn in list(self._revision_listeners):
            fn(rev)

    # -- checkpoint surface --------------------------------------------------

    def snapshot_states(self) -> List:
        """Snapshot of the per-robot SLAM states: the shared grid on robot
        0, host zero grids on the rest (same structure;
        `restore_states`'s dominant-evidence merge rebuilds the alias)."""
        with self._state_lock:
            states = list(self.states)
            shared = self.shared_grid
        if len(states) == 1:
            return states
        zero = torch.zeros((self.cfg.grid.size_cells,) * 2,
                           dtype=torch.float32)
        return [states[0]._replace(grid=shared)] + \
            [st._replace(grid=zero) for st in states[1:]]

    def checkpoint_template(self) -> List:
        """Fresh states shaped as this node's checkpoints are: the device
        config's, so window-shaped when windowed."""
        return [S.init_state(self.cfg, device=self.device)
                for _ in self.states]

    def resume(self, states, world_payload=None, anchors=None,
               map_prior=None) -> None:
        """Resume from checkpointed states. Windowed, the window first
        re-anchors from the checkpoint's `.world` payload (None: the boot
        origin). `anchors` (R, 3), in the WORLD frame, re-anchor each
        robot's chain there (see `restore_states`), moved into the window
        frame of the restored origin."""
        if self.world is not None and world_payload is not None:
            self.world.restore_payload(world_payload)
        if anchors is not None:
            anchors = np.array(anchors, np.float32)
            anchors -= self._world_shift3()[None, :]
        self.restore_states(states, anchor_poses=anchors,
                            map_prior=map_prior)

    def restore_states(self, states, anchor_poses=None,
                       map_prior=None) -> None:
        """Swap in checkpointed SLAM states (on any device, or numpy) and
        reset odometry pairing. `map_prior` replaces (None: clears) the
        live prior. `anchor_poses` (R, 3): re-anchor robot i's chain at
        row i — fresh graph, inherited grid — for resumes where the
        robots no longer sit at the checkpointed poses."""
        if len(states) != len(self.states):
            raise ValueError(
                f"checkpoint has {len(states)} robot state(s), the stack "
                f"runs {len(self.states)}")
        dev = self.device
        with self._state_lock:
            self._map_prior = (None if map_prior is None
                               else torch.as_tensor(map_prior,
                                                    dtype=torch.float32,
                                                    device=dev))
            self.states = [_to_device(st, dev) for st in states]
            # States saved by this design all alias one grid; others merge
            # by dominant evidence.
            g = self.states[0].grid
            for st in self.states[1:]:
                g = torch.where(st.grid.abs() > g.abs(), st.grid, g)
            self.shared_grid = g
            for i in range(len(self.states)):
                if anchor_poses is not None:
                    pose = torch.as_tensor(np.asarray(anchor_poses[i],
                                                      np.float32),
                                           device=dev)
                    self.states[i] = S.init_state(self.cfg, pose0=pose,
                                                  device=dev)
                self.states[i] = self.states[i]._replace(
                    grid=self.shared_grid)
                self._state_gen[i] += 1
                self._prev_paired[i] = None
                self._prev_matched[i] = False
                self._correction[i] = None
            if self._serving_enabled:
                self.map_revision += 1
                self._mark_dirty_all()

    def map_prior(self):
        """The live imported-map prior, or None."""
        with self._state_lock:
            return self._map_prior

    def seed_map_prior(self, prior_logodds) -> None:
        """Install an imported map as the fleet's shared grid
        (localization on a known map). Graphs and poses are untouched;
        per-robot generations bump. Refused in windowed mode: a
        logical-extent prior does not fit the device window."""
        if self.world is not None:
            raise ValueError(
                "map priors are not supported in windowed mode "
                "(world.windowed): a logical-extent prior exceeds the "
                "device window — import it unwindowed or grow the "
                "window to the prior's extent")
        g = self.cfg.grid
        prior = torch.as_tensor(prior_logodds, dtype=torch.float32,
                                device=self.device)
        if tuple(prior.shape) != (g.size_cells, g.size_cells):
            raise ValueError(
                f"map prior shape {tuple(prior.shape)} != grid "
                f"({g.size_cells}, {g.size_cells}); resample the import "
                "to the running config first")
        with self._state_lock:
            self.shared_grid = prior
            self._map_prior = prior
            for i in range(len(self.states)):
                self.states[i] = self.states[i]._replace(
                    grid=self.shared_grid)
                self._state_gen[i] += 1
            if self._serving_enabled:
                self.map_revision += 1
                self._mark_dirty_all()

    # -- topic callbacks -----------------------------------------------------

    def _scan_cb(self, i: int, msg: LaserScan) -> None:
        # The bus made the publish context current for this callback:
        # captured HERE, a scan that waits in the queue still chains its
        # fuse span to the publish that produced it. The enqueue stamp is
        # the ledger's scan→served starting waypoint (None: no ledger).
        ctx = self._tracer.current() if self._tracer is not None else None
        enq_t = time.perf_counter() if self._pipeline is not None \
            else None
        with self._state_lock:
            self._scan_q[i].append((msg, ctx, enq_t))

    def _odom_cb(self, i: int, msg: Odometry) -> None:
        with self._state_lock:
            self._pairer.push(i, msg)

    # -- pairing + device step ----------------------------------------------

    def _pair_odom(self, i: int, stamp: float) -> Optional[Odometry]:
        """Freshest odometry at or before `stamp` (bridge/odom_pairing.py)."""
        return self._pairer.pair(i, stamp)

    def _pad_ranges(self, scan: LaserScan) -> np.ndarray:
        sc = self.cfg.scan
        out = np.zeros(sc.padded_beams, np.float32)
        r = np.asarray(scan.ranges, np.float32)
        n = min(len(r), sc.n_beams)
        if n == sc.n_beams and len(r) != sc.n_beams:
            idx = np.linspace(0, len(r) - 1, sc.n_beams).round().astype(int)
            out[:sc.n_beams] = r[idx]
        else:
            out[:n] = r[:n]
        return out

    def _odom_motion(self, i: int, od: Odometry) -> tuple:
        """(wl, wr, dt): equivalent wheel speeds + the real interval from
        the pose delta between consecutive paired odometry samples (the
        RK2 midpoint model inverted, so the device's integration lands on
        the paired odometry pose)."""
        prev = self._prev_paired[i]
        self._prev_paired[i] = od
        if prev is None or od.header.stamp <= prev.header.stamp:
            # Bootstrap, or the same/out-of-order sample paired again: no
            # new odometric evidence.
            return 0.0, 0.0, 1.0 / self.cfg.robot.control_rate_hz
        dt = od.header.stamp - prev.header.stamp
        dth = math.atan2(math.sin(od.pose.theta - prev.pose.theta),
                         math.cos(od.pose.theta - prev.pose.theta))
        mid = prev.pose.theta + dth / 2.0         # RK2 midpoint heading
        dx = od.pose.x - prev.pose.x
        dy = od.pose.y - prev.pose.y
        v = (math.cos(mid) * dx + math.sin(mid) * dy) / dt
        w = dth / dt
        wl, wr = twist_to_wheel_units(self.cfg.robot, v, w)
        return float(wl), float(wr), dt

    def tick(self) -> None:
        """Drain queues, run the device SLAM step(s) per robot: full
        windows of `max(2, fleet.batch_scans)` queued scans through
        `slam_step_window`, the remainder scan by scan. One `mapper.tick`
        stage (latency histogram) around the whole tick and, with tracing
        on, one `mapper.tick` span, under which everything the tick
        publishes chains; the SLO engine evaluates after the body."""
        self._tick_no += 1
        if self._pipeline is not None:
            self._pipeline.note_tick(self._tick_no)
        t0 = time.perf_counter()
        with M.stages.stage("mapper.tick"):
            if self._tracer is not None:
                with self._tracer.span("mapper.tick", key=self._tick_no):
                    self._tick_body()
            else:
                self._tick_body()
        if self._slo is not None:
            # Once a tick, on the step clock the burn windows count,
            # with the tick's duration (deadline objective) and the live
            # revision (staleness objective).
            self._slo.evaluate(self._tick_no,
                               tick_ms=(time.perf_counter() - t0) * 1e3,
                               map_revision=self.map_revision)

    def _tick_body(self) -> None:
        self._maybe_shift_window()
        with self._state_lock:
            work: List[List] = [[] for _ in range(self.n_robots)]
            for i in range(self.n_robots):
                for scan, ctx, enq_t in sorted(
                        self._scan_q[i], key=lambda e: e[0].header.stamp):
                    if self.cfg.resilience.enabled and \
                            scan.header.stamp < \
                            self._last_accepted_stamp[i]:
                        # Degraded-mode gate: a scan older than the newest
                        # fused one arrived late; fusing it would smear
                        # stale evidence at the current pose chain.
                        self.n_scans_rejected_stale += 1
                        M.counters.inc("mapper.scans_rejected_stale")
                        continue
                    od = self._pair_odom(i, scan.header.stamp)
                    if od is None:
                        self.n_scans_dropped_unpaired += 1
                        M.counters.inc("mapper.scans_unpaired")
                        continue
                    # The stale watermark advances at install time
                    # (_finish_step), not here.
                    work[i].append((scan, od, ctx, enq_t))
                self._scan_q[i].clear()

        # ONE host->device copy for the tick: every robot's queued scans
        # (a quarantined robot's freshest only), padded and stacked.
        ranges_dev = self._upload_scan_ranges(
            [items[-1:] if self._diverged(i) else items
             for i, items in enumerate(work)])
        corrections = []
        for i, items in enumerate(work):
            if not items:
                continue
            if self._diverged(i):
                # Quarantine rung: buffer the evidence, attempt a
                # wide-window relocalization with the freshest scan.
                self._quarantine_and_relocalize(i, items, ranges_dev[i][0])
                continue
            W = max(2, self.cfg.fleet.batch_scans)
            k = 0
            while k < len(items):
                if self._diverged(i):
                    # A step above just declared divergence: the rest of
                    # this tick's queue is the same fault's evidence.
                    self._quarantine_items(i, items[k:])
                    break
                if len(items) - k >= W:
                    self._step_window(i, items[k:k + W],
                                      ranges_dev[i][k:k + W])
                    k += W
                else:
                    self._step_single(i, items[k], ranges_dev[i][k])
                    k += 1
            if not self._diverged(i):
                # A diverged robot's correction TF stays frozen at its
                # last healthy step.
                corrections.append((i, items[-1][0], items[-1][1]))

        decayed = False
        # Localization mode tracks against a frozen map: no healing.
        if self.cfg.decay.enabled and self.cfg.mode == "mapping":
            self._decay_ticks += 1
            if self._decay_ticks % max(1, self.cfg.decay.every_n_ticks) \
                    == 0:
                self._apply_decay()
                decayed = True

        if any(work) or decayed:
            # The publish reads the poses with the map and publishes the
            # correction TFs from that one read.
            self.publish_frontiers(corrections)
        self._notify_revision_listeners()
        self._heartbeater.beat(
            {"scans_fused": self.n_scans_fused,
             "rejected_stale": self.n_scans_rejected_stale,
             "loops_closed": self.n_loops_closed})

    def _read_poses(self) -> np.ndarray:
        """Every robot's current estimate (window frame), (R, 3) float32,
        stacked on the device and read in one copy."""
        with self._state_lock:
            stacked = torch.stack([st.pose for st in self.states])
        return stacked.cpu().numpy()

    def _maybe_shift_window(self) -> None:
        """Windowed-mode world upkeep at the top of a tick (a no-op
        otherwise): join last tick's disk prefetches into the window, then
        recentre the window when a robot strays into the margin band.

        A shift translates the whole frame: the grid rolls (evicting and
        rehydrating through the store) and every pose-like leaf
        (state.pose, last_key_pose, the graph's poses, the correction
        basis) moves by the shift; graph edges are relative and scan rings
        are ranges, so nothing else changes. Every holder of the grid is
        re-pointed in the same lock section; the generations bump, and the
        revision bump with the full dirty mark makes the frontier pipeline
        and the pyramid caches see an ordinary whole-map mutation. It runs
        between steps, so no step is in flight."""
        if self.world is None:
            return
        with self._state_lock:
            grid, n_rehydrated = self.world.poll_prefetch(self.shared_grid)
            if n_rehydrated:
                self.shared_grid = grid
                for j in range(self.n_robots):
                    self.states[j] = self.states[j]._replace(grid=grid)
                if self._serving_enabled:
                    self.map_revision += 1
                    self._mark_dirty_all()
            poses = torch.stack([st.pose for st in self.states]
                                ).cpu().numpy()
            dr, dc = self.world.desired_shift(poses)
            if (dr, dc) == (0, 0):
                return
            with M.stages.stage("mapper.window_shift"):
                new_grid = self.world.shift(self.shared_grid, dr, dc)
            delta = self.world.shift_delta_m(dr, dc)
            shift3_np = np.array([delta[0], delta[1], 0.0], np.float32)
            # Filled in on the device: a copy from the host would sync.
            shift3 = torch.stack([new_grid.new_full((), float(v))
                                  for v in shift3_np])
            self.shared_grid = new_grid
            for j in range(self.n_robots):
                st = self.states[j]
                graph = st.graph._replace(
                    poses=st.graph.poses - shift3[None, :])
                self.states[j] = st._replace(
                    grid=new_grid,
                    pose=st.pose - shift3,
                    last_key_pose=st.last_key_pose - shift3,
                    graph=graph)
                self._state_gen[j] += 1
                if self._correction[j] is not None:
                    est, odo = self._correction[j]
                    self._correction[j] = (est - shift3_np, odo)
            if self._serving_enabled:
                self.map_revision += 1
                self._mark_dirty_all()
        M.counters.inc("mapper.window_shifts")
        flight_recorder.record("window_shift", dr=dr, dc=dc,
                               origin=list(self.world.origin_tile))

    def _apply_decay(self) -> None:
        """One map-healing pass (DecayConfig) between steps; the revision
        bump and full dirty mark make the frontier pipeline and the
        pyramid caches see it as an ordinary revision advance."""
        d = self.cfg.decay
        with self._state_lock:
            g = G.decay_grid(self.shared_grid, d.factor, d.evidence_cap)
            self.shared_grid = g
            for j in range(self.n_robots):
                self.states[j] = self.states[j]._replace(grid=g)
            rev = None
            if self._serving_enabled:
                self.map_revision += 1
                rev = self.map_revision
                self._mark_dirty_all()
        if self._pipeline is not None and rev is not None:
            # A decay pass stamps its revision but is not ingest: healing
            # must not reset the ingest-stall clock.
            self._pipeline.installed(rev, tick=self._tick_no,
                                     ingest=False)
        if self.world is not None:
            # Evicted tiles catch up at rehydration (one clip(x*f) a
            # missed pass, as the device's).
            self.world.note_decay_pass()
        self.n_decay_passes += 1
        M.counters.inc("mapper.decay_passes")
        flight_recorder.record("decay_pass", n=self.n_decay_passes,
                               tick=self._decay_ticks)

    def _upload_scan_ranges(self, work: List[List]) -> List:
        """Every robot's scans in `work`, padded and stacked host-side and
        copied to the device at once; returns one (N_i, padded_beams)
        view per robot (None for a robot with none)."""
        counts = [len(items) for items in work]
        if not sum(counts):
            return [None] * len(work)
        arr = np.stack([self._pad_ranges(it[0])
                        for items in work for it in items])
        M.counters.inc("mapper.scan_upload_batches")
        dev_arr = torch.as_tensor(arr, device=self.device)
        return [part if n else None
                for part, n in zip(torch.split(dev_arr, counts), counts)]

    def _read_step(self, i: int, state, diag, travel_cells: int,
                   agreement_sample=None) -> StepRead:
        """Everything the host needs from one step, in one device-to-host
        copy: the diag's flags, agreement, covariance and matcher
        counters, the new pose, the touched-tile box and (single steps)
        the sub-gate agreement sample, packed as float64 (every value is
        exact in it)."""
        box = self._touched_box(i, state, travel_cells)
        parts = [torch.stack([diag.matched.to(torch.float64),
                              diag.loop_closed.to(torch.float64),
                              diag.window_agreement.to(torch.float64),
                              diag.key_added.to(torch.float64),
                              diag.match_candidates.to(torch.float64),
                              diag.match_prune_ratio.to(torch.float64)]),
                 diag.cov.to(torch.float64), state.pose.to(torch.float64)]
        if box is not None:
            parts.append(box.to(torch.float64))
        if agreement_sample is not None:
            parts.append(agreement_sample.reshape(1).to(torch.float64))
        h = torch.cat(parts).cpu().numpy()
        rest = h[12:]
        return StepRead(
            matched=bool(h[0]), closed=bool(h[1]),
            agreement=float(np.float32(h[2])), key_added=bool(h[3]),
            candidates=int(h[4]), prune_ratio=float(np.float32(h[5])),
            cov=h[6:9].astype(np.float32), pose=h[9:12].astype(np.float32),
            box=(tuple(int(v) for v in rest[:4]) if box is not None
                 else None),
            scan_agreement=(float(np.float32(rest[-1]))
                            if agreement_sample is not None else None))

    def _step_window(self, i: int, items: List, ranges_w) -> None:
        W = len(items)
        # Snapshot generation BEFORE _odom_motion touches _prev_paired.
        with self._state_lock:
            base_grid = self.shared_grid
            base_gen = self._state_gen[i]
        motion = [self._odom_motion(i, it[1]) for it in items]
        wheels_w = torch.tensor([[m[0], m[1]] for m in motion],
                                dtype=torch.float32)
        dts_w = torch.tensor([m[2] for m in motion], dtype=torch.float32)
        travel_cells = self._travel_cells(motion)
        state = self.states[i]._replace(grid=base_grid)
        with M.stages.stage("mapper.slam_step_window"):
            state, diag = S.slam_step_window(self.cfg, state, ranges_w,
                                             wheels_w, dts_w)
            r = self._read_step(i, state, diag, travel_cells)
            if r.matched:
                self._last_cov[i] = r.cov
            if r.key_added:
                self._note_match_stats(i, r)
        if self.cfg.resilience.enabled and \
                r.agreement < self.cfg.resilience.window_agreement_reject:
            self._reject_low_agreement(i, items)
            return
        if self._observe_watchdog(i, r, window=True):
            # The declaring step's own evidence is the first quarantined
            # window.
            self._quarantine_items(i, items)
            return
        installed = self._finish_step(i, state, r, items[-1][1], W,
                                      base_grid, base_gen,
                                      items[-1][0].header.stamp,
                                      enq_t=self._oldest_enq(items))
        if not installed:
            return
        self._emit_fuse_spans(i, items)
        self.n_windows_fused += 1
        M.counters.inc("mapper.windows_fused")
        # A low-agreement window means evidence landed in known-free
        # space — misaligned odometry or a garbage burst.
        if r.agreement < 0.5:
            self.n_low_agreement_windows += 1
            M.counters.inc("mapper.low_agreement_windows")

    def _note_match_stats(self, i: int, r: StepRead) -> None:
        """Key-step matcher work gauges."""
        self._match_candidates[i] = r.candidates
        self._match_prune_ratio[i] = round(r.prune_ratio, 4)

    def match_stats(self) -> dict:
        """Per-robot matcher work accounting (lock-free reads)."""
        return {"candidates": list(self._match_candidates),
                "prune_ratio": list(self._match_prune_ratio)}

    def _emit_fuse_spans(self, i: int, items: List) -> None:
        """One instant `mapper.fuse` span per INSTALLED scan, parented on
        the scan's bus-delivery context (sim publish -> queue -> fuse); a
        scan without one falls back to the tick span. The key is a
        per-robot monotone fuse counter, not the wall-clock scan stamp,
        so two same-seed runs emit the same ids."""
        tr = self._tracer
        if tr is None:
            return
        for it in items:
            self._fuse_no[i] += 1
            tr.emit("mapper.fuse", parent=it[2], key=(i, self._fuse_no[i]))

    @staticmethod
    def _oldest_enq(items: List):
        """Oldest pipeline enqueue stamp among a step's work items (the
        worst-case freshness of its evidence); None with no ledger."""
        return min((it[3] for it in items if it[3] is not None),
                   default=None)

    def _step_single(self, i: int, item: tuple, ranges) -> None:
        scan, od = item[0], item[1]
        with self._state_lock:
            base_grid = self.shared_grid
            base_gen = self._state_gen[i]
        wl, wr, dt = self._odom_motion(i, od)
        travel_cells = self._travel_cells([(wl, wr, dt)])
        state = self.states[i]._replace(grid=base_grid)
        with M.stages.stage("mapper.slam_step"):
            state, diag = S.slam_step(self.cfg, state, ranges, wl, wr, dt)
            # The watchdog samples a sub-gate step's scan against the map
            # at the post-step pose; computed here so it comes back in
            # the step's one copy (a key step's sample goes unused).
            sample = (S.scan_agreement(self.cfg, base_grid, ranges,
                                       state.pose)
                      if self._recovery is not None else None)
            r = self._read_step(i, state, diag, travel_cells, sample)
            if r.matched:
                self._last_cov[i] = r.cov
            if r.key_added:
                self._note_match_stats(i, r)
        if self.cfg.resilience.enabled and \
                r.agreement < self.cfg.resilience.window_agreement_reject:
            # The same do-no-harm floor as _step_window (slam_step reports
            # a neutral 1.0 on skip/localization steps).
            self._reject_low_agreement(i, [item])
            return
        if self._observe_watchdog(i, r, window=False):
            self._quarantine_items(i, [item])
            return
        if self._finish_step(i, state, r, od, 1, base_grid, base_gen,
                             scan.header.stamp,
                             enq_t=self._oldest_enq([item])):
            self._emit_fuse_spans(i, [item])

    def _reject_low_agreement(self, i: int,
                              items: Optional[List] = None) -> None:
        """Degraded-mode gate, shared by the window and single paths:
        near-zero agreement means the evidence landed in known-free space
        (a garbage burst). Nothing installs; the pairing chain resets. The
        rejection is also a maximum-badness watchdog observation."""
        with self._state_lock:
            self._prev_paired[i] = None
            self._prev_matched[i] = False
        if self._recovery is not None \
                and self._recovery.watchdog.observe_rejected(i):
            self._declare_diverged(i)
            if items:
                self._quarantine_items(i, items)
        self.n_windows_rejected_low_agreement += 1
        M.counters.inc("mapper.windows_rejected_low_agreement")
        self.n_low_agreement_windows += 1
        M.counters.inc("mapper.low_agreement_windows")

    # -- estimator guardrails (recovery/) ------------------------------------

    def _diverged(self, i: int) -> bool:
        return (self._recovery is not None
                and self._recovery.watchdog.is_diverged(i))

    def _observe_watchdog(self, i: int, r: StepRead, window: bool) -> bool:
        """Feed one step's health sample to the divergence watchdog;
        True when it DECLARES divergence (the caller then quarantines the
        step's evidence). Key steps carry the diag's agreement and match
        telemetry, windows the window mean, sub-gate single steps the
        `scan_agreement` sample at the post-step pose."""
        if self._recovery is None:
            return False
        agreement = r.agreement
        if not r.key_added and not window and r.scan_agreement is not None:
            agreement = r.scan_agreement
        cov_trace = None
        if r.key_added and r.matched and self._last_cov[i] is not None:
            cov_trace = float(np.sum(self._last_cov[i]))
        declared = self._recovery.watchdog.observe(
            i, r.key_added, r.matched, agreement, cov_trace)
        if declared:
            self._declare_diverged(i)
        return declared

    def _declare_diverged(self, i: int) -> None:
        """ESTIMATOR_DIVERGED side effects: the health ladder gets the
        rung, the relocalizer's streak starts clean, and the flight
        recorder dumps a postmortem."""
        if self._health is not None:
            self._health.note_estimator(i, True)
        self._recovery.relocalizer.reset(i)
        M.counters.inc("mapper.estimator_diverged_events")
        flight_recorder.record("estimator_diverged", robot=i)
        flight_recorder.dump_async(f"watchdog_divergence_robot{i}")

    def _quarantine_items(self, i: int, items: List) -> None:
        """Buffer (scan, odom) pairs instead of fusing them; bounded —
        oldest evidence drops first."""
        q = self._quarantine[i]
        q.extend(items)
        cap = self.cfg.recovery.quarantine_cap
        overflow = len(q) - cap
        if overflow > 0:
            del q[:overflow]
            self.n_quarantine_overflow += overflow
        self.n_scans_quarantined += len(items)
        M.counters.inc("mapper.scans_quarantined", len(items))

    def _quarantine_and_relocalize(self, i: int, items: List,
                                   ranges) -> None:
        """One quarantine tick for robot i: buffer the evidence, then
        attempt relocalization with the freshest scan (`ranges`, its
        device row) against the live shared map; a verified re-anchor
        re-admits the robot (fresh chain, kept map)."""
        self._quarantine_items(i, items)
        scan = items[-1][0]
        with self._state_lock:
            grid = self.shared_grid
            base_rev = self.map_revision
            guess = self.states[i].pose
        pose = self._recovery.relocalizer.attempt_for(
            i, self.cfg, grid, ranges, guess,
            region_rev_fn=self.region_revision,
            grid_revision=base_rev if self._serving_enabled else None)
        M.counters.inc("mapper.relocalization_attempts")
        if pose is None:
            return
        self.reset_robot_pose(i, pose)
        with self._state_lock:
            # Quarantined-era stragglers are older than the verifying
            # scan: the stale watermark rejects them.
            self._last_accepted_stamp[i] = max(
                self._last_accepted_stamp[i], scan.header.stamp)
            self._quarantine[i].clear()
        self._recovery.watchdog.readmit(i)
        if self._health is not None:
            self._health.note_estimator(i, False)
        self.n_relocalizations += 1
        M.counters.inc("mapper.relocalizations")
        flight_recorder.record("relocalized", robot=i,
                               n=self.n_relocalizations)

    def _travel_cells(self, motion) -> int:
        """Odometric path-length bound of a step's window, grid cells
        (the touched-tile box's interior-pose slack)."""
        coeff = self.cfg.robot.speed_coeff_m_per_unit_s
        travel_m = sum(abs((wl + wr) * 0.5) * coeff * dt
                       for wl, wr, dt in motion)
        return int(travel_m / self.cfg.grid.resolution_m) + 1

    def _finish_step(self, i: int, state, r: StepRead, od: Odometry,
                     n_scans: int, base_grid, base_gen: int,
                     newest_stamp: float = -float("inf"),
                     enq_t: Optional[float] = None) -> bool:
        """Install the step's results; returns False when the step was
        dropped as stale. `newest_stamp` advances the robot's
        stale-rejection watermark only when the step installs; `enq_t`
        is the step's oldest ledger enqueue stamp."""
        rev_installed = None
        with self._state_lock:
            if self.shared_grid is not base_grid \
                    or self._state_gen[i] != base_gen:
                # Another mutation replaced fleet or robot state while
                # this step was in flight: drop the step (and the pairing
                # side effect, so the next pair bootstraps).
                self._prev_paired[i] = None
                self._prev_matched[i] = False
                M.counters.inc("mapper.steps_dropped_stale")
                return False
            self.shared_grid = state.grid
            self.states[i] = state
            self._last_accepted_stamp[i] = max(
                self._last_accepted_stamp[i], newest_stamp)
            if r.closed and self.n_robots > 1:
                # The closure re-fused only robot i's ring; rebuild the
                # shared map from every robot's ring.
                self.shared_grid = self._refuse_all_rings()
            if r.closed and self._map_prior is not None:
                # Ring re-fusions rebuild from an empty grid: backfill
                # the cells without live evidence from the prior.
                self.shared_grid = torch.where(self.shared_grid == 0.0,
                                               self._map_prior,
                                               self.shared_grid)
            for j in range(self.n_robots):
                self.states[j] = self.states[j]._replace(
                    grid=self.shared_grid)
            # Odometry-scale calibration sample: SLAM over odometry
            # displacement between consecutive matched, closure-free,
            # mostly-straight installs.
            prev = self._correction[i]
            new_est = r.pose
            new_odo = np.asarray([od.pose.x, od.pose.y, od.pose.theta],
                                 np.float32)
            if self._serving_enabled:
                self.map_revision += 1
                rev_installed = self.map_revision
                if r.closed:
                    self._mark_dirty_all()
                elif r.box is not None:
                    self._mark_dirty_box(r.box)
                else:
                    self._mark_dirty_patch(new_est[:2])
            if prev is not None and r.matched and self._prev_matched[i] \
                    and not r.closed:
                d_slam = float(np.hypot(*(new_est[:2] - prev[0][:2])))
                d_odo = float(np.hypot(*(new_odo[:2] - prev[1][:2])))
                dth = abs(float((new_odo[2] - prev[1][2] + np.pi)
                                % (2 * np.pi) - np.pi))
                if d_odo > 0.01 and dth < 0.2 \
                        and 0.5 < d_slam / d_odo < 2.0:
                    k = self._calib_decay
                    self._calib_odo[i] = self._calib_odo[i] * k + d_odo
                    self._calib_slam[i] = self._calib_slam[i] * k + d_slam
                    self._calib_n[i] += 1
            self._prev_matched[i] = r.matched
            # The installed (estimate, paired odom) pair is the live
            # map->odom correction for robot i.
            self._correction[i] = (new_est, new_odo)
        if self._pipeline is not None and rev_installed is not None:
            # Install waypoint, outside the state lock (the ledger has its
            # own leaf lock).
            self._pipeline.installed(rev_installed, enq_t=enq_t,
                                     tick=self._tick_no)
        self.n_scans_fused += n_scans
        M.counters.inc("mapper.scans_fused", n_scans)
        if r.matched:
            M.counters.inc("mapper.scan_matches")
        if r.closed:
            self.n_loops_closed += 1
            M.counters.inc("mapper.loops_closed")
        return True

    def publish_graph(self) -> None:
        """The fleet's pose graphs as `/graph` (GraphMarkers); loop edges
        are the non-consecutive constraints."""
        from jax_mapping_torch.bridge.messages import GraphMarkers
        with self._state_lock:
            states = list(self.states)
        nodes, nrob, edges, isloop = [], [], [], []
        cap = self.cfg.loop.max_poses
        for i, st in enumerate(states):
            g = st.graph
            poses = g.poses[:cap].cpu().numpy()
            valid = g.pose_valid[:cap].cpu().numpy()
            for k in np.nonzero(valid)[0]:
                nodes.append(poses[k, :2])
                nrob.append(i)
            eij = g.edge_ij.cpu().numpy()
            evalid = g.edge_valid.cpu().numpy()
            for k in np.nonzero(evalid)[0]:
                a, b = int(eij[k, 0]), int(eij[k, 1])
                if not (valid[a] and valid[b]):
                    continue
                edges.append([poses[a, :2], poses[b, :2]])
                isloop.append(abs(b - a) > 1)
        self.graph_pub.publish(GraphMarkers(
            header=Header.now("map"),
            nodes_xy=np.asarray(nodes, np.float32).reshape(-1, 2),
            node_robot=np.asarray(nrob, np.int32),
            edges_xy=np.asarray(edges, np.float32).reshape(-1, 2, 2),
            edge_is_loop=np.asarray(isloop, bool)))

    def calibration(self) -> Optional[dict]:
        """Fleet odometry-scale estimate from the accumulated matched
        straight-motion samples, or None before any (lock-free reads)."""
        odo = sum(self._calib_odo)
        slam = sum(self._calib_slam)
        n = sum(self._calib_n)
        if n == 0 or odo <= 0.0:
            return None
        per_robot = [
            (round(s / o, 4) if o > 0.0 else None)
            for s, o in zip(self._calib_slam, self._calib_odo)]
        scale = slam / odo
        return {
            "odom_scale": round(scale, 4),
            "suggested_speed_coeff": round(
                self.cfg.robot.speed_coeff_m_per_unit_s * scale, 7),
            "n_samples": n,
            "per_robot": per_robot,
        }

    def _refuse_all_rings(self):
        """Shared-map repair across the fleet: re-fuse every robot's
        key-scan ring at its optimised graph poses, masked on pose
        validity, the rings concatenated on the device. Caller holds the
        state lock."""
        cap = self.cfg.loop.max_poses
        grid = G.empty_grid(self.cfg.grid, self.device)
        rings = torch.cat([st.scan_ring for st in self.states], dim=0)
        poses = torch.cat([st.graph.poses[:cap] for st in self.states],
                          dim=0)
        valid = torch.cat([st.graph.pose_valid[:cap] for st in self.states],
                          dim=0)
        return G.fuse_scans_bucketed(self.cfg.grid, self.cfg.scan, grid,
                                     rings, poses, valid)

    def _publish_correction(self, i: int, scan: LaserScan, od: Odometry,
                            est: np.ndarray) -> None:
        """map->odom correction TF: est ⊖ odom (slam_toolbox's role);
        `est` is robot i's current estimate in the window frame, read by
        the caller. TF consumers live in the world frame."""
        est = est + self._world_shift3()
        o = od.pose
        ns = robot_ns(i, self.n_robots)
        c, s = np.cos(est[2] - o.theta), np.sin(est[2] - o.theta)
        self.tf.set_transform(TransformStamped(
            header=Header(stamp=scan.header.stamp, frame_id="map"),
            child_frame_id=f"{ns}odom",
            x=float(est[0] - (c * o.x - s * o.y)),
            y=float(est[1] - (s * o.x + c * o.y)),
            theta=float(est[2] - o.theta)))

    # -- exports ------------------------------------------------------------

    def depth_anchor(self, i: int):
        """Host snapshot of robot i's correction basis and graph tip:
        (gen, est_pose, odom_pose, node_idx, node_pose, n_keyscans), or
        None before the first installed step. The graph tip, its pose
        count and the key-scan count come back in one copy."""
        with self._state_lock:
            corr = self._correction[i]
            if corr is None:
                return None
            st = self.states[i]
            gen = self._state_gen[i]
        tip = (st.graph.n_poses - 1).clamp(min=0).reshape(1).long()
        h = torch.cat([st.graph.poses.index_select(0, tip)[0].double(),
                       st.graph.n_poses.reshape(1).double(),
                       st.n_keyscans.reshape(1).double()]).cpu().numpy()
        n, n_keyscans = int(h[3]), int(h[4])
        # World frame: the estimate and the graph node move with every
        # window shift (odometry stays in its own frame).
        shift3 = self._world_shift3()
        corr = (np.asarray(corr[0], np.float32) + shift3, corr[1])
        if n == 0:
            # Localization mode never grows the graph: no node to anchor.
            return (gen, corr[0], corr[1], -1, corr[0], n_keyscans)
        return (gen, corr[0], corr[1], n - 1,
                h[:3].astype(np.float32) + shift3, n_keyscans)

    def graph_snapshot(self, i: int):
        """(gen, poses (cap, 3) np, pose_valid (cap,) np, n_poses,
        n_keyscans) of robot i's graph."""
        with self._state_lock:
            st = self.states[i]
            gen = self._state_gen[i]
        cap = self.cfg.loop.max_poses
        # World frame, as depth_anchor: node poses stay shift-invariant.
        return (gen, st.graph.poses[:cap].cpu().numpy()
                + self._world_shift3(),
                st.graph.pose_valid[:cap].cpu().numpy(),
                int(st.graph.n_poses), int(st.n_keyscans))

    def merged_grid(self):
        """The fleet's shared global map (a device tensor)."""
        with self._state_lock:
            return self.shared_grid

    def publish_map(self) -> None:
        g = self.cfg.grid
        lo = self.merged_grid().cpu().numpy()
        # Windowed, the published grid is the window: its origin rides
        # the window.
        off = self._world_shift3()
        origin = (float(g.origin_m[0] + off[0]),
                  float(g.origin_m[1] + off[1]))
        msg = occupancy_from_logodds(lo, g.occ_threshold, g.free_threshold,
                                     g.resolution_m, origin)
        self._last_map_stamp = msg.header.stamp
        self.map_pub.publish(msg)
        self.map_updates_pub.publish(msg)

    def _reassign_dead(self, assignment: np.ndarray, targets: np.ndarray,
                       poses: np.ndarray) -> np.ndarray:
        """Strip unavailable robots (DEAD or ESTIMATOR_DIVERGED) from the
        auction's output and hand their orphaned targets to the nearest
        available robot."""
        if self._health is None or len(assignment) == 0:
            return assignment
        alive = self._health.assignable_mask()[:len(assignment)]
        if alive.all() or not alive.any():
            return assignment
        assignment = assignment.copy()
        live_idx = np.nonzero(alive)[0]
        for d in np.nonzero(~alive)[0]:
            a = int(assignment[d])
            assignment[d] = -1
            if 0 <= a < len(targets) \
                    and not np.any(assignment[live_idx] == a):
                dists = np.hypot(poses[live_idx, 0] - targets[a, 0],
                                 poses[live_idx, 1] - targets[a, 1])
                assignment[live_idx[int(np.argmin(dists))]] = a
                M.counters.inc("mapper.frontiers_reassigned")
        return assignment

    def _apply_blacklist(self, assignment: np.ndarray,
                         targets: np.ndarray,
                         poses: np.ndarray) -> np.ndarray:
        """Anti-stuck rung 3: a robot's blacklisted frontier is replaced by
        its nearest frontier not blacklisted for it, or -1. Tolerance: one
        clustering cell."""
        if self._recovery is None or len(assignment) == 0 \
                or len(targets) == 0:
            return assignment
        bl = self._recovery.blacklist
        if not bl.entries():
            return assignment
        tol = (self.cfg.grid.resolution_m * self.cfg.frontier.downsample
               * self.cfg.frontier.cluster_downsample)
        assignment = assignment.copy()
        for i in range(len(assignment)):
            a = int(assignment[i])
            if not 0 <= a < len(targets) \
                    or not bl.is_blacklisted(i, targets[a], tol):
                continue
            allowed = [j for j in range(len(targets))
                       if not bl.is_blacklisted(i, targets[j], tol)]
            if allowed:
                p = poses[i] if i < len(poses) else targets[a]
                dists = [float(np.hypot(targets[j][0] - p[0],
                                        targets[j][1] - p[1]))
                         for j in allowed]
                assignment[i] = allowed[int(np.argmin(dists))]
            else:
                assignment[i] = -1
            M.counters.inc("mapper.frontiers_blacklist_redirects")
        return assignment

    def _frontier_basis(self, lo, rev: int):
        """(grid the frontier auction runs on, its key beyond the tile
        revisions). With a provider wired: the planning grid (the
        planner's voxel overlay), so the auction and the waypoint descent
        see one map, and a frontier whose only corridor the depth camera
        alone sees blocked is not assigned forever while every plan to it
        fails. Without one: the shared 2D map."""
        if self.frontier_grid_provider is None:
            return lo, None
        try:
            # Key BEFORE basis: an overlay advancing in between leaves new
            # content under an older key, which the next read heals.
            key = None
            if self.frontier_grid_key_provider is not None:
                key = ("overlay", self.frontier_grid_key_provider())
            # rev keys content only while revisions are tracked (the
            # revision is frozen at 0 with serving off): None asks the
            # provider to key on identity.
            lo_rev = rev if self._serving_enabled else None
            basis = self.frontier_grid_provider(lo, lo_rev)
            if key is not None:
                return basis, key
            # An unkeyed basis: a fresh sentinel makes the pipeline treat
            # every tile as dirty, never serving a stale overlay.
            return basis, ("unkeyed", object())
        except Exception:                # noqa: BLE001
            # Provider trouble must not stop the frontier publish; the
            # bare 2D map is the fallback.
            import traceback
            traceback.print_exc()
            return lo, None

    def _frontier_incremental(self):
        """The incremental pipeline, or None (disabled config, no
        revision tracking, or a latched geometry rejection)."""
        if not self.cfg.frontier.incremental or self._tile_rev is None \
                or self._frontier_pipeline_failed:
            return None
        if self._frontier_pipeline is None:
            from jax_mapping_torch.ops.frontier_incremental import \
                IncrementalFrontierPipeline
            try:
                self._frontier_pipeline = IncrementalFrontierPipeline(
                    self.cfg.frontier, self.cfg.grid,
                    self.cfg.serving.tile_cells, device=self.device)
            except ValueError as e:
                print(f"[mapper] incremental frontier pipeline disabled "
                      f"({e}); publishing via full recompute", flush=True)
                self._frontier_pipeline_failed = True
                return None
        return self._frontier_pipeline

    def frontier_stats(self) -> Optional[dict]:
        """Incremental-pipeline counters; None until the pipeline
        exists."""
        p = self._frontier_pipeline
        return None if p is None else p.status()

    def publish_frontiers(self, corrections=()) -> None:
        """Publish `/frontiers` and `/pose`, and first the map->odom
        correction TF of each (robot, scan, odom) in `corrections` (the
        tick's), from the same read of the poses. Whole-publish latency
        stage `mapper.publish_frontiers`; the incremental compute alone is
        `mapper.frontier_publish`."""
        with M.stages.stage("mapper.publish_frontiers"):
            self._publish_frontiers_body(corrections)

    def _publish_frontiers_body(self, corrections) -> None:
        with self._state_lock:
            # ONE section for everything this publish uses: the poses
            # (stacked on the device), the grid, the revision and the
            # tile revisions. A writer between two sections would pair a
            # new map with old poses.
            stacked = torch.stack([st.pose for st in self.states])
            lo = self.shared_grid
            rev = self.map_revision
            tile_rev = None
            if self._tile_rev is not None:
                with self._dirty_lock:
                    tile_rev = self._tile_rev.copy()
        poses = stacked.cpu().numpy()
        for i, scan, od in corrections:
            self._publish_correction(i, scan, od, poses[i])
        lo, extra_key = self._frontier_basis(lo, rev)
        if self.world is not None:
            # The pipeline runs at window scale: its view of the logical
            # revision lattice is the resident window, and the origin in
            # its key invalidates every cached tile across a shift.
            r0, c0 = self.world.origin_tile
            wt = self.world.window_tiles
            if tile_rev is not None:
                tile_rev = np.ascontiguousarray(
                    tile_rev[r0:r0 + wt, c0:c0 + wt])
            extra_key = ("worigin", self.world.origin_tile, extra_key)
        pipeline = self._frontier_incremental()
        if pipeline is not None:
            with M.stages.stage("mapper.frontier_publish"):
                pub = pipeline.compute(lo, poses, tile_rev, rev,
                                       extra_key=extra_key)
            targets = pub.targets
            sizes = pub.sizes
            assignment = pub.assignment
            stamp_rev = pub.revision
            M.counters.inc("mapper.frontier_recomputes"
                           if pub.recomputed else "mapper.frontier_skips")
        else:
            fr = F.compute_frontiers(self.cfg.frontier, self.cfg.grid, lo,
                                     stacked)
            # Targets, sizes and assignment in one copy (float64 holds
            # every value exactly).
            K = fr.sizes.shape[0]
            h = torch.cat([fr.targets.reshape(-1).double(),
                           fr.sizes.double(),
                           fr.assignment.double()]).cpu().numpy()
            targets = h[:2 * K].reshape(K, 2).astype(np.float32)
            sizes = h[2 * K:3 * K].astype(np.int32)
            assignment = h[3 * K:].astype(np.int32)
            stamp_rev = rev if self._serving_enabled else -1
            M.counters.inc("mapper.frontier_recomputes")
        if self.world is not None:
            # The publish boundary: targets and poses cross into the world
            # frame before the post-passes (blacklists are world-frame)
            # and the wire; copies, since pub.targets may be the
            # pipeline's cache.
            off = self.world.offset_xy()
            if len(targets):
                targets = np.asarray(targets, np.float32) + off[None, :]
            poses = poses.copy()
            poses[:, :2] += off[None, :]
        # Post-passes run fresh even on a skipped recompute (health and
        # blacklists move on their own clocks); they copy on write.
        assignment = self._reassign_dead(assignment, targets, poses)
        assignment = self._apply_blacklist(assignment, targets, poses)
        hdr = Header.now("map")    # one stamp for the whole publish cycle
        self.frontiers_pub.publish(FrontierArray(
            header=hdr,
            targets_xy=targets,
            sizes=sizes,
            assignment=assignment,
            map_revision=int(stamp_rev)))
        self.pose_pub.publish([
            {"x": float(p[0]), "y": float(p[1]), "theta": float(p[2]),
             "stamp": hdr.stamp,
             "cov": (None if self._last_cov[i] is None
                     else self._last_cov[i].tolist())}
            for i, p in enumerate(poses)])
