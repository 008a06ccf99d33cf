"""Planner node: navigation goals -> `/plan` path + steering waypoint.

Port of the JAX package's `bridge/planner.py`, the Nav2-shaped global
planner over the fleet's own map:

* On a timer (PlannerConfig.period_s) while a navigation goal is set:
  snapshot the mapper's shared grid + the robot's SLAM-corrected pose,
  run `ops.planner.plan_to_goal` (goal-seeded obstacle-aware cost-to-go,
  kernel K3, + greedy descent) on the stack's device, and publish
    - `/plan`          Path: the world-frame waypoint list,
    - `/goal_waypoint` Pose2D + reachable flag: the lookahead steering
                       target the brain prefers over the raw goal while
                       fresh (PlannerConfig.waypoint_ttl_s).
* With `frontier_waypoints`, the same per exploring robot toward its
  `/frontiers` assignment: one goal field per distinct assigned target,
  one descent per robot (`/frontier_waypoints`).
* Unreachable goals publish an EMPTY plan with reachable=False.

Each plan's path, flags and waypoint come back to the host in one copy.
With a voxel mapper attached (`PlannerConfig.use_voxel_obstacles`),
plans search the 2D map overlaid with the 3D map's obstacle slice
(`_planning_grid`): obstacles the depth camera sees and the LiDAR plane
misses block paths. The mapper's frontier auction reads the same basis
(launch wires `frontier_grid_provider`).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from jax_mapping_torch.bridge.bus import Bus
from jax_mapping_torch.bridge.messages import Header, Path, Waypoint
from jax_mapping_torch.bridge.node import Node
from jax_mapping_torch.config import SlamConfig
from jax_mapping_torch.ops import planner as P
from jax_mapping_torch.utils.profiling import global_metrics as M


def _read_plan(r: P.PlanResult):
    """(path (n, 2) float32 of the valid prefix, reachable, waypoint (2,)
    float32, arrived) of a PlanResult, read in one copy."""
    L = r.path_valid.shape[0]
    h = torch.cat([r.path_xy.reshape(-1).double(), r.path_valid.double(),
                   r.reachable.reshape(1).double(),
                   r.waypoint_xy.double(),
                   r.arrived.reshape(1).double()]).cpu().numpy()
    path_xy = h[:2 * L].reshape(L, 2).astype(np.float32)
    valid = h[2 * L:3 * L] != 0
    return (path_xy[valid], bool(h[3 * L]),
            h[3 * L + 1:3 * L + 3].astype(np.float32), bool(h[3 * L + 3]))


class PlannerNode(Node):
    """Global planner for the fleet's goal robot (robot 0, the one RViz's
    SetGoal drives — brain._goal_cb's convention)."""

    def __init__(self, cfg: SlamConfig, bus: Bus, mapper, brain=None,
                 robot_idx: int = 0, voxel_mapper=None, health=None):
        super().__init__("planner", bus)
        self.cfg = cfg
        self.mapper = mapper
        self.brain = brain
        self.robot_idx = robot_idx
        #: Shared degraded-mode registry: no plans for DEAD robots.
        self._health = health
        self.n_plans_skipped_dead = 0
        # 3D-aware planning needs equal cell sizes: checked here, once and
        # loudly, since a per-tick error inside a guarded callback would
        # silently stop every plan. A mismatch plans on the 2D map only.
        self.voxel_mapper = voxel_mapper
        if (voxel_mapper is not None and cfg.planner.use_voxel_obstacles
                and abs(cfg.voxel.resolution_m - cfg.grid.resolution_m)
                > 1e-9):
            print("[planner] voxel resolution "
                  f"{cfg.voxel.resolution_m} != grid "
                  f"{cfg.grid.resolution_m}; 3D obstacle overlay "
                  "DISABLED — plans search the 2D map only", flush=True)
            self.voxel_mapper = None
        #: The overlay cache: (key, 2D grid, voxel grid, overlaid grid).
        self._lo_cache = None
        #: Overlay work: cache hits (keyed or by identity), and the
        #: obstacle-slice overlays actually computed.
        self.n_overlay_rebuilds = 0
        self.n_overlay_reuses = 0
        self.plan_pub = self.create_publisher("/plan")
        self.wp_pub = self.create_publisher("/goal_waypoint")
        # Standalone (no brain): track the goal from the topic. With a
        # brain, the brain owns the goal and this node reads it.
        self._goal: Optional[tuple] = None
        if brain is None:
            self.create_subscription("/goal_pose", self._goal_cb)
        self._frontiers = None
        self.create_subscription("/frontiers", self._frontiers_cb)
        self.fwp_pub = self.create_publisher("/frontier_waypoints")
        self.n_plans = 0
        self.n_frontier_plans = 0
        self.n_goal_fields = 0
        self.last_reachable: Optional[bool] = None
        #: Per-robot manual-plan reachability (fleet goals).
        self.reachable_by_robot: dict = {}
        #: Planner tick counter — the staleness clock for /frontiers, in
        #: the deterministic time base.
        self._n_ticks = 0
        self.create_timer(cfg.planner.period_s, self.tick)

    @property
    def device(self) -> torch.device:
        return self.mapper.device

    def _goal_cb(self, msg) -> None:
        # The brain's ingress guard: a non-finite or off-map goal would
        # clip to a border cell and replan forever.
        x, y = float(msg.x), float(msg.y)
        if not self.cfg.grid.contains_m(x, y):
            print(f"[planner] ignoring non-finite or out-of-map goal "
                  f"({x}, {y})", flush=True)
            return
        self._goal = (x, y)

    def _frontiers_cb(self, msg) -> None:
        # Reorder watermark: a stale /frontiers message must not resurrect
        # assignments the mapper has since dropped.
        if self._frontiers is not None and \
                msg.header.stamp < self._frontiers[0].header.stamp:
            return
        self._frontiers = (msg, self._n_ticks)

    def _current_goal(self) -> Optional[tuple]:
        if self.brain is not None:
            return self.brain.nav_goal()
        return self._goal

    def _manual_goals(self) -> list:
        """Per-robot manual goals (None where unset)."""
        if self.brain is not None:
            return self.brain.nav_goals()
        goals = [None] * self.mapper.n_robots
        if self._goal is not None:
            goals[self.robot_idx] = self._goal
        return goals

    def _robot_pose_xy(self, i: Optional[int] = None
                       ) -> Optional[np.ndarray]:
        """SLAM-corrected pose when the mapper has stepped; the brain's
        odometry pose before that."""
        if i is None:
            i = self.robot_idx
        anchor = self.mapper.depth_anchor(i)
        if anchor is not None:
            return np.asarray(anchor[1], np.float32)[:2]
        if self.brain is not None:
            return self.brain.robot_pose(i)[:2]
        return None

    def overlay_key(self):
        """The voxel overlay's content key (its serving revision), or None
        when no overlay applies: the half of the planning basis the
        mapper's incremental frontier pipeline cannot see per tile."""
        if self.voxel_mapper is None \
                or not self.cfg.planner.use_voxel_obstacles:
            return None
        return self.voxel_mapper.serving_revision()

    def _planning_grid(self, lo=None, lo_rev=None):
        """The log-odds grid plans search: the shared 2D map, overlaid
        with the 3D obstacle slice when a voxel mapper is attached.

        Cached on (map revision, voxel revision) while the mapper tracks
        revisions, else on the identity of both grids: the manual plan,
        every frontier field of a tick and the mapper's frontier publish
        share one overlay. `lo` / `lo_rev` let the mapper pass its own
        snapshot, so the publish's poses and grid stay paired. Each
        revision is read BEFORE its grid: a write landing in between
        leaves new content under an old key (healed by the next miss),
        never old content under a new key. The cache tuple is read once
        and replaced whole, so two threads cost at most one extra
        overlay."""
        if lo is None:
            lo_rev = (self.mapper.serving_revision()
                      if getattr(self.mapper, "_serving_enabled", False)
                      else None)
            lo = self.mapper.merged_grid()
        overlay = (self.voxel_mapper is not None
                   and self.cfg.planner.use_voxel_obstacles)
        v_rev = self.voxel_mapper.serving_revision() if overlay else None
        vg = self.voxel_mapper.voxel_grid() if overlay else None
        key = (lo_rev, v_rev) if lo_rev is not None else None
        cache = self._lo_cache
        # Identity keys only an unkeyed call: a step that fuses nothing
        # may hand back its input grid while the revision moves, where
        # the JAX package's arrays are always new.
        if cache is not None and \
                (cache[0] == key if key is not None
                 else (cache[1] is lo and cache[2] is vg)):
            self.n_overlay_reuses += 1
            return cache[3]
        out = lo
        if overlay:
            out = P.overlay_voxel_obstacles(
                self.cfg.planner, self.cfg.grid, self.cfg.voxel, lo, vg)
            self.n_overlay_rebuilds += 1
        self._lo_cache = (key, lo, vg, out)
        return out

    def _xy(self, xy) -> torch.Tensor:
        return torch.as_tensor(np.asarray(xy, np.float32),
                               device=self.device)

    def _plan(self, goal, pose_xy):
        """One plan; returns (path, reachable, waypoint, arrived)."""
        r = P.plan_to_goal(self.cfg.planner, self.cfg.frontier,
                           self.cfg.grid, self._planning_grid(),
                           self._xy(goal), self._xy(pose_xy))
        return _read_plan(r)

    def tick(self) -> None:
        self._n_ticks += 1
        with M.stages.stage("planner.tick"):
            manual_robots = self._tick_manual_goals()
            if self.cfg.planner.frontier_waypoints:
                self._tick_frontier_waypoints(manual_robots=manual_robots)

    def _tick_manual_goals(self) -> set:
        """Plan for every robot's manual nav goal. Returns the robots with
        an active manual goal — the frontier pass leaves them alone."""
        goals = self._manual_goals()
        active: set = set()
        hdr = Header.now("map")
        alive = (self._health.alive_mask()
                 if self._health is not None else None)
        for i, goal in enumerate(goals):
            if goal is None:
                continue
            if alive is not None and i < len(alive) and not alive[i]:
                self.n_plans_skipped_dead += 1
                continue
            active.add(i)
            pose_xy = self._robot_pose_xy(i)
            if pose_xy is None:
                continue
            path, reachable, wp, arrived = self._plan(goal, pose_xy)
            if self.brain is None and arrived:
                # Standalone arrival bookkeeping (with a brain, the brain
                # clears the goal).
                self._goal = None
                active.discard(i)
                continue
            self.wp_pub.publish(Waypoint(
                header=hdr, x=float(wp[0]), y=float(wp[1]),
                reachable=reachable, goal_x=float(goal[0]),
                goal_y=float(goal[1]), robot=i))
            self.reachable_by_robot[i] = reachable
            if i == self.robot_idx:
                self.plan_pub.publish(Path(header=hdr, poses_xy=path))
                self.last_reachable = reachable
            self.n_plans += 1
            M.counters.inc("planner.plans")
        self.reachable_by_robot = {
            i: v for i, v in self.reachable_by_robot.items() if i in active}
        return active

    def _tick_frontier_waypoints(self, manual_robots: set) -> None:
        """Plan per exploring robot toward its /frontiers assignment and
        publish per-robot waypoints (+ robot 0's plan when no manual goal
        claims /plan)."""
        entry = self._frontiers
        if entry is None:
            return
        fr, at_tick = entry
        if self.brain is not None and not self.brain.is_exploring:
            return                           # /stop: nothing to steer
        # A dead mapper must not keep the planner burning a field per
        # target per period toward frozen assignments.
        ttl_ticks = max(1, round(self.cfg.frontier.seek_ttl_s
                                 / self.cfg.planner.period_s))
        if self._n_ticks - at_tick > ttl_ticks:
            return
        targets = np.asarray(fr.targets_xy, np.float32)
        assign = np.asarray(fr.assignment)
        hdr = Header.now("map")
        # The goal-seeded field depends only on the target: one field per
        # distinct assigned target, one descent per robot.
        fields: dict = {}
        plan_lo = None                       # snapshotted on first use
        avail = (self._health.assignable_mask()
                 if self._health is not None else None)
        for i in range(min(self.mapper.n_robots, len(assign))):
            if i in manual_robots:
                continue                     # a manual goal owns robot i
            if avail is not None and i < len(avail) and not avail[i]:
                self.n_plans_skipped_dead += 1
                continue
            a = int(assign[i])
            if not 0 <= a < len(targets):
                continue
            pose_xy = self._robot_pose_xy(i)
            if pose_xy is None:
                continue
            target = targets[a]
            if a not in fields:
                if plan_lo is None:
                    plan_lo = self._planning_grid()
                fields[a] = P.goal_field(
                    self.cfg.planner, self.cfg.frontier, self.cfg.grid,
                    plan_lo, self._xy(target))
                self.n_goal_fields += 1
            r = P.descend_field(self.cfg.planner, self.cfg.frontier,
                                self.cfg.grid, fields[a], self._xy(target),
                                self._xy(pose_xy))
            path, reachable, wp, _ = _read_plan(r)
            self.fwp_pub.publish(Waypoint(
                header=hdr, x=float(wp[0]), y=float(wp[1]),
                reachable=reachable, goal_x=float(target[0]),
                goal_y=float(target[1]), robot=i))
            self.n_frontier_plans += 1
            M.counters.inc("planner.frontier_plans")
            if i == self.robot_idx:
                self.plan_pub.publish(Path(header=hdr, poses_xy=path))

    def status(self) -> dict:
        return {"n_plans": self.n_plans,
                "n_frontier_plans": self.n_frontier_plans,
                "last_reachable": self.last_reachable,
                "reachable_by_robot": dict(self.reachable_by_robot),
                "goal": self._current_goal()}
