"""ThymioBrain node: the reference's central control node, fleet-batched.

Port of the JAX package's `bridge/brain.py`, which re-creates `class
ThymioBrain` (`server/thymio_project/thymio_project/main.py:38-224`)
against the bridge bus and the driver abstraction. The per-tick
computation — odometry integration, subsumption navigation, LED protocol
— is one batched PyTorch function over (R, ...) tensors (`brain_tick`)
on the brain's device; its inputs go up in one copy and its outputs come
back in one.

Kept behaviors (SURVEY.md §3.2, §5):
* connect on boot, offline mode on failure (pi variant, `pi/src/.../main.py:66-67`),
* throttled reconnect probe every ~2 s while disconnected — by wall clock,
  not the reference's nanosecond-modulo hack (`server/.../main.py:84-88`),
* any I/O exception ⇒ drop the link, reconnect next tick (`:198-200`),
* 16-bit sign fix on motor speed reads (`:101-102`),
* TF odom->base_link + `/odom` publication each tick (`:202-224`) with
  honest stamps (Appendix B),
* `is_exploring` start/stop contract (`:227-239`),
* LED status protocol green/blue/red/orange (`:131,161,181,192`).
"""

from __future__ import annotations

import functools
import threading
import time
from typing import List, Optional

import numpy as np
import torch

from jax_mapping_torch._util import entry_point, resolve_device
from jax_mapping_torch.bridge.bus import Bus
from jax_mapping_torch.bridge.driver import (
    LEDS_TOP, MOTOR_LEFT_SPEED, MOTOR_LEFT_TARGET, MOTOR_RIGHT_SPEED,
    MOTOR_RIGHT_TARGET, PROX_HORIZONTAL, connect_with_retries,
)
from jax_mapping_torch.bridge.messages import (
    Header, LaserScan, Odometry, Pose2D, TransformStamped, Twist,
)
from jax_mapping_torch.bridge.node import Node
from jax_mapping_torch.bridge.qos import qos_sensor_data
from jax_mapping_torch.bridge.tf import TfTree
from jax_mapping_torch.config import SlamConfig, sign_extend_16bit
from jax_mapping_torch.utils import global_metrics as M
from jax_mapping_torch.models.explorer import frontier_policy
from jax_mapping_torch.ops.odometry import rk2_step, wheel_velocities
from jax_mapping_torch.resilience.health import (
    DRIVER_OFFLINE, DRIVER_OK, DRIVER_RECOVERING, FleetHealth,
    acquire_bounded,
)
from jax_mapping_torch.resilience.supervisor import Heartbeater

#: Values in a robot's `prox.horizontal` row (five front, two rear); the
#: packed `brain_tick` input lays them out at a fixed width.
PROX_WIDTH = 7


def robot_ns(i: int, n_robots: int) -> str:
    """Topic/frame namespace: '' for a single robot (reference layout),
    'robot<i>/' for fleets."""
    return "" if n_robots == 1 else f"robot{i}/"


@entry_point(static=("cfg",))
def brain_tick(cfg: SlamConfig, poses, wheel_raw, prox, ranges,
               exploring, goals_xy, goal_valid, dt):
    """One control tick for R robots, on the inputs' device.

    poses (R,3) float32; wheel_raw (R,2) int raw unsigned16 reads;
    prox (R,>=5) int; ranges (R,B) float32 (zeros when no scan yet);
    exploring (R,) bool; goals_xy (R,2) float32 + goal_valid (R,) bool
    (navigation targets; without a valid goal the policy is exactly the
    reference's reactive navigator); dt a float.
    Returns (new_poses, odom_twists (R,2)[v,w], targets (R,2) int32,
    leds (R,3), nav_state (R,) int32).
    """
    wheels = sign_extend_16bit(wheel_raw).to(torch.float32)
    new_poses = rk2_step(cfg.robot, poses, wheels[:, 0], wheels[:, 1], dt)
    v, w = wheel_velocities(cfg.robot, wheels[:, 0], wheels[:, 1])
    # frontier_policy with goal_valid=False IS the subsumption policy
    # (goal seek only engages in the cruise state with a valid goal).
    pol = frontier_policy(cfg.robot, cfg.scan, poses, goals_xy, goal_valid,
                          ranges, prox[:, :5].to(torch.float32), exploring)
    return (new_poses, torch.stack([v, w], -1), pol.targets, pol.led,
            pol.state)


class ThymioBrain(Node):
    """Fleet brain; for n_robots=1 its graph is exactly the reference's."""

    def __init__(self, cfg: SlamConfig, bus: Bus, driver,
                 tf: Optional[TfTree] = None, n_robots: int = 1,
                 connect_retries: int = 3, connect_timeout_s: float = 3.0,
                 reconnect_period_s: float = 2.0,
                 health: Optional[FleetHealth] = None,
                 recovery=None, device=None):
        super().__init__("thymio_brain", bus, tf)
        self.cfg = cfg
        #: Where `brain_tick` runs (the stack's device).
        self.device = resolve_device(device)
        self.driver = driver
        self.n_robots = n_robots
        self.connect_retries = connect_retries
        self.connect_timeout_s = connect_timeout_s
        self.reconnect_period_s = reconnect_period_s
        #: Shared degraded-mode registry (resilience/health.py): this
        #: node FEEDS it (scan arrivals, tick clock, driver link) and
        #: READS the coast mask. None = pre-resilience behavior.
        self._health = health
        #: Estimator guardrails (recovery/manager.py): this node runs
        #: the anti-stuck recovery ladder each tick and advances the
        #: frontier blacklist's control-tick clock. None = pre-guardrail
        #: behavior exactly.
        self._recovery = recovery

        self._state_lock = threading.Lock()
        self.poses = np.zeros((n_robots, 3), np.float32)
        self.is_exploring = False                   # /start /stop contract
        self.link_up = False
        self._last_reconnect_probe = -1e9
        self.n_ticks = 0
        self._tick_no = 0
        self.n_io_errors = 0
        self._latest_scans: List[Optional[LaserScan]] = [None] * n_robots
        self._last_cmd_vel: Optional[Twist] = None
        self._last_cmd_vel_t = -1e9
        self.cmd_vel_timeout_s = 0.5

        self.odom_pubs = []
        for i in range(n_robots):
            ns = robot_ns(i, n_robots)
            self.create_subscription(
                f"{ns}scan",
                functools.partial(self._scan_cb, i),
                qos_sensor_data)                    # Best-Effort, §V.A
            self.odom_pubs.append(self.create_publisher(f"{ns}odom"))
        # Manual teleop override (bridge/teleop.py). Applies to robot 0 —
        # one pad drives one robot, the rest keep their autonomous policy.
        self.create_subscription("/cmd_vel", self._cmd_vel_cb)
        # RViz SetGoal (via the rclpy adapter): navigation goals.
        # /goal_pose addresses robot 0 (the reference's single-robot
        # convention; it shipped the RViz tool but no consumer — Nav2
        # was future work, report.pdf VI.2); fleets also get per-robot
        # {ns}goal_pose topics so an operator can direct ANY robot.
        # Cleared per robot on arrival.
        self._nav_goals: list = [None] * n_robots
        self.goal_reached_dist_m = 0.15
        self.create_subscription("/goal_pose",
                                 functools.partial(self._goal_cb, 0))
        if n_robots > 1:
            # Single-robot stacks skip this: robot_ns(0, 1) is '', so
            # the loop would subscribe a bare 'goal_pose' topic that
            # differs from the canonical '/goal_pose' every publisher
            # uses — a dead subscription that never fires.
            for i in range(n_robots):
                self.create_subscription(
                    f"{robot_ns(i, n_robots)}goal_pose",
                    functools.partial(self._goal_cb, i))
        # Planner waypoint (bridge/planner.py): while fresh, reachable,
        # and computed FOR the current goal, the brain steers at this
        # instead of the raw goal — map-aware navigation around walls.
        # Stale/absent waypoint (planner not launched, goal unreachable)
        # keeps the round-4 straight-line seek under the shield.
        self._waypoints: dict = {}
        self.create_subscription("/goal_waypoint", self._waypoint_cb)
        # Assigned-frontier exploration (FrontierConfig.seek_assigned):
        # the mapper's /frontiers assignments become goal-seek targets
        # for exploring robots without a manual nav goal — the map-based
        # explorer the reference's report defers to future work
        # (report.pdf VI.2), driving the actual robots instead of only
        # the RViz markers.
        self._frontiers = None
        self.create_subscription("/frontiers", self._frontiers_cb)
        # Per-robot planned waypoints toward assignments
        # (bridge/planner.py frontier waypoints): preferred over the raw
        # target when fresh, reachable, and planned for the SAME target.
        self._frontier_wps: dict = {}
        #: Per-stream high-water header stamps for the goal-state
        #: caches (_fresher): reorder protection that survives the TTL
        #: prune deleting the entries themselves.
        self._goal_stamp_hwm: dict = {}
        self.create_subscription("/frontier_waypoints",
                                 self._frontier_wp_cb)

        # Heartbeat for the Supervisor (beats EVERY update_loop call,
        # link up or not — the node is alive even when the robot link
        # is not).
        self._heartbeater = Heartbeater(self)
        # Safe-stop pending after a reconnect: the first post-reconnect
        # tick zeroes the motors and shows LED red instead of running
        # the policy, so stale pre-fault wheel targets never replay.
        self._safe_stop_pending = False

        # Boot connect, offline mode on failure (pi variant semantics).
        self.link_up = connect_with_retries(
            driver, max_retries=connect_retries,
            timeout_s=connect_timeout_s, log=self._log)
        self.timer = self.create_timer(1.0 / cfg.robot.control_rate_hz,
                                       self.update_loop)

    def _log(self, msg: str) -> None:
        print(f"[thymio_brain] {msg}")

    # -- callbacks ----------------------------------------------------------

    def _scan_cb(self, robot_idx: int, msg: LaserScan) -> None:
        with self._state_lock:
            self._latest_scans[robot_idx] = msg
        if self._health is not None:
            # Outside the state lock: FleetHealth is a leaf lock and
            # must never nest inside a node lock (B1 discipline).
            self._health.note_scan(robot_idx, self.n_ticks)

    def _cmd_vel_cb(self, msg: Twist) -> None:
        with self._state_lock:
            self._last_cmd_vel = msg
            self._last_cmd_vel_t = time.monotonic()

    def _goal_cb(self, i: int, msg) -> None:
        """Any pose-shaped message with .x/.y (the adapter's Pose2D)."""
        x, y = float(msg.x), float(msg.y)
        if not self.cfg.grid.contains_m(x, y):
            # The single goal ingress rejects non-finite and off-map
            # coordinates (GridConfig.contains_m — the same predicate
            # the planner and HTTP ingresses gate on): a NaN goal can
            # never be reached or cleared and would feed NaN through
            # brain_tick into that robot's wheel targets until restart;
            # a goal outside the map would clip to a border cell and
            # drive the robot toward a place that does not exist.
            self._log(f"ignoring non-finite or out-of-map goal for "
                      f"robot {i}: ({x}, {y})")
            return
        with self._state_lock:
            self._nav_goals[i] = (x, y)
        self._log(f"navigation goal set for robot {i}: "
                  f"({x:.2f}, {y:.2f}) — engages while exploring")

    def _fresher(self, key, msg) -> bool:
        """Goal-state reorder watermark: under Best-Effort delivery (and
        the chaos bus's reorder weather) a STALE /frontiers or waypoint
        message can arrive after a fresher one — accepting it would
        resurrect an assignment the mapper has since dropped and send a
        robot seeking a goal that no longer exists. The high-water
        stamps live in their OWN map (`_goal_stamp_hwm`), deliberately
        NOT in the cached entries: the TTL prune deletes entries, and a
        watermark that died with its entry would wave through a stale
        message flushed after a TTL-length gap (a healed reorder window
        draining its backlog past a dead mapper). Caller holds the
        state lock."""
        hwm = self._goal_stamp_hwm.get(key)
        if hwm is not None and msg.header.stamp < hwm:
            return False
        self._goal_stamp_hwm[key] = msg.header.stamp
        return True

    def _waypoint_cb(self, msg) -> None:
        with self._state_lock:
            r = int(getattr(msg, "robot", 0))
            if self._fresher(("wp", r), msg):
                self._waypoints[r] = (msg, self.n_ticks)

    def _frontiers_cb(self, msg) -> None:
        with self._state_lock:
            if self._fresher("frontiers", msg):
                self._frontiers = (msg, self.n_ticks)

    def _frontier_wp_cb(self, msg) -> None:
        with self._state_lock:
            r = int(getattr(msg, "robot", 0))
            if self._fresher(("fwp", r), msg):
                self._frontier_wps[r] = (msg, self.n_ticks)

    def _prune_stale_goal_state(self) -> None:
        """Expire frontier-goal state past its TTL (once per tick).

        The TTL gates at the READ sites already keep stale entries from
        steering; this prune makes expiry STRUCTURAL — the entries are
        deleted, so no future read path can forget the gate, a dead
        mapper's last assignment cannot linger in memory for the rest of
        the mission, and the waypoint dicts stay bounded."""
        rate = self.cfg.robot.control_rate_hz
        ttl_wp = self.cfg.planner.waypoint_ttl_s * rate
        ttl_fr = self.cfg.frontier.seek_ttl_s * rate
        with self._state_lock:
            self._waypoints = {
                r: (m, t) for r, (m, t) in self._waypoints.items()
                if self.n_ticks - t <= ttl_wp}
            self._frontier_wps = {
                r: (m, t) for r, (m, t) in self._frontier_wps.items()
                if self.n_ticks - t <= ttl_wp}
            if self._frontiers is not None \
                    and self.n_ticks - self._frontiers[1] > ttl_fr:
                self._frontiers = None

    def _apply_frontier_goals(self, goals_xy: np.ndarray,
                              goal_valid: np.ndarray) -> None:
        """Fill unset goal rows from the freshest /frontiers assignment.

        Manual nav goals (already-valid rows) win; robots whose
        assignment is -1 (no reachable frontier) keep the blind cruise
        fallback. Staleness is measured in control ticks like the
        planner waypoint, and for the same reason."""
        if not self.cfg.frontier.seek_assigned:
            return
        with self._state_lock:
            entry = self._frontiers
            fwps = dict(self._frontier_wps)
        if entry is None:
            return
        msg, at_tick = entry
        ttl_ticks = (self.cfg.frontier.seek_ttl_s
                     * self.cfg.robot.control_rate_hz)
        if self.n_ticks - at_tick > ttl_ticks:
            return
        targets = np.asarray(msg.targets_xy, np.float32)
        assign = np.asarray(msg.assignment)
        ttl_wp = (self.cfg.planner.waypoint_ttl_s
                  * self.cfg.robot.control_rate_hz)
        # A planned waypoint must have been computed for (about) THIS
        # target — clusters drift between publishes, so the echo match
        # is per-coarse-cell, not exact.
        tol = (self.cfg.grid.resolution_m * self.cfg.frontier.downsample
               * 2.0)
        for i in range(min(self.n_robots, len(assign))):
            a = int(assign[i])
            if goal_valid[i] or not 0 <= a < len(targets):
                continue
            goals_xy[i] = targets[a]
            goal_valid[i] = True
            wp_entry = fwps.get(i)
            if wp_entry is None:
                continue
            wp, wp_tick = wp_entry
            if (wp.reachable and self.n_ticks - wp_tick <= ttl_wp
                    and np.hypot(wp.goal_x - targets[a][0],
                                 wp.goal_y - targets[a][1]) <= tol):
                goals_xy[i] = (wp.x, wp.y)

    def _blacklist_current_goal(self, i: int) -> None:
        """Anti-stuck rung 3 — goal reassignment: robot i has proven its
        current goal unreachable-in-practice (two maneuver rungs did not
        free it). A manual nav goal is CANCELLED (the escape hatch — the
        operator's goal is the thing the robot cannot reach); a frontier
        assignment is blacklisted with TTL so the auction's post-pass
        (mapper._apply_blacklist) hands robot i a different frontier."""
        with self._state_lock:
            manual = self._nav_goals[i]
            entry = self._frontiers
        if manual is not None:
            # Cancelled, NOT blacklisted: the operator deliberately
            # pointed at this area — barring every frontier within the
            # blacklist tolerance of it would suppress exploration
            # around the very point they care about. Cancelling reverts
            # the robot to frontier exploration, which approaches the
            # region by other routes.
            self.cancel_goal(i)
            self._log(f"anti-stuck: unreachable manual goal cancelled "
                      f"(robot {i})")
            return
        if entry is None:
            return
        msg, _ = entry
        assign = np.asarray(msg.assignment)
        if i >= len(assign):
            return
        a = int(assign[i])
        targets = np.asarray(msg.targets_xy, np.float32)
        if 0 <= a < len(targets):
            self._recovery.blacklist.add(
                i, (float(targets[a][0]), float(targets[a][1])))
            self._log(f"anti-stuck: frontier ({targets[a][0]:.2f}, "
                      f"{targets[a][1]:.2f}) blacklisted for robot {i}")

    def nav_goal(self) -> Optional[tuple]:
        """Robot 0's navigation goal (planner reads the brain's copy so
        a reached-and-cleared goal stops replanning)."""
        with self._state_lock:
            return self._nav_goals[0]

    def nav_goals(self) -> list:
        """Every robot's manual goal (None where unset)."""
        with self._state_lock:
            return list(self._nav_goals)

    def cancel_goal(self, i: int) -> bool:
        """Clear robot i's manual goal; returns whether one was set.
        The robot reverts to frontier exploration (or cruise) — the
        escape hatch for an unreachable goal the operator regrets."""
        with self._state_lock:
            had = self._nav_goals[i] is not None
            self._nav_goals[i] = None
        if had:
            self._log(f"navigation goal cancelled (robot {i})")
        return had

    def robot_pose(self, i: int) -> np.ndarray:
        with self._state_lock:
            return self.poses[i].copy()

    def _steer_target(self, goal: tuple, robot: int = 0) -> tuple:
        """The point `robot` steers at for `goal`: the planner's lookahead
        waypoint when fresh + reachable + computed for THIS goal, else the
        goal itself. Freshness is measured in CONTROL TICKS, not wall
        time: faster-than-realtime stacks (Stack.run_steps, demo) replan
        every period_s of simulated control time, and a wall-clock TTL
        would silently expire every waypoint on a host where a replan
        window of sim steps takes longer than the TTL to execute —
        host-speed-dependent trajectories in the deterministic path."""
        with self._state_lock:
            entry = self._waypoints.get(robot)
        if entry is None:
            return goal
        wp, at_tick = entry
        if not wp.reachable:
            return goal
        ttl_ticks = (self.cfg.planner.waypoint_ttl_s
                     * self.cfg.robot.control_rate_hz)
        if self.n_ticks - at_tick > ttl_ticks:
            return goal
        if np.hypot(wp.goal_x - goal[0], wp.goal_y - goal[1]) > 1e-3:
            return goal                      # plan for a superseded goal
        return (wp.x, wp.y)

    def _manual_targets(self, now: float):
        """Fresh `/cmd_vel` while not exploring -> (left, right) wheel
        units for robot 0, else None. Inverse of the odometry kinematics
        (`server/.../main.py:105-115`): v = K*(l+r)/2, w = K*(r-l)/width."""
        with self._state_lock:
            cmd = self._last_cmd_vel
            fresh = now - self._last_cmd_vel_t <= self.cmd_vel_timeout_s
            exploring = self.is_exploring
        if exploring or cmd is None or not fresh:
            return None
        r = self.cfg.robot
        k = r.speed_coeff_m_per_unit_s
        half_w = r.wheel_base_m / 2.0
        left = (cmd.linear_x - cmd.angular_z * half_w) / k
        right = (cmd.linear_x + cmd.angular_z * half_w) / k
        lim = float(r.motor_limit_units)              # Thymio target range
        return (int(np.clip(left, -lim, lim)), int(np.clip(right, -lim, lim)))

    def start_exploring(self) -> None:
        with self._state_lock:
            self.is_exploring = True

    def stop_exploring(self) -> None:
        """Stop AND force motors off immediately — the pi variant's safe
        stop (`pi/src/.../main.py:320-326`), not just a flag flip."""
        with self._state_lock:
            self.is_exploring = False
        if self.link_up:
            try:
                for i in range(self.n_robots):
                    self.driver[i][MOTOR_LEFT_TARGET] = 0
                    self.driver[i][MOTOR_RIGHT_TARGET] = 0
            except Exception:                       # noqa: BLE001
                self._drop_link()

    def status(self, lock_timeout_s: Optional[float] = None) -> dict:
        """The pi variant's `/status` payload (`pi/src/.../main.py:332-341`).

        `lock_timeout_s` bounds the state-lock wait (the HTTP plane
        passes ResilienceConfig.http_lock_timeout_s); expiry raises
        LockTimeout, which the API layer answers as 503 degraded instead
        of hanging a worker thread behind a wedged tick."""
        acquire_bounded(self._state_lock, lock_timeout_s,
                        "thymio_brain state")
        try:
            return {
                "connected": self.link_up,
                "exploring": self.is_exploring,
                "n_robots": self.n_robots,
                "poses": [
                    {"x": float(p[0]), "y": float(p[1]),
                     "theta": float(p[2])} for p in self.poses],
                "ticks": self.n_ticks,
                "io_errors": self.n_io_errors,
                "goal": (None if self._nav_goals[0] is None
                         else {"x": self._nav_goals[0][0],
                               "y": self._nav_goals[0][1]}),
                "goals": [
                    (None if g is None else {"x": g[0], "y": g[1]})
                    for g in self._nav_goals],
            }
        finally:
            self._state_lock.release()

    # -- the 10 Hz loop ------------------------------------------------------

    def _drop_link(self) -> None:
        self.n_io_errors += 1
        self.link_up = False
        if self._health is not None:
            self._health.note_driver(DRIVER_OFFLINE)
        try:
            self.driver.disconnect()
        except Exception:                           # noqa: BLE001
            pass

    def _ranges_matrix(self) -> np.ndarray:
        """Latest scans resampled to (R, n_beams); zeros (= no reading,
        which the policy's outlier rule reads as far) when absent."""
        B = self.cfg.scan.n_beams
        out = np.zeros((self.n_robots, B), np.float32)
        with self._state_lock:
            scans = list(self._latest_scans)
        for i, scan in enumerate(scans):
            if scan is None or len(scan.ranges) == 0:
                continue
            r = np.asarray(scan.ranges, np.float32)
            if len(r) == B:
                out[i] = r
            else:
                idx = np.linspace(0, len(r) - 1, B).round().astype(int)
                out[i] = r[idx]
        return out

    def _beat(self) -> None:
        """One heartbeat per update_loop call — the node is alive even
        when the robot link is not (payload says which)."""
        self._heartbeater.beat(
            {"link_up": self.link_up, "ticks": self.n_ticks,
             "io_errors": self.n_io_errors})

    def _safe_stop_all(self) -> None:
        """Zero every robot's motors + LED red: the post-reconnect (and
        degraded-entry) posture. Raises on I/O error like any driver
        write — callers handle via the usual drop-link path."""
        for i in range(self.n_robots):
            self.driver[i][MOTOR_LEFT_TARGET] = 0
            self.driver[i][MOTOR_RIGHT_TARGET] = 0
            self.driver[i][LEDS_TOP] = [32, 0, 0]       # red: degraded

    def update_loop(self) -> None:
        # Causal tracing (obs/): one `brain.tick` span per control tick
        # when armed, so motor/odometry publishes made here chain under
        # the tick that commanded them; a stage timer either way (the
        # control loop's latency histogram on /metrics).
        self._tick_no += 1
        tracer = getattr(self.bus, "tracer", None)
        with M.stages.stage("brain.tick"):
            if tracer is not None:
                with tracer.span("brain.tick", key=self._tick_no):
                    self._update_loop_body()
            else:
                self._update_loop_body()

    def _update_loop_body(self) -> None:
        cfg = self.cfg
        now = time.monotonic()
        if self._health is not None:
            self._health.note_tick(self.n_ticks)
        # Structural expiry of stale frontier-goal state runs regardless
        # of recovery: the read-site TTL gates already ignore these
        # entries, deletion just makes that un-forgettable (and bounds
        # the dicts) — behavior under the gates is unchanged.
        self._prune_stale_goal_state()
        if self._recovery is not None:
            # One clock for every recovery TTL (blacklist expiry).
            self._recovery.blacklist.note_tick(self.n_ticks)
        if not self.link_up:
            if self._health is not None:
                self._health.note_driver(DRIVER_OFFLINE)
            # Throttled reconnect probe (`server/.../main.py:84-88`).
            if now - self._last_reconnect_probe < self.reconnect_period_s:
                self._beat()
                return
            self._last_reconnect_probe = now
            self.link_up = connect_with_retries(
                self.driver, max_retries=1,
                timeout_s=self.connect_timeout_s, log=self._log)
            if not self.link_up:
                self._beat()
                return
            # Reconnected: next tick runs the safe-stop BEFORE any
            # policy output reaches the motors.
            self._safe_stop_pending = True

        if self._safe_stop_pending:
            # One recovery tick: motors zeroed, LED red — the stale
            # targets a pre-fault tick wrote must not keep driving the
            # robot, and no policy targets are computed from the stale
            # sensor snapshot either (no duplicate motor commands).
            try:
                self._safe_stop_all()
                self._safe_stop_pending = False
                if self._health is not None:
                    self._health.note_driver(DRIVER_RECOVERING)
            except Exception:                   # noqa: BLE001
                self._drop_link()
            self._beat()
            return

        try:
            R = self.n_robots
            wheel_raw = np.zeros((R, 2), np.int32)
            prox = np.zeros((R, PROX_WIDTH), np.int32)
            for i in range(R):
                wheel_raw[i, 0] = self.driver[i][MOTOR_LEFT_SPEED]
                wheel_raw[i, 1] = self.driver[i][MOTOR_RIGHT_SPEED]
                prox[i] = self.driver[i][PROX_HORIZONTAL]

            with self._state_lock:
                poses = self.poses.copy()
                exploring = np.full(R, self.is_exploring)
                goals = list(self._nav_goals)
            coast = np.zeros(R, bool)
            if self._health is not None:
                # Degraded mode: a robot whose lidar went silent COASTS —
                # no commanded motion (exploring off ⇒ the policy zeros
                # its targets), odometry keeps integrating so the pose
                # estimate survives for the rejoin. DEAD robots coast
                # too; the fleet has already reassigned their frontiers.
                lidar_ok = self._health.lidar_ok_mask()
                coast = ~lidar_ok
                exploring = exploring & lidar_ok
            ranges = self._ranges_matrix()
            goals_xy = np.zeros((R, 2), np.float32)
            goal_valid = np.zeros(R, bool)
            for i, goal in enumerate(goals):
                if goal is None:
                    continue
                if np.hypot(poses[i, 0] - goal[0],
                            poses[i, 1] - goal[1]) \
                        <= self.goal_reached_dist_m:
                    with self._state_lock:
                        # Compare-and-clear: a goal published between
                        # this tick's snapshot and now must not be
                        # silently erased by arrival at the OLD goal.
                        if self._nav_goals[i] == goal:
                            self._nav_goals[i] = None
                    self._log(f"navigation goal reached (robot {i})")
                else:
                    goals_xy[i] = self._steer_target(goal, i)
                    goal_valid[i] = True
            self._apply_frontier_goals(goals_xy, goal_valid)

            new_poses, twists, targets_np, leds_np = self._device_tick(
                poses, wheel_raw, prox, ranges, exploring, goals_xy,
                goal_valid)

            manual = self._manual_targets(now)
            if self._recovery is not None:
                # Anti-stuck recovery ladder: detect commanded-but-
                # motionless robots, escalate rotate -> backup ->
                # blacklist. Detection skips coasting / idle / manual
                # robots; maneuver overrides yield to the IR emergency
                # pivot (the shield stays the last word on contact) and
                # to manual drive (the operator IS the safety system).
                active = exploring & ~coast
                if manual is not None:
                    active[0] = False
                overrides, blacklist_req = self._recovery.antistuck.step(
                    self.n_ticks, new_poses, targets_np, active)
                # The IR emergency from the HOST-side prox snapshot (the
                # same predicate the policy's state 2 computes on
                # device) — no extra device fetch in the hot path.
                ir_stop = prox[:, :5].max(axis=1) > cfg.robot.ir_threshold
                for r, tgt in overrides.items():
                    if not ir_stop[r]:              # IR pivot outranks
                        targets_np[r] = tgt
                        leds_np[r] = (0, 32, 32)    # cyan: recovery
                for r in blacklist_req:
                    self._blacklist_current_goal(r)
            if manual is not None:
                targets_np[0] = manual
                leds_np[0] = (32, 32, 32)   # white: manual drive (extension
                #                             to the reference's LED states)
            if coast.any():
                # Orange = degraded (the reference's warn color): lidar
                # silent, coasting. Outranks policy colors; manual drive
                # white still wins (the operator IS the safety system).
                coast_led = coast.copy()
                if manual is not None:
                    coast_led[0] = False
                leds_np[coast_led] = (32, 16, 0)
                if self._health is not None:
                    # Magenta = estimator diverged (quarantined, the
                    # mapper is relocalizing it) — distinguishable from
                    # the lidar-silent orange at a glance.
                    div = self._health.diverged_mask()[:R] & coast_led
                    leds_np[div] = (32, 0, 32)

            for i in range(R):
                self.driver[i][MOTOR_LEFT_TARGET] = int(targets_np[i, 0])
                self.driver[i][MOTOR_RIGHT_TARGET] = int(targets_np[i, 1])
                self.driver[i][LEDS_TOP] = leds_np[i].tolist()

            with self._state_lock:
                self.poses = new_poses
            self.publish_tf(new_poses, twists)
            self.n_ticks += 1
            if self._health is not None:
                self._health.note_driver(DRIVER_OK)
        except Exception:                           # noqa: BLE001
            # Reference catch-all: drop and re-probe (`main.py:198-200`).
            self._drop_link()
        self._beat()

    def _device_tick(self, poses, wheel_raw, prox, ranges, exploring,
                     goals_xy, goal_valid):
        """`brain_tick` on the brain's device: the inputs packed into one
        float32 array (every value is exact in float32) and copied up
        once, the outputs packed and copied back once. Returns numpy
        (new_poses, twists, targets int32, leds int64), all writable."""
        packed = np.concatenate(
            [poses, wheel_raw, prox, goals_xy, exploring[:, None],
             goal_valid[:, None], ranges], axis=1).astype(np.float32)
        x = torch.as_tensor(packed, device=self.device)
        g0 = 5 + PROX_WIDTH
        out = brain_tick(
            self.cfg, x[:, 0:3], x[:, 3:5].to(torch.int32),
            x[:, 5:g0].to(torch.int32), x[:, g0 + 4:], x[:, g0 + 2] != 0,
            x[:, g0:g0 + 2], x[:, g0 + 3] != 0,
            float(np.float32(1.0 / self.cfg.robot.control_rate_hz)))
        new_poses, twists, targets, leds, _ = out
        host = torch.cat([new_poses, twists, targets.to(torch.float32),
                          leds.to(torch.float32)], dim=1).cpu().numpy()
        return (host[:, 0:3].copy(), host[:, 3:5].copy(),
                host[:, 5:7].astype(np.int32), host[:, 7:10].astype(np.int64))

    def publish_tf(self, poses: np.ndarray, twists: np.ndarray) -> None:
        """TF odom->base_link + `/odom`, honest stamps
        (`server/.../main.py:202-224`, Appendix B)."""
        stamp = time.monotonic()
        for i in range(self.n_robots):
            ns = robot_ns(i, self.n_robots)
            p = poses[i]
            self.tf.set_transform(TransformStamped(
                header=Header(stamp=stamp, frame_id=f"{ns}odom"),
                child_frame_id=f"{ns}base_link",
                x=float(p[0]), y=float(p[1]), theta=float(p[2])))
            self.odom_pubs[i].publish(Odometry(
                header=Header(stamp=stamp, frame_id=f"{ns}odom"),
                child_frame_id=f"{ns}base_link",
                pose=Pose2D.from_array(p),
                twist=Twist(linear_x=float(twists[i, 0]),
                            angular_z=float(twists[i, 1]))))
