"""Anti-stuck recovery ladder: detect wedged or oscillating explorers and
escalate.

A copy of the JAX package's `recovery/antistuck.py` (host Python and
numpy). Over a sliding window of control ticks a robot was commanded
motion for most ticks, yet its odometric displacement reached only a
small share of the distance those commands should have produced: it is
stuck. (Wheels spinning in place feed phantom motion into odometry; that
fault shows as estimator divergence, the watchdog's case.)

On detection the ladder escalates through open-loop recoveries that
replace the policy's wheel targets:

    rung 0  rotate in place (a fresh view for the matcher and the auction)
    rung 1  back up
    rung 2  blacklist the current frontier goal for `blacklist_ttl_ticks`
            and force a reassignment

A re-detection within `escalation_memory_ticks` of a finished rung climbs
one rung; a clean stretch resets to rung 0. Every clock counts control
ticks. Threading: leaf locks.
"""

from __future__ import annotations

import math
import threading
from typing import Dict, List, Tuple

import numpy as np

from jax_mapping_torch.config import RecoveryConfig

#: Ladder states (per robot).
MONITOR = "monitor"
ROTATE = "rotate"
BACKUP = "backup"

#: Rung order; rung index 2 is the blacklist escalation (no maneuver —
#: it fires once and drops back to MONITOR).
RUNGS = ("rotate", "backup", "blacklist")


class FrontierBlacklist:
    """(robot, target) entries with TTL, on the brain's control-tick
    clock. The mapper's frontier post-pass strips assignments that land
    within `tol_m` of a live entry for that robot and hands them to a
    healthy robot (mapper._reassign_dead's machinery)."""

    def __init__(self, cfg: RecoveryConfig):
        self.cfg = cfg
        self._lock = threading.Lock()
        #: (robot, x, y, expire_tick)
        self._entries: List[tuple] = []
        self._now = 0
        self.n_blacklisted = 0

    def note_tick(self, tick: int) -> None:
        with self._lock:
            self._now = max(self._now, tick)
            self._entries = [e for e in self._entries
                             if e[3] > self._now]

    def add(self, robot: int, xy: Tuple[float, float],
            dedup_tol_m: float = 0.05) -> None:
        with self._lock:
            exp = self._now + self.cfg.blacklist_ttl_ticks
            for k, (r, x, y, _e) in enumerate(self._entries):
                if r == robot and math.hypot(xy[0] - x,
                                             xy[1] - y) <= dedup_tol_m:
                    # Same goal re-blacklisted (e.g. the auction has no
                    # alternative frontier to redirect to): refresh the
                    # TTL instead of stacking duplicates.
                    self._entries[k] = (r, x, y, exp)
                    return
            self._entries.append((robot, float(xy[0]), float(xy[1]), exp))
            self.n_blacklisted += 1

    def is_blacklisted(self, robot: int, xy, tol_m: float) -> bool:
        with self._lock:
            for r, x, y, exp in self._entries:
                if r == robot and exp > self._now \
                        and math.hypot(xy[0] - x, xy[1] - y) <= tol_m:
                    return True
            return False

    def entries(self) -> List[tuple]:
        with self._lock:
            return list(self._entries)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "n_blacklisted": self.n_blacklisted,
                "live_entries": [
                    {"robot": r, "x": round(x, 3), "y": round(y, 3),
                     "expires_tick": exp}
                    for r, x, y, exp in self._entries
                    if exp > self._now],
            }


class AntiStuckLadder:
    """Sliding-window stuck detector + escalating recovery executor."""

    def __init__(self, cfg: RecoveryConfig, n_robots: int,
                 rotation_units: int = 50, cruise_units: int = 100,
                 m_per_unit_tick: float = 3.027e-5):
        self.cfg = cfg
        self.n_robots = n_robots
        #: Maneuver magnitudes, from RobotConfig at wiring time (launch)
        #: so recoveries move at the platform's own speeds.
        self._rotation_units = int(rotation_units)
        self._cruise_units = int(cruise_units)
        #: Metres one wheel unit commands in one control tick
        #: (speed_coeff_m_per_unit_s / control_rate_hz) — converts the
        #: window's commanded wheel speeds into the displacement they
        #: SHOULD have produced. Default: the Thymio at 10 Hz.
        self._m_per_unit_tick = float(m_per_unit_tick)
        # Re-entrant: step() holds it across the per-robot loop and the
        # rung helpers re-acquire for their own writes (the bridge
        # Node._cb_lock pattern), so the lock discipline is explicit at
        # every mutation site.
        self._lock = threading.RLock()
        #: Per-robot window of (pose_xy, commanded) samples, newest last.
        self._window: List[List[tuple]] = [[] for _ in range(n_robots)]
        self._mode = [MONITOR] * n_robots
        self._mode_ticks_left = [0] * n_robots
        #: Next rung to run on re-detection (escalation level).
        self._rung = [0] * n_robots
        #: Tick the last recovery finished (escalation-memory clock).
        self._last_recovery_end = [-10**9] * n_robots
        #: (tick, robot, event) log — the ladder's assertion surface.
        self.events: List[tuple] = []
        self.n_stuck_detections = 0
        self.n_recoveries: Dict[str, int] = {r: 0 for r in RUNGS}

    # -- the per-tick hook (brain.update_loop) ------------------------------

    def step(self, tick: int, poses: np.ndarray, targets: np.ndarray,
             active: np.ndarray) -> Tuple[Dict[int, tuple], List[int]]:
        """One control tick for the whole fleet.

        poses (R, 3) odometry estimates; targets (R, 2) the wheel
        targets the policy just computed; active (R,) bool — robots
        eligible for detection/recovery (exploring, not coasting, not
        under manual drive, not in an IR emergency).

        Returns (overrides, blacklist_requests): overrides maps robot ->
        (left, right) wheel targets replacing the policy output this
        tick; blacklist_requests lists robots whose current goal the
        caller must blacklist/cancel (the brain owns goals and the
        freshest /frontiers assignment, so the rung only REQUESTS)."""
        c = self.cfg
        overrides: Dict[int, tuple] = {}
        blacklist: List[int] = []
        with self._lock:
            for i in range(min(self.n_robots, len(poses))):
                if not active[i]:
                    # Ineligible: recovery aborts (coast/manual outrank
                    # it) and the window restarts — coasting ticks must
                    # not read as "commanded but motionless".
                    if self._mode[i] != MONITOR:
                        self._end_recovery(i, tick, aborted=True)
                    self._window[i].clear()
                    continue
                if self._mode[i] != MONITOR:
                    overrides[i] = self._recovery_targets(i)
                    self._mode_ticks_left[i] -= 1
                    if self._mode_ticks_left[i] <= 0:
                        self._end_recovery(i, tick)
                    continue
                cmd = (abs(float(targets[i, 0]))
                       + abs(float(targets[i, 1]))) / 2.0
                self._window[i].append(
                    ((float(poses[i, 0]), float(poses[i, 1])), cmd))
                if len(self._window[i]) > c.stuck_window_ticks:
                    self._window[i].pop(0)
                if self._detect(i):
                    self.n_stuck_detections += 1
                    rung = self._rung[i]
                    if tick - self._last_recovery_end[i] \
                            > c.escalation_memory_ticks:
                        rung = 0        # clean stretch: restart ladder
                    self._start_rung(i, rung, tick)
                    if RUNGS[rung] == "blacklist":
                        blacklist.append(i)
                        self._end_recovery(i, tick)
                    else:
                        # The detection tick is the maneuver's first
                        # tick (override applied AND counted).
                        overrides[i] = self._recovery_targets(i)
                        self._mode_ticks_left[i] -= 1
        return overrides, blacklist

    # -- internals (caller holds the lock) ----------------------------------

    def _detect(self, i: int) -> bool:
        c = self.cfg
        w = self._window[i]
        if len(w) < c.stuck_window_ticks:
            return False
        n_commanded = sum(1 for _, cm in w if cm >= c.min_commanded_units)
        if n_commanded < c.stuck_commanded_frac * len(w):
            return False
        # Distance the window's commands SHOULD have produced vs what
        # odometry actually saw.
        commanded_m = sum(cm for _, cm in w) * self._m_per_unit_tick
        (x0, y0), _ = w[0]
        (x1, y1), _ = w[-1]
        return math.hypot(x1 - x0, y1 - y0) \
            < c.stuck_displacement_frac * commanded_m

    def _start_rung(self, i: int, rung: int, tick: int) -> None:
        with self._lock:
            name = RUNGS[rung]
            self.n_recoveries[name] += 1
            self.events.append((tick, i, f"stuck:rung={name}"))
            self._rung[i] = min(rung + 1, len(RUNGS) - 1)
            self._window[i].clear()
            if name == "rotate":
                self._mode[i] = ROTATE
                self._mode_ticks_left[i] = self.cfg.rotate_recovery_ticks
            elif name == "backup":
                self._mode[i] = BACKUP
                self._mode_ticks_left[i] = self.cfg.backup_recovery_ticks

    def _end_recovery(self, i: int, tick: int, aborted: bool = False
                      ) -> None:
        with self._lock:
            if self._mode[i] != MONITOR or not aborted:
                self.events.append(
                    (tick, i, "recovery_aborted" if aborted
                     else "recovery_done"))
            self._mode[i] = MONITOR
            self._mode_ticks_left[i] = 0
            self._last_recovery_end[i] = tick
            self._window[i].clear()

    def _recovery_targets(self, i: int) -> tuple:
        # Open-loop maneuvers in thymio wheel units; the brain clamps to
        # the motor range with everything else.
        if self._mode[i] == ROTATE:
            return (self._rotation_units, -self._rotation_units)
        return (-self._cruise_units, -self._cruise_units)   # backup

    # -- readers -------------------------------------------------------------

    def modes(self) -> List[str]:
        with self._lock:
            return list(self._mode)

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "modes": list(self._mode),
                "rungs": list(self._rung),
                "n_stuck_detections": self.n_stuck_detections,
                "n_recoveries": dict(self.n_recoveries),
                "n_events": len(self.events),
            }
