"""RecoveryManager: one handle for the estimator guardrails.

Port of the JAX package's `recovery/manager.py`: the watchdog, the
relocalizer, the anti-stuck ladder and the frontier blacklist, built
together from one `RecoveryConfig` so their settings cannot drift apart.
"""

from __future__ import annotations

from typing import Optional

from jax_mapping_torch.config import RecoveryConfig, RobotConfig
from jax_mapping_torch.recovery.antistuck import (AntiStuckLadder,
                                                  FrontierBlacklist)
from jax_mapping_torch.recovery.relocalize import Relocalizer
from jax_mapping_torch.recovery.watchdog import EstimatorWatchdog


class RecoveryManager:
    """Watchdog + relocalizer + anti-stuck ladder + blacklist."""

    def __init__(self, cfg: RecoveryConfig, n_robots: int,
                 robot: Optional[RobotConfig] = None):
        self.cfg = cfg
        self.n_robots = n_robots
        self.watchdog = EstimatorWatchdog(cfg, n_robots)
        self.relocalizer = Relocalizer(cfg, n_robots)
        self.blacklist = FrontierBlacklist(cfg)
        self.antistuck = AntiStuckLadder(
            cfg, n_robots,
            rotation_units=(robot.rotation_speed_units
                            if robot is not None else 50),
            cruise_units=(robot.cruise_speed_units
                          if robot is not None else 100),
            m_per_unit_tick=(robot.speed_coeff_m_per_unit_s
                             / robot.control_rate_hz
                             if robot is not None else 3.027e-5))

    def snapshot(self) -> dict:
        """The guardrails' status object."""
        return {
            "watchdog": self.watchdog.snapshot(),
            "relocalization": self.relocalizer.snapshot(),
            "antistuck": self.antistuck.snapshot(),
            "blacklist": self.blacklist.snapshot(),
        }
