"""Teleoperation: joystick axes -> `/cmd_vel`, and manual-drive override.

The reference ships (install tree only) a `teleop_twist_joy` configuration
for a PS4 pad — axes 2/3 scaled to 0.20 m/s and 1.5 rad/s, deadman button
0, and `autorepeat_rate: 20.0` "to defeat command lag"
(`server/install/thymio_project/share/thymio_project/
config/joystick.yaml`, SURVEY.md §2.1). That node is external C++; this is
the framework-native equivalent: a `TeleopNode` with the same semantics
(deadman gating, scaling, fixed-rate autorepeat) fed by any axis source —
a real joystick event loop, the HTTP API, or tests.

The brain consumes `/cmd_vel` as a manual override while exploration is
stopped (the reference's RViz tool list already anticipates external
command sources, `server/rviz_config.rviz:186-198`).
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Optional, Sequence

from jax_mapping_torch.bridge.bus import Bus
from jax_mapping_torch.bridge.messages import Twist
from jax_mapping_torch.bridge.node import Node


@dataclasses.dataclass(frozen=True)
class JoystickConfig:
    """Field-for-field capability of the reference's joystick.yaml."""

    axis_linear: int = 3              # joystick.yaml axis_linear.x
    axis_angular: int = 2             # joystick.yaml axis_angular.yaw
    scale_linear: float = 0.20        # m/s full deflection
    scale_angular: float = 1.5        # rad/s full deflection
    deadman_button: int = 0           # enable_button: no motion unless held
    autorepeat_rate_hz: float = 20.0  # republish to defeat command lag


class TeleopNode(Node):
    """Joystick state -> rate-limited `/cmd_vel` Twists.

    `update(axes, buttons)` ingests the latest joystick sample (thread-safe,
    callable from any input loop); a timer republishes at
    `autorepeat_rate_hz` while the deadman is held and publishes a single
    zero Twist on release (the robot stops instead of coasting on the last
    command).
    """

    def __init__(self, bus: Bus, cfg: Optional[JoystickConfig] = None,
                 topic: str = "/cmd_vel", input_timeout_s: float = 0.5):
        super().__init__("teleop", bus)
        self.cfg = cfg or JoystickConfig()
        # Input liveness watchdog: autorepeat must not outlive its source.
        # If update() stops arriving (pad unplugged, event loop dead) the
        # node treats the deadman as released and stops the robot — without
        # this, endless republication keeps the brain's cmd_vel staleness
        # guard permanently fed with a stale command.
        self.input_timeout_s = input_timeout_s
        self._pub = self.create_publisher(topic)
        self._lock = threading.Lock()
        self._axes: Sequence[float] = ()
        self._buttons: Sequence[int] = ()
        self._last_update_t = -1e9
        self._was_active = False
        self.create_timer(1.0 / self.cfg.autorepeat_rate_hz, self._tick)

    def update(self, axes: Sequence[float], buttons: Sequence[int]) -> None:
        with self._lock:
            self._axes = tuple(axes)
            self._buttons = tuple(buttons)
            self._last_update_t = time.monotonic()

    def _tick(self) -> None:
        cfg = self.cfg
        now = time.monotonic()
        with self._lock:
            axes, buttons = self._axes, self._buttons
            live = now - self._last_update_t <= self.input_timeout_s
        deadman = (live and len(buttons) > cfg.deadman_button
                   and bool(buttons[cfg.deadman_button]))
        if deadman and len(axes) > max(cfg.axis_linear, cfg.axis_angular):
            self._pub.publish(Twist(
                linear_x=float(axes[cfg.axis_linear]) * cfg.scale_linear,
                angular_z=float(axes[cfg.axis_angular]) * cfg.scale_angular))
            self._was_active = True
        elif self._was_active:
            # Deadman released: one explicit stop.
            self._pub.publish(Twist(linear_x=0.0, angular_z=0.0))
            self._was_active = False
