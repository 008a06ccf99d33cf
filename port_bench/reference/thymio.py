"""The simulated Thymio fleet's motor lag, wheel noise and kinematics: a
frozen copy of the port's `sim/thymio.py`."""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch

from ._util import entry_point, linspace_f32
from .config import RobotConfig
from .odometry import rk2_step


class FleetSimState(NamedTuple):
    poses: torch.Tensor          # (R, 3) ground-truth poses
    wheel_speeds: torch.Tensor   # (R, 2) actual [left, right], thymio units


def init_fleet(robot: RobotConfig, n_robots: int, device,
               spawn_radius_m: float = 0.5,
               radius_uniforms: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None) -> FleetSimState:
    """Spawn robots on a ring near the origin, facing outward. Ring radii
    are spawn_radius_m * (0.5 + 0.5 * u) with u ~ U[0, 1) per robot."""
    if radius_uniforms is None:
        radius_uniforms = torch.rand(n_robots, generator=generator)
    u = torch.as_tensor(radius_uniforms, dtype=torch.float32, device=device)
    ang = torch.as_tensor(linspace_f32(0.0, 2 * math.pi, n_robots,
                                       endpoint=False), device=device)
    r = spawn_radius_m * (0.5 + 0.5 * u)
    poses = torch.stack([r * torch.cos(ang), r * torch.sin(ang), ang], dim=-1)
    return FleetSimState(poses=poses,
                         wheel_speeds=torch.zeros((n_robots, 2),
                                                  device=device))


@entry_point(static=("robot",))
def step_fleet(robot: RobotConfig, state: FleetSimState,
               targets: torch.Tensor, dt: float,
               speed_noise_frac: float = 0.05,
               wheel_normals: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None):
    """Advance every robot dt seconds toward its (R, 2) wheel targets.

    Returns (new_state, measured): measured speeds are the actual wheel
    speeds times (1 + speed_noise_frac * n), n the (R, 2) standard normals
    `wheel_normals` (drawn from `generator` on the CPU when None). The
    tenant megabatch steps T * R robots at once with (T, R, 2) normals."""
    alpha = 1.0 - math.exp(-dt / robot.motor_lag_tau_s)
    w = state.wheel_speeds
    actual = w + alpha * (targets - w)
    poses = rk2_step(robot, state.poses, actual[:, 0], actual[:, 1], dt)
    if wheel_normals is None:
        wheel_normals = torch.randn(actual.shape, generator=generator)
    n = torch.as_tensor(wheel_normals, dtype=torch.float32,
                        device=actual.device).reshape(actual.shape)
    measured = actual * (1.0 + speed_noise_frac * n)
    return FleetSimState(poses=poses, wheel_speeds=actual), measured


