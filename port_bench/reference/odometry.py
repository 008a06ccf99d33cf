"""Differential-drive odometry and SE(2) helpers: a frozen copy of the
port's `ops/odometry.py`."""

from __future__ import annotations

import torch

from ._util import div
from .config import RobotConfig


def wheel_velocities(robot: RobotConfig, left_units: torch.Tensor,
                     right_units: torch.Tensor):
    """Raw speed units -> (v_lin m/s, v_ang rad/s)."""
    vl = left_units * robot.speed_coeff_m_per_unit_s
    vr = right_units * robot.speed_coeff_m_per_unit_s
    v_lin = (vr + vl) / 2.0
    v_ang = div(vr - vl, robot.wheel_base_m)
    return v_lin, v_ang


def rk2_step(robot: RobotConfig, pose: torch.Tensor, left_units: torch.Tensor,
             right_units: torch.Tensor, dt: float) -> torch.Tensor:
    """One RK2-midpoint odometry update of (..., 3) poses."""
    v_lin, v_ang = wheel_velocities(robot, left_units, right_units)
    delta_th = v_ang * dt
    mid = pose[..., 2] + delta_th / 2.0
    return torch.stack([
        pose[..., 0] + v_lin * torch.cos(mid) * dt,
        pose[..., 1] + v_lin * torch.sin(mid) * dt,
        pose[..., 2] + delta_th,
    ], dim=-1)


def wrap_angle(theta: torch.Tensor) -> torch.Tensor:
    """Wrap to (-pi, pi]."""
    return torch.atan2(torch.sin(theta), torch.cos(theta))


def pose_compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """SE(2) composition a ⊕ b (b expressed in a's frame)."""
    ca, sa = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    return torch.stack([
        a[..., 0] + ca * b[..., 0] - sa * b[..., 1],
        a[..., 1] + sa * b[..., 0] + ca * b[..., 1],
        a[..., 2] + b[..., 2],
    ], dim=-1)


def pose_between(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """SE(2) relative pose a ⊖ b: the transform taking a to b, in a's frame."""
    ca, sa = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    dx = b[..., 0] - a[..., 0]
    dy = b[..., 1] - a[..., 1]
    return torch.stack([
        ca * dx + sa * dy,
        -sa * dx + ca * dy,
        wrap_angle(b[..., 2] - a[..., 2]),
    ], dim=-1)
