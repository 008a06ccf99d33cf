"""Differential-drive odometry (RK2 midpoint) and SE(2) helpers.

Port of the JAX package's `ops/odometry.py`. The step and SE(2) functions
work on any leading batch shape: a pose is the last axis of length 3,
[x, y, yaw]. `integrate` and `integrate_fleet` run a whole wheel log, where
the JAX package scans `rk2_step` with `lax.scan`.
"""

from __future__ import annotations

import torch

from jax_mapping_torch._util import div, entry_point
from jax_mapping_torch.config import RobotConfig


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


@entry_point(static=("robot",))
def integrate(robot: RobotConfig, pose0: torch.Tensor,
              left_units: torch.Tensor, right_units: torch.Tensor,
              dts: torch.Tensor) -> torch.Tensor:
    """Integrate a wheel-speed log of T steps -> (T, 3) poses after each
    step: T `rk2_step`s on the log's device, with no host read between
    them."""
    pose, traj = pose0, []
    for t in range(left_units.shape[0]):
        pose = rk2_step(robot, pose, left_units[t], right_units[t], dts[t])
        traj.append(pose)
    return torch.stack(traj) if traj else pose0.new_zeros((0, 3))


@entry_point(static=("robot",))
def integrate_fleet(robot: RobotConfig, poses0: torch.Tensor,
                    left_units: torch.Tensor, right_units: torch.Tensor,
                    dts: torch.Tensor) -> torch.Tensor:
    """`integrate` for R robots at once: (R, 3), (R, T), (R, T), (R, T) ->
    (R, T, 3); each step moves every robot together."""
    pose, traj = poses0, []
    for t in range(left_units.shape[1]):
        pose = rk2_step(robot, pose, left_units[:, t], right_units[:, t],
                        dts[:, t])
        traj.append(pose)
    if not traj:
        return poses0.new_zeros((poses0.shape[0], 0, 3))
    return torch.stack(traj, dim=1)


def twist_to_wheel_units(robot: RobotConfig, v_lin_mps, v_ang_radps):
    """Inverse kinematics: (v_lin m/s, v_ang rad/s) -> (left, right) raw
    wheel speed units."""
    vr = v_lin_mps + v_ang_radps * robot.wheel_base_m / 2.0
    vl = v_lin_mps - v_ang_radps * robot.wheel_base_m / 2.0
    k = robot.speed_coeff_m_per_unit_s
    return vl / k, vr / k


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
