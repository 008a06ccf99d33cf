"""The frontier-following wheel policy: a frozen copy of the port's
`models/explorer.py`."""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ._util import const, div
from .config import RobotConfig, ScanConfig
from .odometry import wrap_angle

#: LED colours of the states idle, cruise, IR stop, LiDAR warn.
_LEDS = ((0, 32, 0), (0, 0, 32), (32, 0, 0), (32, 16, 0))


class PolicyOut(NamedTuple):
    targets: torch.Tensor  # (R, 2) int32 wheel targets, thymio units
    led: torch.Tensor      # (R, 3) LED colour
    state: torch.Tensor    # (R,) int32: 0 idle, 1 cruise, 2 ir, 3 warn


def _front_cones(scan_cfg: ScanConfig, ranges: torch.Tensor):
    """Min range over the left-front (beams 0:30) and right-front (the
    last 30 live beams) cones; zero ranges read as 10 m."""
    r = torch.where(ranges <= 0.0, 10.0, ranges)
    n = scan_cfg.n_beams
    return r[..., 0:30].amin(dim=-1), r[..., n - 30:n].amin(dim=-1)


def _pair(a: float, b: float, R: int, dev) -> torch.Tensor:
    """(R, 2) rows of [a, b]: a cached constant, expanded (no host copy)."""
    return const((a, b), dev).expand(R, 2)


def subsumption_policy(robot: RobotConfig, scan_cfg: ScanConfig,
                       ranges: torch.Tensor, prox: torch.Tensor,
                       exploring: torch.Tensor) -> PolicyOut:
    """The reference's reactive navigator: IR pivot, LiDAR swerve, cruise."""
    R = ranges.shape[0]
    dev = ranges.device
    cruise = float(robot.cruise_speed_units)
    rot = float(robot.rotation_speed_units)
    inner = float(robot.swerve_inner_units)

    ir_stop = prox[:, 0:5].amax(dim=-1) > robot.ir_threshold
    weight_left = prox[:, 0] * 2 + prox[:, 1]
    weight_right = prox[:, 4] * 2 + prox[:, 3]
    pivot = torch.where((weight_left > weight_right)[:, None],
                        _pair(rot, -rot, R, dev), _pair(-rot, rot, R, dev))
    left_cone, right_cone = _front_cones(scan_cfg, ranges)
    lidar_warn = torch.minimum(left_cone, right_cone) < robot.lidar_warn_dist_m
    swerve = torch.where((left_cone < right_cone)[:, None],
                         _pair(cruise, inner, R, dev),
                         _pair(inner, cruise, R, dev))
    go = _pair(cruise, cruise, R, dev)
    targets = torch.where(ir_stop[:, None], pivot,
                          torch.where(lidar_warn[:, None], swerve, go))
    targets = torch.where(exploring[:, None], targets, 0.0)
    state = torch.where(~exploring, 0,
                        torch.where(ir_stop, 2,
                                    torch.where(lidar_warn, 3, 1)))
    led = const(_LEDS, dev, torch.int64)[state]
    return PolicyOut(targets=targets.to(torch.int32), led=led,
                     state=state.to(torch.int32))


def frontier_policy(robot: RobotConfig, scan_cfg: ScanConfig,
                    poses: torch.Tensor, goals_xy: torch.Tensor,
                    goal_valid: torch.Tensor, ranges: torch.Tensor,
                    prox: torch.Tensor, exploring: torch.Tensor) -> PolicyOut:
    """Proportional steering toward the assigned goal while cruising; the
    reactive layers take over when IR or LiDAR demand it."""
    reactive = subsumption_policy(robot, scan_cfg, ranges, prox, exploring)
    bearing = torch.atan2(goals_xy[:, 1] - poses[:, 1],
                          goals_xy[:, 0] - poses[:, 0])
    err = wrap_angle(bearing - poses[:, 2])
    cruise = float(robot.cruise_speed_units)
    steer = torch.clamp(err * 2.0, -1.5, 1.5)
    base = cruise * torch.clamp(1.0 - div(torch.abs(err), math.pi) * 1.5,
                                0.2, 1.0)
    left = base - steer * cruise * 0.5
    right = base + steer * cruise * 0.5
    seek = torch.stack([left, right], dim=-1)
    use_seek = goal_valid & (reactive.state == 1)
    targets = torch.where(use_seek[:, None], seek,
                          reactive.targets.to(torch.float32))
    targets = torch.where(exploring[:, None], targets, 0.0)
    lim = float(robot.motor_limit_units)
    targets = torch.clamp(targets, -lim, lim)
    return PolicyOut(targets=targets.to(torch.int32), led=reactive.led,
                     state=reactive.state)
