"""Goal-seeded path planning on the occupancy grid.

Port of the JAX package's `ops/planner.py`. The distance field is the
frontier machinery's obstacle-aware min-plus field (`frontier.cost_to_go`,
kernel K3 on a CUDA tensor) seeded at the goal over the first-level coarse
grid, with the frontier costs' passability (free | frontier | unknown).
The path is a greedy descent of that field from the robot's cell, a fixed
`max_path_len` steps of `frontier.descent_step` that stay on the device
(no host sync inside the loop), with a valid prefix up to the first
arrival at the goal and a lookahead waypoint to steer at.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from jax_mapping_torch._util import div, entry_point
from jax_mapping_torch.config import (FrontierConfig, GridConfig,
                                      PlannerConfig, VoxelConfig)
from jax_mapping_torch.ops import frontier as F
from jax_mapping_torch.ops import voxel as VX


class PlanResult(NamedTuple):
    path_xy: torch.Tensor      # (max_path_len, 2) world coords, goal-padded
    path_valid: torch.Tensor   # (max_path_len,) bool prefix of real cells
    n_steps: torch.Tensor      # () int32 valid prefix length
    reachable: torch.Tensor    # () bool: the field reached the robot
    waypoint_xy: torch.Tensor  # (2,) lookahead steering target
    arrived: torch.Tensor      # () bool: the robot's cell is the goal's


def _world_to_cell(grid_cfg: GridConfig, res: float, xy: torch.Tensor,
                   n: int) -> torch.Tensor:
    """World (x, y) -> coarse (row, col), clipped into the grid."""
    ox, oy = grid_cfg.origin_m
    rc = torch.stack([div(xy[1] - oy, res), div(xy[0] - ox, res)])
    return F._to_int32(rc).clamp(0, n - 1)


def _cell_to_world(grid_cfg: GridConfig, res: float,
                   rc: torch.Tensor) -> torch.Tensor:
    """Coarse (row, col) cell centre -> world (x, y)."""
    ox, oy = grid_cfg.origin_m
    return torch.stack([(rc[..., 1].to(torch.float32) + 0.5) * res + ox,
                        (rc[..., 0].to(torch.float32) + 0.5) * res + oy],
                       dim=-1)


@entry_point(static=("fcfg", "grid_cfg", "pcfg"))
def goal_field(pcfg: PlannerConfig, fcfg: FrontierConfig,
               grid_cfg: GridConfig, logodds: torch.Tensor,
               goal_xy: torch.Tensor) -> torch.Tensor:
    """The goal-seeded cost-to-go field (coarse cells to reach the goal):
    2 * pcfg.bfs_iters + 1 sweeps. Apart from the descent, so robots that
    share a goal share its field."""
    free, _occ, unknown = F.coarsen(fcfg, grid_cfg, logodds)
    mask = F.frontier_mask(free, unknown)
    passable = free | mask | unknown
    n = passable.shape[0]
    res = grid_cfg.resolution_m * fcfg.downsample
    goal_rc = _world_to_cell(grid_cfg, res, goal_xy, n)
    # cost_to_go unblocks its seed: a goal in a conservatively occupied
    # coarse cell still radiates.
    bfs_cfg = dataclasses.replace(fcfg, bfs_iters=pcfg.bfs_iters)
    return F.cost_to_go(bfs_cfg, passable, goal_rc[None, :],
                        torch.ones(1, dtype=torch.bool,
                                   device=passable.device))


@entry_point(static=("fcfg", "grid_cfg", "pcfg"))
def descend_field(pcfg: PlannerConfig, fcfg: FrontierConfig,
                  grid_cfg: GridConfig, dist: torch.Tensor,
                  goal_xy: torch.Tensor, start_xy: torch.Tensor
                  ) -> PlanResult:
    """Greedy descent of a `goal_field` from `start_xy`."""
    n = dist.shape[0]
    res = grid_cfg.resolution_m * fcfg.downsample
    goal_rc = _world_to_cell(grid_cfg, res, goal_xy, n)
    start_rc = _world_to_cell(grid_cfg, res, start_xy, n)
    padded = torch.nn.functional.pad(dist, (1, 1, 1, 1), value=F._BIG)

    # The robot may sit in a conservatively blocked coarse cell: judge
    # reachability from the best cell of its 3 x 3 neighbourhood.
    reachable = F._patch3(padded, start_rc).amin() < F._BIG
    arrived = (start_rc == goal_rc).all()

    rc, cells = start_rc, []
    for _ in range(pcfg.max_path_len):
        rc = F.descent_step(padded, rc, n)
        cells.append(rc)
    cells = torch.stack(cells)                            # (L, 2)
    at_goal = (cells == goal_rc[None, :]).all(dim=1)
    # The valid prefix runs up to and including the first arrival; a goal
    # beyond the horizon keeps the whole (partial) path.
    reached_by = torch.cumsum(at_goal.to(torch.int32), 0) > 0
    prev_reached = torch.cat([torch.zeros_like(reached_by[:1]),
                              reached_by[:-1]])
    valid = ~prev_reached & reachable & ~arrived
    n_steps = valid.sum().to(torch.int32)

    goal_f = goal_xy.to(torch.float32)
    path_xy = torch.where(valid[:, None], _cell_to_world(grid_cfg, res, cells),
                          goal_f[None, :])
    # The path cell lookahead_cells along, or the last valid one.
    wp_idx = (torch.clamp_max(n_steps, pcfg.lookahead_cells) - 1).clamp(
        0, pcfg.max_path_len - 1)
    waypoint = torch.where(reachable & (n_steps > 0),
                           path_xy.index_select(0, wp_idx.reshape(1))[0],
                           goal_f)
    return PlanResult(path_xy=path_xy, path_valid=valid, n_steps=n_steps,
                      reachable=reachable, waypoint_xy=waypoint,
                      arrived=arrived)


@entry_point(static=("grid_cfg", "pcfg", "vox_cfg"))
def overlay_voxel_obstacles(pcfg: PlannerConfig, grid_cfg: GridConfig,
                            vox_cfg: VoxelConfig, logodds: torch.Tensor,
                            voxel_grid: torch.Tensor) -> torch.Tensor:
    """The 2D log-odds grid with the voxel map's obstacle slice (any
    occupied voxel in [voxel_z_min_m, voxel_z_max_m]) stamped in as
    occupied: max(current, occ_threshold + 1) at the static cell offset
    the two origins imply. Equal cell sizes only."""
    if abs(vox_cfg.resolution_m - grid_cfg.resolution_m) > 1e-9:
        raise ValueError(
            f"voxel resolution {vox_cfg.resolution_m} != grid "
            f"{grid_cfg.resolution_m}; 3D-aware planning requires equal "
            "cell sizes")
    obs = VX.obstacle_slice(vox_cfg, voxel_grid, pcfg.voxel_z_min_m,
                            pcfg.voxel_z_max_m)          # (Y, X) bool
    vox_o = vox_cfg.origin_m
    res = grid_cfg.resolution_m
    r0 = int(round((vox_o[1] - grid_cfg.origin_m[1]) / res))
    c0 = int(round((vox_o[0] - grid_cfg.origin_m[0]) / res))
    n = grid_cfg.size_cells
    ny, nx = obs.shape
    gr0, gc0 = max(0, r0), max(0, c0)
    gr1, gc1 = min(n, r0 + ny), min(n, c0 + nx)
    if gr1 <= gr0 or gc1 <= gc0:
        return logodds                       # disjoint extents
    sub = obs[gr0 - r0:gr1 - r0, gc0 - c0:gc1 - c0]
    region = logodds[gr0:gr1, gc0:gc1]
    occ_lo = region.new_full((), grid_cfg.occ_threshold + 1.0)
    out = logodds.clone()
    out[gr0:gr1, gc0:gc1] = torch.where(sub, torch.maximum(region, occ_lo),
                                        region)
    return out


@entry_point(static=("fcfg", "grid_cfg", "pcfg"))
def plan_to_goal(pcfg: PlannerConfig, fcfg: FrontierConfig,
                 grid_cfg: GridConfig, logodds: torch.Tensor,
                 goal_xy: torch.Tensor, start_xy: torch.Tensor
                 ) -> PlanResult:
    """A coarse-grid path from `start_xy` to `goal_xy` on the map:
    `goal_field`, then `descend_field`. An unreachable goal (sealed off,
    or beyond bfs_iters) comes back reachable=False with an empty path."""
    dist = goal_field(pcfg, fcfg, grid_cfg, logodds, goal_xy)
    return descend_field(pcfg, fcfg, grid_cfg, dist, goal_xy, start_xy)
