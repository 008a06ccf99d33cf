"""Synthetic LD06 LiDAR and Thymio IR sensors against a world bitmap.

Port of the JAX package's `sim/lidar.py`: every beam samples the world at
fixed radial steps (one gather) and the first hit falls out of an argmax
over the hit profile. Batched over robots; a (T, H, W) stack of worlds
with a per-robot `tenant` index serves the tenant megabatch, every robot
sampling its own mission's world. The sensor faults
(`apply_lidar_miscal`, `apply_ghost_returns`) are host numpy, as in the
JAX package, so the same `rng` gives the same beams.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from jax_mapping_torch._util import div, entry_point, linspace_f32
from jax_mapping_torch.config import ScanConfig


def _first_hit(world: torch.Tensor, world_res_m: float, xs: torch.Tensor,
               ys: torch.Tensor, tenant=None):
    """(any_hit, first index) along the last axis of sample points (R, ...)
    in an (H, W) world, or in world tenant[r] of a (T, H, W) stack."""
    H, W = world.shape[-2:]
    col = torch.round(div(xs, world_res_m) + W / 2 - 0.5).to(torch.int64)
    row = torch.round(div(ys, world_res_m) + H / 2 - 0.5).to(torch.int64)
    inb = (row >= 0) & (row < H) & (col >= 0) & (col < W)
    idx = (row.clamp(0, H - 1), col.clamp(0, W - 1))
    if tenant is not None:
        idx = (tenant.reshape((-1,) + (1,) * (row.dim() - 1)),) + idx
    hit = world[idx] & inb
    # argmax returns the first maximal index on every device.
    return hit.any(dim=-1), torch.argmax(hit.to(torch.uint8), dim=-1)


def _ranges(scan_cfg: ScanConfig, world: torch.Tensor, world_res_m: float,
            n_samples: int, poses: torch.Tensor, tenant=None):
    """(R, 3) poses -> ((R, padded_beams) first-hit ranges before the
    padding mask, any-hit mask, live-beam mask)."""
    dev = poses.device
    B = scan_cfg.padded_beams
    idx = torch.arange(B, dtype=torch.float32, device=dev)
    steps = idx * scan_cfg.angle_increment_rad
    if scan_cfg.counterclockwise:
        ang = poses[:, 2:3] + scan_cfg.angle_min_rad + steps
    else:
        ang = poses[:, 2:3] - (scan_cfg.angle_min_rad + steps)
    rs = torch.as_tensor(linspace_f32(scan_cfg.range_min_m,
                                      scan_cfg.range_max_m, n_samples),
                         device=dev)
    xs = poses[:, 0, None, None] + torch.cos(ang)[:, :, None] * rs
    ys = poses[:, 1, None, None] + torch.sin(ang)[:, :, None] * rs
    any_hit, first = _first_hit(world, world_res_m, xs, ys, tenant)
    return torch.where(any_hit, rs[first], 0.0), any_hit, idx < scan_cfg.n_beams


@entry_point(static=("n_samples", "scan_cfg", "world_res_m"))
def simulate_scans(scan_cfg: ScanConfig, world: torch.Tensor,
                   world_res_m: float, n_samples: int,
                   poses: torch.Tensor, tenant=None) -> torch.Tensor:
    """(R, 3) poses -> (R, padded_beams) ranges in metres; a beam with no
    return inside range_max (or past the world's edge) reports 0.0.
    With `tenant` (R,), `world` is a (T, H, W) stack and robot r scans
    world tenant[r]."""
    r, _, live = _ranges(scan_cfg, world, world_res_m, n_samples, poses,
                         tenant)
    return torch.where(live, r, 0.0).to(torch.float32)


@entry_point(static=("n_samples", "scan_cfg", "world_res_m"))
def simulate_scan(scan_cfg: ScanConfig, world: torch.Tensor,
                  world_res_m: float, n_samples: int, pose: torch.Tensor,
                  noise: Optional[torch.Tensor] = None,
                  noise_std_m: float = 0.0) -> torch.Tensor:
    """One scan (padded_beams,) from pose (3,). `noise` holds the
    (padded_beams,) standard normals that the JAX package draws from its
    `noise_key`: beams with a return get `noise_std_m` times theirs added
    when `noise_std_m` > 0."""
    r, hit, live = _ranges(scan_cfg, world, world_res_m, n_samples,
                           pose[None])
    r, hit = r[0], hit[0]
    if noise is not None:
        n = torch.as_tensor(noise, dtype=torch.float32, device=r.device)
        r = torch.where(hit & (noise_std_m > 0.0), r + noise_std_m * n, r)
    return torch.where(live, r, 0.0).to(torch.float32)


def apply_lidar_miscal(poses, offset_rad):
    """The `lidar_miscal` fault: a sensor mount rotated by `offset_rad`
    reports beam k's range for the world angle theta + offset +
    k * increment while still labelling it beam k, which is a raycast from
    a pose whose heading is offset. poses (R, 3), offset_rad (R,); returns
    the raycast poses (numpy)."""
    out = np.array(poses, np.float32, copy=True)
    out[:, 2] += np.asarray(offset_rad, np.float32)
    return out


def apply_ghost_returns(scan_cfg: ScanConfig, ranges, frac, rng,
                        short_max_m: float = 0.5):
    """The `ghost_returns` fault: replace a `frac` share of the live beams,
    drawn from the caller's `np.random.Generator`, with spurious short
    ranges in [range_min, short_max_m]. ranges (padded_beams,); returns a
    modified float32 copy (numpy)."""
    out = np.array(ranges, np.float32, copy=True)
    n = scan_cfg.n_beams
    mask = rng.random(n) < frac
    ghosts = rng.uniform(scan_cfg.range_min_m, short_max_m, n)
    out[:n] = np.where(mask, ghosts.astype(np.float32), out[:n])
    return out


def ir_proximity(world: torch.Tensor, world_res_m: float, poses: torch.Tensor,
                 max_dist_m: float = 0.12, n_samples: int = 16,
                 tenant=None) -> torch.Tensor:
    """(R, 3) poses -> (R, 5) front IR readings, 0 (clear) to 4500
    (contact); `tenant` as in `simulate_scans`."""
    dev = poses.device
    angles = torch.as_tensor(linspace_f32(-0.7, 0.7, 5), device=dev)
    rs = torch.as_tensor(linspace_f32(0.02, max_dist_m, n_samples),
                         device=dev)
    a = poses[:, 2:3] + angles                                 # (R, 5)
    xs = poses[:, 0, None, None] + torch.cos(a)[:, :, None] * rs
    ys = poses[:, 1, None, None] + torch.sin(a)[:, :, None] * rs
    any_hit, first = _first_hit(world, world_res_m, xs, ys, tenant)
    d = torch.where(any_hit, rs[first], max_dist_m)
    return torch.where(any_hit, 4500.0 * (1.0 - div(d, max_dist_m)), 0.0)
