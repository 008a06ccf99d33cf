"""The simulated LD06 scans and IR proximity: a frozen copy of the port's
`sim/lidar.py`."""

from __future__ import annotations


import torch

from ._util import div, entry_point, linspace_f32
from .config import ScanConfig


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
