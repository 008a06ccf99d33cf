"""Synthetic pinhole depth camera rendered against the 2.5D world.

Port of the JAX package's `sim/depthcam.py`: the world bitmap extruded to
walls of `wall_height_m` standing on an infinite floor at z = 0. Every
pixel samples its ray at S fixed euclidean steps (one gather against the
bitmap, plain math for the floor) and the first hit falls out of an
argmax over the hit profile. Plain PyTorch (the JAX package renders with
XLA, not with a kernel); batched over poses, `_RENDER_CHUNK` images at a
time so that the (B, H, W, S) sample tensors stay bounded (46 MB of f32
per image per tensor at the default 160 x 120 image and 200 samples).

Images follow the real-sensor convention `ops/voxel.py` consumes:
depth = z along the optical axis, 0 = no return (the ray left the world
or ran past range_max).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from jax_mapping_torch._util import div, entry_point, linspace_f32
from jax_mapping_torch.config import DepthCamConfig
from jax_mapping_torch.ops.voxel import camera_pose

#: Images rendered at once.
_RENDER_CHUNK = 4


@functools.lru_cache(maxsize=None)
def _rays(cam: DepthCamConfig, n_samples: int, device: str):
    """The camera's constants, made once per device: per-pixel unit rays
    in the camera frame (3 x (H, W); the third is the optical component
    cos_axis) and the (S,) euclidean sample distances, whose far end is
    stretched so oblique rays still reach range_max in projective depth.
    Computed in numpy f32, whose square root is correctly rounded (torch's
    vectorised CPU square root is not, in ~1% of these values)."""
    f32 = np.float32
    H, W = cam.height_px, cam.width_px
    us = (np.arange(W, dtype=f32) - f32(cam.cx)) / f32(cam.fx)
    vs = (np.arange(H, dtype=f32) - f32(cam.cy)) / f32(cam.fy)
    dx = np.broadcast_to(us[None, :], (H, W))
    dy = np.broadcast_to(vs[:, None], (H, W))
    norm = np.sqrt(dx * dx + dy * dy + f32(1.0))
    rays = (dx / norm, dy / norm, f32(1.0) / norm)
    t_max = f32(cam.range_max_m) / max(rays[2].min(), f32(0.05))
    ts = linspace_f32(cam.range_min_m, float(t_max), n_samples)
    return tuple(torch.as_tensor(np.ascontiguousarray(a, dtype=f32),
                                 device=device) for a in (*rays, ts))


@entry_point(static=("cam", "n_samples", "wall_height_m", "world_res_m"))
def render_depths(cam: DepthCamConfig, world: torch.Tensor,
                  world_res_m: float, n_samples: int,
                  poses_xyyaw: torch.Tensor,
                  wall_height_m: float = 0.5) -> torch.Tensor:
    """(B, 3) planar poses [x, y, yaw] -> (B, H, W) f32 depth images.

    `world` is the (Hw, Ww) bool obstacle bitmap with centred indexing (the
    LiDAR simulator's convention). Walls span 0 <= z <= wall_height_m; the
    floor plane z = 0 returns everywhere."""
    dev = poses_xyyaw.device
    B = poses_xyyaw.shape[0]
    dcx, dcy, dcz, ts = _rays(cam, n_samples, str(dev))
    out = torch.empty((B, cam.height_px, cam.width_px), dtype=torch.float32,
                      device=dev)
    for s in range(0, B, _RENDER_CHUNK):
        e = min(B, s + _RENDER_CHUNK)
        out[s:e] = _render(cam, world, world_res_m, poses_xyyaw[s:e],
                           wall_height_m, dcx, dcy, dcz, ts)
    return out


@entry_point(static=("cam", "n_samples", "wall_height_m", "world_res_m"))
def render_depth(cam: DepthCamConfig, world: torch.Tensor,
                 world_res_m: float, n_samples: int,
                 pose_xyyaw: torch.Tensor,
                 wall_height_m: float = 0.5) -> torch.Tensor:
    """One (H, W) depth image from a planar pose [x, y, yaw]."""
    return render_depths(cam, world, world_res_m, n_samples,
                         pose_xyyaw.reshape(1, 3), wall_height_m)[0]


def _render(cam, world, world_res_m, poses, wall_height_m, dcx, dcy, dcz,
            ts) -> torch.Tensor:
    Hw, Ww = world.shape
    pos, R = camera_pose(poses[:, 0], poses[:, 1], poses[:, 2], cam)
    Rr = R[:, :, :, None, None]                          # (b, 3, 3, 1, 1)
    # R @ d_cam, one component at a time, in the einsum's term order.
    d_world = [Rr[:, i, 0] * dcx + Rr[:, i, 1] * dcy + Rr[:, i, 2] * dcz
               for i in range(3)]                        # 3 x (b, H, W)
    p = [pos[:, i, None, None, None] + d_world[i][..., None] * ts
         for i in range(3)]                              # 3 x (b, H, W, S)
    col = torch.round(div(p[0], world_res_m) + Ww / 2 - 0.5).to(torch.int64)
    row = torch.round(div(p[1], world_res_m) + Hw / 2 - 0.5).to(torch.int64)
    inb = (row >= 0) & (row < Hw) & (col >= 0) & (col < Ww)
    pz = p[2]
    wall = (world[row.clamp(0, Hw - 1), col.clamp(0, Ww - 1)] & inb
            & (pz >= 0.0) & (pz <= wall_height_m))
    hit = wall | (pz <= 0.0)
    any_hit = hit.any(dim=-1)
    # argmax returns the first maximal index on every device.
    first = torch.argmax(hit.to(torch.uint8), dim=-1)
    depth = ts[first] * dcz
    ok = (any_hit & (depth >= cam.range_min_m)
          & (depth <= cam.range_max_m))
    return torch.where(ok, depth, 0.0).to(torch.float32)


def n_samples_for(cam: DepthCamConfig, world_res_m: float) -> int:
    """The sample count the simulator node uses: two per world cell out to
    range_max, at least 16."""
    return max(16, int(cam.range_max_m / (world_res_m * 0.5)))

