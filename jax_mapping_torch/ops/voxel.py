"""3D log-odds voxel grid fused from depth images.

Port of the JAX package's `ops/voxel.py`. Every voxel of a fixed-shape
(Z, P, P) patch around the camera evaluates the inverse sensor model
against the depth image directly (pinhole projection, one image lookup,
free / occupied / unchanged); a batch of images folds into the grid patch
by patch in b order, and the grid is clamped once per call. Layout is
(Z, Y, X); patches span the full Z extent, so patch origins are 2D
(y0, x0).

Two engines compute the same model, and the choice between them is the
JAX package's own static one, `voxel_kernel.kernel_supported(vox, cam)`:

- the **kernel engine** (`voxel_kernel.fuse_depths`) for a level camera
  (mount pitch 0) whose image height and Z extent fit the JAX kernel's
  128-lane limits: kernel K6 on the card, its plain version on the CPU;
- the **general engine** (`fuse_depths_xla`, `classify_region`) for every
  other config, on every device, as the JAX package runs XLA for such
  configs on a TPU.

The limits of 128 have no meaning on the card, but they decide which
arithmetic a config gets (the two engines round differently; see
`classify_region`), so they are kept as the JAX package has them.

Depth is z along the optical axis (camera z forward, x right, y down); a
reading of exactly 0 means no return and carves nothing. Every fuse
returns a new grid and leaves its input unwritten.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from jax_mapping_torch._util import div, entry_point, resolve_device
from jax_mapping_torch.config import DepthCamConfig, VoxelConfig

# ---------------------------------------------------------------------------
# Camera pose and patch origin
# ---------------------------------------------------------------------------


def camera_pose(x_m, y_m, yaw_rad, cam: DepthCamConfig
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Planar robot pose(s) -> (cam_pos (..., 3), R_wc (..., 3, 3)).

    The camera sits `mount_height_m` above the ground at the robot's x/y,
    its optical axis along the heading tilted up by `mount_pitch_rad`.
    R_wc's columns are the camera's x (right), y (down) and z (forward)
    axes in world coordinates; a world point w maps to the camera frame as
    R_wc^T (w - pos). Broadcasts over the leading shape of its inputs."""
    yaw = torch.as_tensor(yaw_rad, dtype=torch.float32)
    x = torch.as_tensor(x_m, dtype=torch.float32, device=yaw.device)
    y = torch.as_tensor(y_m, dtype=torch.float32, device=yaw.device)
    p = torch.full((), cam.mount_pitch_rad, dtype=torch.float32,
                   device=yaw.device)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    cp, sp = torch.cos(p), torch.sin(p)
    fwd = [cp * cy, cp * sy, sp.expand_as(cy)]
    right = [sy, -cy, torch.zeros_like(sy)]
    # jnp.cross(fwd, right), term by term in its order.
    down = [fwd[1] * right[2] - fwd[2] * right[1],
            fwd[2] * right[0] - fwd[0] * right[2],
            fwd[0] * right[1] - fwd[1] * right[0]]
    pos = torch.stack([x, y, torch.full_like(x, cam.mount_height_m)], -1)
    R = torch.stack([torch.stack(right, -1), torch.stack(down, -1),
                     torch.stack(fwd, -1)], -1)
    return pos, R


def patch_origin(vox: VoxelConfig, cam_pos_xy: torch.Tensor) -> torch.Tensor:
    """(..., 2) camera xy -> (..., 2) int32 [y0, x0] of the update patch,
    snapped to (align_y, align_x) and clipped to the grid."""
    ox, oy, _ = vox.origin_m
    cx = div(cam_pos_xy[..., 0] - ox, vox.resolution_m)
    cy = div(cam_pos_xy[..., 1] - oy, vox.resolution_m)
    ax, ay = vox.align_x, vox.align_y
    x0 = torch.round(div(cx - vox.patch_cells / 2, ax)).to(torch.int32) * ax
    y0 = torch.round(div(cy - vox.patch_cells / 2, ay)).to(torch.int32) * ay
    x0 = x0.clamp(0, vox.size_x_cells - vox.patch_cells)
    y0 = y0.clamp(0, vox.size_y_cells - vox.patch_cells)
    return torch.stack([y0, x0], -1)


def empty_voxel_grid(vox: VoxelConfig, device=None,
                     dtype=torch.float32) -> torch.Tensor:
    """Fresh all-unknown (log-odds 0) (Z, Y, X) grid, on the card unless
    `device` names another (raises without a card)."""
    return torch.zeros((vox.size_z_cells, vox.size_y_cells,
                        vox.size_x_cells), dtype=dtype,
                       device=resolve_device(device))


# ---------------------------------------------------------------------------
# The general engine's model over an arbitrary (Z, ny, nx) region
# ---------------------------------------------------------------------------

def classify_region(vox: VoxelConfig, cam: DepthCamConfig,
                    depth: torch.Tensor, cam_pos: torch.Tensor,
                    R_wc: torch.Tensor, y0, x0, ny: int,
                    nx: int) -> torch.Tensor:
    """Log-odds delta of one (H, W) depth image over the (Z, ny, nx)
    region at rows y0, cols x0 (any camera pitch).

    This is the general engine's float program, which is not the kernel
    engine's (`voxel_kernel`): it rotates through the full R_wc, so at
    pitch 0 its camera y is R[2,1] * dz with R[2,1] = -(cos^2 + sin^2) of
    the yaw, which is -0.99999994 for some yaws, where the kernel engine
    uses camz - wz. A pixel index can flip on a boundary between the two.
    """
    dev = depth.device
    res = vox.resolution_m
    ox, oy, oz = vox.origin_m
    Z = vox.size_z_cells
    xs = (x0 + torch.arange(nx, dtype=torch.int32, device=dev)).float()
    ys = (y0 + torch.arange(ny, dtype=torch.int32, device=dev)).float()
    zs = torch.arange(Z, dtype=torch.float32, device=dev)
    wx = (xs + 0.5) * res + ox
    wy = (ys + 0.5) * res + oy
    wz = (zs + 0.5) * res + oz
    dx = (wx - cam_pos[0])[None, None, :]
    dy = (wy - cam_pos[1])[None, :, None]
    dz = (wz - cam_pos[2])[:, None, None]
    cxc = R_wc[0, 0] * dx + R_wc[1, 0] * dy + R_wc[2, 0] * dz
    cyc = R_wc[0, 1] * dx + R_wc[1, 1] * dy + R_wc[2, 1] * dz
    czc = R_wc[0, 2] * dx + R_wc[1, 2] * dy + R_wc[2, 2] * dz

    in_front = czc > cam.range_min_m
    safe_z = torch.where(in_front, czc, 1.0)
    u = cam.fx * cxc / safe_z + cam.cx
    v = cam.fy * cyc / safe_z + cam.cy
    ui = torch.round(u).to(torch.int64)
    vi = torch.round(v).to(torch.int64)
    H, W = cam.height_px, cam.width_px
    frustum = in_front & (ui >= 0) & (ui < W) & (vi >= 0) & (vi < H)
    z_img = depth[vi.clamp(0, H - 1), ui.clamp(0, W - 1)]
    # The trust horizon is euclidean; max_r * max_r is an f32 product here.
    max_r = np.float32(vox.max_range_m)
    near = (cxc * cxc + cyc * cyc + czc * czc) <= float(max_r * max_r)
    valid = frustum & near & (z_img > 0.0) & (z_img >= cam.range_min_m)
    tol = vox.hit_tolerance_cells * res
    carve = torch.clamp_max(torch.where(z_img > 0.0, z_img, 0.0),
                            float(max_r))
    free = valid & (czc < carve - tol)
    occ = valid & (torch.abs(czc - z_img) <= tol) & (z_img <= float(max_r))
    delta = torch.where(occ, vox.logodds_occ,
                        torch.where(free, vox.logodds_free, 0.0))
    return delta.to(torch.float32)


def classify_patch(vox: VoxelConfig, cam: DepthCamConfig,
                   depth: torch.Tensor, cam_pos: torch.Tensor,
                   R_wc: torch.Tensor, origin_yx) -> torch.Tensor:
    """The (Z, P, P) patch delta of one depth image."""
    P = vox.patch_cells
    return classify_region(vox, cam, depth, cam_pos, R_wc, origin_yx[0],
                           origin_yx[1], P, P)


# ---------------------------------------------------------------------------
# Folding patches into the grid
# ---------------------------------------------------------------------------

def apply_patch(vox: VoxelConfig, grid: torch.Tensor, delta: torch.Tensor,
                origin_yx, clamp: bool = True) -> torch.Tensor:
    """A new grid with grid[:, y0:y0+P, x0:x0+P] + delta, clamped to the
    log-odds bounds unless `clamp` is False. The origin is clipped so the
    patch fits, as jax.lax.dynamic_slice clips it."""
    P = vox.patch_cells
    y0 = min(max(int(origin_yx[0]), 0), vox.size_y_cells - P)
    x0 = min(max(int(origin_yx[1]), 0), vox.size_x_cells - P)
    out = grid.clone()
    sl = out[:, y0:y0 + P, x0:x0 + P]
    sl.add_(delta)
    if clamp:
        sl.clamp_(vox.logodds_min, vox.logodds_max)
    return out


#: Images classified per fold chunk: a (B, Z, P, P) delta batch at the
#: default shape is B x 37.7 MB, so chunks bound the transient memory.
_FUSE_CHUNK = 8


def _check_patch_coverage(vox: VoxelConfig, cam: DepthCamConfig) -> None:
    """The coverage contract: patch/2 - align/2 must reach the trust
    horizon, or origin alignment can shift a patch far enough that valid
    returns fall outside it and vanish."""
    slack_m = (vox.patch_cells / 2 - max(vox.align_x, vox.align_y) / 2) \
        * vox.resolution_m
    horizon = vox.max_range_m
    if slack_m < horizon:
        raise ValueError(
            f"voxel patch coverage violated: patch/2 - align/2 = "
            f"{slack_m:.2f} m < trust horizon {horizon:.2f} m; raise "
            f"patch_cells or shrink max_range_m")


@entry_point(static=("cam", "vox"))
def fuse_depth(vox: VoxelConfig, cam: DepthCamConfig, grid: torch.Tensor,
               depth: torch.Tensor, pose_xyyaw: torch.Tensor) -> torch.Tensor:
    """Fuse ONE depth image taken from a planar pose [x, y, yaw] through
    the general engine, clamped."""
    _check_patch_coverage(vox, cam)
    pos, R = camera_pose(pose_xyyaw[0], pose_xyyaw[1], pose_xyyaw[2], cam)
    origin = patch_origin(vox, pos[:2])
    delta = classify_patch(vox, cam, depth, pos, R, origin)
    return apply_patch(vox, grid, delta, origin.tolist())


@entry_point(static=("cam", "vox"))
def fuse_depths(vox: VoxelConfig, cam: DepthCamConfig, grid: torch.Tensor,
                depths_b: torch.Tensor, poses_b: torch.Tensor
                ) -> torch.Tensor:
    """Fuse a batch of B depth images (B, H, W) taken at (B, 3) poses.

    Dispatches on the JAX package's static predicate
    `voxel_kernel.kernel_supported`: the kernel engine (K6 on the card)
    for a level camera within its limits, else the general engine. Both
    fold the images in b order without clamping and clamp once."""
    from jax_mapping_torch.ops import voxel_kernel as VK
    if VK.kernel_supported(vox, cam):
        return VK.fuse_depths(vox, cam, grid, depths_b, poses_b)
    return fuse_depths_xla(vox, cam, grid, depths_b, poses_b)


@entry_point(static=("cam", "vox"))
def fuse_depths_xla(vox: VoxelConfig, cam: DepthCamConfig,
                    grid: torch.Tensor, depths_b: torch.Tensor,
                    poses_b: torch.Tensor) -> torch.Tensor:
    """The general engine (the JAX package's XLA engine, hence the name):
    `classify_patch` of each image, folded into one copy of the grid in b
    order without clamping, then one clamp. One host sync, for the patch
    origins."""
    _check_patch_coverage(vox, cam)
    B = depths_b.shape[0]
    if B == 0:
        return grid
    pos, R = camera_pose(poses_b[:, 0], poses_b[:, 1], poses_b[:, 2], cam)
    origins = patch_origin(vox, pos[:, :2])
    host = origins.tolist()
    P = vox.patch_cells
    out = grid.clone()
    for b in range(B):
        y0, x0 = host[b]
        out[:, y0:y0 + P, x0:x0 + P] += classify_patch(
            vox, cam, depths_b[b], pos[b], R[b], origins[b])
    return out.clamp_(vox.logodds_min, vox.logodds_max)


# ---------------------------------------------------------------------------
# Export
# ---------------------------------------------------------------------------

@entry_point(static=("vox",))
def to_occupancy(vox: VoxelConfig, grid: torch.Tensor) -> torch.Tensor:
    """Log-odds -> int8 {-1 unknown, 0 free, 100 occupied}."""
    out = torch.full(grid.shape, -1, dtype=torch.int8, device=grid.device)
    out[grid < vox.free_threshold] = 0
    out[grid > vox.occ_threshold] = 100
    return out


def _z_centres(vox: VoxelConfig) -> np.ndarray:
    """f32 height of each z layer's centre."""
    _, _, oz = vox.origin_m
    return ((np.arange(vox.size_z_cells, dtype=np.float32) + np.float32(0.5))
            * np.float32(vox.resolution_m) + np.float32(oz))


@entry_point(static=("vox",))
def height_map(vox: VoxelConfig, grid: torch.Tensor) -> torch.Tensor:
    """(Y, X) f32 metres: the top of occupied space in each column, -1.0
    where the column holds no occupied voxel."""
    Z = vox.size_z_cells
    occ = grid > vox.occ_threshold
    # The highest occupied layer: argmax of occ * (z + 1) (0 when none).
    zs1 = torch.arange(1, Z + 1, dtype=torch.int16, device=grid.device)
    top1 = (occ * zs1[:, None, None]).amax(dim=0)
    _, _, oz = vox.origin_m
    h = top1.to(torch.float32) * vox.resolution_m + oz
    return torch.where(top1 > 0, h, -1.0).to(torch.float32)


@entry_point(static=("vox", "z_max_m", "z_min_m"))
def obstacle_slice(vox: VoxelConfig, grid: torch.Tensor, z_min_m: float,
                   z_max_m: float) -> torch.Tensor:
    """(Y, X) bool: any occupied voxel in the height band."""
    zs = _z_centres(vox)
    band = np.nonzero((zs >= np.float32(z_min_m))
                      & (zs <= np.float32(z_max_m)))[0]
    if band.size == 0:
        return torch.zeros(grid.shape[1:], dtype=torch.bool,
                           device=grid.device)
    lo, hi = int(band[0]), int(band[-1]) + 1
    return (grid[lo:hi] > vox.occ_threshold).any(dim=0)


def occupied_voxel_centers(vox: VoxelConfig, grid) -> np.ndarray:
    """Host-side export: (N, 3) f32 world-metre centres of occupied
    voxels. The occupied voxels are found where the grid lies; only their
    indices cross to the host."""
    g = torch.as_tensor(grid)
    zi, yi, xi = torch.nonzero(g > vox.occ_threshold).cpu().numpy().T
    ox, oy, oz = vox.origin_m
    res = vox.resolution_m
    return np.stack([(xi + 0.5) * res + ox,
                     (yi + 0.5) * res + oy,
                     (zi + 0.5) * res + oz], axis=1).astype(np.float32)
