"""Kernels K6 and K7: the 3D depth-camera inverse sensor model on Hopper.

Replaces the two Pallas call sites of the JAX package's
`ops/voxel_kernel.py`, which build one kernel body (`_make_kernel`):

- **K6** (`image_deltas`, CUDA `voxel_image_launch`) replaces the
  per-image site (`image_deltas`): (B, Z, P, P) deltas, each image at its
  own patch origin. The kernel engine's `fuse_depths` folds them.
- **K7** (`_summed_delta`, CUDA `voxel_summed_launch`) replaces the
  accumulating site: the sum, from 0 in b order, of B images' deltas over
  one (Z, ny, nx) region with per-image origins. `window_delta` (one
  robot's frames on a shared patch) and `region_delta` (a full-width Y
  slab, the sharded fuse's local step) both reach it.

CUDA source: `csrc/voxel_model.cu`. Both kernels share one device body
for a voxel column (y, x), written after the Pallas `body()`: the
column's camera x and z (pitch 0 makes them constant in z), its image
column u, then per z the image row v, a direct load of depth[b, v, u],
the euclidean trust horizon and the classification. The plain versions
(`image_deltas_plain`, `summed_delta_plain`) do the same float operations
in the same order, so kernel and plain version agree bit for bit; on a
CPU tensor the wrappers run them, on a CUDA tensor they launch the kernel
or raise.

This float program is the Pallas kernel's, not `voxel.classify_region`'s:
the kernel takes camera y as camz - wz, where classify_region rotates
through R_wc (see there). The rotation terms come from `pose_table`,
computed once outside the kernels by torch's cos and sin, as the JAX
package computes them outside its kernel.

Not ported: `depth_table`. It packs the images into a transposed,
128-padded lane layout for the TPU's one-hot matmul column pick; the
CUDA kernels read the (B, H, W) images as they are, and a direct load is
exact. The 128-lane limits of `kernel_supported` / `region_supported`
stay as the JAX package has them, because they decide which engine (and
so which arithmetic) a config gets.

What bounds the kernels on an H100: K6 writes its (B, Z, P, P) f32 output
once (37.7 MB per image at the default config), against ~20 float
operations per voxel in front of the camera, inside the image and within
the trust horizon (one IEEE division): a few per cent of the voxels, so
it is bound by bytes, and so is K7, which writes one (Z, ny, nx) sum.
Their design evaluates only those voxels. A block owns a tile of
`TILE_Y` x `TILE_X` voxel columns with all their layers; an exact,
conservative test per (tile, image) (`tile_live_plain` mirrors it) drops
the pairs whose tile lies behind range_min, beyond a side plane of the
image or beyond the horizon, and each live column evaluates only a z
interval that holds every layer the model can make non-zero
(`column_z_range_plain` mirrors it). Everything else is written as +0
without computing it: exact for K6, and for K7 because an accumulator
starts at +0 and is never -0. K7 splits z across the block
(`Z_CHUNK` layers a thread), and each thread adds its voxels' deltas
over the tile's live images in b order.
"""

from __future__ import annotations

import torch

from jax_mapping_torch._util import div, entry_point
from jax_mapping_torch.config import DepthCamConfig, VoxelConfig
from jax_mapping_torch.obs import ledger
from jax_mapping_torch.ops import _cuda

LANES = 128      # the JAX kernel's lane count, kept in its limits
COLS = 128       # the JAX kernel's voxel columns per step

#: Images of one K7 launch; larger batches are summed as subtotals of this
#: many images, added in order, as the JAX package's TPU engine does (its
#: VMEM ceiling). The port keeps the split so both give the same sums.
_MAX_B_PER_CALL = 32

#: Largest image count of one K6 launch (the grid's y dimension).
_MAX_B_PER_LAUNCH = 65535

#: The kernels' tile of voxel columns (rows, columns) and the layers one
#: K7 thread sums: `kTileY`, `kTileX` and `kZChunk` in
#: csrc/voxel_model.cu.
TILE_Y, TILE_X = 1, 32
Z_CHUNK = 8


def region_supported(vox: VoxelConfig, cam: DepthCamConfig,
                     ny: int, nx: int) -> bool:
    """The JAX package's static support check for a (ny, nx) region:
    pitch 0 (the factorisation's premise), image height and Z extent at
    most 128, and ny * nx a multiple of 128."""
    return (cam.mount_pitch_rad == 0.0
            and cam.height_px <= LANES
            and vox.size_z_cells <= LANES
            and (ny * nx) % COLS == 0)


def kernel_supported(vox: VoxelConfig, cam: DepthCamConfig) -> bool:
    """Static support check for the patch paths (the engine choice of
    `voxel.fuse_depths`)."""
    return region_supported(vox, cam, vox.patch_cells, vox.patch_cells)


def _check(vox: VoxelConfig, cam: DepthCamConfig) -> None:
    if not kernel_supported(vox, cam):
        raise ValueError(
            f"voxel kernel unsupported for this config: needs pitch==0 "
            f"(got {cam.mount_pitch_rad}), height_px<={LANES} (got "
            f"{cam.height_px}), size_z_cells<={LANES} (got "
            f"{vox.size_z_cells}), patch_cells^2 % {COLS} == 0 (got "
            f"{vox.patch_cells}); use ops.voxel.classify_patch")


def pose_table(poses_b: torch.Tensor) -> torch.Tensor:
    """(B, 3) [x, y, yaw] -> (B, 4) f32 [x, y, cos yaw, sin yaw]: the
    rotation terms kernel and plain version share."""
    p = poses_b.to(torch.float32)
    return torch.stack([p[:, 0], p[:, 1], torch.cos(p[:, 2]),
                        torch.sin(p[:, 2])], dim=1).contiguous()


def model_args(vox: VoxelConfig, cam: DepthCamConfig) -> tuple:
    """The model's scalars in the kernels' C argument order (`Params` in
    csrc/voxel_model.cu). Products and sums of config values are formed
    in double and rounded once to f32, as the JAX kernel's Python-float
    constants are. The last two serve only the kernels' z interval: the
    layers a metre of camera depth spans in half the image height,
    H / (2 fy res), and the camera's height as a fractional layer index,
    (camz - oz) / res - 0.5."""
    ox, oy, oz = vox.origin_m
    res = vox.resolution_m
    max_r = float(vox.max_range_m)
    camz = float(cam.mount_height_m)
    return (vox.size_z_cells, cam.height_px, cam.width_px, res, ox, oy, oz,
            camz, float(cam.fx), float(cam.fy),
            float(cam.cx), float(cam.cy), float(cam.range_min_m), max_r,
            max_r * max_r, vox.hit_tolerance_cells * res,
            float(vox.logodds_occ), float(vox.logodds_free),
            cam.height_px / (2.0 * float(cam.fy) * res),
            (camz - oz) / res - 0.5)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------

def _model(vox: VoxelConfig, cam: DepthCamConfig, depth: torch.Tensor,
           t: torch.Tensor, y0, x0, ny: int, nx: int) -> torch.Tensor:
    """(Z, ny, nx) delta of one (H, W) image with pose-table row t over
    the region at rows y0, cols x0: the kernels' float program."""
    dev = depth.device
    res = vox.resolution_m
    ox, oy, oz = vox.origin_m
    (Z, H, W, _, _, _, _, camz, fx, fy, cx, cy, rmin, max_r, max_r2, tol,
     lo_occ, lo_free, *_) = model_args(vox, cam)
    px, py, cyaw, syaw = t[0], t[1], t[2], t[3]
    # Per column (y, x).
    rows = (y0 + torch.arange(ny, dtype=torch.int32, device=dev)).float()
    cols = (x0 + torch.arange(nx, dtype=torch.int32, device=dev)).float()
    wy = (rows + 0.5) * res + oy
    wx = (cols + 0.5) * res + ox
    dx = (wx - px)[None, :]
    dy = (wy - py)[:, None]
    cxc = syaw * dx - cyaw * dy
    czc = cyaw * dx + syaw * dy
    in_front = czc > rmin
    safe_z = torch.where(in_front, czc, 1.0)
    u = fx * cxc / safe_z + cx
    ui = torch.round(u).to(torch.int64)
    in_u = (ui >= 0) & (ui < W)
    ui_c = ui.clamp(0, W - 1)
    # Per z.
    wz = (torch.arange(Z, dtype=torch.float32, device=dev) + 0.5) * res + oz
    cyc = (camz - wz)[:, None, None]
    v = fy * cyc / safe_z + cy
    vi = torch.round(v).to(torch.int64)
    in_v = (vi >= 0) & (vi < H)
    z_img = depth[vi.clamp(0, H - 1), ui_c]
    near = (cxc * cxc + cyc * cyc) + czc * czc <= max_r2
    valid = (in_front & in_u & in_v & near & (z_img > 0.0)
             & (z_img >= rmin))
    carve = torch.clamp_max(torch.where(z_img > 0.0, z_img, 0.0), max_r)
    free = valid & (czc < carve - tol)
    occ = valid & (torch.abs(czc - z_img) <= tol) & (z_img <= max_r)
    delta = torch.where(occ, lo_occ, torch.where(free, lo_free, 0.0))
    return delta.to(torch.float32)


def image_deltas_plain(vox: VoxelConfig, cam: DepthCamConfig,
                       depths_b: torch.Tensor, table: torch.Tensor,
                       origins_yx: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K6: (B, Z, P, P) from the (B, 4)
    `pose_table` rows and (B, 2) int32 origins."""
    P = vox.patch_cells
    B = depths_b.shape[0]
    out = torch.empty((B, vox.size_z_cells, P, P), dtype=torch.float32,
                      device=depths_b.device)
    for b in range(B):
        out[b] = _model(vox, cam, depths_b[b], table[b], origins_yx[b, 0],
                        origins_yx[b, 1], P, P)
    return out


def summed_delta_plain(vox: VoxelConfig, cam: DepthCamConfig,
                       depths_b: torch.Tensor, table: torch.Tensor,
                       origins_b: torch.Tensor, ny: int,
                       nx: int) -> torch.Tensor:
    """Plain PyTorch version of K7: the (Z, ny, nx) sum, from 0 in b
    order, of every image's delta at its own origin (B, 2)."""
    acc = torch.zeros((vox.size_z_cells, ny, nx), dtype=torch.float32,
                      device=depths_b.device)
    for b in range(depths_b.shape[0]):
        acc = acc + _model(vox, cam, depths_b[b], table[b], origins_b[b, 0],
                           origins_b[b, 1], ny, nx)
    return acc


# ---------------------------------------------------------------------------
# Plain mirrors of the kernels' cull (tests and chip_smoke.py; nothing on
# the main path calls them)
# ---------------------------------------------------------------------------

def _columns(vox: VoxelConfig, cam: DepthCamConfig, t: torch.Tensor, y0,
             x0, ny: int, nx: int) -> tuple:
    """(cxc, czc, in_front and in_u) of each (ny, nx) column of the region
    at rows y0, cols x0, for pose-table row t: the kernels' column_of."""
    dev = t.device
    args = model_args(vox, cam)
    W, res, ox, oy, fx, cx, rmin = (args[2], args[3], args[4], args[5],
                                    args[8], args[10], args[12])
    rows = (y0 + torch.arange(ny, dtype=torch.int32, device=dev)).float()
    cols = (x0 + torch.arange(nx, dtype=torch.int32, device=dev)).float()
    dx = (((cols + 0.5) * res + ox) - t[0])[None, :]
    dy = (((rows + 0.5) * res + oy) - t[1])[:, None]
    cxc = t[3] * dx - t[2] * dy
    czc = t[2] * dx + t[3] * dy
    in_front = czc > rmin
    ui = torch.round(fx * cxc / torch.where(in_front, czc, 1.0) + cx)
    return cxc, czc, in_front & (ui >= 0) & (ui < W)


def column_z_range_plain(vox: VoxelConfig, cam: DepthCamConfig,
                         t: torch.Tensor, y0, x0, ny: int, nx: int) -> tuple:
    """(lo, hi) int64 (ny, nx): the z interval each column of the region
    evaluates for pose-table row t (csrc/voxel_model.cu column_terms), in
    its float operations; lo > hi where the column evaluates nothing.
    Every voxel outside it is 0 by the model's mask."""
    args = model_args(vox, cam)
    Z, res, max_r2, kv, zc = args[0], args[3], args[14], args[18], args[19]
    cxc, czc, ok = _columns(vox, cam, t, y0, x0, ny, nx)
    s = cxc * cxc + czc * czc
    ok = ok & (s <= max_r2)
    hv = kv * czc
    # sqrt in double, rounded once: the correctly rounded f32 root.
    hh = torch.sqrt((max_r2 - s).clamp_min(0.0).double()).float() / res
    h = torch.minimum(hv, hh) + 1.0
    lo = torch.ceil(zc - h).long().clamp_min(0)
    hi = torch.floor(zc + h).long().clamp_max(Z - 1)
    return torch.where(ok, lo, Z), torch.where(ok, hi, -1)


def tile_live_plain(vox: VoxelConfig, cam: DepthCamConfig,
                    table: torch.Tensor, origins: torch.Tensor, ny: int,
                    nx: int) -> torch.Tensor:
    """(B, ceil(ny / TILE_Y), ceil(nx / TILE_X)) bool: the kernels'
    (tile, image) live test (csrc/voxel_model.cu tile_live) over a
    (ny, nx) region at per-image origins (B, 2), in its float operations.
    A dead pair's voxels are all 0 by the model's mask."""
    dev = table.device
    args = model_args(vox, cam)
    W, res, ox, oy, fx, cx, rmin, max_r2 = (
        args[2], args[3], args[4], args[5], args[8], args[10], args[12],
        args[14])
    ty0 = torch.arange(0, ny, TILE_Y, dtype=torch.int32, device=dev)
    tx0 = torch.arange(0, nx, TILE_X, dtype=torch.int32, device=dev)
    o = origins.to(device=dev, dtype=torch.int32)
    px, py, cyaw, syaw = (table[:, k:k + 1] for k in range(4))

    def centre(i, org, p):
        return ((i.float() + 0.5) * res + org) - p
    dx0 = centre(o[:, 1:2] + tx0, ox, px) - res                  # (B, ntx)
    dx1 = centre(o[:, 1:2] + (tx0 + TILE_X).clamp_max(nx) - 1, ox, px) + res
    dy0 = centre(o[:, 0:1] + ty0, oy, py) - res                  # (B, nty)
    dy1 = centre(o[:, 0:1] + (ty0 + TILE_Y).clamp_max(ny) - 1, oy, py) + res
    gx = torch.where(dx0 > 0, dx0, torch.where(dx1 < 0, -dx1, 0.0))
    gy = torch.where(dy0 > 0, dy0, torch.where(dy1 < 0, -dy1, 0.0))
    near = (gx * gx)[:, None, :] + (gy * gy)[:, :, None] <= max_r2
    c, s = cyaw[:, :, None], syaw[:, :, None]
    czc = torch.stack([c * dx[:, None, :] + s * dy[:, :, None]
                       for dx in (dx0, dx1) for dy in (dy0, dy1)])
    cxc = torch.stack([s * dx[:, None, :] - c * dy[:, :, None]
                       for dx in (dx0, dx1) for dy in (dy0, dy1)])
    zmin, zmax = czc.amin(0), czc.amax(0)
    xmin, xmax = cxc.amin(0), cxc.amax(0)
    znear = zmin.clamp_min(rmin)
    umax = fx * xmax / torch.where(xmax >= 0, znear, zmax) + cx
    umin = fx * xmin / torch.where(xmin <= 0, znear, zmax) + cx
    return near & (zmax > rmin) & ~(umax < -0.5) & ~(umin > W - 0.5)


def model_voxel_mask(vox: VoxelConfig, cam: DepthCamConfig,
                     t: torch.Tensor, y0, x0, ny: int, nx: int
                     ) -> torch.Tensor:
    """(Z, ny, nx) bool: the voxels the model may make non-zero whatever
    the depths (in front of the camera, inside the image in u and v,
    within the horizon), in `_model`'s float operations: the function's
    work, whatever a kernel culls."""
    args = model_args(vox, cam)
    Z, H, res, oz, camz, fy, cy, max_r2 = (args[0], args[1], args[3],
                                           args[6], args[7], args[9],
                                           args[11], args[14])
    cxc, czc, ok = _columns(vox, cam, t, y0, x0, ny, nx)
    safe_z = torch.where(ok, czc, 1.0)
    wz = (torch.arange(Z, dtype=torch.float32, device=t.device) + 0.5) \
        * res + oz
    cyc = (camz - wz)[:, None, None]
    vi = torch.round(fy * cyc / safe_z + cy)
    return (ok & (vi >= 0) & (vi < H)
            & ((cxc * cxc + cyc * cyc) + czc * czc <= max_r2))


def cull_counts(vox: VoxelConfig, cam: DepthCamConfig, table: torch.Tensor,
                origins: torch.Tensor, ny: int, nx: int,
                group: int = 1) -> dict:
    """What the kernels' cull keeps of B images over a (ny, nx) region,
    from the mirrors, summed over the images: (tile, image) pairs and the
    live ones, the voxel columns of live pairs (`kept_columns`), the
    voxels the kernels evaluate (`evaluated_voxels`: in a kept column,
    every layer of each group of `group` layers that meets its z interval;
    K6 evaluates the interval, `group` 1, K7 whole groups of `Z_CHUNK`),
    and the function's own columns and voxels (`model_voxel_mask`)."""
    Z = vox.size_z_cells
    live = tile_live_plain(vox, cam, table, origins, ny, nx)
    out = {"pairs": live.numel(), "live_pairs": int(live.sum()),
           "kept_columns": 0, "evaluated_voxels": 0, "model_columns": 0,
           "model_voxels": 0}
    g0 = torch.arange(0, Z, group, device=table.device)[:, None, None]
    size = (g0 + group).clamp_max(Z) - g0
    for b in range(int(table.shape[0])):
        y0, x0 = origins[b, 0], origins[b, 1]
        kept = live[b].repeat_interleave(TILE_Y, 0)[:ny].repeat_interleave(
            TILE_X, 1)[:, :nx]
        lo, hi = column_z_range_plain(vox, cam, table[b], y0, x0, ny, nx)
        meets = (lo <= g0 + group - 1) & (hi >= g0) & (lo <= hi) & kept
        mask = model_voxel_mask(vox, cam, table[b], y0, x0, ny, nx)
        out["kept_columns"] += int(kept.sum())
        out["evaluated_voxels"] += int((meets * size).sum())
        out["model_columns"] += int(mask.any(0).sum())
        out["model_voxels"] += int(mask.sum())
    return out


# ---------------------------------------------------------------------------
# Wrappers
# ---------------------------------------------------------------------------

def _check_inputs(vox: VoxelConfig, cam: DepthCamConfig,
                  depths_b: torch.Tensor, table: torch.Tensor,
                  origins: torch.Tensor) -> None:
    B = depths_b.shape[0]
    _cuda.check_cuda(depths_b, "depths_b", torch.float32,
                     (B, cam.height_px, cam.width_px))
    _cuda.check_cuda(table, "pose table", torch.float32, (B, 4))
    _cuda.check_cuda(origins, "origins", torch.int32, (B, 2))


@entry_point(static=("cam", "vox"))
def image_deltas(vox: VoxelConfig, cam: DepthCamConfig,
                 depths_b: torch.Tensor, poses_b: torch.Tensor,
                 origins_yx: torch.Tensor) -> torch.Tensor:
    """Per-image (B, Z, P, P) log-odds patch deltas, one origin per image.

    depths_b: (B, H, W) metres, 0 = no return; poses_b: (B, 3)
    [x, y, yaw]; origins_yx: (B, 2) int32 [y0, x0]."""
    _check(vox, cam)
    table = pose_table(poses_b)
    if depths_b.device.type == "cpu":
        return image_deltas_plain(vox, cam, depths_b, table, origins_yx)
    B = depths_b.shape[0]
    _check_inputs(vox, cam, depths_b, table, origins_yx)
    if B > _MAX_B_PER_LAUNCH:
        raise ValueError(f"{B} images in one call; at most "
                         f"{_MAX_B_PER_LAUNCH}")
    P = vox.patch_cells
    out = torch.empty((B, vox.size_z_cells, P, P), dtype=torch.float32,
                      device=depths_b.device)
    if B == 0:
        return out
    _cuda.call("voxel_model", _cuda.ptr(depths_b), _cuda.ptr(table),
               _cuda.ptr(origins_yx), _cuda.ptr(out), B, P, P,
               *model_args(vox, cam), entry="voxel_image_launch")
    _cuda.count_launch("voxel_image")
    _cuda.note_cost("voxel_image", lambda: ledger.voxel_image_cost(
        vox, cam, poses_b, origins_yx))
    return out


@entry_point(static=("cam", "vox"))
def window_delta(vox: VoxelConfig, cam: DepthCamConfig,
                 depths_b: torch.Tensor, poses_b: torch.Tensor,
                 origin_yx: torch.Tensor) -> torch.Tensor:
    """Sum of all B images' deltas on ONE shared (Z, P, P) patch at
    origin_yx (2,) int32 [y0, x0]. The caller keeps the shared-patch
    contract (`window_fits`): evidence outside the patch is dropped."""
    _check(vox, cam)
    P = vox.patch_cells
    B = depths_b.shape[0]
    origins = origin_yx.to(torch.int32).reshape(1, 2).expand(
        max(B, 1), 2).contiguous()
    return _summed_delta(vox, cam, depths_b, poses_b, origins, P, P)


def _summed_delta(vox: VoxelConfig, cam: DepthCamConfig,
                  depths_b: torch.Tensor, poses_b: torch.Tensor,
                  origins_b: torch.Tensor, ny: int, nx: int) -> torch.Tensor:
    """The batch-summed (Z, ny, nx) delta at per-image origins, the shared
    body of window_delta and region_delta: one K7 launch per
    `_MAX_B_PER_CALL` images, subtotals added in order."""
    Z = vox.size_z_cells
    B = depths_b.shape[0]
    dev = depths_b.device
    if B == 0:
        return torch.zeros((Z, ny, nx), dtype=torch.float32, device=dev)
    if B > _MAX_B_PER_CALL:
        total = torch.zeros((Z, ny, nx), dtype=torch.float32, device=dev)
        for i in range(0, B, _MAX_B_PER_CALL):
            total = total + _summed_delta(
                vox, cam, depths_b[i:i + _MAX_B_PER_CALL],
                poses_b[i:i + _MAX_B_PER_CALL],
                origins_b[i:i + _MAX_B_PER_CALL], ny, nx)
        return total
    table = pose_table(poses_b)
    if dev.type == "cpu":
        return summed_delta_plain(vox, cam, depths_b, table, origins_b, ny,
                                  nx)
    _check_inputs(vox, cam, depths_b, table, origins_b)
    out = torch.empty((Z, ny, nx), dtype=torch.float32, device=dev)
    _cuda.call("voxel_model", _cuda.ptr(depths_b), _cuda.ptr(table),
               _cuda.ptr(origins_b), _cuda.ptr(out), B, ny, nx,
               *model_args(vox, cam), entry="voxel_summed_launch")
    _cuda.count_launch("voxel_summed")
    _cuda.note_cost("voxel_summed", lambda: ledger.voxel_summed_cost(
        vox, cam, poses_b, origins_b, ny, nx))
    return out


@entry_point(static=("cam", "nx", "ny", "vox"))
def region_delta(vox: VoxelConfig, cam: DepthCamConfig,
                 depths_b: torch.Tensor, poses_b: torch.Tensor, y0,
                 ny: int, nx: int) -> torch.Tensor:
    """Summed (Z, ny, nx) delta of B images over the region at rows
    y0.., cols 0.. (y0 an int or a 0-d tensor): the sharded Y-slab fuse's
    local step. No coverage contract: the slab keeps every update within
    the trust radius."""
    Z = vox.size_z_cells
    if not region_supported(vox, cam, ny, nx):
        raise ValueError(
            f"voxel region kernel unsupported: pitch="
            f"{cam.mount_pitch_rad}, H={cam.height_px}, Z={Z}, "
            f"ny*nx={ny * nx} % {COLS}")
    n = max(depths_b.shape[0], 1)
    dev = depths_b.device
    if isinstance(y0, torch.Tensor):
        ycol = y0.to(device=dev, dtype=torch.int32).reshape(1)
    else:
        ycol = torch.full((1,), int(y0), dtype=torch.int32, device=dev)
    origins = torch.stack([ycol.expand(n),
                           torch.zeros(n, dtype=torch.int32, device=dev)], 1)
    return _summed_delta(vox, cam, depths_b, poses_b, origins, ny, nx)


def window_fits(vox: VoxelConfig, poses_b: torch.Tensor,
                origin_yx: torch.Tensor) -> torch.Tensor:
    """0-d bool tensor: is every camera's max-range disc inside the shared
    patch at origin_yx?"""
    P = vox.patch_cells
    margin = vox.max_range_m / vox.resolution_m
    ox, oy, _ = vox.origin_m
    col = div(poses_b[:, 0] - ox, vox.resolution_m)
    row = div(poses_b[:, 1] - oy, vox.resolution_m)
    r0 = origin_yx[0].to(torch.float32)
    c0 = origin_yx[1].to(torch.float32)
    ok = ((row - margin >= r0) & (row + margin <= r0 + P)
          & (col - margin >= c0) & (col + margin <= c0 + P))
    return ok.all()


# ---------------------------------------------------------------------------
# The kernel engine's batch fuse
# ---------------------------------------------------------------------------

@entry_point(static=("cam", "vox"))
def fuse_depths(vox: VoxelConfig, cam: DepthCamConfig, grid: torch.Tensor,
                depths_b: torch.Tensor, poses_b: torch.Tensor
                ) -> torch.Tensor:
    """Kernel-engine batch fuse: per-image deltas (K6) in chunks of
    `voxel._FUSE_CHUNK` images, folded into one copy of the grid in b
    order without clamping, then one clamp. One host sync, for the patch
    origins. Returns `grid` itself when B = 0."""
    from jax_mapping_torch.ops import voxel as V
    V._check_patch_coverage(vox, cam)
    _check(vox, cam)
    B = depths_b.shape[0]
    if B == 0:
        return grid
    origins = V.patch_origin(vox, poses_b[:, :2]).contiguous()
    host = origins.tolist()
    P = vox.patch_cells
    out = grid.clone()
    for s in range(0, B, V._FUSE_CHUNK):
        e = min(B, s + V._FUSE_CHUNK)
        deltas = image_deltas(vox, cam, depths_b[s:e].contiguous(),
                              poses_b[s:e], origins[s:e])
        for i in range(e - s):
            y0, x0 = host[s + i]
            out[:, y0:y0 + P, x0:x0 + P] += deltas[i]
    return out.clamp_(vox.logodds_min, vox.logodds_max)
