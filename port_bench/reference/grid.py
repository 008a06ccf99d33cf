"""The log-odds grid and the inverse sensor model in plain PyTorch: the
part of the port's `ops/grid.py` that the fleet tick runs, frozen."""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch

from ._util import const, div, entry_point
from .config import GridConfig, ScanConfig
from . import sensor_kernel as SK
from . import trig


# ---------------------------------------------------------------------------
# World <-> grid transforms
# ---------------------------------------------------------------------------

def world_to_cell(grid: GridConfig, xy: torch.Tensor) -> torch.Tensor:
    """Continuous world metres (..., 2) -> continuous cell (col, row)."""
    return div(xy - const(grid.origin_m, xy.device), grid.resolution_m)


def empty_grid(grid: GridConfig, device) -> torch.Tensor:
    """Fresh all-unknown (log-odds 0) grid."""
    return torch.zeros((grid.size_cells, grid.size_cells),
                       dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# Scan sanitation
# ---------------------------------------------------------------------------

def sanitize_ranges(scan_cfg: ScanConfig, ranges: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., padded_beams) raw ranges -> (ranges_m, hit_mask).

    Zero readings become `invalid_range_m` and are not hits; readings
    outside [range_min, range_max] are not hits but still carve; padded
    tail beams carve nothing."""
    if ranges.shape[-1] != scan_cfg.padded_beams:
        raise ValueError(
            f"scan has {ranges.shape[-1]} beams, config expects "
            f"padded_beams={scan_cfg.padded_beams}")
    idx = torch.arange(ranges.shape[-1], device=ranges.device)
    in_beam = idx < scan_cfg.n_beams
    r = ranges.to(torch.float32)
    is_zero = r <= 0.0
    r = torch.where(is_zero, scan_cfg.invalid_range_m, r)
    hit = (~is_zero & (r >= scan_cfg.range_min_m)
           & (r <= scan_cfg.range_max_m) & in_beam)
    r = torch.where(in_beam, r, 0.0)
    return r, hit


# ---------------------------------------------------------------------------
# Patch origin
# ---------------------------------------------------------------------------

def patch_origin(grid: GridConfig, pose_xy: torch.Tensor) -> torch.Tensor:
    """(..., 2) world xy -> (..., 2) int32 [row0, col0] of the update
    patch, snapped to (align_rows, align_cols) and clipped to the grid."""
    ar, ac = grid.align_rows, grid.align_cols
    cr = world_to_cell(grid, pose_xy)
    col0 = torch.round(div(cr[..., 0] - grid.patch_cells / 2, ac)
                       ).to(torch.int32) * ac
    row0 = torch.round(div(cr[..., 1] - grid.patch_cells / 2, ar)
                       ).to(torch.int32) * ar
    hi = grid.size_cells - grid.patch_cells
    return torch.stack([row0.clamp(0, hi), col0.clamp(0, hi)], dim=-1)


# ---------------------------------------------------------------------------
# Dense inverse sensor model over a batch of patches (plain K1)
# ---------------------------------------------------------------------------

def full_circle(scan_cfg: ScanConfig) -> bool:
    """True when the beams cover 2*pi, so the wrap beam aliases beam 0."""
    inc = scan_cfg.angle_increment_rad
    return abs(scan_cfg.n_beams * inc - 2.0 * math.pi) < inc / 2


def patch_geometry(grid: GridConfig, scan_cfg: ScanConfig,
                   poses: torch.Tensor, origins_rc: torch.Tensor):
    """Per-cell (r_cell_m, beam_index, in_fov), each (B, P, P), for B
    patches at origins_rc (B, 2) seen from poses (B, 3)."""
    P = grid.patch_cells
    res = grid.resolution_m
    ox, oy = grid.origin_m
    ar = torch.arange(P, dtype=torch.int32, device=poses.device)
    rows = origins_rc[:, 0:1].to(torch.int32) + ar               # (B, P)
    cols = origins_rc[:, 1:2].to(torch.int32) + ar
    ys = (rows.to(torch.float32) + 0.5) * res + oy
    xs = (cols.to(torch.float32) + 0.5) * res + ox
    dx = xs[:, None, :] - poses[:, 0, None, None]                 # (B, 1, P)
    dy = ys[:, :, None] - poses[:, 1, None, None]                 # (B, P, 1)
    r_cell = torch.sqrt(dx * dx + dy * dy)                        # (B, P, P)

    theta = trig.atan2(dy, dx) - poses[:, 2, None, None]
    if not scan_cfg.counterclockwise:
        theta = -theta
    theta = theta - scan_cfg.angle_min_rad
    # jnp.mod: fmod, then add the divisor where the result is negative.
    two_pi = 2.0 * math.pi
    theta = torch.fmod(theta, two_pi)
    theta = torch.where(theta < 0.0, theta + two_pi, theta)

    beam_raw = torch.round(div(theta, scan_cfg.angle_increment_rad)
                           ).to(torch.int32)
    beam = torch.remainder(beam_raw, scan_cfg.n_beams)
    if full_circle(scan_cfg):
        in_fov = torch.ones_like(beam, dtype=torch.bool)
    else:
        in_fov = beam_raw <= scan_cfg.n_beams - 1
    return r_cell, beam, in_fov


def _lookup(table: torch.Tensor, beam: torch.Tensor) -> torch.Tensor:
    """table (B, beams)[beam (B, P, P)] per scan."""
    B = beam.shape[0]
    return torch.gather(table, 1, beam.reshape(B, -1).to(torch.int64)
                        ).reshape(beam.shape)


def classify_patch(grid: GridConfig, scan_cfg: ScanConfig,
                   ranges: torch.Tensor, poses: torch.Tensor,
                   origins_rc: torch.Tensor) -> torch.Tensor:
    """(B, padded_beams) ranges at (B, 3) poses -> (B, P, P) log-odds
    deltas on patches at (B, 2) origins: occ on the hit band, free short
    of the carve limit, 0 elsewhere."""
    res = grid.resolution_m
    r_m, hit = sanitize_ranges(scan_cfg, ranges)
    r_cell, beam, in_fov = patch_geometry(grid, scan_cfg, poses, origins_rc)
    z = _lookup(r_m, beam)
    beam_hit = _lookup(hit, beam) & in_fov

    tol = grid.hit_tolerance_cells * res
    max_r = grid.max_range_m
    carve = torch.clamp_max(torch.where(z > 0.0, z, 0.0), max_r)
    free = (r_cell < carve - tol) & (r_cell > scan_cfg.range_min_m) & in_fov
    occ = beam_hit & (torch.abs(r_cell - z) <= tol) & (r_cell <= max_r)
    return torch.where(occ, grid.logodds_occ,
                       torch.where(free, grid.logodds_free, 0.0)
                       ).to(torch.float32)


def raster_patch(grid: GridConfig, scan_cfg: ScanConfig,
                 ranges: torch.Tensor, poses: torch.Tensor,
                 origins_rc: torch.Tensor) -> torch.Tensor:
    """Soft scan rasters (B, P, P): max(0, 1 - |r_cell - z| / res) on hit
    beams within max range, no free-space carving (the matcher's)."""
    r_m, hit = sanitize_ranges(scan_cfg, ranges)
    r_cell, beam, in_fov = patch_geometry(grid, scan_cfg, poses, origins_rc)
    z = _lookup(r_m, beam)
    keep = _lookup(hit, beam) & in_fov & (r_cell <= grid.max_range_m)
    w = torch.clamp_min(1.0 - div(torch.abs(r_cell - z), grid.resolution_m),
                        0.0)
    return torch.where(keep, w, 0.0).to(torch.float32)


# ---------------------------------------------------------------------------
# Folding patches into the global grid
# ---------------------------------------------------------------------------

def apply_patch(grid_cfg: GridConfig, grid_arr: torch.Tensor,
                delta: torch.Tensor, row0: int, col0: int,
                clamp: bool = True) -> None:
    """grid[row0:row0+P, col0:col0+P] += delta, clamped to the log-odds
    bounds unless `clamp` is False. Updates `grid_arr` in place (the JAX
    version returns a new array; in place saves a full-grid copy per
    scan)."""
    P = grid_cfg.patch_cells
    sl = grid_arr[row0:row0 + P, col0:col0 + P]
    sl.add_(delta)
    if clamp:
        sl.clamp_(grid_cfg.logodds_min, grid_cfg.logodds_max)


def _classify_batch(grid_cfg: GridConfig, scan_cfg: ScanConfig,
                    ranges_b: torch.Tensor, poses_b: torch.Tensor):
    """Batched inverse sensor model through kernel K1: (deltas, origins)."""
    origins = patch_origin(grid_cfg, poses_b[:, :2])
    deltas = SK.scan_deltas(grid_cfg, scan_cfg, ranges_b, poses_b, origins)
    return deltas, origins


def _fold(grid_cfg: GridConfig, grid_arr: torch.Tensor,
          deltas: torch.Tensor, origins: torch.Tensor,
          mask_b: Optional[torch.Tensor], clamp: bool = True,
          tenant: Optional[torch.Tensor] = None) -> None:
    """Apply patches in b order, in place (exact under overlap); with
    `tenant`, scan b into grid tenant[b] of a (T, N, N) stack.

    The patch origins, the mask and the tenant index come to the host
    once per call (one device sync) because slicing needs Python
    integers. A scan whose mask is False is skipped: the JAX fold adds
    its delta times 0, which leaves an in-range cell unchanged, so
    skipping is exact."""
    B = deltas.shape[0]
    cols = [origins.to(torch.int32),
            torch.ones((B, 1), dtype=torch.int32, device=origins.device)
            if mask_b is None else mask_b.to(torch.int32)[:, None]]
    if tenant is not None:
        cols.append(tenant.to(torch.int32)[:, None])
    host = torch.cat(cols, dim=1).tolist()
    for b, row in enumerate(host):
        if row[2]:
            apply_patch(grid_cfg, grid_arr if tenant is None
                        else grid_arr[row[3]], deltas[b], row[0], row[1],
                        clamp)


# Scans per fold chunk; the fused engine streams each chunk in
# `fuse_kernel._STREAM_CHUNK` sub-batches.
_FUSE_CHUNK = 256


def _batch_bucket(n: int) -> int:
    """Smallest of {2^k} ∪ {3·2^(k-1)} >= n: the scan-batch bucket."""
    if n <= 2:
        return max(n, 1)
    p = 1 << (n - 1).bit_length()
    mid = 3 * (p // 4)
    return mid if mid >= n else p


def _pad_batch_to(bucket: int, ranges_b: torch.Tensor, poses_b: torch.Tensor,
                  mask_b: Optional[torch.Tensor]):
    """Pad a scan batch to `bucket` rows with mask=0 entries: zero ranges,
    poses copying the last real row, mask False."""
    B = ranges_b.shape[0]
    dev = ranges_b.device
    m = (torch.ones(B, dtype=torch.bool, device=dev) if mask_b is None
         else mask_b.to(torch.bool))
    pad = bucket - B
    if pad <= 0:
        return ranges_b, poses_b, m
    return (
        torch.cat([ranges_b, ranges_b.new_zeros((pad, ranges_b.shape[1]))]),
        torch.cat([poses_b, poses_b[B - 1:B].expand(pad, poses_b.shape[1])]),
        torch.cat([m, torch.zeros(pad, dtype=torch.bool, device=dev)]),
    )


def _classify_fold(grid_cfg: GridConfig, scan_cfg: ScanConfig,
                   grid_arr: torch.Tensor, ranges_b: torch.Tensor,
                   poses_b: torch.Tensor, mask_b: Optional[torch.Tensor],
                   clamp: bool = True,
                   tenant: Optional[torch.Tensor] = None) -> None:
    """Chunked classify -> fold over the batch, in place on `grid_arr`.

    Chunks of `_FUSE_CHUNK` scans; the remainder is padded to its
    `_batch_bucket` with masked rows. Each chunk is streamed through
    `fuse_kernel.stream_fold` in sub-batches, so at most `_STREAM_CHUNK`
    deltas are live at once. This is the JAX package's `fused_fusion`
    engine; its other engine classifies a whole chunk before folding the
    same deltas in the same order, so it gives the same grid and the port
    has only the streaming one. `tenant` as in `_fold`."""
    from . import fuse_kernel as FK
    B = ranges_b.shape[0]
    if B == 0:
        return

    def part(x, sl):
        return None if x is None else x[sl]

    CB = min(_FUSE_CHUNK, B)
    nc, rem = B // CB, B % CB
    for k in range(nc):
        sl = slice(k * CB, (k + 1) * CB)
        FK.stream_fold(grid_cfg, scan_cfg, grid_arr, ranges_b[sl],
                       poses_b[sl], part(mask_b, sl), clamp,
                       part(tenant, sl))
    if rem:
        bucket = min(_batch_bucket(rem), CB)
        sl = slice(B - rem, B)
        r, p, m = _pad_batch_to(bucket, ranges_b[sl], poses_b[sl],
                                part(mask_b, sl))
        if bucket == rem and mask_b is None:
            m = None
        t = part(tenant, sl)
        if t is not None and bucket > rem:        # padded rows are masked
            t = torch.cat([t, t[-1:].expand(bucket - rem)])
        FK.stream_fold(grid_cfg, scan_cfg, grid_arr, r, p, m, clamp, t)


@entry_point(static=("grid_cfg", "scan_cfg"))
def fuse_scans_masked(grid_cfg: GridConfig, scan_cfg: ScanConfig,
                      grid_arr: torch.Tensor, ranges_b: torch.Tensor,
                      poses_b: torch.Tensor, mask_b: torch.Tensor,
                      tenant: Optional[torch.Tensor] = None
                      ) -> torch.Tensor:
    """Fuse (B, beams) scans at (B, 3) poses into a copy of the grid;
    scan b contributes iff mask_b[b]. With `tenant` (B,), `grid_arr` is a
    (T, N, N) stack and scan b folds into grid tenant[b]. Returns the new
    grid."""
    out = grid_arr.clone()
    _classify_fold(grid_cfg, scan_cfg, out, ranges_b, poses_b,
                   mask_b.to(torch.bool), tenant=tenant)
    return out


# ---------------------------------------------------------------------------
# Coarse view (loop-closure wide search)
# ---------------------------------------------------------------------------

def coarse_grid_config(grid_cfg: GridConfig, factor: int) -> GridConfig:
    """A GridConfig viewing the same world at `factor`x coarser resolution
    with the same patch cell count."""
    if grid_cfg.size_cells % factor:
        raise ValueError(f"size_cells={grid_cfg.size_cells} not divisible "
                         f"by coarse factor {factor}")
    size = grid_cfg.size_cells // factor
    return dataclasses.replace(
        grid_cfg, size_cells=size,
        resolution_m=grid_cfg.resolution_m * factor,
        patch_cells=min(grid_cfg.patch_cells, size))


@entry_point(static=("factor",))
def downsample_max(grid_arr: torch.Tensor, factor: int) -> torch.Tensor:
    """Log-odds grid -> factor x coarser by block max."""
    n0, n1 = grid_arr.shape
    return grid_arr.reshape(n0 // factor, factor, n1 // factor,
                            factor).amax(dim=(1, 3))


# ---------------------------------------------------------------------------
# Map-side functions: decay, merge, export, serving tiles
# ---------------------------------------------------------------------------


_MASK32 = 0xFFFFFFFF


#: Cells a `tile_hashes` chunk covers (whole tile rows, at least one):
#: each int64 temporary of a chunk is 16 MB, so a hash's device peak stays
#: near a few times that however large the image is.
_HASH_CHUNK_CELLS = 1 << 21


