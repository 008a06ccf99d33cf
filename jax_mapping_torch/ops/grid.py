"""Log-odds occupancy grid: patches, the inverse sensor model, fusion.

Port of the JAX package's `ops/grid.py` core. Each scan updates a P x P
patch around the robot with a dense per-cell inverse sensor model
(`classify_patch`); patches fold into the grid with sequential clamped
read-modify-writes, which keeps overlapping patches exact.

`classify_patch` and `raster_patch` are the plain PyTorch versions of
kernel K1 (`csrc/sensor_model.cu`, wrapped by `ops/sensor_kernel.py`).
They are batched over scans, run the same float operations in the same
order as the kernel, and are what the CPU path uses.

The fuse entry points return a new grid and leave their input unchanged,
as the JAX functions do; inside, the fold updates that copy in place.
`fuse_scans_masked` with a per-scan `tenant` index folds into a (T, N, N)
stack of grids (the tenant megabatch): every tenant's key scans go
through one K1 delta launch a sub-batch and one host read of the origins.
A shared-patch window (`fuse_scans_window`) goes through kernel K5 or K4
(`ops/fuse_kernel.py`, `ops/sensor_kernel.py`). The map-side functions
(`decay_grid`, `merge_delta`, `to_occupancy`, `to_gray`,
`downsample_gray`, `tile_hashes`, `occupancy_to_png_array`) follow at the
end.
"""

from __future__ import annotations

import dataclasses
import math
import threading
from typing import Optional, Tuple

import numpy as np
import torch

from jax_mapping_torch._util import const, div, entry_point
from jax_mapping_torch.config import GridConfig, ScanConfig
from jax_mapping_torch.ops import sensor_kernel as SK
from jax_mapping_torch.ops import trig


# ---------------------------------------------------------------------------
# World <-> grid transforms
# ---------------------------------------------------------------------------

def world_to_cell(grid: GridConfig, xy: torch.Tensor) -> torch.Tensor:
    """Continuous world metres (..., 2) -> continuous cell (col, row)."""
    return div(xy - const(grid.origin_m, xy.device), grid.resolution_m)


def cell_to_world(grid: GridConfig, cr: torch.Tensor) -> torch.Tensor:
    """Continuous cell (col, row) (..., 2) -> world metres; integer
    coordinates + 0.5 give the cell's centre."""
    return cr * grid.resolution_m + const(grid.origin_m, cr.device)


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


#: The calling thread's running count of scans its folds applied.
_FOLDED = threading.local()


def scans_folded() -> int:
    """Scans the calling thread's folds have applied so far (rows whose
    mask is False, padding included, are not applied). A caller reads it
    before and after a fusion to count that fusion's scans, with no
    device read: the fold already has the mask on the host."""
    return getattr(_FOLDED, "n", 0)


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
    _FOLDED.n = scans_folded() + sum(row[2] for row in host)
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
    from jax_mapping_torch.ops import fuse_kernel as FK
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


def fuse_scans_bucketed(grid_cfg: GridConfig, scan_cfg: ScanConfig,
                        grid_arr: torch.Tensor, ranges_b: torch.Tensor,
                        poses_b: torch.Tensor,
                        mask_b: Optional[torch.Tensor] = None
                        ) -> torch.Tensor:
    """`fuse_scans_masked` with the batch padded to its `_batch_bucket`
    with masked rows (exact: a masked scan adds nothing), so callers whose
    batch length churns launch one K1 batch shape per bucket. No mask:
    every scan contributes. B = 0 returns a copy of the grid."""
    B = ranges_b.shape[0]
    if B == 0:
        return grid_arr.clone()
    r, p, m = _pad_batch_to(_batch_bucket(B), ranges_b, poses_b, mask_b)
    return fuse_scans_masked(grid_cfg, scan_cfg, grid_arr, r, p, m)


@entry_point(static=("grid_cfg", "scan_cfg"))
def fuse_scan(grid_cfg: GridConfig, scan_cfg: ScanConfig,
              grid_arr: torch.Tensor, ranges: torch.Tensor,
              pose: torch.Tensor) -> torch.Tensor:
    """Fuse one scan (beams,) at pose (3,) into a copy of the grid."""
    out = grid_arr.clone()
    deltas, origins = _classify_batch(grid_cfg, scan_cfg, ranges[None],
                                      pose[None])
    _fold(grid_cfg, out, deltas, origins, None)
    return out


@entry_point(static=("grid_cfg", "scan_cfg"))
def fuse_scans(grid_cfg: GridConfig, scan_cfg: ScanConfig,
               grid_arr: torch.Tensor, ranges_b: torch.Tensor,
               poses_b: torch.Tensor) -> torch.Tensor:
    """Fuse (B, beams) scans at (B, 3) poses into a copy of the grid, each
    at its own patch, folded in b order (exact under overlap)."""
    out = grid_arr.clone()
    _classify_fold(grid_cfg, scan_cfg, out, ranges_b, poses_b, None)
    return out


@entry_point(static=("grid_cfg", "scan_cfg"))
def scan_deltas_full(grid_cfg: GridConfig, scan_cfg: ScanConfig,
                     ranges_b: torch.Tensor,
                     poses_b: torch.Tensor) -> torch.Tensor:
    """A batch of scans -> one full-size log-odds delta grid, unclamped
    (the fleet merge path adds it to the map with `merge_delta`)."""
    out = empty_grid(grid_cfg, ranges_b.device)
    _classify_fold(grid_cfg, scan_cfg, out, ranges_b, poses_b, None,
                   clamp=False)
    return out


@entry_point(static=("grid_cfg", "scan_cfg"))
def fuse_scans_window(grid_cfg: GridConfig, scan_cfg: ScanConfig,
                      grid_arr: torch.Tensor, ranges_b: torch.Tensor,
                      poses_b: torch.Tensor) -> torch.Tensor:
    """Fuse a temporal scan window (one robot's consecutive scans) into a
    copy of the grid: all B scans share one patch, snapped from their mean
    pose, and the grid sees one clamped read-modify-write (the clamp
    applies once per window, not per scan). Every pose must fit the patch
    (`SK.window_fits`); `fuse_scans_window_checked` checks it.

    `GridConfig.fused_fusion` True goes to `fuse_kernel.window_fused`
    (kernel K5, or K4 subtotals above 512 scans); False sums the window
    with kernel K4 and applies it with `apply_patch`, as the JAX package
    does on a TPU. The two give the same grid."""
    from jax_mapping_torch.ops import fuse_kernel as FK
    origin = patch_origin(grid_cfg, poses_b[:, :2].mean(dim=0))
    if grid_cfg.fused_fusion:
        return FK.window_fused(grid_cfg, scan_cfg, grid_arr, ranges_b,
                               poses_b, origin)
    delta = SK.window_delta(grid_cfg, scan_cfg, ranges_b, poses_b, origin)
    out = grid_arr.clone()
    apply_patch(grid_cfg, out, delta, *FK._patch_start(grid_cfg, origin))
    return out


@entry_point(static=("grid_cfg", "scan_cfg"))
def fuse_scans_window_checked(grid_cfg: GridConfig, scan_cfg: ScanConfig,
                              grid_arr: torch.Tensor, ranges_b: torch.Tensor,
                              poses_b: torch.Tensor) -> torch.Tensor:
    """`fuse_scans_window` that cannot silently lose evidence: a window
    whose poses do not fit the shared patch (`SK.window_fits`) takes the
    exact per-scan fold (`fuse_scans`) instead. The JAX `lax.cond`
    becomes a Python `if`, which reads the check on the host: one sync."""
    origin = patch_origin(grid_cfg, poses_b[:, :2].mean(dim=0))
    if bool(SK.window_fits(grid_cfg, poses_b, origin)):
        return fuse_scans_window(grid_cfg, scan_cfg, grid_arr, ranges_b,
                                 poses_b)
    return fuse_scans(grid_cfg, scan_cfg, grid_arr, ranges_b, poses_b)


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

@entry_point
def decay_grid(grid_arr: torch.Tensor, factor: float,
               cap: float) -> torch.Tensor:
    """One map-healing pass: every cell's log-odds times `factor`, clamped
    to +-`cap`, in float32 arithmetic (as JAX's `jnp.float32(factor)`)."""
    f, c = (grid_arr.new_full((), v) for v in (factor, cap))
    return torch.clamp(grid_arr * f, -c, c)


def merge_delta(grid_cfg: GridConfig, grid_arr: torch.Tensor,
                delta_full: torch.Tensor) -> torch.Tensor:
    """Apply a full-size delta (e.g. the sum of a fleet's deltas)."""
    return torch.clamp(grid_arr + delta_full, grid_cfg.logodds_min,
                       grid_cfg.logodds_max)


def _select3(a: torch.Tensor, b: torch.Tensor, va: int, vb: int,
             vc: int, dtype) -> torch.Tensor:
    """va where a, else vb where b, else vc, as `dtype` (no mask
    indexing, which would read a count back from the device). Filled in
    `dtype` itself: `torch.where` on Python scalars builds int64 arrays,
    eight times the bytes of a uint8 image."""
    out = torch.full(a.shape, vc, dtype=dtype, device=a.device)
    return out.masked_fill_(b, vb).masked_fill_(a, va)


@entry_point(static=("grid_cfg",))
def to_occupancy(grid_cfg: GridConfig, grid_arr: torch.Tensor
                 ) -> torch.Tensor:
    """Log-odds -> int8 {-1 unknown, 0 free, 100 occupied}."""
    return _select3(grid_arr > grid_cfg.occ_threshold,
                    grid_arr < grid_cfg.free_threshold, 100, 0, -1,
                    torch.int8)


@entry_point(static=("grid_cfg",))
def to_gray(grid_cfg: GridConfig, grid_arr: torch.Tensor) -> torch.Tensor:
    """Log-odds -> uint8 gray in grid orientation (row 0 = min-y): 127
    unknown, 255 free, 0 occupied."""
    return _select3(grid_arr > grid_cfg.occ_threshold,
                    grid_arr < grid_cfg.free_threshold, 0, 255, 127,
                    torch.uint8)


@entry_point
def downsample_gray(img: torch.Tensor) -> torch.Tensor:
    """uint8 gray image -> 2x coarser by block priority: occupied (0) >
    free (255) > unknown (127)."""
    rank = _select3(img == 0, img == 255, 0, 1, 2, torch.uint8)
    n0, n1 = img.shape
    blk = rank.reshape(n0 // 2, 2, n1 // 2, 2).amin(dim=(1, 3))
    return _select3(blk == 0, blk == 1, 0, 255, 127, torch.uint8)


_MASK32 = 0xFFFFFFFF


def _mul32(v: torch.Tensor, w) -> torch.Tensor:
    """(v * w) mod 2^32 for int64 values (tensor or int) in [0, 2^32),
    without an int64 overflow: v is split into 16-bit halves, so each
    partial product stays below 2^48."""
    lo = (v & 0xFFFF) * w
    hi = (((v >> 16) * w) & 0xFFFF) << 16
    return (lo + hi) & _MASK32


#: Cells a `tile_hashes` chunk covers (whole tile rows, at least one):
#: each int64 temporary of a chunk is 16 MB, so a hash's device peak stays
#: near a few times that however large the image is.
_HASH_CHUNK_CELLS = 1 << 21


@entry_point(static=("tile_cells",))
def tile_hashes(arr: torch.Tensor, tile_cells: int) -> torch.Tensor:
    """(H, W) array -> (H//t, W//t, 2) per-tile content hashes: the JAX
    package's two multiplicative-weight uint32 lanes, with wraparound.
    PyTorch's uint32 arithmetic is partial, so the lanes are computed in
    int64 with each product reduced mod 2^32 and the tile sums (< 2^48
    for a 256^2 tile) reduced after; the values are those of the uint32
    lanes, held in an int64 tensor. Float arrays hash their bit
    patterns. A tile's hash depends on its own cells only, so the rows
    of tiles are hashed in chunks of `_HASH_CHUNK_CELLS`."""
    h, w = arr.shape
    if h % tile_cells or w % tile_cells:
        raise ValueError(f"array shape ({h}, {w}) not divisible by "
                         f"tile_cells={tile_cells}")
    idx = torch.arange(tile_cells * tile_cells, dtype=torch.int64,
                       device=arr.device).reshape(tile_cells, tile_cells)
    w1 = (_mul32(idx, 2654435761) + 0x9E3779B9) & _MASK32
    w2 = (_mul32(idx ^ 0x85EBCA6B, 2246822519) + 1) & _MASK32
    rows = max(1, _HASH_CHUNK_CELLS // (tile_cells * w)) * tile_cells
    parts = [_tile_row_hashes(arr[r:r + rows], tile_cells, w1, w2)
             for r in range(0, h, rows)]
    return parts[0] if len(parts) == 1 else torch.cat(parts)


def _tile_row_hashes(arr: torch.Tensor, tile_cells: int, w1: torch.Tensor,
                     w2: torch.Tensor) -> torch.Tensor:
    """`tile_hashes` of whole rows of tiles, with the lane weights."""
    if arr.is_floating_point():
        v = arr.to(torch.float32).view(torch.int32).to(torch.int64)
    else:
        v = arr.to(torch.int64)
    v = v & _MASK32
    th, tw = arr.shape[0] // tile_cells, arr.shape[1] // tile_cells
    tv = v.reshape(th, tile_cells, tw, tile_cells).permute(0, 2, 1, 3)
    h1 = _mul32(tv, w1).sum(dim=(2, 3)) & _MASK32
    h2 = _mul32(tv, w2).sum(dim=(2, 3)) & _MASK32
    return torch.stack([h1, h2], dim=-1)


def occupancy_to_png_array(occ_int8) -> np.ndarray:
    """int8 occupancy (a tensor or an array) -> uint8 grayscale image:
    127 unknown, 255 free, 0 occupied, flipped so that row 0 is the top
    (max-y) row. Host numpy."""
    if torch.is_tensor(occ_int8):
        occ_int8 = occ_int8.detach().cpu().numpy()
    data = np.asarray(occ_int8, dtype=np.int8)
    img = np.full(data.shape, 127, dtype=np.uint8)
    img[data == 0] = 255
    img[data == 100] = 0
    return np.flipud(img)
