"""Kernels K1 and K4: the inverse sensor model on Hopper.

Replaces the JAX package's Pallas kernel
`ops/sensor_kernel.py::_per_scan_call` (the `_make_kernel` body, reached
through `scan_deltas` for log-odds deltas and `scan_rasters` for the
matcher's soft rasters). CUDA source: `csrc/sensor_model.cu`, one kernel
templated on the mode.

What bounds it on an H100: the (B, P, P) f32 output, written once
(1.6 MB per scan at P = 640); the function's ~55 float operations per
cell within max range take a third of that time. Most of the output is a
constant (a raster is non-zero only within a cell of a hit on the cell's
own beam; a delta is 0 or exactly `lo_free` on most of the patch), so the
kernel decides the constant per 16 x 16 tile and scan before any per-cell
work (`tile_classes_plain` below mirrors that class) and writes constant
tiles with 16-byte stores; only the remaining tiles run the per-cell model.

Kernel K4 (`window_delta`, CUDA source `csrc/window_fuse.cu`) replaces
the accumulating form of the same Pallas kernel, `window_delta`: the sum
of B scans' deltas on one shared patch, added in b order. It is bound by
the classification, ~55 float operations per cell and scan within range;
each block classifies its tile for every scan first, then each thread
keeps its cells' sums in registers and loops over the scans, skipping the
constant ones (see the source). Both kernels classify a cell and a tile
with the same device code (`csrc/sensor_cell.cuh`).

On a CPU tensor the wrappers run the plain PyTorch versions
(`grid.classify_patch`, `grid.raster_patch`, `window_delta_plain`), which
do the same float operations in the same order; on a CUDA tensor they
launch the kernel or raise.
"""

from __future__ import annotations

import math

import torch

from jax_mapping_torch._util import const, div, entry_point
from jax_mapping_torch.config import GridConfig, ScanConfig
from jax_mapping_torch.obs import ledger
from jax_mapping_torch.ops import _cuda

#: Scans of one window kernel launch; larger windows are summed as
#: subtotals of this many scans, added in order, as the JAX package's TPU
#: engine does (its scoped-SMEM ceiling). The port keeps the split so
#: that both give the same sums.
_MAX_B_PER_CALL = 512

#: Scans classified at once by the plain window sum (bounds its transient
#: (n, P, P) deltas).
_PLAIN_CHUNK = 64


def scan_deltas_plain(grid_cfg: GridConfig, scan_cfg: ScanConfig,
                      ranges_b, poses_b, origins_rc) -> torch.Tensor:
    """Plain PyTorch version of K1 in delta mode."""
    from jax_mapping_torch.ops import grid as G
    return G.classify_patch(grid_cfg, scan_cfg, ranges_b, poses_b,
                            origins_rc)


def scan_rasters_plain(grid_cfg: GridConfig, scan_cfg: ScanConfig,
                       ranges_b, poses_b, origins_rc) -> torch.Tensor:
    """Plain PyTorch version of K1 in raster mode."""
    from jax_mapping_torch.ops import grid as G
    return G.raster_patch(grid_cfg, scan_cfg, ranges_b, poses_b, origins_rc)


@entry_point(static=("grid_cfg", "scan_cfg"))
def scan_deltas(grid_cfg: GridConfig, scan_cfg: ScanConfig,
                ranges_b: torch.Tensor, poses_b: torch.Tensor,
                origins_rc: torch.Tensor) -> torch.Tensor:
    """Per-scan (B, P, P) log-odds deltas, one patch origin per scan."""
    if ranges_b.device.type == "cpu":
        return scan_deltas_plain(grid_cfg, scan_cfg, ranges_b, poses_b,
                                 origins_rc)
    return _launch(grid_cfg, scan_cfg, ranges_b, poses_b, origins_rc,
                   raster=False)


@entry_point(static=("grid_cfg", "scan_cfg"))
def scan_rasters(grid_cfg: GridConfig, scan_cfg: ScanConfig,
                 ranges_b: torch.Tensor, poses_b: torch.Tensor,
                 origins_rc: torch.Tensor) -> torch.Tensor:
    """Soft (B, P, P) scan rasters at continuous candidate poses."""
    if ranges_b.device.type == "cpu":
        return scan_rasters_plain(grid_cfg, scan_cfg, ranges_b, poses_b,
                                  origins_rc)
    return _launch(grid_cfg, scan_cfg, ranges_b, poses_b, origins_rc,
                   raster=True)


#: Largest scan count of one launch (the grid's y dimension).
_MAX_B_PER_LAUNCH = 65535


@entry_point(static=("grid_cfg", "scan_cfg", "raster"))
def _launch(grid_cfg: GridConfig, scan_cfg: ScanConfig,
            ranges_b: torch.Tensor, poses_b: torch.Tensor,
            origins_rc: torch.Tensor, raster: bool) -> torch.Tensor:
    B = ranges_b.shape[0]
    P = grid_cfg.patch_cells
    nb = scan_cfg.padded_beams
    _cuda.check_cuda(ranges_b, "ranges_b", torch.float32, (B, nb))
    _cuda.check_cuda(poses_b, "poses_b", torch.float32, (B, 3))
    _cuda.check_cuda(origins_rc, "origins_rc", torch.int32, (B, 2))
    if B > _MAX_B_PER_LAUNCH:
        raise ValueError(f"{B} scans in one call; at most "
                         f"{_MAX_B_PER_LAUNCH}")
    out = torch.empty((B, P, P), dtype=torch.float32,
                      device=ranges_b.device)
    if B == 0:
        return out
    _cuda.call(
        "sensor_model", int(raster), _cuda.ptr(ranges_b), _cuda.ptr(poses_b),
        _cuda.ptr(origins_rc), _cuda.ptr(out), B, P, nb,
        *model_args(grid_cfg, scan_cfg))
    kernel = "sensor_model_raster" if raster else "sensor_model_delta"
    _cuda.count_launch(kernel)
    _cuda.note_cost(kernel, lambda: ledger.sensor_model_cost(
        grid_cfg, scan_cfg, ranges_b, poses_b, origins_rc))
    return out


def model_args(grid_cfg: GridConfig, scan_cfg: ScanConfig) -> tuple:
    """The sensor model's scalars in the kernels' C argument order
    (`sensor_cell::Params`)."""
    from jax_mapping_torch.ops.grid import full_circle
    ox, oy = grid_cfg.origin_m
    return (scan_cfg.n_beams, grid_cfg.resolution_m, ox, oy,
            scan_cfg.angle_increment_rad, scan_cfg.angle_min_rad,
            int(scan_cfg.counterclockwise), int(full_circle(scan_cfg)),
            scan_cfg.invalid_range_m, scan_cfg.range_min_m,
            scan_cfg.range_max_m, grid_cfg.max_range_m,
            grid_cfg.hit_tolerance_cells * grid_cfg.resolution_m,
            grid_cfg.logodds_occ, grid_cfg.logodds_free)


# ---------------------------------------------------------------------------
# Shared-patch window (kernel K4)
# ---------------------------------------------------------------------------

def window_delta_plain(grid_cfg: GridConfig, scan_cfg: ScanConfig,
                       ranges_b: torch.Tensor, poses_b: torch.Tensor,
                       origin_rc: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K4: the (P, P) sum, from 0 in b order, of
    `grid.classify_patch` of every scan at the one origin (2,)."""
    from jax_mapping_torch.ops import grid as G
    P = grid_cfg.patch_cells
    B = ranges_b.shape[0]
    acc = torch.zeros((P, P), dtype=torch.float32, device=ranges_b.device)
    for s in range(0, B, _PLAIN_CHUNK):
        e = min(B, s + _PLAIN_CHUNK)
        origins = origin_rc.to(torch.int32).reshape(1, 2).expand(e - s, 2)
        deltas = G.classify_patch(grid_cfg, scan_cfg, ranges_b[s:e],
                                  poses_b[s:e], origins)
        for d in deltas:
            acc = acc + d
    return acc


@entry_point(static=("grid_cfg", "scan_cfg"))
def window_delta(grid_cfg: GridConfig, scan_cfg: ScanConfig,
                 ranges_b: torch.Tensor, poses_b: torch.Tensor,
                 origin_rc: torch.Tensor) -> torch.Tensor:
    """Sum of all B scans' log-odds deltas on one shared (P, P) patch at
    origin_rc (2,) int32 [row0, col0]; every pose must fit the patch
    (`window_fits`). B = 0 gives zeros; B > `_MAX_B_PER_CALL` is summed
    as subtotals of that many scans, `total = total + chunk` in order."""
    P = grid_cfg.patch_cells
    B = ranges_b.shape[0]
    if B == 0:
        return torch.zeros((P, P), dtype=torch.float32,
                           device=ranges_b.device)
    if B > _MAX_B_PER_CALL:
        total = torch.zeros((P, P), dtype=torch.float32,
                            device=ranges_b.device)
        for i in range(0, B, _MAX_B_PER_CALL):
            total = total + window_delta(
                grid_cfg, scan_cfg, ranges_b[i:i + _MAX_B_PER_CALL],
                poses_b[i:i + _MAX_B_PER_CALL], origin_rc)
        return total
    if ranges_b.device.type == "cpu":
        return window_delta_plain(grid_cfg, scan_cfg, ranges_b, poses_b,
                                  origin_rc)
    _check_window(grid_cfg, scan_cfg, ranges_b, poses_b, origin_rc)
    out = torch.empty((P, P), dtype=torch.float32, device=ranges_b.device)
    _cuda.call("window_fuse", _cuda.ptr(ranges_b), _cuda.ptr(poses_b), B,
               _cuda.ptr(origin_rc), _cuda.ptr(out), grid_cfg.size_cells,
               P, scan_cfg.padded_beams, *model_args(grid_cfg, scan_cfg),
               entry="window_delta_launch")
    _cuda.count_launch("window_delta")
    _cuda.note_cost("window_delta", lambda: ledger.window_delta_cost(
        grid_cfg, scan_cfg, ranges_b, poses_b, origin_rc))
    return out


def _check_window(grid_cfg: GridConfig, scan_cfg: ScanConfig,
                  ranges_b: torch.Tensor, poses_b: torch.Tensor,
                  origin_rc: torch.Tensor) -> None:
    """The window kernels' input checks (K4 and K5)."""
    B = ranges_b.shape[0]
    _cuda.check_cuda(ranges_b, "ranges_b", torch.float32,
                     (B, scan_cfg.padded_beams))
    _cuda.check_cuda(poses_b, "poses_b", torch.float32, (B, 3))
    _cuda.check_cuda(origin_rc, "origin_rc", torch.int32, (2,))
    if grid_cfg.patch_cells > grid_cfg.size_cells:
        raise ValueError("patch larger than the grid")


def window_fits(grid_cfg: GridConfig, poses_b: torch.Tensor,
                origin_rc: torch.Tensor) -> torch.Tensor:
    """0-d bool tensor: does every pose's max-range disc fit in the patch
    at origin_rc? The window kernels drop evidence outside the shared
    patch, so callers check this (or use
    `grid.fuse_scans_window_checked`, which falls back to the per-scan
    fold)."""
    P = grid_cfg.patch_cells
    margin = grid_cfg.max_range_cells
    cr = div(poses_b[:, :2] - const(grid_cfg.origin_m, poses_b.device),
             grid_cfg.resolution_m)
    col, row = cr[:, 0], cr[:, 1]
    r0 = origin_rc[0].to(torch.float32)
    c0 = origin_rc[1].to(torch.float32)
    ok = ((row - margin >= r0) & (row + margin <= r0 + P)
          & (col - margin >= c0) & (col + margin <= c0 + P))
    return ok.all()


# ---------------------------------------------------------------------------
# Per-(tile, scan) class: the plain mirror of csrc/sensor_cell.cuh
# ---------------------------------------------------------------------------

#: Class codes of `sensor_cell::tile_class`, in order: every cell 0 beyond
#: max range; every cell 0 for want of a hit (and, for deltas, of carving)
#: near it; every cell exactly `logodds_free`; the per-cell model.
TILE_CLASSES = ("zero", "no_hit", "uniform_free", "per_cell")
ZERO, NO_HIT, FREE, PER_CELL = range(4)

#: Edge of the kernels' square tiles (cells).
TILE = 16

#: Largest |yaw| the class handles (`sensor_cell::kMaxYaw`).
_MAX_YAW = 64.0

#: Scans classified at once by the plain class (bounds its transient
#: (n, T, T, n_beams) masks).
_CLASS_CHUNK = 8


def tile_classes_plain(grid_cfg: GridConfig, scan_cfg: ScanConfig,
                       ranges_b: torch.Tensor, poses_b: torch.Tensor,
                       origins_rc: torch.Tensor, tile: int = TILE,
                       raster: bool = False) -> torch.Tensor:
    """(B, T, T) int64 class (`TILE_CLASSES`) of every tile x tile tile of
    each scan's patch (origins_rc (B, 2); T = ceil(P / tile), the last
    tile ragged), for deltas or, with `raster`, for rasters.

    The PyTorch mirror of `sensor_cell::tile_class`, step for step in
    float32; the kernels compute the class themselves and nothing on the
    main path calls this. Tests and `chip_smoke.py` use it to check that
    the class is sound and to report the share of each class."""
    from jax_mapping_torch.ops import grid as G
    from jax_mapping_torch.ops import trig
    dev = poses_b.device
    P = grid_cfg.patch_cells
    n = scan_cfg.n_beams

    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=dev)

    res = f32(grid_cfg.resolution_m)
    ox, oy = (f32(v) for v in grid_cfg.origin_m)
    inc = f32(scan_cfg.angle_increment_rad)
    amin = f32(scan_cfg.angle_min_rad)
    max_r = f32(grid_cfg.max_range_m)
    tol = f32(grid_cfg.hit_tolerance_cells * grid_cfg.resolution_m)
    range_min = f32(scan_cfg.range_min_m)
    inv_inc = f32(1.0) / inc
    pi, two_pi = f32(math.pi), f32(2.0 * math.pi)
    inv_two_pi = f32(1.0 / (2.0 * math.pi))
    slack = f32(2.0) * res
    full = G.full_circle(scan_cfg)

    first = torch.arange(0, P, tile, dtype=torch.int32, device=dev)
    last = torch.clamp_max(first + tile, P) - 1
    org = origins_rc.to(torch.int32)
    px, py = poses_b[:, 0, None], poses_b[:, 1, None]
    yaw = poses_b[:, 2, None, None]

    def centre(idx, o, p):                # centre_dy / centre_dx
        return ((idx.to(torch.float32) + 0.5) * res + o) - p

    dya = centre(org[:, 0:1] + first, oy, py)[:, :, None]     # (B, T, 1)
    dyb = centre(org[:, 0:1] + last, oy, py)[:, :, None]
    dxa = centre(org[:, 1:2] + first, ox, px)[:, None, :]     # (B, 1, T)
    dxb = centre(org[:, 1:2] + last, ox, px)[:, None, :]
    zero_f = torch.zeros((), dtype=torch.float32, device=dev)
    nx = torch.where((dxa <= 0.0) & (dxb >= 0.0), zero_f,
                     torch.fmin(dxa.abs(), dxb.abs()))
    ny = torch.where((dya <= 0.0) & (dyb >= 0.0), zero_f,
                     torch.fmin(dya.abs(), dyb.abs()))
    fx = torch.fmax(dxa.abs(), dxb.abs())
    fy = torch.fmax(dya.abs(), dyb.abs())
    r_min = torch.sqrt(nx * nx + ny * ny)                     # (B, T, T)
    r_max = torch.sqrt(fx * fx + fy * fy)
    zero = r_min > max_r + slack
    near_pose = ~(r_min > slack) | ~(yaw.abs() <= _MAX_YAW)

    corners = [trig.atan2(dy, dx) for dy, dx in
               ((dya, dxa), (dya, dxb), (dyb, dxa), (dyb, dxb))]
    a0 = corners[0]
    lo = hi = None
    for ak in corners:
        rel = ak - a0
        rel = torch.where(rel > pi, rel - two_pi,
                          torch.where(rel < -pi, rel + two_pi, rel))
        lo = rel if lo is None else torch.fmin(lo, rel)
        hi = rel if hi is None else torch.fmax(hi, rel)
    b_lo, b_hi = a0 + lo, a0 + hi
    if scan_cfg.counterclockwise:
        t_lo, t_hi = (b_lo - yaw) - amin, (b_hi - yaw) - amin
    else:
        t_lo, t_hi = (-(b_hi - yaw)) - amin, (-(b_lo - yaw)) - amin
    turns = torch.floor(t_lo * inv_two_pi)
    t_lo = t_lo - turns * two_pi
    t_hi = t_hi - turns * two_pi

    def to_int(x):                        # only read where finite
        return torch.nan_to_num(x, 0.0, 0.0, 0.0).clamp(-1e6, 1e6).long()

    lo_beam = to_int(torch.floor(t_lo * inv_inc)) - 2
    hi_beam = to_int(torch.ceil(t_hi * inv_inc)) + 2
    if full:
        cross = torch.zeros_like(zero)
        j0 = lo_beam
        j1 = torch.minimum(hi_beam, lo_beam + n - 1)
    else:
        cross = (lo_beam < 0) | (hi_beam.to(torch.float32) * inc >= two_pi)
        j0 = lo_beam
        j1 = torch.clamp_max(hi_beam, n - 1)

    r_m, hit = G.sanitize_ranges(scan_cfg, ranges_b)
    carve = torch.clamp_max(torch.where(r_m > 0.0, r_m, zero_f), max_r)
    enc = torch.where(hit, r_m, -carve)[:, :n]                # (B, n)
    band = res if raster else tol
    z_lo = (r_min - band) - slack
    z_hi = (r_max + band) + slack
    m = torch.arange(n, device=dev)
    inf = torch.tensor(float("inf"), device=dev)
    near = torch.zeros_like(zero)
    lim_min = torch.empty_like(r_min)
    lim_max = torch.empty_like(r_min)
    for s in range(0, poses_b.shape[0], _CLASS_CHUNK):
        sl = slice(s, s + _CLASS_CHUNK)
        if full:
            member = (torch.remainder(m - j0[sl, ..., None], n)
                      <= (j1 - j0)[sl, ..., None])
        else:
            member = (m >= j0[sl, ..., None]) & (m <= j1[sl, ..., None])
        e = enc[sl, None, None, :]
        near[sl] = (member & (e > 0.0) & (e >= z_lo[sl, ..., None])
                    & (e <= z_hi[sl, ..., None])).any(dim=-1)
        lim = torch.where(e > 0.0, torch.fmin(e, max_r), -e) - tol
        lim_min[sl] = torch.where(member, lim, inf).amin(dim=-1)
        lim_max[sl] = torch.where(member, lim, -inf).amax(dim=-1)

    if raster:
        by_set = torch.where(near, PER_CELL, NO_HIT)
    else:
        no_hit = ~near & (lim_max <= r_min - slack)
        free = (~near & ((r_min - slack) > range_min)
                & ((r_max + slack) < lim_min)) if full else \
            torch.zeros_like(near)
        by_set = torch.where(no_hit, NO_HIT,
                             torch.where(free, FREE, PER_CELL))
    return torch.where(zero, ZERO,
                       torch.where(near_pose | cross, PER_CELL, by_set))


def tile_class_shares(classes: torch.Tensor) -> dict:
    """Share of (tile, scan) pairs in each class of `TILE_CLASSES`."""
    counts = torch.bincount(classes.reshape(-1), minlength=len(TILE_CLASSES))
    total = max(int(classes.numel()), 1)
    return {name: int(c) / total for name, c in zip(TILE_CLASSES, counts)}


def model_cells(grid_cfg: GridConfig, poses_b: torch.Tensor,
                origins_rc: torch.Tensor) -> int:
    """Cells where the sensor model can be non-zero, summed over scans:
    the cells of each scan's patch (origins_rc (B, 2)) whose centre lies
    within max range of its pose (occ and rasters need r <= max range,
    free needs r < carve - tol <= max range). It counts the function's
    work from the poses alone, whatever a kernel culls; float64, row by
    row."""
    P = grid_cfg.patch_cells
    res = grid_cfg.resolution_m
    ox, oy = grid_cfg.origin_m
    R = grid_cfg.max_range_m
    p = poses_b.detach().to("cpu", torch.float64)
    o = origins_rc.detach().to("cpu", torch.float64)
    i = torch.arange(P, dtype=torch.float64)
    dy = (o[:, 0:1] + i + 0.5) * res + oy - p[:, 1:2]              # (B, P)
    w = torch.sqrt(torch.clamp_min(R * R - dy * dy, 0.0))
    # Columns j with |(col0 + j + 0.5) res + ox - px| <= w.
    c = (p[:, 0:1] - ox) / res - 0.5 - o[:, 1:2]
    j_lo = torch.clamp_min(torch.ceil(c - w / res), 0)
    j_hi = torch.clamp_max(torch.floor(c + w / res), P - 1)
    n = torch.clamp_min(j_hi - j_lo + 1, 0) * (dy.abs() <= R)
    return int(n.sum())
