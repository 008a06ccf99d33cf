"""Kernels K1 and K4: the inverse sensor model on Hopper.

Replaces the JAX package's Pallas kernel
`ops/sensor_kernel.py::_per_scan_call` (the `_make_kernel` body, reached
through `scan_deltas` for log-odds deltas and `scan_rasters` for the
matcher's soft rasters). CUDA source: `csrc/sensor_model.cu`, one kernel
templated on the mode.

What bounds it on an H100: the (B, P, P) f32 output, written once
(1.6 MB per scan at P = 640), against ~60 float operations per cell for
the bearing polynomial, the square root and the classification. The
design spends nothing else on memory: each block (one scan, a band of
four patch rows) builds the scan's sanitised signed beam table (at most
`padded_beams` floats) in shared memory, one thread computes one cell at
a time with a single table lookup, and a band whose row gap to the pose
exceeds the maximum range writes zeros without computing.

Kernel K4 (`window_delta`, CUDA source `csrc/window_fuse.cu`) replaces
the accumulating form of the same Pallas kernel, `window_delta`: the sum
of B scans' deltas on one shared patch, added in b order. It is bound by
the classification, ~55 float operations per cell and scan within range;
each thread keeps its cells' sums in registers and loops over the scans,
whose beam tables are staged in shared memory a chunk at a time (see the
source). Both kernels classify a cell with the same device code
(`csrc/sensor_cell.cuh`).

On a CPU tensor the wrappers run the plain PyTorch versions
(`grid.classify_patch`, `grid.raster_patch`, `window_delta_plain`), which
do the same float operations in the same order; on a CUDA tensor they
launch the kernel or raise.
"""

from __future__ import annotations

import torch

from jax_mapping_torch._util import const, div
from jax_mapping_torch.config import GridConfig, ScanConfig
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


def scan_deltas(grid_cfg: GridConfig, scan_cfg: ScanConfig,
                ranges_b: torch.Tensor, poses_b: torch.Tensor,
                origins_rc: torch.Tensor) -> torch.Tensor:
    """Per-scan (B, P, P) log-odds deltas, one patch origin per scan."""
    if ranges_b.device.type == "cpu":
        return scan_deltas_plain(grid_cfg, scan_cfg, ranges_b, poses_b,
                                 origins_rc)
    return _launch(grid_cfg, scan_cfg, ranges_b, poses_b, origins_rc,
                   raster=False)


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
    _cuda.count_launch("sensor_model_raster" if raster
                       else "sensor_model_delta")
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
