"""The yardstick of the rooflines: a frozen copy of the port's kernel
arithmetic (`obs/ledger.py` and `ops/sensor_kernel.model_cells`) and the
card's published peaks.

A function's bytes count each input read once and each output written
once; its operations are the work the function needs at these inputs,
whatever kernel implements it (K1 counts the cells within max range of
each scan). The least time is the larger of bytes over the memory
bandwidth and operations over the float32 rate.
"""

from __future__ import annotations

from typing import Tuple

import torch

#: NVIDIA H100 SXM (data sheet): HBM3 bandwidth and the float32 rate
#: outside the tensor cores, at the full 700 W power limit.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

#: Float operations of the sensor model on one cell within max range:
#: cell centre (6), offsets and range with its square root (5), the atan2
#: polynomial with its octant reduction (30), the [0, 2pi) wrap and beam
#: rounding (7), classification (7).
K1_OPS_PER_CELL = 55


def least_seconds(n_bytes: float, n_ops: float) -> float:
    return max(n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_F32_FLOPS)


def model_cells(patch_cells: int, resolution_m: float, origin_m,
                max_range_m: float, poses_b: torch.Tensor,
                origins_rc: torch.Tensor) -> int:
    """Cells of each scan's (P, P) patch whose centre lies within max
    range of its pose, summed over scans (float64, on the host)."""
    P, res, R = patch_cells, resolution_m, max_range_m
    ox, oy = origin_m
    p = poses_b.detach().to("cpu", torch.float64)
    o = origins_rc.detach().to("cpu", torch.float64)
    i = torch.arange(P, dtype=torch.float64)
    dy = (o[:, 0:1] + i + 0.5) * res + oy - p[:, 1:2]              # (B, P)
    w = torch.sqrt(torch.clamp_min(R * R - dy * dy, 0.0))
    c = (p[:, 0:1] - ox) / res - 0.5 - o[:, 1:2]
    j_lo = torch.clamp_min(torch.ceil(c - w / res), 0)
    j_hi = torch.clamp_max(torch.floor(c + w / res), P - 1)
    n = torch.clamp_min(j_hi - j_lo + 1, 0) * (dy.abs() <= R)
    return int(n.sum())


def sensor_model_cost(patch_cells: int, resolution_m: float, origin_m,
                      max_range_m: float, n_beams_padded: int,
                      poses_b: torch.Tensor,
                      origins_rc: torch.Tensor) -> Tuple[int, int]:
    """K1 (deltas or rasters) on B scans: reads the ranges, poses and
    origins, writes B (P, P) float32 patches; 55 operations a cell
    within range."""
    B = int(poses_b.shape[0])
    P = patch_cells
    cells = model_cells(P, resolution_m, origin_m, max_range_m, poses_b,
                        origins_rc)
    return B * (n_beams_padded * 4 + 12 + 8 + P * P * 4), \
        cells * K1_OPS_PER_CELL


def label_prop_cost(mask_shape, sweeps: int) -> Tuple[int, int]:
    """K2 on (n, n) or (T, n, n) grids: the mask (1 byte), the seeds and
    the labels (4 each) a cell; 9 operations a cell a sweep."""
    n = mask_shape[-1]
    T = 1
    for s in mask_shape[:-2]:
        T *= s
    return T * n * n * (1 + 4 + 4), T * sweeps * n * n * 9


def relax_cost(mask_shape, init_shape, sweeps: int) -> Tuple[int, int]:
    """K3: F fields under M masks of (n, n); each mask read once, each
    field read and written once; 8 adds, 8 mins and a select a cell of
    every field a sweep."""
    n = init_shape[-1]
    fields = 1
    for s in init_shape[:-2]:
        fields *= s
    masks = 1
    for s in mask_shape[:-2]:
        masks *= s
    return n * n * (masks + 2 * 4 * fields), 17 * fields * sweeps * n * n
