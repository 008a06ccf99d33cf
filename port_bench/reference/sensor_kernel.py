"""The sensor model's entry points, always on their plain versions (the
plain versions of kernel K1): the part of the port's
`ops/sensor_kernel.py` that the fleet tick runs, frozen."""

from __future__ import annotations

import torch

from ._util import entry_point
from .config import GridConfig, ScanConfig


def scan_deltas_plain(grid_cfg: GridConfig, scan_cfg: ScanConfig,
                      ranges_b, poses_b, origins_rc) -> torch.Tensor:
    """Plain PyTorch version of K1 in delta mode."""
    from . import grid as G
    return G.classify_patch(grid_cfg, scan_cfg, ranges_b, poses_b,
                            origins_rc)


def scan_rasters_plain(grid_cfg: GridConfig, scan_cfg: ScanConfig,
                       ranges_b, poses_b, origins_rc) -> torch.Tensor:
    """Plain PyTorch version of K1 in raster mode."""
    from . import grid as G
    return G.raster_patch(grid_cfg, scan_cfg, ranges_b, poses_b, origins_rc)


@entry_point(static=("grid_cfg", "scan_cfg"))
def scan_deltas(grid_cfg: GridConfig, scan_cfg: ScanConfig,
                ranges_b: torch.Tensor, poses_b: torch.Tensor,
                origins_rc: torch.Tensor) -> torch.Tensor:
    """Per-scan (B, P, P) log-odds deltas, one patch origin per scan."""
    return scan_deltas_plain(grid_cfg, scan_cfg, ranges_b, poses_b,
                             origins_rc)


@entry_point(static=("grid_cfg", "scan_cfg"))
def scan_rasters(grid_cfg: GridConfig, scan_cfg: ScanConfig,
                 ranges_b: torch.Tensor, poses_b: torch.Tensor,
                 origins_rc: torch.Tensor) -> torch.Tensor:
    """Soft (B, P, P) scan rasters at continuous candidate poses."""
    return scan_rasters_plain(grid_cfg, scan_cfg, ranges_b, poses_b,
                              origins_rc)
