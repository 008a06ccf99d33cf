"""The streaming fold of the masked fusion: the part of the port's
`ops/fuse_kernel.py` that the fleet tick runs, frozen."""

from __future__ import annotations

from typing import Optional

import torch

from .config import GridConfig, ScanConfig

#: Scans classified and folded at once.
_STREAM_CHUNK = 64


def stream_fold(grid_cfg: GridConfig, scan_cfg: ScanConfig,
                grid_arr: torch.Tensor, ranges_b: torch.Tensor,
                poses_b: torch.Tensor, mask_b: Optional[torch.Tensor],
                clamp: bool = True,
                tenant: Optional[torch.Tensor] = None) -> None:
    """Classify and fold `ranges_b` into `grid_arr` in place, in b order,
    `_STREAM_CHUNK` scans at a time; with `tenant`, scan b into grid
    tenant[b] of a (T, N, N) stack (one K1 launch and one host read a
    sub-batch for every tenant's scans)."""
    from . import grid as G
    B = ranges_b.shape[0]
    for s in range(0, B, _STREAM_CHUNK):
        e = min(B, s + _STREAM_CHUNK)
        deltas, origins = G._classify_batch(grid_cfg, scan_cfg,
                                            ranges_b[s:e], poses_b[s:e])
        G._fold(grid_cfg, grid_arr, deltas, origins,
                None if mask_b is None else mask_b[s:e], clamp=clamp,
                tenant=None if tenant is None else tenant[s:e])

