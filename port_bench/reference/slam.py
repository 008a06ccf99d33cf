"""Loop verification against a key-scan chain map: the part of the port's
`models/slam.py` that the fleet tick runs, frozen."""

from __future__ import annotations

import dataclasses

import torch

from .config import SlamConfig
from . import grid as G
from . import posegraph as PG
from . import scan_match as M

_LOOP_W = (200.0, 400.0)        # verified loop edge information (t, theta)


def _loop_matcher_cfg(cfg: SlamConfig):
    """Fine-stage window of loop verification: the online window widened
    to the patch margin, at twice the coarse step."""
    m = cfg.matcher
    half = min(cfg.loop.search_radius_m,
               (cfg.grid.patch_cells / 2 - cfg.grid.align_cols / 2)
               * cfg.grid.resolution_m - cfg.grid.max_range_m)
    half = max(half, m.search_half_extent_m)
    return dataclasses.replace(m, search_half_extent_m=half,
                               coarse_step_m=m.coarse_step_m * 2)


def _loop_wide_cfgs(cfg: SlamConfig):
    """(coarse GridConfig, wide MatcherConfig) of the loop-window sweep on
    a `loop.coarse_downsample`x coarser view of the grid."""
    g_c = G.coarse_grid_config(cfg.grid, cfg.loop.coarse_downsample)
    half = min(cfg.loop.loop_window_m / 2.0,
               (g_c.patch_cells / 2 - g_c.align_cols / 2)
               * g_c.resolution_m - g_c.max_range_m)
    half = max(half, g_c.resolution_m)
    m_c = dataclasses.replace(
        cfg.matcher, search_half_extent_m=half,
        coarse_step_m=g_c.resolution_m,
        min_response=cfg.loop.response_coarse)
    return g_c, m_c


def _chain_grid(cfg: SlamConfig, graph: PG.PoseGraph, ring: torch.Tensor,
                cand: int, k: int) -> torch.Tensor:
    """Re-fuse the candidate's local chain of 2 * min_chain_size + 1 ring
    scans at their graph poses, leaving out the query's recent tail.
    `graph` holds one graph (leaves without the robot axis)."""
    CH = min(2 * cfg.loop.min_chain_size + 1, cfg.loop.max_poses)
    start = min(max(cand - CH // 2, 0), cfg.loop.max_poses - CH)
    sl = slice(start, start + CH)
    idx = torch.arange(start, start + CH, device=ring.device)
    valid = graph.pose_valid[sl] & (idx <= k - cfg.loop.min_chain_size)
    return G.fuse_scans_masked(cfg.grid, cfg.scan,
                               G.empty_grid(cfg.grid, ring.device),
                               ring[sl], graph.poses[sl], valid)


def _verify_loop(cfg: SlamConfig, graph: PG.PoseGraph, ring: torch.Tensor,
                 cand: int, k: int, ranges: torch.Tensor,
                 pose: torch.Tensor) -> M.MatchResult:
    """Two-stage verification of a scan (beams,) at pose (3,) against the
    candidate chain's map: a wide sweep on the coarse view, then a fine
    match seeded by it. Returns the fine MatchResult (leading axis 1)."""
    grid_v = _chain_grid(cfg, graph, ring, cand, k)
    g_c, m_c = _loop_wide_cfgs(cfg)
    wide = M.match(g_c, cfg.scan, m_c,
                   G.downsample_max(grid_v, cfg.loop.coarse_downsample),
                   ranges, pose)
    seed = torch.where(wide.accepted[0], wide.pose[0], pose)
    return M.match(cfg.grid, cfg.scan, _loop_matcher_cfg(cfg), grid_v,
                   ranges, seed)


