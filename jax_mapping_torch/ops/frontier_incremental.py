"""Incremental, revision-keyed frontier publish (the mapper's publish path).

Port of the JAX package's `ops/frontier_incremental.py`. A publish
recomputes frontiers, clusters, costs and the assignment from the live
grid, but only what changed since the last one:

  * a tile-keyed coarse-mask cache: `coarsen` (and `stale_mask`) are
    block pools local to a tile, so only tiles whose revision advanced
    are re-pooled, gathered as one batch and scattered back
    (`_refresh_tiles`); dense dirt re-pools the whole grid once;
  * an active-region crop: clustering and cost fields run on the box of
    observed tiles and robot cells, padded by `crop_pad`, its origin
    snapped to the pooling period and its span bucketed (2^k, 3 * 2^(k-1));
  * warm-started cost fields: while no blocked cell appeared in the same
    crop, the previous fields are carried; only the robots whose BFS cell
    moved are relaxed again (`costfield.warm_cost_fields`, kernel K3), and
    the crop then runs in exact-reuse form (0 sweeps);
  * a publish skip when no tile is dirty and no robot moved past
    `pose_skip_m` or out of its cell.

Sizes, assignment and targets equal the full recompute's
(`frontier.compute_frontiers`): tile pooling is local, row-major index
tie-breaks survive cropping, and the cluster sums are exact.

One writer calls `compute`; `status()` is a lock-free snapshot.
"""

from __future__ import annotations

import time
from typing import NamedTuple, Optional

import numpy as np
import torch

from jax_mapping_torch._util import entry_point, resolve_device
from jax_mapping_torch.config import FrontierConfig, GridConfig
from jax_mapping_torch.ops import costfield as CF
from jax_mapping_torch.ops import frontier as F

#: Smallest crop span in first-level coarse cells.
_MIN_SPAN = 32

#: Dirty-tile share from which one full-grid re-pool replaces the
#: per-tile refresh.
_DENSE_DIRTY_FRAC = 0.25


class IncrementalPublish(NamedTuple):
    """Host-side publish payload and provenance of one `compute` call."""

    targets: np.ndarray      # (K, 2) world-metre goal points
    sizes: np.ndarray        # (K,) fine frontier cells per cluster
    assignment: np.ndarray   # (R,) cluster per robot, -1 none
    costs: np.ndarray        # (R, K) travel costs (first-level coarse cells)
    revision: int            # map revision the result was computed at
    recomputed: bool         # False: the cached result (publish skip)
    crop_rc: tuple           # (row0, col0, span) first-level coarse cells


def _next_pow2(x: int) -> int:
    return 1 << max(0, int(x - 1).bit_length())


def _tiles(x: torch.Tensor, t: int) -> torch.Tensor:
    """(n, n) -> a (n/t, n/t, t, t) view of its t x t tiles."""
    nt = x.shape[0] // t
    return x.view(nt, t, nt, t).transpose(1, 2)


@entry_point(static=("fcfg", "grid_cfg", "tile_cells"))
def _refresh_tiles(fcfg: FrontierConfig, grid_cfg: GridConfig,
                   tile_cells: int, logodds: torch.Tensor, free, occ,
                   unknown, stale, tile_rc: torch.Tensor) -> torch.Tensor:
    """Re-coarsen the dirty tiles (tile_rc (M, 2) tile indices) into the
    persistent coarse masks, in place: one gather of the M tiles, one
    pooling pass over them, one scatter per mask. `stale` is re-pooled
    too when `decay_aware` is on (it is None otherwise). Returns each
    tile's observed flag (any non-unknown coarse cell), (M,)."""
    M = tile_rc.shape[0]
    tcc = tile_cells // fcfg.downsample
    tr, tc = tile_rc[:, 0], tile_rc[:, 1]
    # The tiles stacked as one tall grid: tile_cells is a multiple of
    # downsample, so no pooling block crosses two tiles.
    patches = _tiles(logodds, tile_cells)[tr, tc].reshape(
        M * tile_cells, tile_cells)
    f, o, u = F.coarsen(fcfg, grid_cfg, patches)
    for buf, new in ((free, f), (occ, o), (unknown, u)):
        _tiles(buf, tcc)[tr, tc] = new.reshape(M, tcc, tcc)
    if fcfg.decay_aware:
        _tiles(stale, tcc)[tr, tc] = F.stale_mask(
            fcfg, grid_cfg, patches).reshape(M, tcc, tcc)
    return (~u).reshape(M, -1).any(dim=1)


@entry_point(static=("fcfg", "grid_cfg", "tile_cells"))
def _refresh_full(fcfg: FrontierConfig, grid_cfg: GridConfig,
                  tile_cells: int, logodds: torch.Tensor, stale):
    """Dense dirt: one full-grid coarsen (and stale mask) and the per-tile
    observed flags. The caller treats it as invalidating the carried
    fields."""
    free, occ, unknown = F.coarsen(fcfg, grid_cfg, logodds)
    if fcfg.decay_aware:
        stale = F.stale_mask(fcfg, grid_cfg, logodds)
    obs = F._pool_any(~unknown, tile_cells // fcfg.downsample)
    return free, occ, unknown, stale, obs


def _crop_masks(free, unknown, origin_rc: tuple, span: int):
    r0, c0 = origin_rc
    return (free[r0:r0 + span, c0:c0 + span],
            unknown[r0:r0 + span, c0:c0 + span])


@entry_point(static=("fcfg", "grid_cfg", "span"))
def _crop_blocked(fcfg: FrontierConfig, grid_cfg: GridConfig, span: int,
                  free, unknown, origin_rc: tuple) -> torch.Tensor:
    """The crop's BFS blocked mask, which the carried fields depend on.
    It depends on the frontier mask as well as occupancy (frontier blocks
    stay passable), so a consumed frontier cell can block a cell with no
    new occupancy."""
    f, u = _crop_masks(free, unknown, origin_rc, span)
    mask = F.frontier_mask(f, u)
    bfs_passable, _ = F.bfs_passability(fcfg, grid_cfg, f, u, mask)
    return ~bfs_passable


def _crop_stale(fcfg: FrontierConfig, stale, origin_rc: tuple, span: int):
    """The stale mask's crop, or None when decay_aware is off."""
    if not fcfg.decay_aware or stale is None:
        return None
    r0, c0 = origin_rc
    return stale[r0:r0 + span, c0:c0 + span]


@entry_point(static=("fcfg", "grid_cfg", "span"))
def _compute_crop(fcfg: FrontierConfig, grid_cfg: GridConfig, span: int,
                  free, unknown, stale, origin_rc: tuple,
                  poses: torch.Tensor):
    f, u = _crop_masks(free, unknown, origin_rc, span)
    return F.compute_frontiers_from_masks(
        fcfg, grid_cfg, f, u, poses, origin_rc=origin_rc,
        return_fields=True, stale=_crop_stale(fcfg, stale, origin_rc, span))


@entry_point(static=("fcfg", "grid_cfg", "span", "warm_iters"))
def _compute_crop_warm(fcfg: FrontierConfig, grid_cfg: GridConfig,
                       span: int, warm_iters: int, free, unknown, stale,
                       origin_rc: tuple, poses: torch.Tensor,
                       prev_fields: torch.Tensor):
    f, u = _crop_masks(free, unknown, origin_rc, span)
    return F.compute_frontiers_from_masks(
        fcfg, grid_cfg, f, u, poses, origin_rc=origin_rc,
        warm_fields=prev_fields, warm_iters=warm_iters, return_fields=True,
        stale=_crop_stale(fcfg, stale, origin_rc, span))


class IncrementalFrontierPipeline:
    """Revision-keyed incremental frontier recompute for one mapper.

    The constructor raises ValueError on geometry the incremental path
    cannot serve (tile and pooling divisibility, pooling factors that are
    not powers of two). State lives on `device`: the card unless the
    caller names another."""

    def __init__(self, fcfg: FrontierConfig, grid_cfg: GridConfig,
                 tile_cells: int, device=None):
        d = fcfg.downsample
        c = fcfg.cluster_downsample
        n_full = grid_cfg.size_cells
        if n_full % tile_cells:
            raise ValueError(f"tile_cells={tile_cells} does not divide "
                             f"grid size {n_full}")
        if tile_cells % d:
            raise ValueError(f"downsample={d} does not divide "
                             f"tile_cells={tile_cells}")
        if c & (c - 1) or d & (d - 1):
            raise ValueError("incremental frontier pipeline needs "
                             f"power-of-two pooling factors, got "
                             f"downsample={d} cluster_downsample={c}")
        self.fcfg = fcfg
        self.grid_cfg = grid_cfg
        self.tile_cells = tile_cells
        self.device = resolve_device(device)
        self._n = n_full // d                    # coarse grid edge
        self._tcc = tile_cells // d              # coarse cells per tile
        self._nt = n_full // tile_cells
        # Crop origins snap to the clustering x multigrid pooling period
        # so the crop's pooling blocks are the full grid's.
        self._snap = c * (1 << (fcfg.mg_levels - 1))
        if self._n % self._snap:
            raise ValueError(f"coarse grid {self._n} not divisible by "
                             f"crop alignment {self._snap}")
        # An empty grid is all unknown, as coarsen() of zeros: tiles never
        # marked dirty are already right.
        shape = (self._n, self._n)
        self._free = torch.zeros(shape, dtype=torch.bool, device=self.device)
        self._occ = torch.zeros(shape, dtype=torch.bool, device=self.device)
        self._unknown = torch.ones(shape, dtype=torch.bool,
                                   device=self.device)
        self._stale = (torch.zeros(shape, dtype=torch.bool,
                                   device=self.device)
                       if fcfg.decay_aware else None)
        self._seen_rev = np.full((self._nt, self._nt), -1, np.int64)
        self._tile_observed = np.zeros((self._nt, self._nt), bool)
        self._extra_key = None
        # The previous publish's carry.
        self._last: Optional[IncrementalPublish] = None
        self._last_poses: Optional[np.ndarray] = None
        self._last_cells: Optional[np.ndarray] = None
        self._prev_fields = None                 # (R, nb, nb) or None
        self._prev_crop: Optional[tuple] = None
        #: BFS cells the carried fields were last relaxed at (a reuse
        #: passes them through, so it does not advance this).
        self._field_cells: Optional[np.ndarray] = None
        #: The crop's BFS blocked mask the carried fields were solved on.
        self._prev_blocked = None
        self.n_recomputes = 0
        self.n_skips = 0
        self.n_tiles_refreshed = 0               # tile-cache misses
        self.n_tiles_clean = 0                   # tile-cache hits
        self.n_warm_starts = 0
        self.n_field_reuses = 0
        self.n_full_refreshes = 0
        self.last_recompute_ms: Optional[float] = None
        self.last_crop: Optional[tuple] = None
        self.last_device_result = None           # crop-shaped
        #: Distinct (kind, size) shapes met: refresh buckets, crop spans
        #: by field mode, warm sub-batches. The JAX package compiles one
        #: program per entry; the set stays logarithmic in the grid.
        self.compiled_shapes: set = set()

    # -- host-side geometry ------------------------------------------------

    def _robot_cells(self, poses: np.ndarray) -> np.ndarray:
        """Robot (row, col) in first-level coarse cells, clipped."""
        res = self.grid_cfg.resolution_m * self.fcfg.downsample
        ox, oy = self.grid_cfg.origin_m
        rows = np.clip(((poses[:, 1] - oy) / res).astype(np.int64),
                       0, self._n - 1)
        cols = np.clip(((poses[:, 0] - ox) / res).astype(np.int64),
                       0, self._n - 1)
        return np.stack([rows, cols], axis=1)

    def _bucket_span(self, needed: int) -> int:
        """Smallest allowed span >= needed: 2^k or 3 * 2^(k-1), divisible
        by the pooling period, at least _MIN_SPAN, at most the grid."""
        n = self._n
        floor = max(_MIN_SPAN, self._snap)
        span = n
        p = floor
        while p <= n:
            for s in (p, p + p // 2):
                if s >= needed and s <= n and s % self._snap == 0 \
                        and s < span:
                    span = s
            p *= 2
        return span

    def _crop(self, cells: np.ndarray) -> tuple:
        """(row0, col0, span): observed tiles' box and robot cells, padded
        by crop_pad, origin snapped, span bucketed."""
        n = self._n
        tcc = self._tcc
        obs = np.argwhere(self._tile_observed)
        lo = cells.min(axis=0)
        hi = cells.max(axis=0) + 1
        if obs.size:
            lo = np.minimum(lo, obs.min(axis=0) * tcc)
            hi = np.maximum(hi, (obs.max(axis=0) + 1) * tcc)
        pad = self.fcfg.crop_pad
        lo = np.maximum(lo - pad, 0)
        hi = np.minimum(hi + pad, n)
        snap = self._snap
        lo = (lo // snap) * snap
        span = self._bucket_span(int((hi - lo).max()))
        r0 = int(min(lo[0], n - span))
        c0 = int(min(lo[1], n - span))
        return r0, c0, span

    # -- the pipeline ------------------------------------------------------

    def compute(self, logodds, poses: np.ndarray, tile_rev: np.ndarray,
                revision: int, extra_key=None) -> IncrementalPublish:
        """One publish: refresh dirty tiles, recompute on the crop (warm
        where valid), or skip.

        logodds: the full-resolution grid (tensor or array) of a
        consistent snapshot; tile_rev: the per-tile last-dirty revisions
        of the same snapshot; extra_key: any ingredient of `logodds` that
        tile revisions do not track (a change re-pools every tile)."""
        fcfg, g = self.fcfg, self.grid_cfg
        if extra_key != self._extra_key:
            self._seen_rev[:] = -1
            self._extra_key = extra_key
            self._prev_fields = None
        dirty = tile_rev > self._seen_rev
        ndirty = int(dirty.sum())
        cells = self._robot_cells(poses)

        if ndirty == 0 and self._last is not None \
                and self._last_poses is not None \
                and len(poses) == len(self._last_poses):
            moved = float(np.abs(poses[:, :2]
                                 - self._last_poses[:, :2]).max())
            if moved < fcfg.pose_skip_m \
                    and bool((cells == self._last_cells).all()):
                self.n_skips += 1
                return self._last._replace(recomputed=False)

        t0 = time.perf_counter()
        dev = self.device
        if ndirty:
            logodds = torch.as_tensor(logodds, device=dev)
            if ndirty >= max(1, int(dirty.size * _DENSE_DIRTY_FRAC)):
                (self._free, self._occ, self._unknown, self._stale,
                 obs) = _refresh_full(fcfg, g, self.tile_cells, logodds,
                                      self._stale)
                self._tile_observed = obs.cpu().numpy().copy()
                self.n_full_refreshes += 1
                self.compiled_shapes.add(("refresh", "full"))
            else:
                idx = torch.as_tensor(np.argwhere(dirty), device=dev)
                obs = _refresh_tiles(fcfg, g, self.tile_cells, logodds,
                                     self._free, self._occ, self._unknown,
                                     self._stale, idx)
                self._tile_observed[dirty] = obs.cpu().numpy()
                self.compiled_shapes.add(("refresh", _next_pow2(ndirty)))
            self._seen_rev = np.where(dirty, tile_rev, self._seen_rev)
            self.n_tiles_refreshed += ndirty
        self.n_tiles_clean += int(dirty.size) - ndirty

        crop = self._crop(cells)
        r0, c0, span = crop
        origin = (r0, c0)
        mode, cur_blocked = self._field_mode(ndirty, crop, cells, origin)
        poses_d = torch.as_tensor(poses.astype(np.float32), device=dev)
        if mode is not None:
            # Fields are per robot: only the robots whose BFS cell moved
            # are relaxed again (warm, against the validated mask) and
            # patched into the carried stack; the crop then runs in exact
            # reuse (0 sweeps: re-mask and re-seed).
            carried = self._prev_fields
            if mode == "warm":
                c = fcfg.cluster_downsample
                moved = np.nonzero(
                    (cells // c != self._field_cells).any(axis=1))[0]
                m_b = _next_pow2(max(1, len(moved)))
                # Padding repeats robot 0, as the JAX package's bucket
                # does: its row is relaxed again from its own field.
                pad_idx = np.zeros(m_b, np.int64)
                pad_idx[:len(moved)] = moved
                origin_bfs = np.array([r0 // c, c0 // c])
                sub_rc = torch.as_tensor(
                    (cells[pad_idx] // c - origin_bfs).astype(np.int32),
                    device=dev)
                rows = torch.as_tensor(pad_idx, device=dev)
                sub = CF.warm_cost_fields(cur_blocked, sub_rc,
                                          carried[rows],
                                          fcfg.warm_extra_iters)
                carried = carried.index_put((rows,), sub)
                self.compiled_shapes.add(("warmsub", m_b, span))
            fr, fields, blocked_out = _compute_crop_warm(
                fcfg, g, span, 0, self._free, self._unknown, self._stale,
                origin, poses_d, carried)
            self.n_warm_starts += 1
            if mode == "reuse":
                self.n_field_reuses += 1
            self.compiled_shapes.add(("crop", span, 0))
        else:
            fr, fields, blocked_out = _compute_crop(
                fcfg, g, span, self._free, self._unknown, self._stale,
                origin, poses_d)
            self.compiled_shapes.add(("crop", span, "cold"))
        if mode != "reuse":
            self._field_cells = cells // fcfg.cluster_downsample
        self._prev_blocked = blocked_out if fields is not None else None
        out = IncrementalPublish(
            targets=fr.targets.cpu().numpy(),
            sizes=fr.sizes.cpu().numpy(),
            assignment=fr.assignment.cpu().numpy(),
            costs=fr.costs.cpu().numpy(),
            revision=int(revision), recomputed=True, crop_rc=crop)
        self._prev_fields = fields
        self._prev_crop = crop
        self._last = out
        self._last_poses = np.array(poses, np.float32, copy=True)
        self._last_cells = cells
        self.last_device_result = fr
        self.n_recomputes += 1
        dt = time.perf_counter() - t0
        self.last_recompute_ms = round(dt * 1e3, 3)
        # The `frontier.recompute` stage renders as /metrics' summary and
        # histogram families; last_recompute_ms is /status' number.
        from jax_mapping_torch.utils import global_metrics
        global_metrics.stages.observe("frontier.recompute", dt)
        self.last_crop = crop
        return out

    def _field_mode(self, ndirty: int, crop: tuple, cells: np.ndarray,
                    origin: tuple):
        """(mode, crop blocked mask or None): None = a cold multigrid
        solve; "warm" = the carried fields relaxed again (valid while no
        blocked cell appeared in the same crop and the warm sweeps cover
        every robot's move); "reuse" = the carried fields are exact (same
        blocked mask, every robot in its BFS cell)."""
        fcfg = self.fcfg
        if not (fcfg.warm_start and fcfg.obstacle_aware
                and not fcfg.exact_bfs and self._prev_fields is not None
                and self._prev_crop == crop
                and self._prev_blocked is not None
                and self._field_cells is not None
                and len(cells) == len(self._field_cells)):
            return None, None
        if ndirty == 0:
            blocked = self._prev_blocked         # no refresh: unchanged
            grew, same = False, True
        else:
            blocked = _crop_blocked(fcfg, self.grid_cfg, crop[2],
                                    self._free, self._unknown, origin)
            grew = bool((blocked & ~self._prev_blocked).any())
            same = not grew and not bool(
                (blocked ^ self._prev_blocked).any())
        if grew:
            return None, None
        bfs_cells = cells // fcfg.cluster_downsample
        move = int(np.abs(bfs_cells - self._field_cells).max()) \
            if len(bfs_cells) else 0
        if same and move == 0:
            return "reuse", blocked
        if move <= max(0, 2 * fcfg.warm_extra_iters - 2):
            return "warm", blocked
        return None, None

    # -- exports -----------------------------------------------------------

    def coarse_masks(self):
        """The persistent (free, occupied, unknown) coarse masks."""
        return self._free, self._occ, self._unknown

    def stale(self):
        """The carried healed coarse mask, or None when decay_aware is
        off."""
        return self._stale

    def status(self) -> dict:
        """Lock-free counters (the JAX package's /status keys)."""
        hits, misses = self.n_tiles_clean, self.n_tiles_refreshed
        total = hits + misses
        return {
            "n_recomputes": self.n_recomputes,
            "n_skips": self.n_skips,
            "cache_hits": hits,
            "cache_misses": misses,
            "cache_hit_rate": (hits / total) if total else 0.0,
            "n_warm_starts": self.n_warm_starts,
            "n_field_reuses": self.n_field_reuses,
            "n_full_refreshes": self.n_full_refreshes,
            "last_recompute_ms": self.last_recompute_ms,
            "crop": (list(self.last_crop)
                     if self.last_crop is not None else None),
            "crop_cells": (self.last_crop[2] ** 2
                           if self.last_crop is not None else 0),
            "n_compiled_shapes": len(self.compiled_shapes),
        }
