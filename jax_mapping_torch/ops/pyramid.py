"""Revision-keyed likelihood-pyramid cache for the pruned scan matcher.

Port of the JAX package's `ops/pyramid.py`. Inside a SLAM step the
matcher builds its max-pyramid per call; host-driven repeated matches
against an unchanged map region (the relocalizer's attempt every tick)
would rebuild the same pyramid each time. `PyramidCache` keys a built
pyramid on (region key, region revision): the key names where the pyramid
reads (a stage and its patch origin), the revision says when that area
last changed. A `None` revision means there is no revision source: the
entry is rebuilt every time and never stored.

Entries are whole pyramids, tuples of (1, ., .) tensors on the grid's
device, shared by every later hit: the matcher's cached entry points
(`scan_match.match_with_pyramid` and its split) only read them.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from jax_mapping_torch._util import entry_point
from jax_mapping_torch.config import GridConfig, MatcherConfig
from jax_mapping_torch.ops import scan_match as M


@entry_point(static=("grid_cfg", "m_cfg", "n_levels"))
def build_match_pyramid(grid_cfg: GridConfig, m_cfg: MatcherConfig,
                        n_levels: int, grid_arr: torch.Tensor,
                        origin_rc: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Grid + patch origin (2,) int32 -> the pruned matcher's pyramid: the
    patch, its likelihood field and the max-pyramid levels of
    `scan_match.build_levels`, each (1, ., .), on the grid's device. The
    patch is gathered at the origin (clamped into the grid, as
    jax.lax.dynamic_slice clamps), with no host read."""
    P = grid_cfg.patch_cells
    o = origin_rc.long().clamp(0, grid_arr.shape[0] - P)
    ar = torch.arange(P, device=grid_arr.device)
    patch = grid_arr[(o[0] + ar)[:, None], (o[1] + ar)[None, :]]
    field = M.likelihood_field(grid_cfg, m_cfg, patch[None])
    stride, n_steps = M.window_params(grid_cfg, m_cfg)
    return M.build_levels(field, n_steps, stride, n_levels)


def patch_origin_host(grid_cfg: GridConfig, xy) -> Tuple[int, int]:
    """`grid.patch_origin` of a host xy as Python ints, the cache-key form
    (origins snap to the alignment, so nearby guesses share keys). The
    same float32 operations in numpy, so it builds no tensor and reads
    nothing from a device: [row0, col0]."""
    if torch.is_tensor(xy):
        xy = xy.detach().cpu().numpy()
    xy = np.asarray(xy, np.float32)
    ar, ac = grid_cfg.align_rows, grid_cfg.align_cols
    res = np.float32(grid_cfg.resolution_m)
    half = np.float32(grid_cfg.patch_cells / 2)
    col = (xy[0] - np.float32(grid_cfg.origin_m[0])) / res
    row = (xy[1] - np.float32(grid_cfg.origin_m[1])) / res
    col0 = int(np.rint((col - half) / np.float32(ac))) * ac
    row0 = int(np.rint((row - half) / np.float32(ar))) * ar
    hi = grid_cfg.size_cells - grid_cfg.patch_cells
    return min(max(row0, 0), hi), min(max(col0, 0), hi)


class PyramidCache:
    """Bounded LRU of built pyramids keyed on (region, revision).

    Lookups and installs serialise on a leaf lock; the build runs outside
    it (device work under a host lock would stall every other reader).
    Two threads racing one cold key both build; the last install wins."""

    def __init__(self, max_entries: int = 8):
        self._lock = threading.Lock()
        #: key -> (revision, pyramid levels tuple), in LRU order.
        self._entries: "OrderedDict[tuple, tuple]" = OrderedDict()
        self.max_entries = max_entries
        self.n_hits = 0
        self.n_misses = 0
        self.n_invalidations = 0

    def get(self, key: tuple, revision: Optional[int],
            build: Callable[[], Tuple[torch.Tensor, ...]]
            ) -> Tuple[torch.Tensor, ...]:
        """The cached pyramid for `key` at `revision`, built on a miss.

        A hit needs the stored revision to equal the requested one: a
        dirty region (newer revision) rebuilds, a clean one is reused
        however far the map moved elsewhere. `revision=None` always
        rebuilds and never stores."""
        stale = False
        if revision is not None:
            with self._lock:
                ent = self._entries.get(key)
                if ent is not None:
                    if ent[0] == revision:
                        self._entries.move_to_end(key)
                        self.n_hits += 1
                        return ent[1]
                    stale = True
        levels = build()
        with self._lock:
            self.n_misses += 1
            if stale:
                self.n_invalidations += 1
            if revision is not None:
                self._entries[key] = (revision, levels)
                self._entries.move_to_end(key)
                while len(self._entries) > self.max_entries:
                    self._entries.popitem(last=False)
        return levels

    def clear(self) -> None:
        with self._lock:
            self._entries.clear()

    def snapshot(self) -> dict:
        with self._lock:
            total = self.n_hits + self.n_misses
            return {
                "n_entries": len(self._entries),
                "n_hits": self.n_hits,
                "n_misses": self.n_misses,
                "n_invalidations": self.n_invalidations,
                "hit_rate": (self.n_hits / total) if total else 0.0,
            }
