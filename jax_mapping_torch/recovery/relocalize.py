"""Wide-window relocalization for quarantined robots.

Port of the JAX package's `recovery/relocalize.py`. A diverged robot's
pose estimate is what cannot be trusted, so re-admission comes from the
map: each quarantined scan is matched against the fleet's shared grid by
loop verification's two stages (a coarse sweep of the whole loop window
on a downsampled view, then a fine full-resolution refine), seeded at the
last estimate. Both stages rasterise their candidates with kernel K1.

Verification: a re-anchor is verified only when `reloc_consecutive`
consecutive scans accept with response >= `reloc_min_response`, agree
with the map at their candidate pose, and their poses agree within the
consistency radii. Any miss resets the streak.

With `MatcherConfig.pruned` the attempt runs through the revision-keyed
pyramid cache (`ops/pyramid.py`). Its host decisions are the JAX
package's: each stage's cache key from `patch_origin_host`, the wide
stage's acceptance read for the fine stage's seed, and the revision guard
against `grid_revision`. Numpy inputs go to the grid's device. Each
stage is timed (`match.coarse_score`, `match.refine`,
`match.pyramid_build`) and pyramid builds are counted
(`match.pyramid_builds`), as in the JAX package; the timers add no host
sync, so each measures the host's side of its stage.
"""

from __future__ import annotations

import math
import threading
from typing import Callable, List, Optional

import numpy as np
import torch

from jax_mapping_torch._util import entry_point
from jax_mapping_torch.config import RecoveryConfig, SlamConfig
from jax_mapping_torch.models.slam import (_loop_matcher_cfg,
                                           _loop_wide_cfgs, scan_agreement)
from jax_mapping_torch.ops import grid as G
from jax_mapping_torch.ops import pyramid as PYR
from jax_mapping_torch.ops import scan_match as M
from jax_mapping_torch.utils import global_metrics as GM


@entry_point(static=("cfg",))
def relocalize_match(cfg: SlamConfig, grid: torch.Tensor,
                     ranges: torch.Tensor,
                     guess: torch.Tensor) -> M.MatchResult:
    """One wide-window relocalization attempt of a scan (beams,) from a
    guess (3,) against the live shared map: the wide sweep on the
    downsampled grid, then the fine match seeded by it (`models.slam.
    _verify_loop`'s stages on the live grid instead of a chain map). The
    fields keep `match`'s leading axis of 1. No host read."""
    g_c, m_c = _loop_wide_cfgs(cfg)
    wide = M.match(g_c, cfg.scan, m_c,
                   G.downsample_max(grid, cfg.loop.coarse_downsample),
                   ranges, guess)
    seed = torch.where(wide.accepted[0], wide.pose[0], guess)
    return M.match(cfg.grid, cfg.scan, _loop_matcher_cfg(cfg), grid,
                   ranges, seed)


@entry_point(static=("cfg", "n_levels"))
def _build_wide_pyramid(cfg: SlamConfig, n_levels: int, grid: torch.Tensor,
                        origin_c: torch.Tensor):
    """The wide stage's pyramid for one coarse-patch region: the
    loop-window downsample, the patch, its likelihood field and the
    max-pyramid."""
    g_c, m_c = _loop_wide_cfgs(cfg)
    coarse = G.downsample_max(grid, cfg.loop.coarse_downsample)
    return PYR.build_match_pyramid(g_c, m_c, n_levels, coarse, origin_c)


def _wrap(a: float) -> float:
    return (a + math.pi) % (2.0 * math.pi) - math.pi


class Relocalizer:
    """Per-robot candidate streaks around relocalize_match.

    Host-side and deterministic; fed by one thread, read by exporters
    (leaf lock)."""

    def __init__(self, cfg: RecoveryConfig, n_robots: int,
                 pyramid_cache: Optional[PYR.PyramidCache] = None):
        self.cfg = cfg
        self._lock = threading.Lock()
        #: Per-robot streak of consistent accepted candidates (x, y, theta),
        #: newest last.
        self._streak: List[List[tuple]] = [[] for _ in range(n_robots)]
        #: The pruned stages' pyramids: a quarantined robot re-attempts
        #: against the same region every tick, and the region changes only
        #: when another robot fuses nearby.
        self.pyramid_cache = pyramid_cache or PYR.PyramidCache()
        self.n_attempts = 0
        self.n_accepted = 0
        self.n_verified = 0

    # -- pruned + cached matching ------------------------------------------

    @staticmethod
    def _stage_match(g_cfg, scan_cfg, m_cfg, n_levels, levels, origin,
                     ranges, guess) -> M.MatchResult:
        """One pruned stage through the coarse/refine split, timed as the
        `match.coarse_score` and `match.refine` stages."""
        with GM.stages.stage("match.coarse_score"):
            resp_top, rasters_c, mass_ref = M.pyramid_coarse_scores(
                g_cfg, scan_cfg, m_cfg, n_levels, levels, origin, ranges,
                guess)
        with GM.stages.stage("match.refine"):
            return M.pyramid_refine(g_cfg, scan_cfg, m_cfg, n_levels,
                                    resp_top, levels, origin, ranges,
                                    rasters_c, mass_ref, guess)

    def _cached_pyramid(self, key: tuple, revision: Optional[int],
                        build: Callable) -> tuple:
        """The pyramid cache's entry for `key`, built (and timed as the
        `match.pyramid_build` stage, counted in `match.pyramid_builds`)
        on a miss."""
        def timed_build():
            with GM.stages.stage("match.pyramid_build"):
                levels = build()
            GM.counters.inc("match.pyramid_builds")
            return levels
        return self.pyramid_cache.get(key, revision, timed_build)

    def _match_pruned(self, cfg: SlamConfig, grid: torch.Tensor,
                      ranges: torch.Tensor, guess: np.ndarray,
                      region_rev_fn, grid_revision=None) -> M.MatchResult:
        """`relocalize_match` through the cached pyramids: each stage's
        pyramid is keyed on its patch region's revision.
        `region_rev_fn(row0, col0, span_cells) -> Optional[int]` is the
        caller's dirty-region revision probe (None: prune, never reuse).
        `grid_revision` is the map revision of the caller's grid snapshot:
        a region revision newer than it means a change landed between the
        snapshot and the probe, and a pyramid built from the snapshot must
        not be stored (or served) at that revision. `ranges` is on the
        grid's device; `guess` is host float32."""
        def fresh(rev):
            if rev is None or (grid_revision is not None
                               and rev > grid_revision):
                return None
            return rev

        dev = grid.device
        g_c, m_c = _loop_wide_cfgs(cfg)
        f = cfg.loop.coarse_downsample
        _, n_c = M.window_params(g_c, m_c)
        lv_c = M.bnb_num_levels(m_c, n_c)
        m_f = _loop_matcher_cfg(cfg)
        _, n_f = M.window_params(cfg.grid, m_f)
        lv_f = M.bnb_num_levels(m_f, n_f)
        guess_t = torch.as_tensor(guess, device=dev)
        if lv_c == 0 or lv_f == 0:
            # A window too small to prune: the one-call path.
            return relocalize_match(cfg, grid, ranges, guess_t)
        oc = PYR.patch_origin_host(g_c, guess[:2])
        rev_c = None if region_rev_fn is None else fresh(region_rev_fn(
            oc[0] * f, oc[1] * f, g_c.patch_cells * f))
        origin_c = torch.tensor(oc, dtype=torch.int32, device=dev)
        levels_c = self._cached_pyramid(
            ("wide", oc[0], oc[1]), rev_c,
            lambda: _build_wide_pyramid(cfg, lv_c, grid, origin_c))
        wide = self._stage_match(g_c, cfg.scan, m_c, lv_c, levels_c,
                                 origin_c, ranges, guess_t)
        # The acceptance and the pose come back in one read.
        head = torch.cat([wide.pose[0], wide.accepted.to(torch.float32)])
        *wide_pose, accepted = head.tolist()
        seed = (np.asarray(wide_pose, np.float32) if accepted else guess)
        seed_t = wide.pose[0] if accepted else guess_t
        of = PYR.patch_origin_host(cfg.grid, seed[:2])
        rev_f = None if region_rev_fn is None else fresh(region_rev_fn(
            of[0], of[1], cfg.grid.patch_cells))
        origin_f = torch.tensor(of, dtype=torch.int32, device=dev)
        levels_f = self._cached_pyramid(
            ("fine", of[0], of[1]), rev_f,
            lambda: PYR.build_match_pyramid(cfg.grid, m_f, lv_f, grid,
                                            origin_f))
        return self._stage_match(cfg.grid, cfg.scan, m_f, lv_f, levels_f,
                                 origin_f, ranges, seed_t)

    def attempt_for(self, robot: int, cfg: SlamConfig, grid: torch.Tensor,
                    ranges, guess, region_rev_fn: Optional[Callable] = None,
                    grid_revision: Optional[int] = None
                    ) -> Optional[np.ndarray]:
        """One attempt with robot `robot`'s freshest quarantined scan
        `ranges` (beams,) from `guess` (3,), numpy or tensors. Returns the
        verified re-anchor pose (3,) float32 when the streak completes,
        else None; the caller re-anchors the robot. `grid_revision` is the
        map revision of the caller's `grid` snapshot (see
        `_match_pruned`)."""
        dev = grid.device
        ranges_t = torch.as_tensor(ranges, dtype=torch.float32, device=dev)
        if torch.is_tensor(guess):
            guess = guess.detach().cpu().numpy()
        guess = np.asarray(guess, np.float32)
        if cfg.matcher.pruned:
            res = self._match_pruned(cfg, grid, ranges_t, guess,
                                     region_rev_fn, grid_revision)
        else:
            res = relocalize_match(cfg, grid, ranges_t,
                                   torch.as_tensor(guess, device=dev))
        head = torch.cat([res.pose[0], res.response,
                          res.accepted.to(torch.float32)]).tolist()
        pose = np.asarray(head[:3], np.float32)
        response, accepted = head[3], bool(head[4])
        c = self.cfg
        if accepted and response >= c.reloc_min_response:
            # Agreement at the candidate pose: a still-faulting sensor can
            # find plausible basins (half a ghosting scan's beams are real
            # walls), and re-admitting it would resume fusing garbage.
            agreement = float(scan_agreement(cfg, grid, ranges_t,
                                             res.pose[0]))
            accepted = agreement >= c.reloc_min_agreement
        with self._lock:
            self.n_attempts += 1
            streak = self._streak[robot]
            if not (accepted and response >= c.reloc_min_response):
                streak.clear()
                return None
            self.n_accepted += 1
            # Every candidate must sit in the streak head's basin, or the
            # streak restarts from this candidate.
            if streak:
                x0, y0, t0 = streak[0]
                if (math.hypot(pose[0] - x0, pose[1] - y0)
                        > c.reloc_consistency_m
                        or abs(_wrap(float(pose[2]) - t0))
                        > c.reloc_consistency_rad):
                    streak.clear()
            streak.append((float(pose[0]), float(pose[1]),
                           float(pose[2])))
            if len(streak) < c.reloc_consecutive:
                return None
            self.n_verified += 1
            streak.clear()
            return pose

    def reset(self, robot: int) -> None:
        with self._lock:
            self._streak[robot].clear()

    def snapshot(self) -> dict:
        with self._lock:
            snap = {
                "n_attempts": self.n_attempts,
                "n_accepted": self.n_accepted,
                "n_verified": self.n_verified,
            }
        snap["pyramid_cache"] = self.pyramid_cache.snapshot()
        return snap
