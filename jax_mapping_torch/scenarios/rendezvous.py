"""Rendezvous fleet merges: two worlds become one.

Port of the JAX package's `scenarios/rendezvous.py`. Two fleets launched
apart share no map and no pose frame. This module detects their overlap
and merges them:

1. Detection: fleet B's freshest key scan is matched against fleet A's
   live grid by `recovery.relocalize_match` (kernel K1 rasterises every
   candidate), seeded at A's robot and graph poses. Acceptance is
   streak-verified: the implied inter-fleet transform must agree across
   `consecutive` attempts within the consistency radii.
2. Alignment: the verified match fixes the rigid SE(2) transform T with
   T (+) pose_B = pose_A; every B state maps through T.
3. Merge: B's key-scan rings are re-fused into A's grid at their
   transformed graph poses (`grid.fuse_scans_masked`, kernel K1 in delta
   mode), the matched robot's graph gets a `posegraph.anchor_tip` edge at
   the verified pose and one optimize, and every merged state aliases one
   grid.

A host-orchestrated cold path with no random draws. The sweep is the
`rendezvous.sweep` stage, attempts and merges are counted
(`rendezvous.attempts`, `rendezvous.merges`), and every accepted attempt
and the merge are flight-recorded (`rendezvous_accept`,
`rendezvous_merge`), as in the JAX package.
"""

from __future__ import annotations

import math
import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from jax_mapping_torch.config import SlamConfig
from jax_mapping_torch.obs.recorder import flight_recorder
from jax_mapping_torch.ops import frontier as F
from jax_mapping_torch.ops import grid as G
from jax_mapping_torch.ops import posegraph as PG
from jax_mapping_torch.recovery.relocalize import relocalize_match
from jax_mapping_torch.utils import global_metrics as GM


def _np(x) -> np.ndarray:
    """A tensor or array as a float32 numpy array."""
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


# ---------------------------------------------------------------------------
# Host-side SE(2)
# ---------------------------------------------------------------------------

def _wrap(a):
    return (a + math.pi) % (2.0 * math.pi) - math.pi


def se2_apply(T: np.ndarray, poses: np.ndarray) -> np.ndarray:
    """Apply transform T (3,) to poses (..., 3): frame-B coordinates
    become frame-A coordinates."""
    T = np.asarray(T, np.float32)
    p = np.asarray(poses, np.float32)
    c, s = math.cos(float(T[2])), math.sin(float(T[2]))
    out = np.empty_like(p)
    out[..., 0] = T[0] + c * p[..., 0] - s * p[..., 1]
    out[..., 1] = T[1] + s * p[..., 0] + c * p[..., 1]
    out[..., 2] = _wrap(p[..., 2] + T[2])
    return out


def se2_from_pair(pose_a: np.ndarray, pose_b: np.ndarray) -> np.ndarray:
    """The rigid T with `se2_apply(T, pose_b) == pose_a`: pose_a is a
    matched pose in A's frame, pose_b the same physical pose in B's."""
    a = np.asarray(pose_a, np.float64)
    b = np.asarray(pose_b, np.float64)
    th = _wrap(float(a[2]) - float(b[2]))
    c, s = math.cos(th), math.sin(th)
    tx = float(a[0]) - (c * float(b[0]) - s * float(b[1]))
    ty = float(a[1]) - (s * float(b[0]) + c * float(b[1]))
    return np.asarray([tx, ty, th], np.float32)


def transform_state(st, T: np.ndarray):
    """One SlamState expressed in frame A: the current pose, the key
    anchor and every graph pose map through T (on the host, then back to
    the state's device). The grid is untouched; the caller re-fuses."""
    dev = st.pose.device

    def move(x):
        return torch.as_tensor(se2_apply(T, _np(x)), device=dev)

    return st._replace(pose=move(st.pose),
                       last_key_pose=move(st.last_key_pose),
                       graph=st.graph._replace(poses=move(st.graph.poses)))


def merge_fleets(cfg: SlamConfig, states_a: Sequence, states_b: Sequence,
                 T: np.ndarray,
                 anchor: Optional[Tuple[int, np.ndarray]] = None):
    """One shared world from two fleets: returns (merged_grid,
    merged_states). B's states are transformed by T; with `anchor`
    (j, verified_pose) robot j's graph gets the anchor edge and one
    optimize; B's key-scan rings are re-fused into A's grid at their
    graph poses, masked on pose validity. Every returned state aliases the
    merged grid."""
    moved = [transform_state(st, T) for st in states_b]
    if anchor is not None:
        j, verified_pose = anchor
        g2 = PG.anchor_tip(moved[j].graph, verified_pose)
        g2 = PG.unbatch1(PG.optimize(cfg.loop, PG.batch1(g2)))
        moved[j] = moved[j]._replace(graph=g2)
    cap = cfg.loop.max_poses
    grid = states_a[0].grid
    for st in moved:
        grid = G.fuse_scans_masked(
            cfg.grid, cfg.scan, grid, st.scan_ring,
            st.graph.poses[:cap], st.graph.pose_valid[:cap])
    merged = [st._replace(grid=grid) for st in list(states_a) + moved]
    return grid, merged


def merged_frontier_assignment(cfg: SlamConfig, grid: torch.Tensor, states):
    """Frontier auction over the merged fleet: one compute_frontiers on
    the shared grid with every robot's pose (kernels K2 and K3)."""
    poses = torch.stack([st.pose for st in states])
    return F.compute_frontiers(cfg.frontier, cfg.grid, grid, poses)


# ---------------------------------------------------------------------------
# Detection: the cross-fleet overlap watcher
# ---------------------------------------------------------------------------

class RendezvousMerger:
    """Watches two live mappers for inter-fleet overlap; merges on a
    verified streak.

    A mapper here is any object with `.states` (SlamStates), `.n_robots`,
    `.graph_snapshot(i)` -> (gen, poses (cap, 3), pose_valid (cap,),
    n_poses, n_keyscans) in numpy, and `.merged_grid()`. Call `poll()`
    from the thread that drives both fleets: each poll is one sweep of
    wide matches. After `merged` turns True, `merged_grid`,
    `merged_states` and `transform` hold the shared world. `_lock` guards
    the streak and the result; the sweep runs outside it."""

    def __init__(self, cfg: SlamConfig, mapper_a, mapper_b,
                 min_response: float = 0.35, consecutive: int = 2,
                 consistency_m: float = 0.3,
                 consistency_rad: float = 0.3, max_seeds: int = 8,
                 min_keyscans: int = 3):
        self.cfg = cfg
        self.mapper_a = mapper_a
        self.mapper_b = mapper_b
        self.min_response = min_response
        self.consecutive = consecutive
        self.consistency_m = consistency_m
        self.consistency_rad = consistency_rad
        self.max_seeds = max_seeds
        self.min_keyscans = min_keyscans
        self._lock = threading.Lock()
        #: Streak of implied transforms (3,) float32.
        self._streak: List[np.ndarray] = []
        self.transform: Optional[np.ndarray] = None
        self.merged_grid = None
        self.merged_states: Optional[List] = None
        self.n_attempts = 0
        self.n_accepted = 0
        self.merged = False

    # -- sweep ingredients ---------------------------------------------------

    def _seeds(self) -> np.ndarray:
        """Candidate poses in A's frame: every A robot's live pose, then
        an even subsample of A's valid graph poses, at most
        `max_seeds`."""
        seeds = [_np(st.pose) for st in self.mapper_a.states]
        for i in range(self.mapper_a.n_robots):
            _gen, poses, valid, n, _k = self.mapper_a.graph_snapshot(i)
            idx = np.nonzero(valid[:n])[0]
            if len(idx):
                take = max(1, len(idx) // max(1, self.max_seeds))
                seeds.extend(poses[idx[::take]])
        seeds = np.asarray(seeds, np.float32).reshape(-1, 3)
        return seeds[:self.max_seeds]

    def _probe(self):
        """Fleet B's freshest key (scan, pose in B) pair, the ring slot at
        the graph tip, or None before enough chain exists."""
        best = None
        for j in range(self.mapper_b.n_robots):
            st = self.mapper_b.states[j]
            n = int(st.graph.n_poses)
            if n >= self.min_keyscans and (best is None or n > best[0]):
                best = (n, j, st)
        if best is None:
            return None
        n, j, st = best
        ranges = _np(st.scan_ring[n - 1])
        pose_b = _np(st.graph.poses[n - 1])
        if not ranges.any():
            return None                  # an empty ring slot
        return j, ranges, pose_b

    # -- the per-cadence attempt --------------------------------------------

    def poll(self) -> bool:
        """One overlap attempt; returns the merged flag (idempotent after
        the merge)."""
        if self.merged:
            return True
        probe = self._probe()
        if probe is None:
            return False
        j, ranges, pose_b = probe
        grid_a = self.mapper_a.merged_grid()
        dev = grid_a.device
        ranges_t = torch.as_tensor(ranges, device=dev)
        seeds_t = torch.as_tensor(self._seeds(), device=dev)
        best_pose, best_resp = None, -1.0
        with GM.stages.stage("rendezvous.sweep"):
            for seed in seeds_t:
                res = relocalize_match(self.cfg, grid_a, ranges_t, seed)
                head = torch.cat([res.pose[0], res.response,
                                  res.accepted.to(torch.float32)]).tolist()
                if head[4]:
                    if head[3] > best_resp:
                        best_resp = head[3]
                        best_pose = np.asarray(head[:3], np.float32)
        GM.counters.inc("rendezvous.attempts")
        if best_pose is None or best_resp < self.min_response:
            with self._lock:
                self.n_attempts += 1
                self._streak.clear()
            return False
        T = se2_from_pair(best_pose, pose_b)
        with self._lock:
            self.n_attempts += 1
            self.n_accepted += 1
            if self._streak:
                t0 = self._streak[0]
                if (math.hypot(float(T[0] - t0[0]), float(T[1] - t0[1]))
                        > self.consistency_m
                        or abs(_wrap(float(T[2] - t0[2])))
                        > self.consistency_rad):
                    # Another basin than the streak head: restart the
                    # streak from this candidate.
                    self._streak.clear()
            self._streak.append(T)
            streak_len = len(self._streak)
            done = streak_len >= self.consecutive
            if done:
                verified = self._streak[-1]
                self._streak.clear()
        # The handshake trail, recorded after the lock releases: a
        # postmortem of a wrong-basin merge reads the whole streak.
        flight_recorder.record("rendezvous_accept", robot=j,
                               streak=streak_len,
                               response=round(best_resp, 4))
        if not done:
            return False
        self._finish_merge(j, verified, best_pose)
        return True

    def _finish_merge(self, j: int, T: np.ndarray,
                      verified_pose: np.ndarray) -> None:
        """Build the shared world (outside `_lock`: device work) and
        publish it."""
        grid, states = merge_fleets(
            self.cfg, list(self.mapper_a.states),
            list(self.mapper_b.states), T, anchor=(j, verified_pose))
        with self._lock:
            self.transform = T
            self.merged_grid = grid
            self.merged_states = states
            self.merged = True
        GM.counters.inc("rendezvous.merges")
        flight_recorder.record(
            "rendezvous_merge", robot=j,
            transform=[round(float(v), 4) for v in T])

    def snapshot(self) -> dict:
        with self._lock:
            return {
                "merged": self.merged,
                "n_attempts": self.n_attempts,
                "n_accepted": self.n_accepted,
                "streak": len(self._streak),
                "transform": (None if self.transform is None
                              else [round(float(v), 4)
                                    for v in self.transform]),
            }
