"""Voxel mapper node: depth images -> the fleet's shared 3D log-odds map.

Port of the JAX package's `bridge/voxel_mapper.py`, the 3D counterpart of
`bridge/mapper.py` in the node graph. It subscribes `{ns}depth`
(Best-Effort sensor QoS) and `{ns}odom` per robot, pairs each depth image
with the freshest odometry at or before its stamp (the 2D mapper's
drop- and reorder-tolerant pairer), and fuses each tick's images in one
`ops.voxel.fuse_depths` call (kernel K6 on the card) into ONE shared voxel
grid for the whole fleet, on the stack's device.

SLAM coupling, as in the JAX package:

* Every image fuses at the CORRECTED pose: the 2D mapper's live map->odom
  correction (`mapper.depth_anchor`) applied to the image's paired
  odometry, so the 3D map lives in the map frame.
* A bounded depth-keyframe ring (`VoxelConfig.keyframe_cap`, a per-fleet
  bound shared equally by the robots) stores a keyframe when the robot has
  moved past the 2D key-scan gate, anchored to the robot's current graph
  node as a relative pose; a full ring halves its density.
* After a loop closure the grid is RE-FUSED from the keyframe ring at the
  optimized node poses (`_refuse_from_keyframes`). Graph thinning halves
  node indices; keyframes carry their capture-time thin count
  (`_ThinSim`) and re-anchor through `idx >> (thins_now - thins_then)`.

Standalone (mapper=None) the node maps in the odom frame. The per-image
SE(2) correction math runs on host numpy 3-vectors, as the JAX package
keeps it. A tick's images and poses go to the device in one copy; the
grid only comes back for the exports that need it on the host.
"""

from __future__ import annotations

import functools
import math
import threading
from typing import List, Optional

import numpy as np
import torch

from jax_mapping_torch._util import resolve_device
from jax_mapping_torch.bridge.brain import robot_ns
from jax_mapping_torch.bridge.bus import Bus
from jax_mapping_torch.bridge.messages import (DepthImage, Header, Odometry,
                                               VoxelPoints)
from jax_mapping_torch.bridge.node import Node
from jax_mapping_torch.bridge.odom_pairing import OdomPairer
from jax_mapping_torch.bridge.qos import QoSProfile, qos_sensor_data
from jax_mapping_torch.bridge.tf import TfTree
from jax_mapping_torch.config import SlamConfig
from jax_mapping_torch.ops import voxel as V
from jax_mapping_torch.utils import global_metrics as M


# Host-side SE(2) mirrors of ops/odometry.pose_compose/pose_between: the
# per-image correction math runs on 3-vectors, where a device round trip
# per image would dominate the tick.

def _se2_compose(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ca, sa = math.cos(a[2]), math.sin(a[2])
    return np.array([a[0] + ca * b[0] - sa * b[1],
                     a[1] + sa * b[0] + ca * b[1],
                     a[2] + b[2]], np.float32)


def _se2_between(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    ca, sa = math.cos(a[2]), math.sin(a[2])
    dx, dy = b[0] - a[0], b[1] - a[1]
    dth = (b[2] - a[2] + math.pi) % (2.0 * math.pi) - math.pi
    return np.array([ca * dx + sa * dy, -sa * dx + ca * dy, dth],
                    np.float32)


class _Keyframe:
    """One depth keyframe, anchored to a 2D graph node."""

    __slots__ = ("depth", "rel", "node_idx", "thins", "gen")

    def __init__(self, depth, rel, node_idx, thins, gen):
        self.depth = depth          # (H, W) np.float32
        self.rel = rel              # (3,) pose in the anchor node's frame
        self.node_idx = node_idx    # graph node index at capture
        self.thins = thins          # graph thin count at capture
        self.gen = gen              # mapper state generation at capture


class _ThinSim:
    """Per-robot replica of the 2D graph's thinning schedule.

    The SLAM step thins exactly when a key add finds the ring full
    (n >= cap -> n = (cap + 1) // 2), so the thin count after k key scans
    is a function of k; advancing this mirror to the mapper's n_keyscans
    tells the keyframe ring how often node indices have halved since each
    capture."""

    __slots__ = ("cap", "k", "n", "t")

    def __init__(self, cap: int):
        self.cap, self.k, self.n, self.t = cap, 0, 0, 0

    def thins_at(self, k: int) -> int:
        if k < self.k:              # fresh chain (/initialpose, restore)
            self.k, self.n, self.t = 0, 0, 0
        while self.k < k:
            if self.n >= self.cap:
                self.n = (self.cap + 1) // 2
                self.t += 1
            self.n += 1
            self.k += 1
        return self.t


class VoxelMapperNode(Node):
    """Device-resident 3D mapping behind the topic contract."""

    def __init__(self, cfg: SlamConfig, bus: Bus,
                 tf: Optional[TfTree] = None, n_robots: int = 1,
                 tick_period_s: Optional[float] = None, mapper=None,
                 device=None):
        super().__init__("jax_voxel_mapper", bus, tf)
        V._check_patch_coverage(cfg.voxel, cfg.depthcam)
        self.cfg = cfg
        self.n_robots = n_robots
        #: The 2D MapperNode whose corrections and graph this node
        #: follows; None = standalone odom-frame mapping.
        self.mapper = mapper
        #: The device of the grid: the mapper's, else the CUDA card
        #: unless the caller asks for another.
        self.device = (mapper.device if device is None and mapper is not None
                       else resolve_device(device))

        self._lock = threading.Lock()
        self.grid = V.empty_voxel_grid(cfg.voxel, self.device)
        self._depth_q: List[List[DepthImage]] = [[] for _ in range(n_robots)]
        self._pairer = OdomPairer(n_robots)
        self.n_images_fused = 0
        self.n_images_dropped_unpaired = 0
        #: Bumped on out-of-band grid replacement (restore_grid, closure
        #: re-fuse); cache keys combine it with n_images_fused.
        self.map_revision = 0

        # SLAM-coupled state (all under self._lock).
        self._keyframes: List[List[_Keyframe]] = \
            [[] for _ in range(n_robots)]
        self._last_kf_pose: List[Optional[np.ndarray]] = [None] * n_robots
        self._thin_sim = [_ThinSim(cfg.loop.max_poses)
                          for _ in range(n_robots)]
        self._loops_seen = 0
        self.n_keyframes_stored = 0
        self.n_refuses = 0

        for i in range(n_robots):
            ns = robot_ns(i, n_robots)
            self.create_subscription(
                f"{ns}depth", functools.partial(self._depth_cb, i),
                qos_sensor_data)
            self.create_subscription(
                f"{ns}odom", functools.partial(self._odom_cb, i),
                QoSProfile(depth=50))

        self.points_pub = self.create_publisher("/voxel_points")
        #: Point export cap: RViz chokes long before a mapped grid's
        #: millions of occupied voxels.
        self.max_points = 65536

        period = tick_period_s if tick_period_s is not None \
            else 1.0 / cfg.robot.control_rate_hz
        self.create_timer(period, self.tick)
        self.create_timer(cfg.map_publish_period_s, self.publish_points)

    # -- callbacks ----------------------------------------------------------

    def _depth_cb(self, i: int, msg: DepthImage) -> None:
        with self._lock:
            self._depth_q[i].append(msg)

    def _odom_cb(self, i: int, msg: Odometry) -> None:
        with self._lock:
            self._pairer.push(i, msg)

    # -- SLAM coupling ------------------------------------------------------

    def _corrected_pose(self, anchor, od_pose: np.ndarray) -> np.ndarray:
        """Corrected world pose of an image paired with od_pose; anchor
        from mapper.depth_anchor (None = uncorrected: standalone, or
        before the 2D mapper's first step)."""
        if anchor is None:
            return od_pose
        _, est, odom_then, _, _, _ = anchor
        # T_map_odom = est o odom_then^-1, applied to the capture odom.
        return _se2_compose(est, _se2_between(odom_then, od_pose))

    def _maybe_keyframe(self, i: int, depth: np.ndarray,
                        corrected: np.ndarray, anchor) -> None:
        """Store a depth keyframe when the robot moved past the 2D
        key-scan gate."""
        if anchor is None or anchor[3] < 0:
            # No graph node to anchor to (localization mode: no graph,
            # no closures, so keyframes would never re-fuse).
            return
        m = self.cfg.matcher
        last = self._last_kf_pose[i]
        if last is not None:
            d = math.hypot(corrected[0] - last[0], corrected[1] - last[1])
            dth = abs((corrected[2] - last[2] + math.pi)
                      % (2.0 * math.pi) - math.pi)
            if d <= m.min_travel_m and dth <= m.min_heading_rad:
                return
        gen, _, _, node_idx, node_pose, k_then = anchor
        kf = _Keyframe(depth=np.array(depth, np.float32, copy=True),
                       rel=_se2_between(node_pose, corrected),
                       node_idx=node_idx,
                       thins=self._thin_sim[i].thins_at(k_then),
                       gen=gen)
        with self._lock:
            ring = self._keyframes[i]
            ring.append(kf)
            # keyframe_cap bounds the FLEET: each robot's ring gets an
            # equal share of the slots.
            if len(ring) > max(1, self.cfg.voxel.keyframe_cap
                               // self.n_robots):
                # Ring full: halve its density (even decimation).
                self._keyframes[i] = ring[::2]
                M.counters.inc("voxel_mapper.keyframe_thins")
        self._last_kf_pose[i] = corrected
        self.n_keyframes_stored += 1
        M.counters.inc("voxel_mapper.keyframes")

    def _to_device(self, depths: List[np.ndarray], poses: List[np.ndarray]):
        """(B, H, W) depths and (B, 3) poses on the device, in one copy."""
        d = np.stack(depths).astype(np.float32)
        p = np.stack(poses).astype(np.float32)
        buf = torch.as_tensor(np.concatenate([d.reshape(-1), p.reshape(-1)]),
                              device=self.device)
        return buf[:d.size].reshape(d.shape), buf[d.size:].reshape(p.shape)

    def _refuse_from_keyframes(self) -> None:
        """Rebuild the voxel grid from the keyframe ring at the OPTIMIZED
        graph poses, the 3D analog of the 2D ring re-fusion after a loop
        closure. Keyframes from a stale state generation (a chain reset
        since capture) are dropped; keyframes whose anchor node thinned
        away re-anchor to the surviving even node at or before it."""
        depths, poses = [], []
        for i in range(self.n_robots):
            gen, node_poses, node_valid, n_now, k_now = \
                self.mapper.graph_snapshot(i)
            t_now = self._thin_sim[i].thins_at(k_now)
            with self._lock:
                keep = [kf for kf in self._keyframes[i] if kf.gen == gen]
                self._keyframes[i] = keep
                ring = list(keep)
            for kf in ring:
                idx = kf.node_idx >> (t_now - kf.thins)
                if idx >= n_now or not bool(node_valid[idx]):
                    continue
                depths.append(kf.depth)
                poses.append(_se2_compose(node_poses[idx], kf.rel))
        if not depths:
            return
        with self._lock:
            base_revision = self.map_revision
        with M.stages.stage("voxel_mapper.refuse"):
            d, p = self._to_device(depths, poses)
            grid = V.fuse_depths(self.cfg.voxel, self.cfg.depthcam,
                                 V.empty_voxel_grid(self.cfg.voxel,
                                                    self.device), d, p)
            with self._lock:
                if self.map_revision != base_revision:
                    M.counters.inc("voxel_mapper.fuse_dropped_stale")
                    return
                self.grid = grid
                # Content replaced out of band of n_images_fused: bump so
                # caches keyed on (fused, revision) refresh.
                self.map_revision += 1
        self.n_refuses += 1
        M.counters.inc("voxel_mapper.refuses", 1)

    # -- device step --------------------------------------------------------

    def tick(self) -> None:
        """Drain the queues and fuse the tick's images in one call at
        corrected poses; re-fuse from keyframes when the 2D mapper closed
        a loop."""
        cam = self.cfg.depthcam
        with self._lock:
            work = []
            for i in range(self.n_robots):
                for msg in sorted(self._depth_q[i],
                                  key=lambda m: m.header.stamp):
                    od = self._pairer.pair(i, msg.header.stamp)
                    if od is None:
                        self.n_images_dropped_unpaired += 1
                        M.counters.inc("voxel_mapper.images_unpaired")
                        continue
                    if msg.depth.shape != (cam.height_px, cam.width_px):
                        # Shape drift would mis-project through the
                        # pinhole model: refuse it, in the counters.
                        M.counters.inc("voxel_mapper.images_bad_shape")
                        continue
                    work.append((i, msg.depth, od.pose))
                self._depth_q[i].clear()
        if work:
            # One anchor snapshot per robot per tick: the correction basis
            # moves at the 2D mapper's step cadence, not per image.
            anchors = {}
            for i in {i for i, _, _ in work}:
                anchors[i] = self.mapper.depth_anchor(i) \
                    if self.mapper is not None else None
            depths, poses = [], []
            for i, depth, od_pose in work:
                od_np = np.array([od_pose.x, od_pose.y, od_pose.theta],
                                 np.float32)
                corrected = self._corrected_pose(anchors[i], od_np)
                depths.append(depth)
                poses.append(corrected)
                self._maybe_keyframe(i, depth, corrected, anchors[i])
            with M.stages.stage("voxel_mapper.fuse"):
                with self._lock:
                    base_grid = self.grid
                    base_revision = self.map_revision
                d, p = self._to_device(depths, poses)
                grid = V.fuse_depths(self.cfg.voxel, cam, base_grid, d, p)
                with self._lock:
                    # The mapper's stale-state guard: a restore_grid
                    # landing while this fused would be overwritten by a
                    # grid fused from the pre-restore state. Drop the
                    # fused result; the images are lost, the restored map
                    # is not.
                    if self.map_revision != base_revision \
                            or self.grid is not base_grid:
                        M.counters.inc("voxel_mapper.fuse_dropped_stale")
                        grid = None
                    else:
                        self.grid = grid
            if grid is not None:
                self.n_images_fused += len(work)
                M.counters.inc("voxel_mapper.images_fused", len(work))
        if self.mapper is not None:
            loops = self.mapper.n_loops_closed
            if loops != self._loops_seen:
                self._loops_seen = loops
                self._refuse_from_keyframes()

    # -- exports ------------------------------------------------------------

    def voxel_grid(self) -> torch.Tensor:
        with self._lock:
            return self.grid

    def height_map(self) -> np.ndarray:
        """(Y, X) float32 metres, a writable host copy (-1 where the
        column holds no occupied voxel)."""
        return np.array(V.height_map(self.cfg.voxel,
                                     self.voxel_grid()).cpu().numpy())

    def obstacle_slice(self, z_min_m: float, z_max_m: float) -> np.ndarray:
        """(Y, X) bool, a writable host copy."""
        return np.array(V.obstacle_slice(self.cfg.voxel, self.voxel_grid(),
                                         z_min_m, z_max_m).cpu().numpy())

    # -- serving surface ----------------------------------------------------

    def serving_revision(self) -> int:
        """Monotonic content revision: every grid change bumps exactly
        one of two nondecreasing counters (`n_images_fused` for fusions,
        `map_revision` for out-of-band replacements), so their sum
        strictly increases per change. A lock-free read."""
        return self.n_images_fused + self.map_revision

    def serving_snapshot(self):
        """(revision, height-map uint8 image in GRID orientation): the
        revision is read BEFORE the grid, so a fusion landing between the
        two leaves newer content under an older stamp (healed by the next
        read), never old content under a new one."""
        rev = self.n_images_fused + self.map_revision
        hm = V.height_map(self.cfg.voxel, self.voxel_grid()).cpu().numpy()
        return rev, self._height_to_gray(hm)

    def _height_to_gray(self, hm: np.ndarray) -> np.ndarray:
        """The height-to-grayscale palette: 0 = no occupied voxel in the
        column, 1..255 linear in top-surface height over the z extent."""
        _, _, ez = self.cfg.voxel.extent_m
        img = np.zeros(hm.shape, np.uint8)
        mapped = hm >= 0.0
        img[mapped] = (1.0 + 254.0 * np.clip(hm[mapped] / ez, 0.0, 1.0)) \
            .astype(np.uint8)
        return img

    # -- checkpoint surface -------------------------------------------------

    def snapshot_grid(self) -> torch.Tensor:
        """The 3D map state for checkpoints (the grid is the whole device
        state; the counters are telemetry)."""
        return self.voxel_grid()

    def snapshot_keyframes(self) -> dict:
        """The depth-keyframe ring as flat arrays for the keyframe
        checkpoint sidecar (`io/checkpoint.save_keyframe_sidecar`). State
        generations are process-local and not saved: restore_keyframes
        re-tags with the live generation."""
        with self._lock:
            kfs = [(i, kf) for i in range(self.n_robots)
                   for kf in self._keyframes[i]]
        H, W = self.cfg.depthcam.height_px, self.cfg.depthcam.width_px
        return {
            "depths": (np.stack([kf.depth for _, kf in kfs])
                       if kfs else np.zeros((0, H, W), np.float32)),
            "rels": np.asarray([kf.rel for _, kf in kfs],
                               np.float32).reshape(len(kfs), 3),
            "node_idx": np.asarray([kf.node_idx for _, kf in kfs],
                                   np.int32),
            "thins": np.asarray([kf.thins for _, kf in kfs], np.int32),
            "robot": np.asarray([i for i, _ in kfs], np.int32),
        }

    def validate_keyframes(self, kf: dict) -> None:
        """Raise ValueError if a keyframe sidecar cannot be restored into
        this node (shape or robot-range drift), before anything is
        touched."""
        H, W = self.cfg.depthcam.height_px, self.cfg.depthcam.width_px
        depths = np.asarray(kf["depths"], np.float32)
        if depths.ndim != 3 or depths.shape[1:] != (H, W):
            raise ValueError(
                f"keyframe depths shape {depths.shape} != (K, {H}, {W})")
        robots = np.asarray(kf["robot"], np.int32)
        if len(robots) != len(depths):
            raise ValueError(
                f"keyframe arrays disagree: {len(robots)} robot ids vs "
                f"{len(depths)} depths")
        if len(robots) and (robots.min() < 0
                            or robots.max() >= self.n_robots):
            raise ValueError(
                f"keyframe robot ids outside 0..{self.n_robots - 1}")

    def restore_keyframes(self, kf: dict) -> None:
        """Repopulate the ring from a keyframe sidecar. Valid only beside
        a graph-preserving state restore: the node anchors refer to the
        checkpointed graphs. A re-anchored resume (demo --resume, fresh
        chains) must not call this (restore_grid clears the ring).
        Keyframes take each robot's LIVE state generation, so a later
        chain reset still invalidates them."""
        self.validate_keyframes(kf)
        depths = np.asarray(kf["depths"], np.float32)
        robots = np.asarray(kf["robot"], np.int32)
        gens = [self.mapper.graph_snapshot(i)[0] if self.mapper is not None
                else 0 for i in range(self.n_robots)]
        rings: List[List[_Keyframe]] = [[] for _ in range(self.n_robots)]
        for k in range(len(robots)):
            i = int(robots[k])
            rings[i].append(_Keyframe(
                depth=depths[k],
                rel=np.asarray(kf["rels"][k], np.float32),
                node_idx=int(kf["node_idx"][k]),
                thins=int(kf["thins"][k]),
                gen=gens[i]))
        with self._lock:
            self._keyframes = rings
        # Fresh gating and thin replicas: thins_at() re-simulates from the
        # restored n_keyscans on next use.
        self._last_kf_pose = [None] * self.n_robots
        self._thin_sim = [_ThinSim(self.cfg.loop.max_poses)
                          for _ in range(self.n_robots)]

    def restore_grid(self, grid) -> None:
        """Install a checkpointed grid (any array the device copy reads):
        the revision moves, and the keyframe ring, which belongs to the
        pre-restore trajectory, is cleared."""
        g = (grid if torch.is_tensor(grid) else torch.as_tensor(
            np.asarray(grid))).to(self.device, torch.float32)
        want = (self.cfg.voxel.size_z_cells, self.cfg.voxel.size_y_cells,
                self.cfg.voxel.size_x_cells)
        if tuple(g.shape) != want:
            raise ValueError(
                f"voxel checkpoint shape {tuple(g.shape)} != configured "
                f"{want}")
        with self._lock:
            self.grid = g
            # Content changed without fusing: caches keyed on
            # n_images_fused must see a new revision.
            self.map_revision += 1
            # A later closure re-fuse from the old trajectory's keyframes
            # would overwrite the restored map with stale geometry.
            for ring in self._keyframes:
                ring.clear()
        self._last_kf_pose = [None] * self.n_robots

    def publish_points(self) -> None:
        """Occupied-voxel centres on `/voxel_points` (uniformly subsampled
        past `max_points`), the 3D analog of the mapper's /map publish."""
        pts = V.occupied_voxel_centers(self.cfg.voxel, self.voxel_grid())
        if len(pts) > self.max_points:
            idx = np.linspace(0, len(pts) - 1, self.max_points) \
                .round().astype(int)
            pts = pts[idx]
        self.points_pub.publish(VoxelPoints(header=Header.now("map"),
                                            points=pts))

    def height_map_image(self) -> np.ndarray:
        """(Y, X) uint8 grayscale, flipped up-down for image coordinates
        (the /map-image convention)."""
        return np.flipud(self._height_to_gray(self.height_map()))
