"""Single-robot SLAM: the per-robot step the mapper runs for every robot.

Port of the JAX package's `models/slam.py`:

  odometry -> key-scan gate (0.1 m / 0.1 rad) -> correlative scan match
  -> fusion -> pose-graph insert -> loop-closure search and verification
  -> optimise -> map repair by re-fusing the key-scan ring.

`slam_step` runs one scan; `slam_step_window` runs a burst of W scans:
the leading W-1 fuse as one shared-patch window (kernel K5, or the exact
per-scan fold when they do not fit one patch) and the last runs
`slam_step`. State lives on one device (CUDA unless `init_state` is asked
for the CPU); `SlamState.graph` is one pose graph in the JAX layout
(leaves without a robot axis).

Both step functions are pure: they return a new state and leave the
input state's tensors as they were (the fusion works on a copy of the
grid, 64 MiB at the default config), so a caller can drop a step's result
and keep its input, as the mapper does when it rejects a window.

The JAX step is one jitted program whose branches are `lax.cond`s. Here
they are Python `if`s on values read from the device. Host syncs of a key
step: (1) the key gate, read together with the graph's pose count; (2)
the patch origin of the fused scan (`grid._fold`); (3) whether a loop
candidate was found. A verified candidate adds (4) the verification's
acceptance, plus the folds of the chain map and of the ring re-fuse. A
non-key step has (1) only. `slam_step_window` adds one for
`window_fits`. (`chip_smoke.py` counts the syncs: 5 in a key window step,
1 in a non-key single step.) Random draws: none.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch

from jax_mapping_torch._util import const, entry_point, resolve_device
from jax_mapping_torch.config import SlamConfig, ensure_valid_mode
from jax_mapping_torch.ops import grid as G
from jax_mapping_torch.ops import posegraph as PG
from jax_mapping_torch.ops import scan_match as M
from jax_mapping_torch.ops.odometry import pose_between, rk2_step, wrap_angle

_LOOP_W = (200.0, 400.0)        # verified loop edge information (t, theta)


class SlamState(NamedTuple):
    grid: torch.Tensor           # (N, N) log-odds
    pose: torch.Tensor           # (3,) current estimate (map frame)
    last_key_pose: torch.Tensor  # (3,) pose at the last accepted key-scan
    graph: PG.PoseGraph          # one graph, leaves without a robot axis
    scan_ring: torch.Tensor      # (max_poses, padded_beams) key-scans
    n_loops: torch.Tensor        # () int32 closed loops
    n_keyscans: torch.Tensor     # () int32


class SlamDiag(NamedTuple):
    matched: torch.Tensor            # () bool: the matcher accepted
    response: torch.Tensor           # () float32
    key_added: torch.Tensor          # () bool
    loop_closed: torch.Tensor        # () bool
    window_agreement: torch.Tensor   # () float32 in [0, 1]
    cov: torch.Tensor                # (3,) match covariance diag
    match_candidates: torch.Tensor   # () int32
    match_prune_ratio: torch.Tensor  # () float32


def init_state(cfg: SlamConfig, pose0=None, device=None) -> SlamState:
    """Fresh state on `device` (None: the CUDA card, raising without one)."""
    dev = resolve_device(device)
    pose = (torch.zeros(3, dtype=torch.float32, device=dev) if pose0 is None
            else torch.as_tensor(pose0, dtype=torch.float32, device=dev))
    return SlamState(
        grid=G.empty_grid(cfg.grid, dev),
        pose=pose,
        last_key_pose=torch.full((3,), 1e9, dtype=torch.float32,
                                 device=dev),   # forces the first key-scan
        graph=PG.single_graph(cfg.loop, dev),
        scan_ring=torch.zeros((cfg.loop.max_poses, cfg.scan.padded_beams),
                              dtype=torch.float32, device=dev),
        n_loops=torch.zeros((), dtype=torch.int32, device=dev),
        n_keyscans=torch.zeros((), dtype=torch.int32, device=dev),
    )


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


def _f32(x, dev) -> torch.Tensor:
    """x as float32 on dev; a Python number is filled in on the device
    (a copy from the host would wait for the stream)."""
    if torch.is_tensor(x):
        return x.to(device=dev, dtype=torch.float32)
    return torch.full((), x, dtype=torch.float32, device=dev)


def _skip_diag(dev) -> SlamDiag:
    z = torch.zeros((), dtype=torch.float32, device=dev)
    f = torch.zeros((), dtype=torch.bool, device=dev)
    return SlamDiag(matched=f, response=z, key_added=f, loop_closed=f,
                    window_agreement=torch.ones((), dtype=torch.float32,
                                                device=dev),
                    cov=torch.zeros(3, dtype=torch.float32, device=dev),
                    match_candidates=torch.zeros((), dtype=torch.int32,
                                                 device=dev),
                    match_prune_ratio=z)


@entry_point(static=("cfg",))
def slam_step(cfg: SlamConfig, state: SlamState, ranges: torch.Tensor,
              wheel_left, wheel_right, dt) -> tuple:
    """One control-period update of one robot: odometry, the key-scan
    gate, then on a key scan the match, fusion, pose-graph insert and loop
    closure. ranges (padded_beams,); the wheel speeds (raw units) and dt
    are scalars or 0-d tensors. Returns (state, diag)."""
    ensure_valid_mode(cfg)
    dev = state.pose.device
    m = cfg.matcher
    pose_odo = rk2_step(cfg.robot, state.pose, _f32(wheel_left, dev),
                        _f32(wheel_right, dev), _f32(dt, dev))

    # Key-scan gate; the pose count comes along in the same host read.
    dxy = pose_odo[:2] - state.last_key_pose[:2]
    d = torch.sqrt(dxy[0] * dxy[0] + dxy[1] * dxy[1])
    dth = torch.abs(wrap_angle(pose_odo[2] - state.last_key_pose[2]))
    is_key = (d > m.min_travel_m) | (dth > m.min_heading_rad)
    key, n_poses = torch.stack([is_key.to(torch.int32),
                                state.graph.n_poses]).tolist()   # sync 1
    if not key:
        return state._replace(pose=pose_odo), _skip_diag(dev)

    res = M.match(cfg.grid, cfg.scan, m, state.grid, ranges, pose_odo)
    pose = torch.where(res.accepted[0], res.pose[0], pose_odo)
    diag = SlamDiag(matched=res.accepted[0], response=res.response[0],
                    key_added=torch.ones((), dtype=torch.bool, device=dev),
                    loop_closed=torch.zeros((), dtype=torch.bool,
                                            device=dev),
                    window_agreement=torch.ones((), dtype=torch.float32,
                                                device=dev),
                    cov=res.cov[0], match_candidates=res.n_candidates[0],
                    match_prune_ratio=res.prune_ratio[0])

    if cfg.mode == "localization":
        # Track against a frozen map: no fusion, no graph growth, no loop
        # closures.
        diag = diag._replace(key_added=torch.zeros_like(diag.key_added))
        return state._replace(pose=pose, last_key_pose=pose), diag

    # Pre-fusion map agreement at the chosen pose.
    agreement = _window_agreement(cfg, state.grid, ranges[None], pose[None])
    grid = G.fuse_scan(cfg.grid, cfg.scan, state.grid, ranges, pose)  # 2

    # A full ring first halves its keyframe density.
    graph0, ring0 = state.graph, state.scan_ring
    if n_poses >= cfg.loop.max_poses:
        g2, r2 = PG.thin_keyframes(PG.batch1(graph0), ring0[None])
        graph0, ring0 = PG.unbatch1(g2), r2[0]
        n_poses = (n_poses + 1) // 2
    k = n_poses
    graph = PG.add_pose(graph0, pose)
    if k > 0:
        graph = PG.odometry_edge(graph, k - 1, k)
    ring = ring0.clone()
    ring[min(k, cfg.loop.max_poses - 1)] = ranges

    closed = False
    if cfg.loop.enabled:
        cand_t, found_t = PG.loop_candidate(
            cfg.loop, PG.batch1(graph),
            torch.full((1,), k, dtype=torch.int32, device=dev))
        cand, found = torch.stack([cand_t[0],
                                   found_t[0].to(torch.int32)]).tolist()
        if found:                                                   # sync 3
            lres = _verify_loop(cfg, graph, ring, cand, k, ranges, pose)
            good = lres.accepted[0] & (lres.response[0]
                                       >= cfg.loop.response_fine)
            if bool(good):                                          # sync 4
                rel = pose_between(graph.poses[cand], lres.pose[0])
                w = const((_LOOP_W[0], _LOOP_W[0], _LOOP_W[1]), dev)
                graph = PG.add_edge(graph, cand, k, rel, w)
                graph = PG.unbatch1(PG.optimize(cfg.loop,
                                                PG.batch1(graph)))
                # Map repair: re-fuse every key-scan at its optimised
                # pose, masked on pose validity (a never-written ring slot
                # would carve a phantom free disc at the origin).
                cap = cfg.loop.max_poses
                grid = G.fuse_scans_masked(
                    cfg.grid, cfg.scan, G.empty_grid(cfg.grid, dev), ring,
                    graph.poses[:cap], graph.pose_valid[:cap])
                closed = True

    # After optimisation the current pose may have moved.
    if closed:
        pose = graph.poses[k]
    st2 = SlamState(grid=grid, pose=pose, last_key_pose=pose, graph=graph,
                    scan_ring=ring, n_loops=state.n_loops + int(closed),
                    n_keyscans=state.n_keyscans + 1)
    diag = diag._replace(
        loop_closed=torch.full((), closed, dtype=torch.bool, device=dev),
        window_agreement=agreement)
    return st2, diag


@entry_point(static=("cfg",))
def slam_step_window(cfg: SlamConfig, state: SlamState,
                     ranges_w: torch.Tensor, wheels_w: torch.Tensor,
                     dts_w) -> tuple:
    """A burst of W consecutive scans: odometry through the window, the
    leading W-1 scans fused as one shared-patch window (checked: a window
    that does not fit one patch takes the exact per-scan fold), and the
    last scan through `slam_step`. ranges_w (W, padded_beams); wheels_w
    (W, 2) raw wheel speeds; dts_w a scalar or (W,). W >= 2. The diag's
    window_agreement is that of the W-1 leading scans."""
    W = ranges_w.shape[0]
    if W < 2:
        raise ValueError(
            f"slam_step_window needs a window of >= 2 scans, got W={W}; "
            "feed single scans through slam_step")
    dev = state.pose.device
    dts_w = torch.broadcast_to(_f32(dts_w, dev), (W,))
    wheels_w = _f32(wheels_w, dev)

    # Scan i is taken at the pose after integrating wheels_w[i].
    p, poses = state.pose, []
    for i in range(W):
        p = rk2_step(cfg.robot, p, wheels_w[i, 0], wheels_w[i, 1], dts_w[i])
        poses.append(p)
    poses_w = torch.stack(poses)

    agreement = _window_agreement(cfg, state.grid, ranges_w[:-1],
                                  poses_w[:-1])
    if cfg.mode == "localization":
        grid = state.grid
    else:
        grid = G.fuse_scans_window_checked(cfg.grid, cfg.scan, state.grid,
                                           ranges_w[:-1].contiguous(),
                                           poses_w[:-1].contiguous())
    # Starting the last scan from the W-2th pose makes its own odometry
    # land on poses_w[-1].
    st = state._replace(grid=grid, pose=poses_w[-2])
    st2, diag = slam_step(cfg, st, ranges_w[-1], wheels_w[-1, 0],
                          wheels_w[-1, 1], dts_w[-1])
    return st2, diag._replace(window_agreement=agreement)


@entry_point(static=("cfg",))
def scan_agreement(cfg: SlamConfig, grid: torch.Tensor, ranges: torch.Tensor,
                   pose: torch.Tensor) -> torch.Tensor:
    """Pre-fusion map agreement (0-d) of one scan (beams,) at pose (3,)."""
    return _window_agreement(cfg, grid, ranges[None], pose[None])


def _window_agreement(cfg: SlamConfig, grid: torch.Tensor,
                      ranges_w: torch.Tensor,
                      poses_w: torch.Tensor) -> torch.Tensor:
    """Mean map agreement of scans (W, beams) at poses (W, 3) before they
    fuse: the share of hit endpoints that land on cells the map does not
    call confidently free. 1.0 when no hit lands in the grid."""
    g, s = cfg.grid, cfg.scan
    pts, hit = M.scan_points(s, ranges_w)
    cs = torch.cos(poses_w[:, 2])[:, None]
    sn = torch.sin(poses_w[:, 2])[:, None]
    x = poses_w[:, 0:1] + pts[:, :, 0] * cs - pts[:, :, 1] * sn
    y = poses_w[:, 1:2] + pts[:, :, 0] * sn + pts[:, :, 1] * cs
    cr = G.world_to_cell(g, torch.stack([x, y], dim=-1))
    cols = torch.floor(cr[..., 0]).to(torch.int64)
    rows = torch.floor(cr[..., 1]).to(torch.int64)
    n = g.size_cells
    inb = (rows >= 0) & (rows < n) & (cols >= 0) & (cols < n)
    vals = grid[rows.clamp(0, n - 1), cols.clamp(0, n - 1)]
    ok = hit & inb
    agree = (vals > g.free_threshold) & ok
    n_ok = ok.sum()
    frac = agree.sum().to(torch.float32) / \
        torch.clamp_min(n_ok, 1).to(torch.float32)
    return torch.where(n_ok == 0, torch.ones_like(frac), frac)
