"""Fleet model: N simulated Thymios exploring and mapping one shared world.

Port of the JAX package's `models/fleet.py`. One `fleet_step` closes the
whole loop for every robot at once:

  simulated LD06 scans -> frontier assignment -> explorer policy
  -> fleet kinematics -> odometry -> 0.1 m / 0.1 rad key-scan gate
  -> batched correlative matching -> masked log-odds fusion
  -> per-robot pose graphs, loop closure with shared-map re-fusion.

State lives on one device (CUDA unless the caller asks for the CPU) and
every stage carries a leading robot axis. The JAX step is one jitted
program; here the loop-closure branch (`lax.cond` there) is a Python `if`
on `(attempt | xattempt).any()`, which costs one host sync per tick, and
the fusion fold reads its patch origins on the host (one sync per fused
sub-batch). Random draws are inputs: `fleet_step` takes the (R, 2)
wheel-noise normals, or draws them from a `torch.Generator`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from jax_mapping_torch._util import const, resolve_device
from jax_mapping_torch.config import SlamConfig, ensure_valid_mode
from jax_mapping_torch.models.explorer import PolicyOut, frontier_policy
from jax_mapping_torch.models.slam import _verify_loop
from jax_mapping_torch.ops import frontier as F
from jax_mapping_torch.ops import grid as G
from jax_mapping_torch.ops import posegraph as PG
from jax_mapping_torch.ops import scan_match as M
from jax_mapping_torch.ops.odometry import pose_between, rk2_step, wrap_angle
from jax_mapping_torch.sim import lidar, thymio

_ODO_W = (50.0, 100.0)          # odometry edge information (t, theta)
_LOOP_W = (200.0, 400.0)        # verified loop edge information


class FleetState(NamedTuple):
    sim: thymio.FleetSimState       # ground truth
    est_poses: torch.Tensor         # (R, 3) SLAM estimates
    grid: torch.Tensor              # (N, N) shared log-odds map
    exploring: torch.Tensor         # (R,) bool
    last_key_poses: torch.Tensor    # (R, 3) pose at each last key-scan
    graphs: PG.PoseGraph            # per-robot graphs, leading (R,) axis
    scan_rings: torch.Tensor        # (R, max_poses, padded_beams)
    n_loops: torch.Tensor           # (R,) int32 closed loops per robot
    t: torch.Tensor                 # () int32 step counter


class FleetDiag(NamedTuple):
    policy: PolicyOut
    frontiers: F.FrontierResult
    match_response: torch.Tensor    # (R,)
    pose_err: torch.Tensor          # (R,) |est - truth|
    is_key: torch.Tensor            # (R,) bool
    loop_closed: torch.Tensor       # (R,) bool


def init_fleet_state(cfg: SlamConfig, device=None,
                     radius_uniforms: Optional[torch.Tensor] = None,
                     generator: Optional[torch.Generator] = None
                     ) -> FleetState:
    """Fresh fleet on `device` (None: the CUDA card, raising without one)."""
    dev = resolve_device(device)
    R = cfg.fleet.n_robots
    sim = thymio.init_fleet(cfg.robot, R, dev,
                            radius_uniforms=radius_uniforms,
                            generator=generator)
    return FleetState(
        sim=sim,
        est_poses=sim.poses.clone(),
        grid=G.empty_grid(cfg.grid, dev),
        exploring=torch.ones((R,), dtype=torch.bool, device=dev),
        last_key_poses=torch.full((R, 3), 1e9, dtype=torch.float32,
                                  device=dev),
        graphs=PG.empty_graph(cfg.loop, R, dev),
        scan_rings=torch.zeros((R, cfg.loop.max_poses,
                                cfg.scan.padded_beams),
                               dtype=torch.float32, device=dev),
        n_loops=torch.zeros((R,), dtype=torch.int32, device=dev),
        t=torch.zeros((), dtype=torch.int32, device=dev),
    )


def _norm2(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1])


def _update_graphs(cfg: SlamConfig, graphs: PG.PoseGraph, est: torch.Tensor,
                   is_key: torch.Tensor, scans: torch.Tensor,
                   rings: torch.Tensor):
    """Key robots append a pose, an odometry edge and a ring scan; a full
    ring thins first. Returns (graphs, rings, k_idx)."""
    cap = cfg.loop.max_poses
    R = est.shape[0]
    rr = torch.arange(R, device=est.device)
    need_thin = graphs.n_poses >= cap
    if bool(need_thin.any()):           # host sync, only to skip the work
        g2, ring2 = PG.thin_keyframes(graphs, rings, _ODO_W[0], _ODO_W[1])
        graphs = PG.select(need_thin, g2, graphs)
        rings = torch.where(need_thin[:, None, None], ring2, rings)
    k = graphs.n_poses.long()
    k_prev = torch.clamp_min(k - 1, 0)
    prev = graphs.poses[rr, k_prev.clamp_max(cap - 1)]
    g2 = PG.add_pose_if(graphs, est, is_key)
    meas = pose_between(prev, est)
    w = const((_ODO_W[0], _ODO_W[0], _ODO_W[1]), est.device)
    graphs = PG.add_edge_if(g2, k_prev, k, meas, w,
                            is_key & (k > 0) & (k < cap))
    slot = k.clamp_max(cap - 1)
    ok = is_key & (k < cap)
    rings = rings.clone()
    rings[rr, slot] = torch.where(ok[:, None], scans, rings[rr, slot])
    return graphs, rings, k.to(torch.int32)


def _cross_candidates(cfg: SlamConfig, graphs: PG.PoseGraph,
                      est: torch.Tensor):
    """Nearest OTHER robot's established chain pose within the loop radius:
    (robot (R,), pose index (R,), found (R,))."""
    R = est.shape[0]
    cap = cfg.loop.max_poses
    dev = est.device
    pos = graphs.poses[:, :, :2]
    d = _norm2(pos[None, :, :, :] - est[:, None, None, :2])    # (R, R, cap)
    established = graphs.n_poses >= cfg.loop.min_chain_size
    ok = (graphs.pose_valid & established[:, None])[None]
    ok = ok & ~torch.eye(R, dtype=torch.bool, device=dev)[:, :, None]
    flat = torch.where(ok, d, float("inf")).reshape(R, R * cap)
    best = torch.argmin(flat, dim=1)
    found = flat.gather(1, best[:, None])[:, 0] <= cfg.loop.search_radius_m
    return ((best // cap).to(torch.int32), (best % cap).to(torch.int32),
            found)


def _verify_and_optimize(cfg: SlamConfig, graphs: PG.PoseGraph,
                         rings: torch.Tensor, est: torch.Tensor,
                         scans: torch.Tensor, k_idx: torch.Tensor,
                         cand: torch.Tensor, attempt: torch.Tensor,
                         xrobot: torch.Tensor, xcand: torch.Tensor,
                         xattempt: torch.Tensor):
    """Verify every attempting robot against a chain map (own candidate,
    else a fleet-mate's), add loop or anchor edges, optimise the graphs
    that closed, and move their estimates. Returns (graphs, est, closed).

    The JAX step verifies all robots under `lax.map` and masks the ones
    not attempting; here only attempting robots are verified (the masked
    results are discarded either way), one at a time, so one extra chain
    grid is live at once."""
    cap = cfg.loop.max_poses
    R = est.shape[0]
    dev = est.device
    rr = torch.arange(R, device=dev)
    use_x = xattempt & ~attempt
    vrobot = torch.where(use_x, xrobot.long(), rr)
    vcand = torch.where(use_x, xcand.long(), cand.long())
    vk = torch.where(use_x, cap + cfg.loop.min_chain_size, k_idx.long())

    fine_pose = est.clone()
    fine_acc = torch.zeros(R, dtype=torch.bool, device=dev)
    fine_resp = torch.zeros(R, dtype=torch.float32, device=dev)
    run = (attempt | use_x).tolist()
    host = torch.stack([vrobot, vcand, vk]).tolist()
    for r in range(R):
        if not run[r]:
            continue
        v, c, q = host[0][r], host[1][r], host[2][r]
        res = _verify_loop(cfg, PG.index(graphs, v), rings[v], c, q,
                           scans[r], est[r])
        fine_pose[r] = res.pose[0]
        fine_acc[r] = res.accepted[0]
        fine_resp[r] = res.response[0]
    closed = (attempt | use_x) & fine_acc & \
        (fine_resp >= cfg.loop.response_fine)

    # Loop edges: own loop cand -> q; cross relocalisation overwrites the
    # newest node with the verified pose and anchors (q-1) -> q.
    q = k_idx.long()
    qc = q.clamp_max(cap - 1)
    poses = graphs.poses.clone()
    poses[rr, qc] = torch.where((closed & use_x & (q < cap))[:, None],
                                fine_pose, poses[rr, qc])
    g = graphs._replace(poses=poses)
    src = torch.where(use_x, torch.clamp_min(q - 1, 0), cand.long())
    rel = pose_between(poses[rr, src], fine_pose)
    w = const((_LOOP_W[0], _LOOP_W[0], _LOOP_W[1]), dev)
    ok = closed & (q < cap) & (~use_x | (q > 0))
    graphs2 = PG.add_edge_if(g, src, q, rel, w, ok)

    graphs3 = graphs2
    closed_idx = torch.nonzero(closed).flatten()
    if closed_idx.numel():
        opt = PG.optimize(cfg.loop, PG.index(graphs2, closed_idx))
        graphs3 = graphs2._replace(poses=graphs2.poses.index_copy(
            0, closed_idx, opt.poses))
    est2 = torch.where(closed[:, None], graphs3.poses[rr, qc], est)
    return graphs3, est2, closed


def _close_loops(cfg: SlamConfig, graphs: PG.PoseGraph, grid: torch.Tensor,
                 rings: torch.Tensor, est: torch.Tensor, scans: torch.Tensor,
                 k_idx: torch.Tensor, cand: torch.Tensor,
                 attempt: torch.Tensor, xrobot: torch.Tensor,
                 xcand: torch.Tensor, xattempt: torch.Tensor):
    """Closure plus shared-map repair: when any robot closed, re-fuse
    every robot's key-scan ring at its (re-optimised) poses into an empty
    grid. Returns (graphs, grid, est, closed)."""
    graphs3, est2, closed = _verify_and_optimize(
        cfg, graphs, rings, est, scans, k_idx, cand, attempt, xrobot,
        xcand, xattempt)
    if bool(closed.any()):
        R, cap, beams = rings.shape
        grid = G.fuse_scans_masked(
            cfg.grid, cfg.scan, G.empty_grid(cfg.grid, grid.device),
            rings.reshape(R * cap, beams),
            graphs3.poses[:, :cap].reshape(R * cap, 3),
            graphs3.pose_valid[:, :cap].reshape(R * cap))
    return graphs3, grid, est2, closed


class _TickPre(NamedTuple):
    sim2: thymio.FleetSimState
    pol: PolicyOut
    fr: F.FrontierResult
    match_response: torch.Tensor
    est: torch.Tensor
    is_key: torch.Tensor
    grid: torch.Tensor
    graphs: PG.PoseGraph
    rings: torch.Tensor
    k_idx: torch.Tensor
    scans: torch.Tensor
    cand: torch.Tensor
    attempt: torch.Tensor
    xrobot: torch.Tensor
    xcand: torch.Tensor
    xattempt: torch.Tensor


class _TickMove(NamedTuple):
    sim2: thymio.FleetSimState
    measured: torch.Tensor
    pol: PolicyOut
    fr: F.FrontierResult
    scans: torch.Tensor


def _tick_move(cfg: SlamConfig, state: FleetState, world_res_m: float,
               world: torch.Tensor, wheel_normals=None,
               generator=None) -> _TickMove:
    """Sense, frontier-driven policy, simulated motion."""
    dt = 1.0 / cfg.robot.control_rate_hz
    n_samples = int(cfg.scan.range_max_m / (world_res_m * 0.5))
    scans = lidar.simulate_scans(cfg.scan, world, world_res_m, n_samples,
                                 state.sim.poses)
    prox = lidar.ir_proximity(world, world_res_m, state.sim.poses)
    fr = F.compute_frontiers(cfg.frontier, cfg.grid, state.grid,
                             state.est_poses)
    goals = fr.targets[fr.assignment.long().clamp_min(0)]
    goal_valid = fr.assignment >= 0
    if cfg.frontier.planned_goals:
        # A waypoint along the min-plus shortest path to the assigned
        # target replaces the straight-line goal wherever a plan exists.
        wps, wvalid = F.assigned_waypoints(cfg.frontier, cfg.grid,
                                           state.grid, state.est_poses,
                                           fr.targets, fr.assignment)
        goals = torch.where(wvalid[:, None], wps, goals)
    pol = frontier_policy(cfg.robot, cfg.scan, state.est_poses, goals,
                          goal_valid, scans, prox, state.exploring)
    # step_fleet's own noise fraction, as in the JAX fleet tick (which
    # does not pass RobotConfig.speed_noise_frac either).
    sim2, measured = thymio.step_fleet(
        cfg.robot, state.sim, pol.targets.to(torch.float32), dt,
        wheel_normals=wheel_normals, generator=generator)
    return _TickMove(sim2=sim2, measured=measured, pol=pol, fr=fr,
                     scans=scans)


def _tick_est(cfg: SlamConfig, est_poses: torch.Tensor,
              measured: torch.Tensor) -> torch.Tensor:
    """Odometry: propagate the estimates from the measured wheel speeds."""
    dt = 1.0 / cfg.robot.control_rate_hz
    return rk2_step(cfg.robot, est_poses, measured[:, 0], measured[:, 1], dt)


def _tick_map(cfg: SlamConfig, state: FleetState, est: torch.Tensor,
              scans: torch.Tensor):
    """Key gate, correlative correction, fusion: (res, est, is_key, grid)."""
    d = _norm2(est[:, :2] - state.last_key_poses[:, :2])
    dth = torch.abs(wrap_angle(est[:, 2] - state.last_key_poses[:, 2]))
    is_key = (d > cfg.matcher.min_travel_m) | \
        (dth > cfg.matcher.min_heading_rad)
    res = M.match_batch(cfg.grid, cfg.scan, cfg.matcher, state.grid, scans,
                        est)
    est = torch.where((is_key & res.accepted)[:, None], res.pose, est)
    if cfg.mode == "localization":
        grid = state.grid
    else:
        grid = G.fuse_scans_masked(cfg.grid, cfg.scan, state.grid, scans,
                                   est, is_key)
    return res, est, is_key, grid


def _tick_graph(cfg: SlamConfig, graphs: PG.PoseGraph, rings: torch.Tensor,
                est: torch.Tensor, is_key: torch.Tensor, scans: torch.Tensor,
                accepted: torch.Tensor):
    """Graph growth and loop-closure candidates: (graphs, rings, k_idx,
    cand, attempt, xrobot, xcand, xattempt)."""
    R = est.shape[0]
    if cfg.mode == "localization":
        zi = torch.zeros((R,), dtype=torch.int32, device=est.device)
        zb = torch.zeros((R,), dtype=torch.bool, device=est.device)
        return graphs, rings, zi, zi, zb, zi, zi, zb
    graphs, rings, k_idx = _update_graphs(cfg, graphs, est, is_key, scans,
                                          rings)
    cand, cand_found = PG.loop_candidate(cfg.loop, graphs, k_idx)
    attempt = is_key & cand_found & bool(cfg.loop.enabled)
    xrobot, xcand, xfound = _cross_candidates(cfg, graphs, est)
    xattempt = is_key & ~accepted & xfound & ~attempt & \
        bool(cfg.loop.enabled) & bool(cfg.loop.cross_robot)
    return graphs, rings, k_idx, cand, attempt, xrobot, xcand, xattempt


def _tick_pre(cfg: SlamConfig, state: FleetState, world_res_m: float,
              world: torch.Tensor, wheel_normals=None,
              generator=None) -> _TickPre:
    mv = _tick_move(cfg, state, world_res_m, world, wheel_normals,
                    generator)
    est = _tick_est(cfg, state.est_poses, mv.measured)
    res, est, is_key, grid = _tick_map(cfg, state, est, mv.scans)
    (graphs, rings, k_idx, cand, attempt, xrobot, xcand,
     xattempt) = _tick_graph(cfg, state.graphs, state.scan_rings, est,
                             is_key, mv.scans, res.accepted)
    return _TickPre(sim2=mv.sim2, pol=mv.pol, fr=mv.fr,
                    match_response=res.response, est=est, is_key=is_key,
                    grid=grid, graphs=graphs, rings=rings, k_idx=k_idx,
                    scans=mv.scans, cand=cand, attempt=attempt,
                    xrobot=xrobot, xcand=xcand, xattempt=xattempt)


def _tick_finish(cfg: SlamConfig, state: FleetState, pre: _TickPre,
                 grid: torch.Tensor, graphs: PG.PoseGraph, est: torch.Tensor,
                 closed: torch.Tensor):
    last_key = torch.where(pre.is_key[:, None], est, state.last_key_poses)
    state2 = FleetState(sim=pre.sim2, est_poses=est, grid=grid,
                        exploring=state.exploring, last_key_poses=last_key,
                        graphs=graphs, scan_rings=pre.rings,
                        n_loops=state.n_loops + closed.to(torch.int32),
                        t=state.t + 1)
    diag = FleetDiag(policy=pre.pol, frontiers=pre.fr,
                     match_response=pre.match_response,
                     pose_err=_norm2(est[:, :2] - pre.sim2.poses[:, :2]),
                     is_key=pre.is_key, loop_closed=closed)
    return state2, diag


def fleet_step(cfg: SlamConfig, state: FleetState, world_res_m: float,
               world: torch.Tensor,
               wheel_normals: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None):
    """One synchronous fleet tick on the device of `state`.

    world: (H, W) bool world bitmap on the same device.
    wheel_normals: (R, 2) standard normals of this tick's wheel noise;
    None draws them from `generator`. Returns (state, diag)."""
    ensure_valid_mode(cfg)
    pre = _tick_pre(cfg, state, world_res_m, world, wheel_normals,
                    generator)
    if cfg.mode == "localization":
        grid, graphs, est = pre.grid, pre.graphs, pre.est
        closed = torch.zeros_like(pre.is_key)
    elif bool((pre.attempt | pre.xattempt).any()):   # one host sync a tick
        graphs, grid, est, closed = _close_loops(
            cfg, pre.graphs, pre.grid, pre.rings, pre.est, pre.scans,
            pre.k_idx, pre.cand, pre.attempt, pre.xrobot, pre.xcand,
            pre.xattempt)
    else:
        graphs, grid, est = pre.graphs, pre.grid, pre.est
        closed = torch.zeros_like(pre.attempt)
    return _tick_finish(cfg, state, pre, grid, graphs, est, closed)
