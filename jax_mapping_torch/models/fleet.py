"""Fleet model: N simulated Thymios exploring and mapping one shared world.

Port of the JAX package's `models/fleet.py`. One `fleet_step` closes the
whole loop for every robot at once:

  simulated LD06 scans -> frontier assignment -> explorer policy
  -> fleet kinematics -> odometry -> 0.1 m / 0.1 rad key-scan gate
  -> batched correlative matching -> masked log-odds fusion
  -> per-robot pose graphs, loop closure with shared-map re-fusion.

State lives on one device (CUDA unless the caller asks for the CPU) and
every stage carries a leading robot axis. The tenant megabatch
(`tenancy/megabatch.py`) runs the same stages (`_tick_sense`,
`_tick_graph`, `_tick_finish`) on T missions stacked on a leading tenant
axis. The JAX step is one jitted
program; here the loop-closure branch (`lax.cond` there) is a Python `if`
on `(attempt | xattempt).any()`, which costs one host sync per tick, and
the fusion fold reads its patch origins on the host (one sync per fused
sub-batch). Random draws are inputs: `fleet_step` takes the (R, 2)
wheel-noise normals, or draws them from a `torch.Generator`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from jax_mapping_torch._util import const, entry_point, resolve_device
from jax_mapping_torch.config import SlamConfig, ensure_valid_mode
from jax_mapping_torch.models.explorer import PolicyOut, frontier_policy
from jax_mapping_torch.models.slam import _verify_loop
from jax_mapping_torch.ops import frontier as F
from jax_mapping_torch.ops import grid as G
from jax_mapping_torch.ops import posegraph as PG
from jax_mapping_torch.ops import scan_match as M
from jax_mapping_torch.ops.odometry import pose_between, rk2_step, wrap_angle
from jax_mapping_torch.sim import lidar, thymio
from jax_mapping_torch.utils.profiling import global_metrics, span

_ODO_W = (50.0, 100.0)          # odometry edge information (t, theta)
_LOOP_W = (200.0, 400.0)        # verified loop edge information

counters = global_metrics.counters


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
    (robot, pose index, found), each (R,), or (T, R) for the megabatch's
    missions, a robot looking only at its own mission's fleet-mates."""
    one = est.dim() == 2
    if one:
        graphs, est = PG.PoseGraph(*(x[None] for x in graphs)), est[None]
    T, R = est.shape[:2]
    cap = cfg.loop.max_poses
    dev = est.device
    pos = graphs.poses[..., :2]
    d = _norm2(pos[:, None] - est[:, :, None, None, :2])     # (T, R, R, cap)
    established = graphs.n_poses >= cfg.loop.min_chain_size
    ok = (graphs.pose_valid & established[..., None])[:, None]
    ok = ok & ~torch.eye(R, dtype=torch.bool, device=dev)[None, :, :, None]
    flat = torch.where(ok, d, float("inf")).reshape(T, R, R * cap)
    best = torch.argmin(flat, dim=2)
    found = flat.gather(2, best[..., None])[..., 0] <= \
        cfg.loop.search_radius_m
    out = ((best // cap).to(torch.int32), (best % cap).to(torch.int32),
           found)
    return tuple(x[0] for x in out) if one else out


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
    counters.inc("tick.loop_attempts", sum(run))
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
    counters.inc("tick.loops_closed", closed_idx.numel())
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
        folded = G.scans_folded()
        grid = G.fuse_scans_masked(
            cfg.grid, cfg.scan, G.empty_grid(cfg.grid, grid.device),
            rings.reshape(R * cap, beams),
            graphs3.poses[:, :cap].reshape(R * cap, 3),
            graphs3.pose_valid[:, :cap].reshape(R * cap))
        counters.inc("tick.scans_refused", G.scans_folded() - folded)
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


class _TickSense(NamedTuple):
    """Steps 1-7 of a tick: sense, frontier-driven policy, move,
    odometry, key gate, correlative match, fusion. Under the tenant
    megabatch every field keeps the (T, R) layout of its input."""

    sim2: thymio.FleetSimState
    pol: PolicyOut
    fr: F.FrontierResult
    res: M.MatchResult
    est: torch.Tensor
    is_key: torch.Tensor
    grid: torch.Tensor
    scans: torch.Tensor


def _flat(x: torch.Tensor, lead: tuple) -> torch.Tensor:
    """Merge the robot axes `lead` ((R,) or (T, R)) of x into one."""
    return x.reshape(-1, *x.shape[len(lead):])


def _unflat(x: torch.Tensor, lead: tuple) -> torch.Tensor:
    return x.reshape(*lead, *x.shape[1:])


def _tick_sense(cfg: SlamConfig, state: FleetState, world_res_m: float,
                world: torch.Tensor, wheel_normals=None,
                generator=None) -> _TickSense:
    """Steps 1-7 of the fleet tick on one mission (grid (N, N), robot
    leaves (R, ...), world (H, W), normals (R, 2)) or on the tenant
    megabatch's T missions (grid (T, N, N), robot leaves (T, R, ...),
    worlds (T, H, W), normals (T, R, 2)). Per-robot stages run on all
    T * R robots at once; a tenant index picks each robot's world and
    map; the frontiers run over the T grids."""
    dt = 1.0 / cfg.robot.control_rate_hz
    n_samples = int(cfg.scan.range_max_m / (world_res_m * 0.5))
    lead = tuple(state.est_poses.shape[:-1])
    tenant = None
    if state.grid.dim() == 3:
        T, R = lead
        tenant = torch.arange(T, device=state.grid.device
                              ).repeat_interleave(R)

    def flat(x):
        return _flat(x, lead)

    def unflat(x):
        return _unflat(x, lead)

    sim_poses = flat(state.sim.poses)
    with span("tick.sim"):
        scans = lidar.simulate_scans(cfg.scan, world, world_res_m,
                                     n_samples, sim_poses, tenant=tenant)
        prox = lidar.ir_proximity(world, world_res_m, sim_poses,
                                  tenant=tenant)
    with span("tick.frontier"):
        fr = F.compute_frontiers(cfg.frontier, cfg.grid, state.grid,
                                 state.est_poses)
        a = fr.assignment.long().clamp_min(0)
        goals = torch.gather(fr.targets, -2,
                             a[..., None].expand(*a.shape, 2))
        goal_valid = fr.assignment >= 0
        if cfg.frontier.planned_goals:
            # A waypoint along the min-plus shortest path to the assigned
            # target replaces the straight-line goal wherever a plan
            # exists; over the megabatch's T grids, one cost-field call
            # for all.
            wps, wvalid = F.assigned_waypoints(cfg.frontier, cfg.grid,
                                               state.grid, state.est_poses,
                                               fr.targets, fr.assignment)
            goals = torch.where(wvalid[..., None], wps, goals)
    est0 = flat(state.est_poses)
    with span("tick.policy"):
        pol = frontier_policy(cfg.robot, cfg.scan, est0, flat(goals),
                              flat(goal_valid), scans, prox,
                              flat(state.exploring))
    with span("tick.motion"):
        # step_fleet's own noise fraction, as in the JAX fleet tick (which
        # does not pass RobotConfig.speed_noise_frac either).
        sim2, measured = thymio.step_fleet(
            cfg.robot, thymio.FleetSimState(sim_poses,
                                            flat(state.sim.wheel_speeds)),
            pol.targets.to(torch.float32), dt, wheel_normals=wheel_normals,
            generator=generator)
        # Odometry, then the key-scan gate.
        est = rk2_step(cfg.robot, est0, measured[:, 0], measured[:, 1], dt)
        last_key = flat(state.last_key_poses)
        d = _norm2(est[:, :2] - last_key[:, :2])
        dth = torch.abs(wrap_angle(est[:, 2] - last_key[:, 2]))
        is_key = (d > cfg.matcher.min_travel_m) | \
            (dth > cfg.matcher.min_heading_rad)
    with span("tick.match"):
        res = M.match_batch(cfg.grid, cfg.scan, cfg.matcher, state.grid,
                            scans, est, tenant=tenant)
        est = torch.where((is_key & res.accepted)[:, None], res.pose, est)
    counters.inc("tick.scans_matched", scans.shape[0])
    if cfg.mode == "localization":
        grid = state.grid
    else:
        with span("tick.fuse"):
            folded = G.scans_folded()
            grid = G.fuse_scans_masked(cfg.grid, cfg.scan, state.grid,
                                       scans, est, is_key, tenant=tenant)
        counters.inc("tick.scans_fused", G.scans_folded() - folded)
    return _TickSense(
        sim2=thymio.FleetSimState(*(unflat(x) for x in sim2)),
        pol=PolicyOut(*(unflat(x) for x in pol)), fr=fr,
        res=M.MatchResult(*(unflat(x) for x in res)), est=unflat(est),
        is_key=unflat(is_key), grid=grid, scans=unflat(scans))


def _tick_graph(cfg: SlamConfig, graphs: PG.PoseGraph, rings: torch.Tensor,
                est: torch.Tensor, is_key: torch.Tensor, scans: torch.Tensor,
                accepted: torch.Tensor):
    """Graph growth and loop-closure candidates: (graphs, rings, k_idx,
    cand, attempt, xrobot, xcand, xattempt), on (R, ...) robots or the
    megabatch's (T, R, ...); cross-robot candidates stay within a
    mission."""
    with span("tick.graph"):
        lead = tuple(est.shape[:-1])
        if cfg.mode == "localization":
            zi = torch.zeros(lead, dtype=torch.int32, device=est.device)
            zb = torch.zeros(lead, dtype=torch.bool, device=est.device)
            return graphs, rings, zi, zi, zb, zi, zi, zb
        g, rings, k_idx = _update_graphs(
            cfg, PG.PoseGraph(*(_flat(x, lead) for x in graphs)),
            _flat(est, lead), _flat(is_key, lead), _flat(scans, lead),
            _flat(rings, lead))
        cand, cand_found = PG.loop_candidate(cfg.loop, g, k_idx)
        graphs = PG.PoseGraph(*(_unflat(x, lead) for x in g))
        rings, k_idx, cand, cand_found = (_unflat(x, lead) for x in
                                          (rings, k_idx, cand, cand_found))
        attempt = is_key & cand_found & bool(cfg.loop.enabled)
        xrobot, xcand, xfound = _cross_candidates(cfg, graphs, est)
        xattempt = is_key & ~accepted & xfound & ~attempt & \
            bool(cfg.loop.enabled) & bool(cfg.loop.cross_robot)
        return graphs, rings, k_idx, cand, attempt, xrobot, xcand, xattempt


def _tick_pre(cfg: SlamConfig, state: FleetState, world_res_m: float,
              world: torch.Tensor, wheel_normals=None,
              generator=None) -> _TickPre:
    sense = _tick_sense(cfg, state, world_res_m, world, wheel_normals,
                        generator)
    (graphs, rings, k_idx, cand, attempt, xrobot, xcand,
     xattempt) = _tick_graph(cfg, state.graphs, state.scan_rings, sense.est,
                             sense.is_key, sense.scans, sense.res.accepted)
    return _TickPre(sim2=sense.sim2, pol=sense.pol, fr=sense.fr,
                    match_response=sense.res.response, est=sense.est,
                    is_key=sense.is_key, grid=sense.grid, graphs=graphs,
                    rings=rings, k_idx=k_idx, scans=sense.scans, cand=cand,
                    attempt=attempt, xrobot=xrobot, xcand=xcand,
                    xattempt=xattempt)


def _tick_finish(cfg: SlamConfig, state: FleetState, pre: _TickPre,
                 grid: torch.Tensor, graphs: PG.PoseGraph, est: torch.Tensor,
                 closed: torch.Tensor):
    last_key = torch.where(pre.is_key[..., None], est, state.last_key_poses)
    state2 = FleetState(sim=pre.sim2, est_poses=est, grid=grid,
                        exploring=state.exploring, last_key_poses=last_key,
                        graphs=graphs, scan_rings=pre.rings,
                        n_loops=state.n_loops + closed.to(torch.int32),
                        t=state.t + 1)
    diag = FleetDiag(policy=pre.pol, frontiers=pre.fr,
                     match_response=pre.match_response,
                     pose_err=_norm2(est[..., :2] - pre.sim2.poses[..., :2]),
                     is_key=pre.is_key, loop_closed=closed)
    return state2, diag


@entry_point(static=("cfg", "world_res_m"))
def fleet_step(cfg: SlamConfig, state: FleetState, world_res_m: float,
               world: torch.Tensor,
               wheel_normals: Optional[torch.Tensor] = None,
               generator: Optional[torch.Generator] = None):
    """One synchronous fleet tick on the device of `state`.

    world: (H, W) bool world bitmap on the same device.
    wheel_normals: (R, 2) standard normals of this tick's wheel noise;
    None draws them from `generator`. Returns (state, diag)."""
    ensure_valid_mode(cfg)
    counters.inc("fleet.ticks")
    with span("fleet.tick"):
        pre = _tick_pre(cfg, state, world_res_m, world, wheel_normals,
                        generator)
        with span("tick.loop"):
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
        with span("tick.finish"):
            return _tick_finish(cfg, state, pre, grid, graphs, est, closed)
