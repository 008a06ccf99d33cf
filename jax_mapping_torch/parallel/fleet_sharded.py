"""The sharded fleet step: one rank of a ('fleet', 'space') mesh.

Port of the JAX package's `parallel/fleet_sharded.py`. JAX traces one
global-view program under `shard_map`; here each rank is a process that
holds only its shard and issues the collectives itself:

  axis 'fleet' — robots are data-parallel. Sensing, matching, patch
      classification and the explorer policy never communicate; the
      fleet-wide exchanges are one all_reduce merging the robots' slab
      deltas and one all_gather of the small robot -> cluster cost matrix,
      so that the greedy auction sees the whole fleet.

  axis 'space' — the grid lives in row slabs. The inverse sensor model is
      cell-local, so each slab evaluates every local robot's patch
      restricted to its own rows, on a canvas with a patch-sized margin
      that is then thrown away: no halo exchange. The matcher gets its
      context from one all_gather of the slabs; the frontier work
      coarsens each slab and all_gathers only the coarse masks.

Collectives a step, in the order every rank issues them: all_gather of
the coarse masks ('space'), all_gather of the costs ('fleet'), all_gather
of the grid ('space'); then, when mapping, the all_reduce ('fleet') of
the slab delta and of the loop-closure attempts, and after the closure
branch those of the closures and of the repair slab (zero where the
branch was skipped), as the JAX step psums them outside its `lax.cond`;
last the metrics' all_reduce ('fleet').

The branch is a Python `if` on the all-reduced attempt count (one host
read), so every rank of a fleet row takes the same arm, and neither arm
issues a collective. Robots are replicated along 'space': every rank of
a space row runs the same matcher, graph and closure on the same inputs
(the gathered grid and masks, the gathered costs), and each of those
operations is deterministic on one device type, so the replicas stay
bit-equal without a broadcast.

Kernels on the card: K1's delta route (`grid._classify_batch`) in the
slab fuse and the closure repair, K1's raster route in the matcher, K2
and K3 in the frontier costs (and K3 in `planned_goals`' waypoints).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from jax_mapping_torch._util import linspace_f32
from jax_mapping_torch.config import SlamConfig, ensure_valid_mode
from jax_mapping_torch.models.explorer import frontier_policy
from jax_mapping_torch.models.fleet import (_cross_candidates, _norm2,
                                            _update_graphs,
                                            _verify_and_optimize)
from jax_mapping_torch.ops import frontier as F
from jax_mapping_torch.ops import grid as G
from jax_mapping_torch.ops import posegraph as PG
from jax_mapping_torch.ops import scan_match as M
from jax_mapping_torch.ops.fuse_kernel import _STREAM_CHUNK
from jax_mapping_torch.ops.odometry import rk2_step, wrap_angle
from jax_mapping_torch.parallel.mesh import (all_sum, axis_index, axis_size,
                                             gather_rows)
from jax_mapping_torch.sim import lidar, thymio


class ShardedFleetState(NamedTuple):
    """One rank's shard: its R / n_fleet robots and its slab of
    N / n_space grid rows. The JAX state's per-robot PRNG keys are not
    carried: the wheel noise is a step input."""
    true_poses: torch.Tensor      # (R_l, 3)
    wheel_speeds: torch.Tensor    # (R_l, 2)
    est_poses: torch.Tensor       # (R_l, 3)
    grid: torch.Tensor            # (slab_rows, N)
    exploring: torch.Tensor       # (R_l,) bool
    last_key_poses: torch.Tensor  # (R_l, 3)
    graphs: PG.PoseGraph          # per-robot graphs, leading (R_l,) axis
    scan_rings: torch.Tensor      # (R_l, max_poses, beams)
    n_loops: torch.Tensor         # (R_l,) int32
    t: torch.Tensor               # () int32, the same on every rank


#: The fields split along 'fleet' (every one but `grid` and `t`).
FLEET_FIELDS = ("true_poses", "wheel_speeds", "est_poses", "exploring",
                "last_key_poses", "scan_rings", "n_loops")


def mesh_device(mesh) -> torch.device:
    """The device a rank keeps its shard on: the mesh's device type (the
    current card for "cuda")."""
    return torch.device(mesh.device_type)


def shard_shape(cfg: SlamConfig, mesh) -> tuple[int, int]:
    """(robots a rank, grid rows a rank), with the JAX step's checks."""
    n_fleet = axis_size(mesh, "fleet")
    n_space = axis_size(mesh, "space")
    R = cfg.fleet.n_robots
    if R % n_fleet:
        raise ValueError(f"n_robots={R} not divisible by fleet axis {n_fleet}")
    slab_rows = cfg.grid.size_cells // n_space
    if slab_rows % cfg.frontier.downsample:
        raise ValueError("slab rows must be divisible by frontier downsample")
    return R // n_fleet, slab_rows


def init_sharded_state(cfg: SlamConfig, mesh) -> ShardedFleetState:
    """This rank's shard of the JAX package's initial state: robots on a
    ring of radius 0.4-0.53 m facing outward, an all-unknown grid."""
    dev = mesh_device(mesh)
    Rl, slab_rows = shard_shape(cfg, mesh)
    R = cfg.fleet.n_robots
    ang = torch.as_tensor(linspace_f32(0.0, 2 * torch.pi, R, endpoint=False),
                          device=dev)
    r = 0.4 + 0.2 * (torch.arange(R, device=dev) % 3).to(torch.float32) / 3.0
    poses = torch.stack([r * torch.cos(ang), r * torch.sin(ang), ang], -1)
    lo = axis_index(mesh, "fleet") * Rl
    poses = poses[lo:lo + Rl].contiguous()
    return ShardedFleetState(
        true_poses=poses, wheel_speeds=torch.zeros((Rl, 2), device=dev),
        est_poses=poses.clone(),
        grid=torch.zeros((slab_rows, cfg.grid.size_cells),
                         dtype=torch.float32, device=dev),
        exploring=torch.ones((Rl,), dtype=torch.bool, device=dev),
        last_key_poses=torch.full((Rl, 3), 1e9, dtype=torch.float32,
                                  device=dev),
        graphs=PG.empty_graph(cfg.loop, Rl, dev),
        scan_rings=torch.zeros((Rl, cfg.loop.max_poses,
                                cfg.scan.padded_beams),
                               dtype=torch.float32, device=dev),
        n_loops=torch.zeros((Rl,), dtype=torch.int32, device=dev),
        t=torch.zeros((), dtype=torch.int32, device=dev))


def _slab_delta(cfg: SlamConfig, scans: torch.Tensor, poses: torch.Tensor,
                slab_row0: int, slab_rows: int,
                mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Per-scan patches -> one (slab_rows, N) delta restricted to this
    slab, unclamped.

    A patch at global row origin o lands at canvas row o - slab_row0 + P
    (clipped to [0, slab_rows + P]) of a zero (slab_rows + 2P, N) canvas;
    patches outside the slab fall into the discarded margins, and
    overlapping ones add in b order. `mask` (B,) drops scans (the JAX
    step multiplies their deltas by 0, which adds nothing). The patch
    origins and the mask come to the host once (one sync); the kept
    scans go through K1's delta route in sub-batches of
    `fuse_kernel._STREAM_CHUNK`, so the closure repair's thousands of
    ring scans never hold more than that many patches at once."""
    g, s = cfg.grid, cfg.scan
    P, N = g.patch_cells, g.size_cells
    dev = scans.device
    canvas = torch.zeros((slab_rows + 2 * P, N), dtype=torch.float32,
                         device=dev)
    B = scans.shape[0]
    if B == 0:
        return canvas[P:P + slab_rows]
    origins = G.patch_origin(g, poses[:, :2])
    keep = (torch.ones((B,), dtype=torch.bool, device=dev) if mask is None
            else mask.to(torch.bool))
    host = torch.cat([origins, keep.to(torch.int32)[:, None]], 1).tolist()
    idx = [b for b, row in enumerate(host) if row[2]]
    # Kept rows on the device: slices when every scan is kept, else one
    # nonzero (after the read above, the stream has nothing left to wait
    # for).
    rows = None if len(idx) == B else torch.nonzero(keep).flatten()
    for c in range(0, len(idx), _STREAM_CHUNK):
        part = idx[c:c + _STREAM_CHUNK]
        sel = (slice(c, c + len(part)) if rows is None
               else rows[c:c + len(part)])
        deltas, _ = G._classify_batch(g, s, scans[sel], poses[sel])
        for j, b in enumerate(part):
            r0, c0 = host[b][0], host[b][1]
            ro = min(max(r0 - slab_row0 + P, 0), slab_rows + P)
            canvas[ro:ro + P, c0:c0 + P] += deltas[j]
    return canvas[P:P + slab_rows]


def make_fleet_step(cfg: SlamConfig, mesh, world_res_m: float):
    """The sharded step of this rank: step(state, world, wheel_normals) ->
    (state, metrics).

    world: the (H, W) bool world bitmap, the same on every rank.
    wheel_normals: the fleet's (R, 2) standard normals of this tick's
    wheel noise, the same on every rank (each takes its robots' rows).
    metrics: 0-d tensors on the shard's device, the same on every rank:
    mean_pose_err_m, mean_match_response, n_clusters, n_loops (the
    fleet's total) and n_thins (this step's ring thinnings); and
    `assignment`, this rank's robots' (R_l,) frontier clusters (-1:
    none)."""
    ensure_valid_mode(cfg)
    Rl, slab_rows = shard_shape(cfg, mesh)
    R = cfg.fleet.n_robots
    N = cfg.grid.size_cells
    n_samples = max(8, int(cfg.scan.range_max_m / (world_res_m * 0.5)))
    dt = 1.0 / cfg.robot.control_rate_hz
    fleet_idx = axis_index(mesh, "fleet")
    slab_row0 = axis_index(mesh, "space") * slab_rows
    lo, hi = cfg.grid.logodds_min, cfg.grid.logodds_max

    def step(state: ShardedFleetState, world: torch.Tensor,
             wheel_normals: torch.Tensor):
        normals = torch.as_tensor(wheel_normals, device=state.grid.device)[
            fleet_idx * Rl:(fleet_idx + 1) * Rl]
        # 1. Sense (local robots, replicated world).
        scans = lidar.simulate_scans(cfg.scan, world, world_res_m,
                                     n_samples, state.true_poses)
        prox = lidar.ir_proximity(world, world_res_m, state.true_poses)

        # 2. Frontier: coarsen the own slab, gather the coarse masks
        # along 'space' (one uint8 gather: free + 2 unknown).
        free_s, _occ_s, unk_s = F.coarsen(cfg.frontier, cfg.grid, state.grid)
        packed = gather_rows(free_s.to(torch.uint8)
                             + 2 * unk_s.to(torch.uint8), mesh, "space")
        free, unk = (packed & 1).bool(), (packed & 2).bool()
        fr = F.compute_frontiers_from_masks(cfg.frontier, cfg.grid, free,
                                            unk, state.est_poses)
        # Fleet-wide auction: gather every robot's costs, auction, slice.
        costs_all = gather_rows(fr.costs, mesh, "fleet")
        assignment = F.assign_frontiers(costs_all)[
            fleet_idx * Rl:(fleet_idx + 1) * Rl]
        goals = fr.targets[assignment.long().clamp_min(0)]
        goal_valid = assignment >= 0
        if cfg.frontier.planned_goals:
            # From the same gathered masks the assignment used: local
            # robots only, no extra collectives.
            wps, wvalid = F.assigned_waypoints_from_masks(
                cfg.frontier, cfg.grid, free, unk, state.est_poses,
                fr.targets, assignment)
            goals = torch.where(wvalid[:, None], wps, goals)

        # 3. Policy (local).
        pol = frontier_policy(cfg.robot, cfg.scan, state.est_poses, goals,
                              goal_valid, scans, prox, state.exploring)

        # 4. Kinematics (local robots, their own noise).
        tp, ws, measured = thymio.step_robots_keyed(
            cfg.robot, state.true_poses, state.wheel_speeds,
            pol.targets.to(torch.float32), dt, normals)

        # 5. Odometry, then gated matching against the gathered grid.
        est = rk2_step(cfg.robot, state.est_poses, measured[:, 0],
                       measured[:, 1], dt)
        full_grid = gather_rows(state.grid, mesh, "space")
        d_trav = _norm2(est[:, :2] - state.last_key_poses[:, :2])
        d_head = torch.abs(wrap_angle(est[:, 2] - state.last_key_poses[:, 2]))
        is_key = (d_trav > cfg.matcher.min_travel_m) | \
            (d_head > cfg.matcher.min_heading_rad)
        res = M.match_batch(cfg.grid, cfg.scan, cfg.matcher, full_grid,
                            scans, est)
        est = torch.where((is_key & res.accepted)[:, None], res.pose, est)
        del full_grid

        if cfg.mode == "localization":
            # Frozen map: corrections stand, nothing fuses, graphs never
            # grow, closures never fire, and the skipped collectives are
            # skipped on every rank alike (static config).
            grid = state.grid
            graphs, rings = state.graphs, state.scan_rings
            closed = torch.zeros_like(is_key)
        else:
            # 6. Fuse: local key robots' slab contributions, summed over
            # 'fleet', clipped once.
            delta = _slab_delta(cfg, scans, est, slab_row0, slab_rows,
                                mask=is_key)
            grid = torch.clamp(state.grid + all_sum(delta, mesh, "fleet"),
                               lo, hi)
            del delta

            # 7. Pose graphs (local robots) and loop closure.
            graphs, rings, k_idx = _update_graphs(
                cfg, state.graphs, est, is_key, scans, state.scan_rings)
            cand, found = PG.loop_candidate(cfg.loop, graphs, k_idx)
            attempt = is_key & found & bool(cfg.loop.enabled)
            # Cross-robot relocalization stays shard-local: candidates
            # come from this shard's graphs only.
            xrobot, xcand, xfound = _cross_candidates(cfg, graphs, est)
            xattempt = is_key & ~res.accepted & xfound & ~attempt & \
                bool(cfg.loop.enabled) & bool(cfg.loop.cross_robot)
            n_attempt = all_sum((attempt | xattempt).sum().to(torch.int32),
                                mesh, "fleet")
            if int(n_attempt) > 0:          # the same on the fleet row
                graphs, est, closed = _verify_and_optimize(
                    cfg, graphs, rings, est, scans, k_idx, cand, attempt,
                    xrobot, xcand, xattempt)
                cap, beams = rings.shape[1:]
                repair = _slab_delta(
                    cfg, rings.reshape(Rl * cap, beams),
                    graphs.poses[:, :cap].reshape(Rl * cap, 3),
                    slab_row0, slab_rows,
                    mask=graphs.pose_valid[:, :cap].reshape(-1))
            else:
                closed = torch.zeros_like(attempt)
                repair = torch.zeros((slab_rows, N), dtype=torch.float32,
                                     device=grid.device)
            # Outside the branch, as the JAX step psums outside its cond.
            n_closed = all_sum(closed.sum().to(torch.int32), mesh, "fleet")
            repair = all_sum(repair, mesh, "fleet")
            grid = torch.where(n_closed > 0, torch.clamp(repair, lo, hi),
                               grid)
            del repair

        last_key = torch.where(is_key[:, None], est, state.last_key_poses)
        state2 = ShardedFleetState(
            true_poses=tp, wheel_speeds=ws, est_poses=est, grid=grid,
            exploring=state.exploring, last_key_poses=last_key,
            graphs=graphs, scan_rings=rings,
            n_loops=state.n_loops + closed.to(torch.int32), t=state.t + 1)
        # Fleet aggregates: one all_reduce of the four sums. Thin events
        # are counted at their trigger (a key add that finds the ring
        # full): n_poses alone is capacity-bounded whether or not the
        # thin ran.
        thins = is_key & (state.graphs.n_poses >= cfg.loop.max_poses)
        sums = all_sum(torch.stack([
            _norm2(est[:, :2] - tp[:, :2]).sum().to(torch.float64),
            res.response.sum().to(torch.float64),
            state2.n_loops.sum().to(torch.float64),
            thins.sum().to(torch.float64)]), mesh, "fleet")
        metrics = {"mean_pose_err_m": (sums[0] / R).to(torch.float32),
                   "mean_match_response": (sums[1] / R).to(torch.float32),
                   "n_clusters": (fr.sizes > 0).sum().to(torch.int32),
                   "n_loops": sums[2].to(torch.int32),
                   "n_thins": sums[3].to(torch.int32),
                   "assignment": assignment}
        return state2, metrics

    return step
