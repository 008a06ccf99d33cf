"""A mission caught mid-way, made from the seed: the state a window
starts from.

At the LD06 fleet's 3 cm/s a mission needs minutes of ticks before its
robots leave the spawn ring and see past the first room; a run cannot
spend them in set-up. So the harness
makes that state itself, as a mission would have left it: each robot has
driven a path of key poses through free space, keyed a scan at each
(simulated from the world at the true pose), grown its pose graph by one
odometry edge a key, and the shared map holds every key scan. The
robots stand at their paths' ends, each facing the frontier target the
plain assignment gives it there and cruising toward it; robot r has come
(R - r) / R of the key gate's travel past its last key, so the robots
key in turn and the first keys on the first tick.

Each robot drove one straight leg from a start drawn from the seed, in a
direction drawn from the seed: the map ends in frontiers where the legs
could not see, and no robot comes back to its own chain. The traffic
file's `preroll` gives

* `keys`: key poses on the leg;
* `step_m`: the distance between key poses;
* `clearance_m`: the least distance from a pose to a wall.

Everything here is plain PyTorch and the benchmark's own reference
(its LiDAR and its fusion), so the program's state starts from inputs
that it did not make.
"""

from __future__ import annotations

import math

import torch

from port_bench.reference import frontier as RF
from port_bench.reference import grid as RG
from port_bench.reference import lidar as RL
from port_bench.reference import odometry as RO

#: Odometry edge information (translation, heading), as the fleet tick's.
ODO_W = (50.0, 100.0)

#: Key poses simulated and fused at once.
CHUNK = 64


def _clear_cells(world: torch.Tensor, cells: int) -> torch.Tensor:
    """(H, W) bool on the CPU: cells with no wall within `cells` (a
    square) and not at the world's edge. Computed on the world's device,
    one axis at a time."""
    k = 2 * cells + 1
    pool = torch.nn.functional.max_pool2d
    near = pool(pool(world[None, None].float(), (k, 1), stride=1,
                     padding=(cells, 0)), (1, k), stride=1,
                padding=(0, cells))[0, 0] > 0
    clear = (~near).cpu()
    clear[:cells + 1] = False
    clear[-cells - 1:] = False
    clear[:, :cells + 1] = False
    clear[:, -cells - 1:] = False
    return clear


def _xy(rc: torch.Tensor, shape, res: float) -> torch.Tensor:
    """Cell (row, col) centres -> world (x, y), the simulator's centred
    indexing."""
    H, W = shape
    return torch.stack([(rc[..., 1] + 0.5 - W / 2) * res,
                        (rc[..., 0] + 0.5 - H / 2) * res], -1)


def _rc(xy: torch.Tensor, shape, res: float) -> torch.Tensor:
    H, W = shape
    return torch.stack([torch.round(xy[..., 1] / res + H / 2 - 0.5),
                        torch.round(xy[..., 0] / res + W / 2 - 0.5)],
                       -1).long()


def _draw_cell(clear: torch.Tensor, g: torch.Generator) -> torch.Tensor:
    idx = torch.nonzero(clear)
    if not len(idx):
        raise ValueError("preroll: no cell of the world has the clearance "
                         "asked for")
    return idx[int(torch.randint(len(idx), (1,), generator=g))].double()


def _straight(clear, res, spec, g, tries: int = 500) -> torch.Tensor:
    """(keys, 3) poses of one straight leg through `clear` cells."""
    n, step = int(spec["keys"]), float(spec["step_m"])
    for _ in range(tries):
        xy0 = _xy(_draw_cell(clear, g), clear.shape, res)
        th = float(torch.rand((), generator=g, dtype=torch.float64)
                   * 2 * math.pi - math.pi)
        s = torch.arange(n, dtype=torch.float64) * step
        xy = xy0 + s[:, None] * torch.tensor([math.cos(th), math.sin(th)],
                                             dtype=torch.float64)
        rc = _rc(xy, clear.shape, res)
        inside = ((rc >= 0) & (rc < torch.tensor(tuple(clear.shape)))).all()
        if inside and bool(clear[rc[:, 0], rc[:, 1]].all()):
            return torch.cat([xy, torch.full((n, 1), th,
                                             dtype=torch.float64)], 1)
    raise ValueError(f"preroll: no clear straight leg of {n} keys in "
                     f"{tries} draws")


def paths(world: torch.Tensor, res: float, spec: dict, robots: int,
          seed: int, mission: int):
    """Each robot's key poses, float64 on the CPU, from (seed, mission)."""
    g = torch.Generator().manual_seed((int(seed) * 1009 + mission)
                                      % (2 ** 63))
    clear = _clear_cells(world, math.ceil(spec["clearance_m"] / res))
    return [_straight(clear, res, spec, g) for _ in range(robots)]


def mid_mission(cfg, rcfg, state, world, res: float, spec: dict,
                seed: int, mission: int):
    """`state` (a fresh FleetState of the program) as the preroll leaves
    it, its tensors on the state's device. `cfg` is the program's
    SlamConfig, `rcfg` the reference's (the same numbers)."""
    dev = state.grid.device
    R = cfg.fleet.n_robots
    cap = cfg.loop.max_poses
    world_d = torch.as_tensor(world, device=dev).bool()
    chains = paths(world_d, res, spec, R, seed, mission)
    n = len(chains[0])
    if n > cap or n - 1 > cfg.loop.max_edges:
        raise ValueError(f"preroll: {n} key poses exceed the pose graph's "
                         f"{cap}")
    poses = torch.stack(chains).to(torch.float32).to(dev)      # (R, n, 3)
    n_samples = int(rcfg.scan.range_max_m / (res * 0.5))

    def fuse(grid, p):
        """Scans simulated at the (R, k, 3) poses p, fused key by key;
        (grid, scans (R, k, beams))."""
        flat = p.reshape(-1, 3)
        scans = torch.cat([RL.simulate_scans(rcfg.scan, world_d, res,
                                             n_samples, flat[i:i + CHUNK])
                           for i in range(0, len(flat), CHUNK)])
        scans = scans.reshape(p.shape[0], p.shape[1], -1)
        order = p.transpose(0, 1).reshape(-1, 3)
        sc = scans.transpose(0, 1).reshape(len(order), -1)
        ones = torch.ones(len(order), dtype=torch.bool, device=dev)
        for i in range(0, len(order), CHUNK):
            grid = RG.fuse_scans_masked(rcfg.grid, rcfg.scan, grid,
                                        sc[i:i + CHUNK], order[i:i + CHUNK],
                                        ones[i:i + CHUNK])
        return grid, scans

    # Every key but the last; then each robot turns to the frontier target
    # the plain assignment gives it on that map (keeping its heading where
    # none is reachable) and keys its last scan facing it, as a robot
    # under the frontier policy would have.
    grid, scans = fuse(state.grid, poses[:, :-1])
    fr = RF.compute_frontiers(rcfg.frontier, rcfg.grid, grid, poses[:, -1])
    goal = fr.targets[fr.assignment.long().clamp_min(0)]
    bearing = torch.atan2(goal[:, 1] - poses[:, -1, 1],
                          goal[:, 0] - poses[:, -1, 0])
    poses[:, -1, 2] = torch.where(fr.assignment >= 0, bearing,
                                  poses[:, -1, 2])
    grid, last = fuse(grid, poses[:, -1:])
    scans = torch.cat([scans, last], 1)

    gr = state.graphs
    gposes = gr.poses.clone()
    gposes[:, :n] = poses
    valid = gr.pose_valid.clone()
    valid[:, :n] = True
    ij = gr.edge_ij.clone()
    ar = torch.arange(1, n, device=dev, dtype=ij.dtype)
    ij[:, :n - 1] = torch.stack([ar - 1, ar], -1)
    meas = gr.edge_meas.clone()
    meas[:, :n - 1] = RO.pose_between(poses[:, :-1], poses[:, 1:])
    wt = gr.edge_weight.clone()
    wt[:, :n - 1] = torch.tensor((ODO_W[0], ODO_W[0], ODO_W[1]),
                                 device=dev)
    ev = gr.edge_valid.clone()
    ev[:, :n - 1] = True
    graphs = type(gr)(
        poses=gposes, pose_valid=valid,
        n_poses=torch.full_like(gr.n_poses, n), edge_ij=ij, edge_meas=meas,
        edge_weight=wt, edge_valid=ev,
        n_edges=torch.full_like(gr.n_edges, n - 1))
    rings = state.scan_rings.clone()
    rings[:, :n] = scans.reshape(R, n, -1)

    # Each robot a share of the key gate's travel past its last key,
    # along its heading: robot 0 keys on the first tick, the others in
    # turn.
    gate = float(cfg.matcher.min_travel_m)
    last = poses[:, -1]
    ahead = gate * (R - torch.arange(R, device=dev,
                                     dtype=torch.float32)) / R - 1e-3
    now = last.clone()
    now[:, 0] += ahead * torch.cos(last[:, 2])
    now[:, 1] += ahead * torch.sin(last[:, 2])
    cruise = float(cfg.robot.cruise_speed_units)
    sim = type(state.sim)(poses=now,
                          wheel_speeds=torch.full_like(
                              state.sim.wheel_speeds, cruise))
    speed = cruise * cfg.robot.speed_coeff_m_per_unit_s
    ticks = round(n * float(spec["step_m"])
                  / (speed / cfg.robot.control_rate_hz))
    return state._replace(
        sim=sim, est_poses=now.clone(), grid=grid, last_key_poses=last,
        graphs=graphs, scan_rings=rings,
        t=torch.full_like(state.t, ticks))
