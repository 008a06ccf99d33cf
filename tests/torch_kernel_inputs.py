"""Seeded inputs that the port's kernel tests and chip_smoke.py share.

The frontier sweeps' inputs (K2, K3): paths longer than the sweep count
that cross every row slab of the kernels' cluster decomposition
(tests/test_torch_frontier_sweeps.py). The voxel cull's edge cases (K6,
K7): poses at the edges of the (tile, image) cull and the z interval
(tests/test_torch_voxel_tiles.py). The exploration path's inputs: the
incremental publish's seeded missions
(tests/test_torch_frontier_incremental.py) and the planner's walled map
(tests/test_torch_planner.py). The score starts of K8's two modes and a
float64 evaluation of its sums (tests/test_torch_match_kernel.py). The
rendezvous merge's stand-in mapper (`StandInMapper`). Plain numpy and
PyTorch; no pytest and no JAX, so chip_smoke.py and the card tests can
import it on the card's machine.
"""

import math

import numpy as np
import torch

from jax_mapping_torch.config import FrontierConfig, GridConfig
from jax_mapping_torch.ops import voxel as V
from jax_mapping_torch.ops import voxel_kernel as VK

# ---------------------------------------------------------------------------
# Frontier sweeps (K2, K3)
# ---------------------------------------------------------------------------


def serpentine_mask(n: int, seed: int = 0, breaks: int = 5) -> np.ndarray:
    """A one-cell-wide path down every even column, joined at the bottom
    and top by turns, in turn: its runs cross every row, and so every slab
    boundary. Every `breaks`-th run (none for 0) is cut at a random row,
    which makes several components."""
    rng = np.random.default_rng(seed)
    m = np.zeros((n, n), bool)
    m[:, 0::2] = True
    for k, c in enumerate(range(0, n - 2, 2)):
        m[n - 1 if k % 2 == 0 else 0, c + 1] = True
    for c in range(0, n, 2 * breaks) if breaks else ():
        m[rng.integers(1, n - 1), c] = False
    return m


def label_seed(mask: np.ndarray, off_mask: bool = False,
               seed: int = 0) -> np.ndarray:
    """`label_components`' seed (the linear index on the mask, -1 off it),
    or with random labels off the mask, which the first sweep reads."""
    n = mask.shape[0]
    lin = np.arange(n * n, dtype=np.int32).reshape(n, n)
    fill = (np.random.default_rng(seed).integers(-1, n * n, (n, n))
            .astype(np.int32) if off_mask else np.int32(-1))
    return np.where(mask, lin, fill).astype(np.int32)


def corridor_maze(n: int, seed: int = 0) -> np.ndarray:
    """Blocked cells of a maze whose one corridor is `serpentine_mask`."""
    return ~serpentine_mask(n, seed, breaks=0)


def maze_init(blocked: np.ndarray, R: int, seed: int = 0,
              dense: bool = False) -> np.ndarray:
    """(R, n, n) initial fields: 0 at one open cell a robot, 1e9 elsewhere;
    or, `dense`, random finite values everywhere, blocked cells included,
    which the first sweep reads."""
    n = blocked.shape[0]
    rng = np.random.default_rng(seed)
    if dense:
        return rng.uniform(0, 4 * n, (R, n, n)).astype(np.float32)
    init = np.full((R, n, n), 1e9, np.float32)
    open_cells = np.argwhere(~blocked)
    for i, (r, c) in enumerate(open_cells[rng.choice(len(open_cells), R,
                                                     replace=False)]):
        init[i, r, c] = 0.0
    return init


# ---------------------------------------------------------------------------
# The voxel cull's edges (K6, K7)
# ---------------------------------------------------------------------------

def voxel_depths(cfg, B, rng):
    """Speckled depths up to 1.2 x the camera's range, 10% no return."""
    cam = cfg.depthcam
    d = rng.uniform(0.0, 1.2 * cam.range_max_m,
                    (B, cam.height_px, cam.width_px)).astype(np.float32)
    d[rng.random(d.shape) < 0.1] = 0.0
    return torch.from_numpy(d)



def voxel_edge_case(cfg, case):
    """Six poses and origins at an edge of the cull: the camera on tile
    corners or cell boundaries, yaws at multiples of pi/2 or putting a
    side plane of the image along a tile edge, the horizon circle tangent
    to a tile, the camera just outside its patch, or origins at the
    grid's edges."""
    vox, cam = cfg.voxel, cfg.depthcam
    res, R = vox.resolution_m, vox.max_range_m
    ox, oy, _ = vox.origin_m
    P, Y, X = vox.patch_cells, vox.size_y_cells, vox.size_x_cells
    rng = np.random.default_rng(23)
    base = np.stack([rng.uniform(-0.3, 0.3, 6), rng.uniform(-0.3, 0.3, 6),
                     rng.uniform(-math.pi, math.pi, 6)], 1)
    origins = V.patch_origin(vox, torch.tensor(base[:, :2],
                                               dtype=torch.float32))
    o = origins.numpy().astype(np.float64)
    k = np.arange(6)
    # Tile corners well inside the patch.
    col = o[:, 1] + VK.TILE_X * (1 + k % max(1, P // VK.TILE_X - 2))
    row = o[:, 0] + VK.TILE_Y * (2 + 3 * k)
    x_c, y_c = col * res + ox, row * res + oy
    poses = base.copy()
    half_fov = cam.hfov_rad / 2
    if case == "camera_on_tile_corner":
        poses[:, 0], poses[:, 1] = x_c, y_c
    elif case == "camera_on_cell_boundary":
        poses[:, 0] = x_c + 3 * res
        poses[:, 1] = y_c + 0.5 * res
    elif case == "yaw_multiples_of_half_pi":
        poses[:, 0], poses[:, 1] = x_c, y_c
        poses[:, 2] = np.array([0.0, 0.5, 1.0, -0.5, 2.0, -1.0]) * math.pi
    elif case == "frustum_edge_along_tile_edge":
        poses[:, 0], poses[:, 1] = x_c, y_c
        poses[:, 2] = (np.array([0, 1, 2, 3, 0, 1]) * math.pi / 2
                       + np.array([1, 1, 1, -1, -1, -1]) * half_fov)
    elif case == "horizon_tangent_to_tile":
        # The camera R left of (or below) a tile edge, looking at it.
        eps = np.array([0.0, 1e-4, -1e-4, 0.0, 1e-4, -1e-4])
        poses[:, 0] = np.where(k < 3, x_c - R + eps, x_c + 0.5 * res)
        poses[:, 1] = np.where(k < 3, y_c + 0.5 * res, y_c - R + eps)
        poses[:, 2] = np.where(k < 3, 0.0, math.pi / 2)
    elif case == "camera_just_outside_patch":
        left, right = o[:, 1] * res + ox, (o[:, 1] + P) * res + ox
        poses[:, 0] = np.where(k % 2 == 0, left - 0.01, right + 0.01)
        poses[:, 1] = (o[:, 0] + P / 2) * res + oy
        poses[:, 2] = np.array([0.0, math.pi, math.pi, 0.0, 0.3, 2.8])
    elif case == "origins_at_grid_edges":
        corners = np.array([[0, 0], [Y - P, X - P], [0, X - P], [Y - P, 0],
                            [0, 0], [Y - P, X - P]])
        origins = torch.tensor(corners, dtype=torch.int32)
        # On the region's corner, on its edge, just inside: looking out of
        # the grid and along its edges.
        poses[:, 0] = corners[:, 1] * res + ox + np.array(
            [0.0, P * res, 0.02, P * res / 2, 1.0, P * res - 1.0])
        poses[:, 1] = corners[:, 0] * res + oy + np.array(
            [0.0, P * res, P * res, 0.0, 0.05, P * res - 0.05])
        poses[:, 2] = np.array([-3 * math.pi / 4, math.pi / 4, 0.0,
                                -math.pi / 2, math.pi, 0.0])
    else:
        raise ValueError(case)
    return (voxel_depths(cfg, 6, rng), torch.tensor(poses, dtype=torch.float32),
            origins)


VOXEL_EDGES = ["camera_on_tile_corner", "camera_on_cell_boundary",
         "yaw_multiples_of_half_pi", "frustum_edge_along_tile_edge",
         "horizon_tangent_to_tile", "camera_just_outside_patch",
         "origins_at_grid_edges"]


#: (config, y0, ny, nx) of K7's region cases: the whole grid as one Y slab
#: (the 1 x 1 mesh's local step), its upper half, and regions whose sides
#: the 1 x 32 tile does not divide (ny * nx still a multiple of 128).
VOXEL_REGIONS = [("tiny", 0, 128, 128), ("tiny", 64, 64, 128),
                 ("tiny", 40, 16, 72), ("tiny", 7, 9, 128),
                 ("tiny", 50, 24, 48), ("default", 0, 1024, 1024),
                 ("default", 512, 512, 1024), ("default", 300, 40, 80)]


def cameras_around_region(cfg, y0, ny, nx, B, seed):
    """B speckled depth images from cameras within 10 cells of the region
    at rows y0.., cols 0.. (region_delta's origins), looking every way,
    so that the tiles at the region's edges hold live voxels."""
    vox = cfg.voxel
    rng = np.random.default_rng(seed)
    res, (ox, oy, _) = vox.resolution_m, vox.origin_m
    poses = torch.tensor(np.stack([
        rng.uniform(-10, nx + 10, B) * res + ox,
        (y0 + rng.uniform(-10, ny + 10, B)) * res + oy,
        rng.uniform(-math.pi, math.pi, B)], 1), dtype=torch.float32)
    return voxel_depths(cfg, B, rng), poses


# ---------------------------------------------------------------------------
# The exploration path: incremental-publish missions, the planner's map
# ---------------------------------------------------------------------------

#: The incremental publish missions' tile (cells).
MISSION_TILE = 64


def rooms_wide_doors(size_cells: int, resolution_m: float,
                     door_m: float = 2.0, seed: int = 1,
                     return_doors: bool = False):
    """`rooms_world` with each door widened to `door_m` about its centre.
    The default frontier config plans on 0.8 m cells pooled
    conservatively, which seal rooms_world's 0.5 m doors (ROADMAP C.3,
    tests/test_torch_frontier_scene.py); 2 m doors stay open to it, so the
    mission stack's fleet can be assigned the frontiers it sees through
    them. With `return_doors`, (world, doors): the widened rectangles as
    the world generators' door dicts (`scenarios.WorldDynamics`)."""
    from jax_mapping_torch.sim import world as W
    w, doors = W.rooms_with_doors(size_cells, resolution_m, seed=seed)
    half = int(round(door_m / resolution_m)) // 2
    wide = []
    for d in doors:
        if d["r1"] - d["r0"] == 2:              # a gap in a horizontal wall
            c = (d["c0"] + d["c1"]) // 2
            rect = (d["r0"], d["r1"], c - half, c + half)
        else:
            r = (d["r0"] + d["r1"]) // 2
            rect = (r - half, r + half, d["c0"], d["c1"])
        w[rect[0]:rect[1], rect[2]:rect[3]] = False
        wide.append(dict(name=d["name"], r0=rect[0], r1=rect[1],
                         c0=rect[2], c1=rect[3]))
    return (w, wide) if return_doors else w


def mission_grid(size=512):
    """The missions' grid: 512^2 cells at 0.05 m, tile 64."""
    return GridConfig(size_cells=size, patch_cells=64, max_range_m=2.0,
                      align_rows=8, align_cols=8)


#: The missions' FrontierConfig fields (JAX's tests/test_frontier_incremental
#: `_fcfg`).
MISSION_FRONTIER = dict(downsample=2, max_clusters=8, min_cluster_cells=2,
                        label_prop_iters=64, bfs_iters=256, crop_pad=8)


def mission_frontier(**kw):
    """The missions' FrontierConfig with `kw` overridden."""
    return FrontierConfig(**{**MISSION_FRONTIER, **kw})


class WorldSim:
    """Seeded random mission: free-space carves, occasional walls, robot
    pose walks; every mutation marks its tiles' revisions."""

    def __init__(self, gcfg, seed, n_robots=3, walls=True):
        self.g = gcfg
        self.rng = np.random.default_rng(seed)
        n = gcfg.size_cells
        self.nt = n // MISSION_TILE
        self.lo = np.zeros((n, n), np.float32)
        self.tile_rev = np.zeros((self.nt, self.nt), np.int64)
        self.rev = 0
        self.walls = walls
        self._carve(40, 40, 60, walls=False)
        res = gcfg.resolution_m
        ox, oy = gcfg.origin_m
        self.poses = np.stack([
            np.array([ox + self.rng.uniform(45, 95) * res,
                      oy + self.rng.uniform(45, 95) * res,
                      0.0], np.float32)
            for _ in range(n_robots)])

    def _mark(self, r, c, h, w):
        self.rev += 1
        t = MISSION_TILE
        t0r, t1r = r // t, min(self.nt - 1, (r + h) // t)
        t0c, t1c = c // t, min(self.nt - 1, (c + w) // t)
        self.tile_rev[t0r:t1r + 1, t0c:t1c + 1] = self.rev

    def _carve(self, r, c, size, walls):
        n = self.g.size_cells
        r, c = min(r, n - size - 1), min(c, n - size - 1)
        self.lo[r:r + size, c:c + size] = -2.0
        if walls and self.rng.random() < 0.6:
            wr = r + int(self.rng.integers(2, size - 4))
            self.lo[wr:wr + 2, c:c + int(0.7 * size)] = 2.0
        self._mark(r, c, size, size)

    def step(self, grow=True):
        """One mission step: maybe carve near the frontier, walk robots."""
        if grow and self.rng.random() < 0.8:
            free = np.argwhere(self.lo < 0)
            base = free[self.rng.integers(len(free))]
            jitter = self.rng.integers(-20, 30, 2)
            r = int(np.clip(base[0] + jitter[0], 2,
                            self.g.size_cells - 30))
            c = int(np.clip(base[1] + jitter[1], 2,
                            self.g.size_cells - 30))
            self._carve(r, c, int(self.rng.integers(12, 26)),
                        walls=self.walls)
        self.poses[:, :2] += self.rng.normal(
            0, 0.08, self.poses[:, :2].shape).astype(np.float32)

    def snapshot(self):
        return (self.lo.copy(), self.poses.copy(), self.tile_rev.copy(),
                self.rev)


#: name -> (FrontierConfig overrides, seed, walls). "decay" decays the map
#: after four steps (every cell's log-odds x 0.2, every tile marked).
MISSIONS = {
    "mg0": (dict(), 0, False),
    "mg1": (dict(), 1, False),
    "exact0": (dict(exact_bfs=True), 0, True),
    "euclid0": (dict(obstacle_aware=False), 0, True),
    "decay2": (dict(decay_aware=True, stale_bonus=0.3), 2, True),
}


def mission_steps(name):
    """The mission's publish inputs, one (lo, poses, tile_rev, rev) a
    step: ten steps, every third holding the world still; the decay
    mission's four steps, the decay pass and two more."""
    _kw, seed, walls = MISSIONS[name]
    g = mission_grid(512)
    sim = WorldSim(g, seed=seed, walls=walls)
    steps = []
    if name.startswith("decay"):
        for step in range(4):
            if step:
                sim.step(grow=True)
            steps.append(sim.snapshot())
        sim.lo *= 0.2
        sim._mark(0, 0, g.size_cells, g.size_cells)
        steps.append(sim.snapshot())
        for _ in range(2):
            sim.step(grow=True)
            steps.append(sim.snapshot())
        return steps
    for step in range(10):
        if step:
            sim.step(grow=(step % 3 != 0))
        steps.append(sim.snapshot())
    return steps

def walled_map(cfg):
    """The planner's walled map at `cfg` (tests/test_planner.py): a
    vertical wall with one gap near the top; start left of it and goal
    right of it, both near the bottom. Returns (log-odds, the same with
    the gap sealed, {"start": xy, "goal": xy})."""
    g, f = cfg.grid, cfg.frontier
    n = g.size_cells
    lo = np.full((n, n), -1.0, np.float32)
    mid = n // 2
    lo[:, mid - 2:mid + 2] = 3.0
    lo[n - 40:n - 20, mid - 2:mid + 2] = -1.0
    sealed = lo.copy()
    sealed[:, mid - 2:mid + 2] = 3.0
    res = g.resolution_m * f.downsample
    ox, oy = g.origin_m
    start = np.array([ox + 10 * res, oy + 10 * res], np.float32)
    goal = np.array([ox + (n // f.downsample - 10) * res, oy + 10 * res],
                    np.float32)
    return lo, sealed, {"start": start, "goal": goal}


# ---------------------------------------------------------------------------
# The matcher's window correlations (K8)
# ---------------------------------------------------------------------------


def dense_starts(R, A, H, W_, P, n_out, stride, device):
    """The (r, a, y0, x0) of every dense score, in output order."""
    L = (W_ - P) // stride + 1
    r, a, my, mx = torch.meshgrid(
        torch.arange(R), torch.arange(A), torch.arange(n_out),
        torch.arange(L), indexing="ij")
    y0 = torch.clamp_max(my * stride, H - P)
    return [t.reshape(-1).to(device) for t in (r, a, y0, mx * stride)], L


def list_starts(a_idx, oy, ox, H, W_, P):
    """The (r, a, y0, x0) of every candidate score, starts clamped."""
    R, K = a_idx.shape
    r = torch.arange(R, device=a_idx.device)[:, None].expand(R, K)
    return [t.reshape(-1) for t in (r, a_idx, oy.clamp(0, H - P),
                                    ox.clamp(0, W_ - P))]


def k8_windows(field, rasters, r, a, y0, x0):
    """Score i's raster and its P x P field window, gathered."""
    P = rasters.shape[-1]
    ar = torch.arange(P, device=field.device)
    fw = field[r[:, None, None], (y0[:, None] + ar)[:, :, None],
               (x0[:, None] + ar)[:, None, :]]
    return rasters[r, a], fw


def direct64(field, rasters, r, a, y0, x0, mass, chunk=64):
    """Each score's sum in float64 from the same float32 inputs."""
    out = []
    for s in range(0, r.numel(), chunk):
        sl = slice(s, s + chunk)
        ra, fw = k8_windows(field, rasters, r[sl], a[sl], y0[sl], x0[sl])
        out.append((ra.double() * fw.double()).sum(dim=(1, 2))
                   / mass[r[sl]].double())
    return torch.cat(out)


# ---------------------------------------------------------------------------
# Rendezvous merge (RendezvousMerger's mapper interface)
# ---------------------------------------------------------------------------

def _host(x) -> np.ndarray:
    """A tensor (torch, or any array type numpy reads) as numpy."""
    if torch.is_tensor(x):
        x = x.detach().cpu()
    return np.asarray(x)


class StandInMapper:
    """The four members `RendezvousMerger` reads of a mapper, over a list
    of SlamStates that share one grid: `.states`, `.n_robots`,
    `.graph_snapshot(i)` and `.merged_grid()`. Works on either package's
    states (numpy reads torch tensors through `_host`, JAX arrays
    directly)."""

    def __init__(self, states, max_poses: int):
        self.states = list(states)
        self.n_robots = len(self.states)
        self.max_poses = max_poses

    def graph_snapshot(self, i: int):
        st = self.states[i]
        cap = self.max_poses
        return (0, _host(st.graph.poses[:cap]).astype(np.float32),
                _host(st.graph.pose_valid[:cap]).astype(bool),
                int(st.graph.n_poses), int(st.n_keyscans))

    def merged_grid(self):
        return self.states[0].grid


def reloc_inputs(cfg, device="cpu"):
    """A relocalization case at tiny_config: rooms_world(256) fused from 16
    poses on a 1.6 m circle, a scan at (1.0, 0.4, 0.3) and a guess
    (0.06, -0.05, 0.08) off it. Returns (grid, ranges, guess) on
    `device`."""
    from jax_mapping_torch.ops import grid as G
    from jax_mapping_torch.sim import lidar
    from jax_mapping_torch.sim import world as W
    g, s = cfg.grid, cfg.scan
    world = torch.as_tensor(W.rooms_world(g.size_cells, g.resolution_m))
    ns = int(s.range_max_m / (g.resolution_m * 0.5))
    k = torch.arange(16, dtype=torch.float32)
    poses = torch.stack([1.6 * torch.cos(k / 3), 1.6 * torch.sin(k / 3),
                         k * 0.3], 1)
    scans = lidar.simulate_scans(s, world, g.resolution_m, ns, poses)
    grid = G.fuse_scans(g, s, G.empty_grid(g, "cpu"), scans, poses)
    truth = torch.tensor([1.0, 0.4, 0.3])
    ranges = lidar.simulate_scans(s, world, g.resolution_m, ns,
                                  truth[None])[0]
    guess = truth + torch.tensor([0.06, -0.05, 0.08])
    return grid.to(device), ranges.to(device), guess.to(device)


def tiny_fleets(cfg, T, device="cpu"):
    """Two fleets for the rendezvous merge at tiny_config: fleet A is two
    robots along short paths in rooms_world(256)'s centre room (graph
    poses, key-scan rings, one grid fused from their scans); fleet B is
    the same robots in a frame that T (B -> A) maps onto A's, on a grid
    re-fused in that frame. Returns (states_a, states_b) on `device`."""
    from jax_mapping_torch.models import slam as S
    from jax_mapping_torch.ops import grid as G
    from jax_mapping_torch.ops import posegraph as PG
    from jax_mapping_torch.scenarios import rendezvous as RV
    from jax_mapping_torch.sim import lidar
    from jax_mapping_torch.sim import world as W
    g, s = cfg.grid, cfg.scan
    world = torch.as_tensor(W.rooms_world(g.size_cells, g.resolution_m))
    ns = int(s.range_max_m / (g.resolution_m * 0.5))
    k = torch.arange(6, dtype=torch.float32)
    paths = [torch.stack([-0.6 + 0.15 * k, 0.4 + 0.05 * k, 0.1 * k], 1),
             torch.stack([0.7 - 0.05 * k, -0.5 + 0.15 * k, 1.6 + 0.12 * k],
                         1)]
    states, scans_all = [], []
    for path in paths:
        scans = lidar.simulate_scans(s, world, g.resolution_m, ns, path)
        st = S.init_state(cfg, path[0], "cpu")
        gr, ring = st.graph, st.scan_ring.clone()
        for i in range(len(path)):
            gr = PG.add_pose(gr, path[i])
            if i:
                gr = PG.odometry_edge(gr, i - 1, i)
            ring[i] = scans[i]
        states.append(st._replace(pose=path[-1], last_key_pose=path[-1],
                                  graph=gr, scan_ring=ring,
                                  n_keyscans=torch.tensor(len(path),
                                                          dtype=torch.int32)))
        scans_all.append(scans)
    grid_a = G.fuse_scans(g, s, G.empty_grid(g, "cpu"),
                          torch.cat(scans_all), torch.cat(paths))
    t_inv = RV.se2_from_pair(np.zeros(3, np.float32), T)
    moved = [RV.transform_state(st, t_inv) for st in states]
    cap = cfg.loop.max_poses
    grid_b = G.empty_grid(g, "cpu")
    for st in moved:
        grid_b = G.fuse_scans_masked(g, s, grid_b, st.scan_ring,
                                     st.graph.poses[:cap],
                                     st.graph.pose_valid[:cap])

    def on(st, grid):
        return type(st)(*(x.to(device) if torch.is_tensor(x) else
                          type(x)(*(y.to(device) for y in x))
                          for x in st._replace(grid=grid)))

    return ([on(st, grid_a) for st in states],
            [on(st, grid_b) for st in moved])
