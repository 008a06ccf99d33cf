"""Seeded inputs that the port's kernel tests and chip_smoke.py share.

The frontier sweeps' inputs (K2, K3): paths longer than the sweep count
that cross every row slab of the kernels' cluster decomposition
(tests/test_torch_frontier_sweeps.py). The voxel cull's edge cases (K6,
K7): poses at the edges of the (tile, image) cull and the z interval
(tests/test_torch_voxel_tiles.py). Plain numpy and PyTorch; no pytest and
no JAX, so chip_smoke.py can import it on the card's machine.
"""

import math

import numpy as np
import torch

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
