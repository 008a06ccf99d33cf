"""The per-(tile, scan) class of kernels K1, K4 and K5, through its plain
mirror `sensor_kernel.tile_classes_plain`, on the CPU.

The kernels decide per 16 x 16 tile and scan whether the sensor model is a
constant there (`csrc/sensor_cell.cuh::tile_class`) and write or add that
constant without the per-cell model. These tests hold the mirror against
the plain per-cell model (`grid.classify_patch`, `grid.raster_patch`):
every tile the class calls constant must be that constant cell for cell,
and the class must cull enough to be worth its cost. They also check the
kernels' wrap of a bearing into [0, 2pi) against fmod, and the
function-based operation count the chip smoke's bounds use.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from jax_mapping_torch.config import SlamConfig, micro_config, tiny_config
from jax_mapping_torch.ops import grid as G
from jax_mapping_torch.ops import sensor_kernel as SK
from jax_mapping_torch.sim import lidar
from jax_mapping_torch.sim import world as W
# Imported as a sibling, as the card's test file imports this one.
from torch_threads import one_intra_op_thread  # noqa: F401


def _fov_config():
    """A 270-degree clockwise scan: no full circle, so the class takes its
    other branch (no uniform-free tiles, intervals that may cross 0 or
    2pi go to the per-cell model)."""
    t = tiny_config(2)
    return t.replace(scan=dataclasses.replace(
        t.scan, n_beams=68, angle_min_rad=-2.356, counterclockwise=False))


CONFIGS = {"micro": micro_config, "tiny": lambda: tiny_config(2),
           "fov": _fov_config, "default": SlamConfig}


def _poses_near_walls(cfg, world, n, rng):
    """n free poses 0.1-1.0 max ranges from random wall cells."""
    res = cfg.grid.resolution_m
    H, Wd = world.shape
    walls = np.argwhere(world)
    out = []
    while len(out) < n:
        r, c = walls[rng.integers(len(walls))]
        ang = rng.uniform(0.0, 2 * np.pi)
        d = rng.uniform(0.1, 1.0) * cfg.grid.max_range_m
        x = (c + 0.5 - Wd / 2) * res + d * np.cos(ang)
        y = (r + 0.5 - H / 2) * res + d * np.sin(ang)
        col = int(np.floor(x / res + Wd / 2))
        row = int(np.floor(y / res + H / 2))
        if 0 <= row < H and 0 <= col < Wd and not world[row, col]:
            out.append((x, y, rng.uniform(-np.pi, np.pi)))
    return torch.tensor(np.array(out, dtype=np.float32))


def _scans(cfg, poses):
    g, s = cfg.grid, cfg.scan
    world = torch.as_tensor(W.rooms_world(g.size_cells, g.resolution_m,
                                          seed=1))
    return lidar.simulate_scans(s, world, g.resolution_m,
                                int(s.range_max_m / (g.resolution_m * 0.5)),
                                poses)


def _inputs(cfg, seed, n=6):
    g = cfg.grid
    world = W.rooms_world(g.size_cells, g.resolution_m, seed=1)
    poses = _poses_near_walls(cfg, world, n, np.random.default_rng(seed))
    return _scans(cfg, poses), poses, G.patch_origin(g, poses[:, :2])


def _tiles(out, tile):
    """(B, P, P) -> (B, T, T, tile * tile), NaN past the ragged edge."""
    B, P, _ = out.shape
    T = -(-P // tile)
    pad = torch.nn.functional.pad(out, (0, T * tile - P, 0, T * tile - P),
                                  value=float("nan"))
    return pad.reshape(B, T, tile, T, tile).permute(0, 1, 3, 2, 4).reshape(
        B, T, T, tile * tile)


def _check_sound(cfg, ranges, poses, origins, raster):
    g, s = cfg.grid, cfg.scan
    plain = G.raster_patch if raster else G.classify_patch
    out = plain(g, s, ranges, poses, origins)
    cls = SK.tile_classes_plain(g, s, ranges, poses, origins, raster=raster)
    tiles = _tiles(out, SK.TILE)
    pad = torch.isnan(tiles)
    all_zero = ((tiles == 0.0) | pad).all(dim=-1)
    all_free = ((tiles == g.logodds_free) | pad).all(dim=-1)
    constant_zero = (cls == SK.ZERO) | (cls == SK.NO_HIT)
    assert not bool((constant_zero & ~all_zero).any()), \
        "a zero or no-hit tile holds a non-zero cell"
    assert not bool(((cls == SK.FREE) & ~all_free).any()), \
        "a uniform-free tile holds a cell other than lo_free"
    if raster:
        assert not bool((cls == SK.FREE).any())
    return cls


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("mode", ["delta", "raster"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_class_is_sound_near_walls(name, mode, seed):
    cfg = CONFIGS[name]()
    _check_sound(cfg, *_inputs(cfg, seed), raster=mode == "raster")


def _edge_inputs(cfg, case):
    """Poses and scans at the edges the class has to get right."""
    g, s = cfg.grid, cfg.scan
    res = g.resolution_m
    ranges, poses, origins = _inputs(cfg, 7, n=4)
    poses = poses.clone()
    if case == "pose_outside_patch":
        poses[:, 0] += 0.75 * g.patch_cells * res
        poses[:, 1] -= 0.6 * g.patch_cells * res
    elif case == "pose_on_tile_corner":
        ox, oy = g.origin_m
        k = torch.tensor([2, 3, 4, 5], dtype=torch.int32)
        col = origins[:, 1] + SK.TILE * k
        row = origins[:, 0] + SK.TILE * (k - 1)
        poses[:, 0] = col.to(torch.float32) * res + ox
        poses[:, 1] = row.to(torch.float32) * res + oy
    elif case == "yaw_beyond_pi_and_2pi":
        poses[:, 2] = torch.tensor([3.5, -3.5, 2 * math.pi, -2 * math.pi])
    elif case == "yaw_beyond_4pi":
        poses[:, 2] = torch.tensor([4 * math.pi, -4 * math.pi, 13.0, -40.0])
    elif case == "all_zero_ranges":
        ranges = torch.zeros_like(ranges)
    elif case == "hits_at_max_range":
        ranges = torch.full_like(ranges, g.max_range_m)
        ranges[:, s.n_beams:] = 0.0
    return ranges, poses, origins


EDGES = ["pose_outside_patch", "pose_on_tile_corner", "yaw_beyond_pi_and_2pi",
         "yaw_beyond_4pi", "all_zero_ranges", "hits_at_max_range"]


@pytest.mark.parametrize("mode", ["delta", "raster"])
@pytest.mark.parametrize("case", EDGES)
def test_class_is_sound_at_edges(case, mode):
    cfg = tiny_config(2)
    _check_sound(cfg, *_edge_inputs(cfg, case), raster=mode == "raster")


#: Least share of (tile, scan) pairs the class must send to a constant at
#: the default config near walls (measured 0.953-0.962 for rasters and
#: 0.919-0.926 for deltas on these seeds; floors 5 points lower).
CULL_FLOORS = {"raster": 0.90, "delta": 0.87}


@pytest.mark.parametrize("mode", ["delta", "raster"])
def test_class_culls_most_tiles_at_the_default_config(mode):
    cfg = SlamConfig()
    shares = []
    for seed in (0, 1, 2):
        cls = _check_sound(cfg, *_inputs(cfg, seed), raster=mode == "raster")
        shares.append(float((cls != SK.PER_CELL).float().mean()))
    assert min(shares) >= CULL_FLOORS[mode], shares


# ---------------------------------------------------------------------------
# The wrap into [0, 2pi)
# ---------------------------------------------------------------------------

_TWO_PI = np.float32(2.0 * math.pi)


def _wrap_kernel(th):
    """float32 copy of sensor_cell.cuh::wrap_two_pi."""
    th = th.copy()
    a = np.abs(th)
    mid = (a >= _TWO_PI) & (a < np.float32(2.0) * _TWO_PI)
    far = a >= np.float32(2.0) * _TWO_PI
    th[mid] = np.where(th[mid] > 0, th[mid] - _TWO_PI, th[mid] + _TWO_PI)
    th[far] = np.fmod(th[far], _TWO_PI)
    return np.where(th < 0, th + _TWO_PI, th).astype(np.float32)


def _wrap_fmod(th):
    """The plain version's wrap: fmod, then add 2pi where negative."""
    r = np.fmod(th, _TWO_PI)
    return np.where(r < 0, r + _TWO_PI, r).astype(np.float32)


def _beam(th, inc, n):
    return np.mod(np.rint(th / inc).astype(np.int64), n)


def _specials():
    base = np.array([0.0, 2 * math.pi, 4 * math.pi, 6 * math.pi, math.pi],
                    dtype=np.float32)
    vals = [base, np.nextafter(base, np.float32(np.inf)),
            np.nextafter(base, np.float32(-np.inf))]
    v = np.concatenate(vals)
    return np.concatenate([v, -v, np.array([-0.0], dtype=np.float32)])


@pytest.mark.parametrize("draw", ["specials", "uniform"])
def test_wrap_equals_fmod_as_the_beam(draw):
    if draw == "specials":
        th = _specials()
    else:
        rng = np.random.default_rng(5)
        th = rng.uniform(-6 * math.pi, 6 * math.pi, 2_000_000).astype(
            np.float32)
    with np.errstate(invalid="ignore"):
        got, want = _wrap_kernel(th), _wrap_fmod(th)
    assert np.array_equal(got, want)          # +0 == -0
    for cfg in (SlamConfig(), tiny_config(2), micro_config()):
        inc = np.float32(cfg.scan.angle_increment_rad)
        n = cfg.scan.n_beams
        assert np.array_equal(_beam(got, inc, n), _beam(want, inc, n))


# ---------------------------------------------------------------------------
# The function-based operation count of the bounds
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tile", [8, 16, 37])
def test_model_cells_counts_cells_within_max_range(tile):
    cfg = SlamConfig()
    g = cfg.grid
    rng = np.random.default_rng(3)
    poses = torch.tensor(np.stack([rng.uniform(-20, 20, 5),
                                   rng.uniform(-20, 20, 5),
                                   rng.uniform(-3, 3, 5)], 1),
                         dtype=torch.float32)
    origins = G.patch_origin(g, poses[:, :2])
    origins[0] += 200                         # a pose off its patch centre
    P, res = g.patch_cells, g.resolution_m
    i = torch.arange(P, dtype=torch.float64)
    p = poses.to(torch.float64)
    o = origins.to(torch.float64)
    dy = ((o[:, 0:1] + i + 0.5) * res + g.origin_m[1] - p[:, 1:2])[:, :, None]
    dx = ((o[:, 1:2] + i + 0.5) * res + g.origin_m[0] - p[:, 0:1])[:, None, :]
    inside = (torch.sqrt(dx * dx + dy * dy) <= g.max_range_m).to(
        torch.float64)
    per_tile = _tiles(inside, tile).nan_to_num(0.0).sum()
    n = SK.model_cells(g, poses, origins)
    assert n == int(inside.sum()) == int(per_tile)
    assert 0 < n < poses.shape[0] * P * P
