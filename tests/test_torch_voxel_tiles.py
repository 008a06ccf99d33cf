"""The voxel kernels' cull (K6, K7), through its plain mirrors in
`voxel_kernel`, on the CPU.

Both kernels test each (tile of voxel columns, image) pair once and skip
the dead ones (`csrc/voxel_model.cu::tile_live`, mirrored by
`tile_live_plain`), and evaluate each live column only inside a z interval
(`column_terms`, mirrored by `column_z_range_plain`). These tests hold the
mirrors against the model itself (`_model`, `model_voxel_mask`): every
voxel the model may make non-zero, whatever the depths, lies in a live
pair and inside its column's interval, on random poses and on poses at the
cull's edges. A replay of the kernels' schedule (tiles, the z split, the
images in b order with the dead ones skipped) equals the plain versions
bit for bit on regions whose sides the tile does not divide, and on the
bench's poses the kernels evaluate few more voxels than the model needs.
The kernels' division (`div_rn`: a reciprocal per column, two Markstein
corrections per voxel) is held against IEEE division.
No JAX here: the mirrors are checked against the port's own plain model,
which tests/test_torch_voxel_kernel.py holds against the JAX package.
"""

import math
import re
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest
import torch

from jax_mapping_torch.config import SlamConfig, tiny_config
from jax_mapping_torch.ops import voxel as V
from jax_mapping_torch.ops import voxel_kernel as VK

from torch_kernel_inputs import VOXEL_EDGES as EDGES
from torch_kernel_inputs import VOXEL_REGIONS, cameras_around_region
from torch_kernel_inputs import voxel_depths as _depths
from torch_kernel_inputs import voxel_edge_case as edge_case
from tests.torch_threads import one_intra_op_thread  # noqa: F401

CONFIGS = {"tiny": lambda: tiny_config(2), "default": SlamConfig}


def test_mirror_constants_match_the_kernel_source():
    src = (Path(VK.__file__).resolve().parent.parent / "csrc"
           / "voxel_model.cu").read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
    assert (const("kTileY"), const("kTileX"), const("kZChunk")) == (
        VK.TILE_Y, VK.TILE_X, VK.Z_CHUNK)


def _random_case(cfg, seed, B=6):
    rng = np.random.default_rng(seed)
    vox = cfg.voxel
    half = vox.size_x_cells * vox.resolution_m / 4
    poses = torch.tensor(np.stack([rng.uniform(-half, half, B),
                                   rng.uniform(-half, half, B),
                                   rng.uniform(-4.0, 4.0, B)], 1),
                         dtype=torch.float32)
    return _depths(cfg, B, rng), poses, V.patch_origin(vox, poses[:, :2])


def _kept_columns(live_b, ny, nx):
    return live_b.repeat_interleave(VK.TILE_Y, 0)[:ny].repeat_interleave(
        VK.TILE_X, 1)[:, :nx]


def _check_sound(cfg, depths, poses, origins, ny=None, nx=None):
    """Every voxel the model may make non-zero lies in a live pair and in
    its column's z interval; every non-zero delta is such a voxel.
    Returns the number of non-zero deltas."""
    vox, cam = cfg.voxel, cfg.depthcam
    ny = ny or vox.patch_cells
    nx = nx or vox.patch_cells
    table = VK.pose_table(poses)
    live = VK.tile_live_plain(vox, cam, table, origins, ny, nx)
    z = torch.arange(vox.size_z_cells)[:, None, None]
    nonzero = 0
    for b in range(poses.shape[0]):
        y0, x0 = origins[b, 0], origins[b, 1]
        mask = VK.model_voxel_mask(vox, cam, table[b], y0, x0, ny, nx)
        delta = VK._model(vox, cam, depths[b], table[b], y0, x0, ny, nx)
        assert not bool(((delta != 0) & ~mask).any()), \
            "a non-zero delta outside the model's mask"
        assert not bool((mask & ~_kept_columns(live[b], ny, nx)).any()), \
            f"image {b}: a dead (tile, image) pair holds a live voxel"
        lo, hi = VK.column_z_range_plain(vox, cam, table[b], y0, x0, ny, nx)
        assert not bool((mask & ((z < lo) | (z > hi))).any()), \
            f"image {b}: a live voxel outside its column's z interval"
        nonzero += int((delta != 0).sum())
    return nonzero


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_cull_is_sound_on_random_poses(name, seed):
    cfg = CONFIGS[name]()
    assert _check_sound(cfg, *_random_case(cfg, seed)) > 0


@pytest.mark.parametrize("case", EDGES)
@pytest.mark.parametrize("name", list(CONFIGS))
def test_cull_is_sound_at_edges(name, case):
    cfg = CONFIGS[name]()
    _check_sound(cfg, *edge_case(cfg, case))


@pytest.mark.parametrize("ny, nx", [(16, 72), (9, 128), (24, 48)])
def test_cull_is_sound_on_regions_the_tile_does_not_divide(ny, nx):
    cfg = tiny_config(2)
    depths, poses, _ = _random_case(cfg, 4)
    origins = torch.tensor([[40, 30], [50, 0], [41, 57], [0, 3], [60, 60],
                            [47, 20]], dtype=torch.int32)
    poses[:, 0] = (origins[:, 1] + nx / 2) * cfg.voxel.resolution_m \
        + cfg.voxel.origin_m[0]
    poses[:, 1] = (origins[:, 0] - 3) * cfg.voxel.resolution_m \
        + cfg.voxel.origin_m[1]
    _check_sound(cfg, depths, poses, origins, ny, nx)


@pytest.mark.parametrize(
    "region", [r for r in VOXEL_REGIONS if 2 * r[2] < CONFIGS[r[0]]().voxel
               .size_y_cells], ids=lambda r: "-".join(map(str, r)))
def test_region_cases_reach_the_edge_tiles(region):
    """The card's random cases on regions smaller than half the grid
    (tests/test_torch_cuda.py) compare live voxels: the plain sum is
    non-zero in the region's last row and last tile column, where the
    tile is cut short, and the cull keeps those columns."""
    name, y0, ny, nx = region
    cfg = CONFIGS[name]()
    vox, cam = cfg.voxel, cfg.depthcam
    depths, poses = cameras_around_region(cfg, y0, ny, nx, 8, 3)
    origins = torch.tensor([[y0, 0]] * 8, dtype=torch.int32)
    table = VK.pose_table(poses)
    nonzero = VK.summed_delta_plain(vox, cam, depths, table, origins, ny,
                                    nx) != 0
    last = (nx - 1) // VK.TILE_X * VK.TILE_X
    assert bool(nonzero[:, -1].any()) and bool(nonzero[:, :, last:].any())
    kept = _kept_columns(VK.tile_live_plain(vox, cam, table, origins, ny,
                                            nx).any(0), ny, nx)
    assert bool(kept[-1].any()) and bool(kept[:, last:].any())
    _check_sound(cfg, depths, poses, origins, ny, nx)


# ---------------------------------------------------------------------------
# The kernels' schedule, replayed
# ---------------------------------------------------------------------------

def _replay(cfg, depths, table, origins, ny, nx, summed):
    """K7 (summed) or K6 as the kernels schedule them: per tile, per z
    group of Z_CHUNK layers, the images in b order. A dead pair is
    skipped; for a live one K7 adds the deltas of every group that meets
    a column's z interval (all its layers), and K6 writes the deltas
    inside the interval and zeros elsewhere. Asserts that every delta
    left out is 0."""
    vox, cam = cfg.voxel, cfg.depthcam
    Z, B = vox.size_z_cells, depths.shape[0]
    live = VK.tile_live_plain(vox, cam, table, origins, ny, nx)
    out = torch.zeros((Z, ny, nx) if summed else (B, Z, ny, nx))
    z = torch.arange(Z)[:, None, None]
    for r0 in range(0, ny, VK.TILE_Y):
        for c0 in range(0, nx, VK.TILE_X):
            h, w = min(VK.TILE_Y, ny - r0), min(VK.TILE_X, nx - c0)
            acc = torch.zeros((Z, h, w))
            for b in range(B):
                y0, x0 = origins[b, 0] + r0, origins[b, 1] + c0
                d = VK._model(vox, cam, depths[b], table[b], y0, x0, h, w)
                lo, hi = VK.column_z_range_plain(vox, cam, table[b], y0, x0,
                                                 h, w)
                inside = (z >= lo) & (z <= hi) & bool(
                    live[b, r0 // VK.TILE_Y, c0 // VK.TILE_X])
                assert not bool((d[~inside] != 0).any())
                if not summed:
                    out[b, :, r0:r0 + h, c0:c0 + w] = torch.where(inside, d,
                                                                 0.0)
                    continue
                for z0 in range(0, Z, VK.Z_CHUNK):
                    g = slice(z0, z0 + VK.Z_CHUNK)
                    meets = inside[g].any(0)            # per column
                    acc[g] = torch.where(meets, acc[g] + d[g], acc[g])
            if summed:
                out[:, r0:r0 + h, c0:c0 + w] = acc
    return out


REGIONS = [(64, 64), (16, 72), (9, 128), (24, 48)]


@pytest.mark.parametrize("B", [1, 8, 32])
@pytest.mark.parametrize("ny, nx", REGIONS)
def test_k7_schedule_equals_the_plain_sum(ny, nx, B):
    """Up to K7's 32 images a launch; the first two origins at the grid's
    corners."""
    cfg = tiny_config(2)
    vox, cam = cfg.voxel, cfg.depthcam
    rng = np.random.default_rng(ny * nx + B)
    depths = _depths(cfg, B, rng)
    # Cameras around the region, looking every way, and origins at the
    # grid's edges and off them.
    origins = torch.tensor(np.stack(
        [rng.integers(0, vox.size_y_cells - ny + 1, B),
         rng.integers(0, vox.size_x_cells - nx + 1, B)], 1),
        dtype=torch.int32)
    origins[0] = 0
    origins[-1] = torch.tensor([vox.size_y_cells - ny,
                                vox.size_x_cells - nx])
    res = vox.resolution_m
    ox, oy, _ = vox.origin_m
    poses = torch.tensor(np.stack([
        (origins[:, 1].numpy() + rng.uniform(-10, nx + 10, B)) * res + ox,
        (origins[:, 0].numpy() + rng.uniform(-10, ny + 10, B)) * res + oy,
        rng.uniform(-math.pi, math.pi, B)], 1), dtype=torch.float32)
    table = VK.pose_table(poses)
    got = _replay(cfg, depths, table, origins, ny, nx, summed=True)
    want = VK.summed_delta_plain(vox, cam, depths, table, origins, ny, nx)
    assert torch.equal(got, want)
    assert not bool(torch.signbit(got[got == 0]).any())   # never -0
    assert int((want != 0).sum()) > 0


@pytest.mark.parametrize("case", ["random", *EDGES])
def test_k6_schedule_equals_the_plain_deltas(case):
    cfg = tiny_config(2)
    vox, cam = cfg.voxel, cfg.depthcam
    depths, poses, origins = (_random_case(cfg, 9) if case == "random"
                              else edge_case(cfg, case))
    table = VK.pose_table(poses)
    P = vox.patch_cells
    got = _replay(cfg, depths, table, origins, P, P, summed=False)
    want = VK.image_deltas_plain(vox, cam, depths, table, origins)
    assert torch.equal(got, want)


# ---------------------------------------------------------------------------
# How much the cull removes
# ---------------------------------------------------------------------------

def _bench_poses(which):
    """bench.py's voxel poses (chip_smoke.py phase_voxel_bench): the
    32-image window on a 0.2 m circle at one shared patch, or the fuse's
    32 images on a 3 m circle at their own patches."""
    vox = SlamConfig().voxel
    if which == "window":
        wt = np.linspace(0, 0.5, 32).astype(np.float32)
        poses = torch.as_tensor(np.stack(
            [0.2 * np.cos(wt * 2 * np.pi), 0.2 * np.sin(wt * 2 * np.pi), wt],
            axis=1).astype(np.float32))
        origin = V.patch_origin(vox, poses[:, :2].mean(dim=0))
        return poses, origin.reshape(1, 2).expand(32, 2)
    t = np.linspace(0, 2 * math.pi, 32, endpoint=False)
    poses = torch.as_tensor(np.stack(
        [3.0 * np.cos(t), 3.0 * np.sin(t), t + math.pi / 2],
        axis=1).astype(np.float32))
    return poses, V.patch_origin(vox, poses[:, :2])


#: Most evaluated voxels per voxel the model needs, and most kept columns
#: per column it needs, on the bench's poses (measured 1.025 and 1.78;
#: the old row-band cull of 256-column strips evaluated 16.3x and kept
#: 10.4x).
MAX_EVALUATED_PER_LIVE = 2.5
MAX_KEPT_PER_LIVE_COLUMN = 2.5


@pytest.mark.parametrize("which", ["window", "fuse"])
@pytest.mark.parametrize("kernel", ["k6", "k7"])
def test_cull_evaluates_few_more_voxels_than_the_model_needs(kernel, which):
    cfg = SlamConfig()
    poses, origins = _bench_poses(which)
    P = cfg.voxel.patch_cells
    c = VK.cull_counts(cfg.voxel, cfg.depthcam, VK.pose_table(poses),
                       origins, P, P, group=1 if kernel == "k6" else
                       VK.Z_CHUNK)
    assert 0 < c["model_voxels"] <= c["evaluated_voxels"]
    assert c["evaluated_voxels"] <= MAX_EVALUATED_PER_LIVE * \
        c["model_voxels"], c
    assert c["model_columns"] <= c["kept_columns"] <= \
        MAX_KEPT_PER_LIVE_COLUMN * c["model_columns"], c
    assert c["live_pairs"] <= 0.15 * c["pairs"], c


# ---------------------------------------------------------------------------
# The kernels' division
# ---------------------------------------------------------------------------

def _rn32(x: Fraction) -> np.float32:
    """x rounded to the nearest float32, ties to even (exactly)."""
    f = np.float32(float(x))
    best = None
    for c in (np.nextafter(f, np.float32(-np.inf)), f,
              np.nextafter(f, np.float32(np.inf))):
        d = abs(Fraction(float(c)) - x)
        even = int(np.array(c).view(np.uint32)) % 2 == 0
        if best is None or d < best[0] or (d == best[0] and even):
            best = (d, c)
    return best[1]


def _fma32(a, b, c) -> np.float32:
    return _rn32(Fraction(float(a)) * Fraction(float(b)) + Fraction(float(c)))


def _div_rn(a, b):
    """csrc/voxel_model.cu div_rn from y = RN(1/b): q = RN(a y), then two
    corrections q + (a - b q) y, each an fma."""
    y = np.float32(1.0) / b
    q = a * y
    for _ in range(2):
        q = _fma32(y, _fma32(-b, q, a), q)
    return q


def test_division_equals_ieee_on_the_models_operands():
    """a = fy (camz - wz) of every layer of both configs, b = czc in
    (range_min, max_range]: random, at powers of two and their
    neighbours, and a quotient near a rounding tie."""
    rng = np.random.default_rng(31)
    cases = []
    for cfg in (SlamConfig(), tiny_config(2)):
        args = VK.model_args(cfg.voxel, cfg.depthcam)
        Z, res, oz, camz, fy = args[0], args[3], args[6], args[7], args[9]
        z = np.arange(VK.Z_CHUNK * -(-Z // VK.Z_CHUNK), dtype=np.float32)
        wz = (z + np.float32(0.5)) * np.float32(res) + np.float32(oz)
        fyc = np.float32(fy) * (np.float32(camz) - wz)
        b = rng.uniform(cfg.depthcam.range_min_m, cfg.voxel.max_range_m,
                        600).astype(np.float32)
        pw = np.float32(2.0) ** np.arange(-2, 3, dtype=np.float32)
        b = np.concatenate([b, pw, np.nextafter(pw, np.float32(0)),
                            np.nextafter(pw, np.float32(9))])
        cases += [(a, bb) for a in fyc[::3] for bb in b[::7]]
        cases += [(a, bb) for a in rng.choice(fyc, 40) for bb in b[-15:]]
    # Quotients a hair from a tie: a = (k + 1/2) b rounded.
    for bb in rng.uniform(0.2, 5.0, 200).astype(np.float32):
        k = np.float32(rng.integers(-60, 60))
        cases.append((np.float32((k + np.float32(0.5)) * bb), bb))
    bad = [(a, b) for a, b in cases
           if _div_rn(np.float32(a), np.float32(b))
           != np.float32(a) / np.float32(b)]
    assert len(cases) > 3000
    assert not bad, bad[:5]
