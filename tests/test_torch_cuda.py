"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Every test is marked `cuda` and skips where there is no CUDA device (the
fixture decides, at run time). On a machine with a card:

    python -m pytest tests/test_torch_cuda.py -q

The kernels must equal their plain versions exactly: K1 evaluates the
plain version's float operations one rounding each in the same order, K2
is integer max, and every K3 candidate is one add under an exact min. K4
and K5 classify a cell with K1's device code and add the deltas in b
order, as their plain versions do. K1, K4 and K5 decide per tile and scan
whether the model is a constant there; the tests near walls and at the
edges reach every class of that decision. K6 and K7 evaluate the voxel model's
float operations in the plain version's order and K7 adds in b order; both
skip the (tile, image) pairs and the layers their cull finds empty, and the
cases at the cull's edges (tests/torch_kernel_inputs.py) hold them to
the plain versions there too. K2
and K3 run each field as one thread-block cluster of row slabs up to
512^2 and one launch a sweep above; their cases reach cluster sizes 16, 8
and 4 (through the number of fields) and both routes, on paths through
every slab boundary. Other slab splits are held on the CPU by the plain
mirror in tests/test_torch_frontier_sweeps.py. The recovery path's cases
put K1 on the relocalizer's, the bucketed and touched fuses' and the
rendezvous merge's batches, card against CPU. The tenant megabatch's
cases run K2 over T grids under a mask each and K3 over T tenants' fields
under a mask a tenant (T in 1, 2, 3, 6, both routes), and a tiny megabatch
against its missions' solo runs on the card. The mission stack's cases run
`launch_sim_stack` at tiny_config(2) on the card against the CPU, and a
stalled mapper's queue through `_step_window` (K5). The scenario case
drives a scripted door and crowd through the sim on the card: the card's
world equals the host composition after every step, and its uploads make
no host sync.
"""

import dataclasses
import math

import numpy as np
import pytest
import torch

from jax_mapping_torch import interop
from jax_mapping_torch.config import SlamConfig, micro_config, tiny_config
from jax_mapping_torch.models import fleet as FL
from jax_mapping_torch.ops import _cuda
from jax_mapping_torch.ops import costfield as CF
from jax_mapping_torch.models import slam as S
from jax_mapping_torch.ops import frontier as F
from jax_mapping_torch.ops import fuse_kernel as FK
from jax_mapping_torch.ops import grid as G
from jax_mapping_torch.ops import planner as P
from jax_mapping_torch.ops import sensor_kernel as SK
from jax_mapping_torch.ops import voxel as V
from jax_mapping_torch.ops import voxel_kernel as VK
from jax_mapping_torch.sim import depthcam as D
from jax_mapping_torch.sim import world as W

import test_torch_sensor_tiles as ST  # a sibling test file's inputs
import torch_kernel_inputs as KI
import torch_sharded_drive as SD

pytestmark = pytest.mark.cuda


def _odd_config():
    """A patch and a beam padding that are no multiple of anything."""
    t = tiny_config(2)
    return t.replace(
        grid=dataclasses.replace(t.grid, patch_cells=72),
        scan=dataclasses.replace(t.scan, padded_beams=100))


CONFIGS = {"micro": micro_config, "tiny": lambda: tiny_config(2),
           "odd": _odd_config, "default": SlamConfig}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _scan_batch(cfg, B, seed):
    g = torch.Generator().manual_seed(seed)
    s = cfg.scan
    half = cfg.grid.size_cells * cfg.grid.resolution_m / 2 - 0.3
    poses = (torch.rand((B, 3), generator=g) * 2 - 1) * torch.tensor(
        [half, half, math.pi])
    ranges = torch.rand((B, s.padded_beams), generator=g) * s.range_max_m * 1.2
    ranges[:, ::7] = 0.0
    ranges[:, s.n_beams:] = 0.0
    return ranges, poses, G.patch_origin(cfg.grid, poses[:, :2])


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("mode", ["delta", "raster"])
def test_sensor_model_equals_plain(dev, name, mode):
    cfg = CONFIGS[name]()
    r, p, o = (x.to(dev).contiguous() for x in _scan_batch(cfg, 9, 1))
    kernel, plain = ((SK.scan_deltas, SK.scan_deltas_plain) if mode == "delta"
                     else (SK.scan_rasters, SK.scan_rasters_plain))
    key = "sensor_model_" + mode
    before = _cuda.LAUNCHES[key]
    got = kernel(cfg.grid, cfg.scan, r, p, o)
    assert _cuda.LAUNCHES[key] == before + 1
    want = plain(cfg.grid, cfg.scan, r, p, o)
    torch.cuda.synchronize()
    assert torch.equal(got, want), int((got != want).sum())
    assert bool((want != 0).any())


TILE_CONFIGS = ("micro", "tiny", "fov", "default")


@pytest.mark.parametrize("mode", ["delta", "raster"])
@pytest.mark.parametrize("name", TILE_CONFIGS)
def test_sensor_model_near_walls_equals_plain(dev, name, mode):
    """Scans of rooms_world near its walls, where the tiles take every
    class (zero, no hit, uniform free, per cell); micro's P = 24 leaves
    ragged 8-cell tiles, fov has no full circle."""
    cfg = ST.CONFIGS[name]()
    r, p, o = (x.to(dev).contiguous() for x in ST._inputs(cfg, 4, n=9))
    kernel, plain = ((SK.scan_deltas, SK.scan_deltas_plain) if mode == "delta"
                     else (SK.scan_rasters, SK.scan_rasters_plain))
    got = kernel(cfg.grid, cfg.scan, r, p, o)
    want = plain(cfg.grid, cfg.scan, r, p, o)
    torch.cuda.synchronize()
    assert torch.equal(got, want), int((got != want).sum())
    assert bool((want != 0).any())


@pytest.mark.parametrize("mode", ["delta", "raster"])
@pytest.mark.parametrize("case", ST.EDGES)
@pytest.mark.parametrize("name", ["micro", "tiny", "default"])
def test_sensor_model_edges_equal_plain(dev, name, case, mode):
    """Poses off their patch, on a tile corner, yaws beyond +-pi, +-2pi and
    +-4pi, all-zero scans and hits exactly at max range."""
    cfg = CONFIGS[name]()
    r, p, o = (x.to(dev).contiguous() for x in ST._edge_inputs(cfg, case))
    kernel, plain = ((SK.scan_deltas, SK.scan_deltas_plain) if mode == "delta"
                     else (SK.scan_rasters, SK.scan_rasters_plain))
    got = kernel(cfg.grid, cfg.scan, r, p, o)
    want = plain(cfg.grid, cfg.scan, r, p, o)
    torch.cuda.synchronize()
    assert torch.equal(got, want), int((got != want).sum())


def _shared_origin_inputs(cfg, case, B):
    """B scans near walls (or an edge case's four, repeated) sharing the
    patch at their mean pose."""
    if case == "near_walls":
        r, p, _ = ST._inputs(cfg, 5, n=B)
    else:
        r, p, _ = ST._edge_inputs(cfg, case)
        reps = -(-B // r.shape[0])
        r, p = r.repeat(reps, 1)[:B], p.repeat(reps, 1)[:B]
    return r, p, G.patch_origin(cfg.grid, p[:, :2].mean(dim=0))


@pytest.mark.parametrize("case", ["near_walls", *ST.EDGES])
@pytest.mark.parametrize("B", [16, 17])
@pytest.mark.parametrize("name", TILE_CONFIGS)
def test_window_kernels_near_walls_equal_plain(dev, name, B, case):
    """K4 and K5 on scans whose tiles take every class, one and more than
    one 16-scan chunk, and at the edges."""
    cfg = ST.CONFIGS[name]()
    r, p, o = (x.to(dev).contiguous()
               for x in _shared_origin_inputs(cfg, case, B))
    got = SK.window_delta(cfg.grid, cfg.scan, r, p, o)
    want = SK.window_delta_plain(cfg.grid, cfg.scan, r, p, o)
    assert torch.equal(got, want), int((got != want).sum())
    n = cfg.grid.size_cells
    g = torch.Generator().manual_seed(B)
    base = ((torch.rand((n, n), generator=g) * 8 - 4)
            * (torch.rand((n, n), generator=g) < 0.5)).to(dev)
    got, want = base.clone(), base.clone()
    FK.window_apply(cfg.grid, cfg.scan, got, r, p, o)
    FK.window_apply_plain(cfg.grid, cfg.scan, want, r, p, o)
    torch.cuda.synchronize()
    assert torch.equal(got, want), int((got != want).sum())


def _check_launches(name, n_sweeps, n):
    """The launches of one K2 or K3 call since reset_launches(): one
    cluster launch up to n = 512 (the slabs fit 16 CTAs' shared memory),
    one launch a sweep on the global route above."""
    want, route = (1, "cluster") if n <= 512 else (n_sweeps, "global")
    assert _cuda.LAUNCHES[name] == want
    assert any(r.startswith(route) for r in _cuda.ROUTES[name])


@pytest.mark.parametrize("n,iters", [(40, 9), (256, 24), (48, 9), (64, 16),
                                     (128, 24), (512, 24), (1024, 8)])
def test_label_prop_equals_plain(dev, n, iters):
    """One cluster launch a call up to 512^2, one launch a sweep above."""
    g = torch.Generator().manual_seed(n)
    mask = (torch.rand((n, n), generator=g) < 0.4).to(dev)
    lin = torch.arange(n * n, dtype=torch.int32, device=dev).reshape(n, n)
    seed = torch.where(mask, lin, -1).to(torch.int32)
    _cuda.reset_launches()
    got = F.label_prop(mask, seed, iters)
    _check_launches("label_prop", 2 * iters + 1, n)
    want = F._label_prop_plain(mask, seed, iters)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert torch.unique(want).numel() > 5


SWEEP_NS = [40, 48, 64, 128, 256, 512, 1024]


@pytest.mark.parametrize("off_mask", [False, True])
@pytest.mark.parametrize("n", SWEEP_NS)
def test_label_prop_serpentine_equals_plain(dev, n, off_mask):
    """A path through every slab boundary, longer than the 49 sweeps; with
    labels off the mask in the seed, which the first sweep reads."""
    m = KI.serpentine_mask(n, seed=n)
    mask = torch.as_tensor(m).to(dev)
    seed = torch.as_tensor(KI.label_seed(m, off_mask, seed=n)).to(dev)
    got = F.label_prop(mask, seed, 24)
    want = F._label_prop_plain(mask, seed, 24)
    torch.cuda.synchronize()
    assert torch.equal(got, want), int((got != want).sum())


@pytest.mark.parametrize("n_sweeps", [0, 1, 2, 49])
@pytest.mark.parametrize("n", [40, 42, 48, 256, 1024])
def test_label_sweeps_sweep_counts(dev, n, n_sweeps):
    """Odd and even sweep counts and zero sweeps (the seed as given), at
    widths 16 CTAs do not divide (CTAs without rows), at a width that is
    not a multiple of 4 (4-byte staging and pushes), and on the global
    route."""
    m = KI.serpentine_mask(n, seed=1)
    mask = torch.as_tensor(m).to(dev)
    seed = torch.as_tensor(KI.label_seed(m, True, seed=2)).to(dev)
    got, ran = F.label_sweeps(mask, seed, n_sweeps)
    want = seed
    for _ in range(n_sweeps):
        want = F._neighbor_max_sweep(want, mask)
    torch.cuda.synchronize()
    assert torch.equal(got, want), int((got != want).sum())
    if n <= 512:
        assert ran["route"] == "cluster16" and ran["launches"] == 1
        assert ran["clusters_at_once"] > 0
    else:
        assert ran["route"] == "global" and ran["launches"] == n_sweeps


@pytest.mark.parametrize("n,R,grids", [(48, 3, 1), (128, 8, 1), (256, 5, 1),
                                       (40, 1, 1), (64, 8, 1), (256, 8, 1),
                                       (512, 3, 1), (1024, 1, 14)])
def test_relax_level_equals_plain(dev, n, R, grids):
    """Fields up to 512^2 run every sweep of a level in one cluster launch
    a robot (one grid); 1024^2 ping-pongs global buffers, one grid a
    sweep."""
    g = torch.Generator().manual_seed(n)
    blocked = torch.rand((n, n), generator=g) < 0.2
    init = torch.full((R, n, n), CF._BIG)
    rc = torch.randint(0, n, (R, 2), generator=g)
    for i in range(R):
        blocked[rc[i, 0], rc[i, 1]] = False
        init[i, rc[i, 0], rc[i, 1]] = 0.0
    blocked, init = blocked.to(dev), init.to(dev)
    before = _cuda.LAUNCHES["costfield_relax"]
    got = CF.relax_level(blocked, init, 7)
    assert _cuda.LAUNCHES["costfield_relax"] == before + grids
    want = CF._relax_level_xla(blocked, init, 7)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    assert bool((want < CF._BIG).sum() > R)


@pytest.mark.parametrize("dense", [False, True])
@pytest.mark.parametrize("R", [1, 3, 8])
@pytest.mark.parametrize("n", SWEEP_NS)
def test_relax_level_maze_equals_plain(dev, n, R, dense):
    """A corridor through every slab boundary, longer than the sweeps;
    dense initial fields hold values at blocked cells, which the first
    sweep reads."""
    blocked = KI.corridor_maze(n, seed=n)
    init = torch.as_tensor(KI.maze_init(blocked, R, seed=R, dense=dense))
    blocked = torch.as_tensor(blocked).to(dev)
    init = init.to(dev)
    _cuda.reset_launches()
    got = CF.relax_level(blocked, init, 8)
    _check_launches("costfield_relax", 16, n)
    want = CF._relax_level_xla(blocked, init, 8)
    torch.cuda.synchronize()
    assert torch.equal(got, want), int((got != want).sum())


@pytest.mark.parametrize("n_sweeps", [0, 1, 16, 64])
@pytest.mark.parametrize("R,cluster", [(8, 16), (16, 8), (32, 4)])
@pytest.mark.parametrize("n", [40, 42, 48, 64, 128, 256, 512])
def test_relax_sweeps_cluster_sizes(dev, n, R, cluster, n_sweeps):
    """The launcher gives R fields about 128 CTAs: 16 a field up to 8
    fields, 8 at 16 and 4 at 32, doubled until a slab fits (at 512^2 only
    16 CTAs hold a field). Widths those sizes do not divide, a width that
    is not a multiple of 4, odd sweep counts and zero sweeps (the input)."""
    blocked = KI.corridor_maze(n, seed=3)
    init = torch.as_tensor(KI.maze_init(blocked, R, seed=4)).to(dev)
    blocked = torch.as_tensor(blocked).to(dev)
    got, ran = CF.relax_sweeps(blocked, init, n_sweeps)
    want = init
    for _ in range(n_sweeps):
        want = CF._relax_once(want, blocked)
    torch.cuda.synchronize()
    assert torch.equal(got, want), int((got != want).sum())
    want_route = f"cluster{16 if n == 512 else cluster}"
    assert ran["route"] == want_route and ran["launches"] == 1
    assert ran["clusters_at_once"] > 0


def test_cost_fields_equal_plain(dev):
    g = torch.Generator().manual_seed(5)
    blocked = (torch.rand((256, 256), generator=g) < 0.1).to(dev)
    rc = torch.randint(0, 256, (8, 2), generator=g).to(dev)
    got = CF.cost_fields(blocked, rc, 3, 8)
    want = CF.cost_fields(blocked, rc, 3, 8, relax=CF._relax_level_xla)
    assert torch.equal(got, want)


TENANTS = [1, 2, 3, 6]


@pytest.mark.parametrize("T", TENANTS)
@pytest.mark.parametrize("n", [256, 1024])
def test_label_sweeps_batched_equals_plain(dev, n, T):
    """T grids, each under its own mask (the tenant megabatch's), in one
    launch on the cluster route (one launch a sweep on the global route
    at 1024^2): every grid equals its own solo plain sweeps, with the
    linear-index seeds of each grid starting at 0."""
    masks = [KI.serpentine_mask(n, seed=n + t) for t in range(T)]
    mask = torch.as_tensor(np.stack(masks)).to(dev)
    seed = torch.as_tensor(np.stack([KI.label_seed(m, t % 2 == 1, seed=t)
                                     for t, m in enumerate(masks)])).to(dev)
    sweeps = 49 if n <= 512 else 9
    _cuda.reset_launches()
    got, ran = F.label_sweeps(mask, seed, sweeps)
    _check_launches("label_prop", sweeps, n)
    want = []
    for t in range(T):
        w = seed[t]
        for _ in range(sweeps):
            w = F._neighbor_max_sweep(w, mask[t])
        want.append(w)
    torch.cuda.synchronize()
    assert torch.equal(got, torch.stack(want))
    assert ran["launches"] == (1 if n <= 512 else sweeps)


@pytest.mark.parametrize("T", TENANTS)
@pytest.mark.parametrize("n", [256, 1024])
def test_relax_sweeps_batched_equals_plain(dev, n, T):
    """T tenants' R = 8 fields each under the tenant's own blocked mask,
    in one launch on the cluster route (one a sweep at 1024^2): every
    tenant's fields equal its solo plain sweeps."""
    R = 8
    mazes = [KI.corridor_maze(n, seed=n + t) for t in range(T)]
    blocked = torch.as_tensor(np.stack(mazes)).to(dev)
    init = torch.as_tensor(np.concatenate(
        [KI.maze_init(m, R, seed=t, dense=t % 2 == 1)
         for t, m in enumerate(mazes)])).to(dev)
    sweeps = 16 if n <= 512 else 4
    _cuda.reset_launches()
    got, ran = CF.relax_sweeps(blocked, init, sweeps)
    _check_launches("costfield_relax", sweeps, n)
    want = torch.cat([CF._relax_sweeps_plain(blocked[t],
                                             init[t * R:(t + 1) * R], sweeps)
                      for t in range(T)])
    torch.cuda.synchronize()
    assert torch.equal(got, want), int((got != want).sum())
    assert torch.equal(CF.sweeps(blocked, init, sweeps), want)


@pytest.mark.parametrize("T", TENANTS)
def test_cost_fields_batched_equal_plain(dev, T):
    """The fleet's three levels over T tenants' masks: three launches for
    all tenants, each tenant's fields its solo plain solve's."""
    g = torch.Generator().manual_seed(T)
    blocked = (torch.rand((T, 256, 256), generator=g) < 0.1).to(dev)
    rc = torch.randint(0, 256, (T, 8, 2), generator=g).to(dev)
    _cuda.reset_launches()
    got = CF.cost_fields(blocked, rc, 3, 8)
    assert _cuda.LAUNCHES["costfield_relax"] == 3
    want = torch.stack([CF.cost_fields(blocked[t], rc[t], 3, 8,
                                       relax=CF._relax_level_xla)
                        for t in range(T)])
    assert torch.equal(got, want)


@pytest.mark.parametrize("F_", [1, 8, 24])
@pytest.mark.parametrize("n", [256, 1024])
def test_relax_sweeps_mask_per_field_equals_plain(dev, n, F_):
    """F fields each under its own blocked mask (`exact_bfs`' one launch
    for every robot of every tenant), one launch on the cluster route
    (one a sweep at 1024^2): every field equals its plain sweeps under
    its own mask."""
    mazes = [KI.corridor_maze(n, seed=n + f) for f in range(F_)]
    blocked = torch.as_tensor(np.stack(mazes)).to(dev)
    init = torch.as_tensor(np.concatenate(
        [KI.maze_init(m, 1, seed=f, dense=f % 3 == 2)
         for f, m in enumerate(mazes)])).to(dev)
    sweeps = 257 if n <= 512 else 5
    _cuda.reset_launches()
    got, ran = CF.relax_sweeps(blocked, init, sweeps)
    _check_launches("costfield_relax", sweeps, n)
    want = torch.stack([CF._relax_sweeps_plain(blocked[f], init[f:f + 1],
                                               sweeps)[0]
                        for f in range(F_)])
    torch.cuda.synchronize()
    assert torch.equal(got, want), int((got != want).sum())
    assert torch.equal(CF.sweeps(blocked, init, sweeps), want)


@pytest.mark.parametrize("T", [1, 3])
def test_exact_bfs_one_launch_on_card(dev, T):
    """`exact_bfs` over T grids of the default config: one K3 launch for
    all T * 8 fields, costs and assignment equal to the per-robot plain
    fields (one `cost_to_go` a robot under its own seed's mask)."""
    cfg = SlamConfig()
    fc = dataclasses.replace(cfg.frontier, exact_bfs=True)
    # The rooms with 2 m doors: the 0.8 m cells seal 0.5 m ones (C.3).
    n = cfg.grid.size_cells
    world = torch.as_tensor(KI.rooms_wide_doors(n, cfg.grid.resolution_m))
    lo1 = torch.where(world, 3.0, -1.0)
    lo1[:, : n // 8] = 0.0
    lo = torch.stack([lo1.to(dev)] * T)
    g = torch.Generator().manual_seed(T)
    poses = ((torch.rand((T, 8, 3), generator=g) - 0.5)
             * torch.tensor([40.0, 40.0, 6.0])).to(dev)
    _cuda.reset_launches()
    fr = F.compute_frontiers(fc, cfg.grid, lo if T > 1 else lo[0],
                             poses if T > 1 else poses[0])
    relax = dict(_cuda.LAUNCHES)["costfield_relax"]
    assert relax == 1, relax
    free, _occ, unknown = F.coarsen(fc, cfg.grid, lo[0])
    mask = F.frontier_mask(free, unknown)
    passable, bres = F.bfs_passability(fc, cfg.grid, free, unknown, mask)
    bfs_cfg = dataclasses.replace(fc, bfs_iters=-(-fc.bfs_iters // 4))
    ox, oy = cfg.grid.origin_m
    costs = fr.costs if T > 1 else fr.costs[None]
    targets = fr.targets if T > 1 else fr.targets[None]
    sizes = fr.sizes if T > 1 else fr.sizes[None]
    for t in range(T):
        tr = ((targets[t, :, 1] - oy) / bres).clamp(0, 255).long()
        tc = ((targets[t, :, 0] - ox) / bres).clamp(0, 255).long()
        for r in range(8):
            rc = torch.stack([((poses[t, r, 1] - oy) / bres).int(),
                              ((poses[t, r, 0] - ox) / bres).int()])[None]
            d = F.cost_to_go(bfs_cfg, passable, rc,
                             torch.ones(1, dtype=torch.bool, device=dev),
                             relax=CF._relax_sweeps_plain)
            want = torch.where(sizes[t] > 0,
                               torch.clamp_max(d[tr, tc] * 4.0, 1e9), 1e9)
            live = sizes[t] > 0
            assert torch.equal(costs[t, r][live], want[live]), (t, r)
    assert bool((costs < 1e9).any())


def test_megabatch_on_card_equals_solo(dev):
    """Three tiny missions (bucket 3) and 2 + 1 pad (bucket 3) ticked as a
    megabatch on the card: every lane equals its solo `fleet_step` run on
    the card bit for bit, the pad lane stays frozen, and K2 launches once
    and K3 three times a tick for all lanes."""
    from jax_mapping_torch.tenancy import megabatch as MB
    cfg = tiny_config(2)
    res = cfg.grid.resolution_m
    worlds = [torch.as_tensor(W.plank_course(256, res, n_planks=8, seed=t),
                              device=dev) for t in range(3)]
    for n_active in (3, 2):
        gen = torch.Generator().manual_seed(n_active)
        states = [FL.init_fleet_state(cfg, device=dev, generator=gen)
                  for _ in range(n_active)]
        b0 = MB.make_tenant_batch(states, worlds[:n_active],
                                  list(range(n_active)), capacity=3)
        normals = [torch.randn((3, 2, 2), generator=gen) for _ in range(4)]
        b = b0
        _cuda.reset_launches()
        for nm in normals:
            b, _d, _h = MB.megabatch_tick(cfg, b, res, wheel_normals=nm)
        assert _cuda.LAUNCHES["label_prop"] == 4
        assert _cuda.LAUNCHES["costfield_relax"] == 12
        for t in range(n_active):
            st = states[t]
            for nm in normals:
                st, _ = FL.fleet_step(cfg, st, res, worlds[t],
                                      wheel_normals=nm[t])
            got = MB.lane_state(b, t)
            MB._tree_map(lambda x, y: _assert_equal(x, y), got, st)
        for t in range(n_active, 3):
            MB._tree_map(lambda x, y: _assert_equal(x, y),
                         MB.lane_state(b, t), MB.lane_state(b0, t))


def _assert_equal(x, y):
    assert torch.equal(x, y)


def test_wrappers_check_their_inputs(dev):
    cfg = tiny_config(2)
    r, p, o = (x.to(dev) for x in _scan_batch(cfg, 2, 0))
    with pytest.raises(ValueError):
        SK.scan_deltas(cfg.grid, cfg.scan, r.double(), p, o)
    with pytest.raises(ValueError):
        SK.scan_rasters(cfg.grid, cfg.scan, r, p, o.long())


def test_fleet_step_on_card_equals_cpu(dev):
    """One tiny-mission tick per state on the card and on the CPU, with the
    same wheel noise, agree (the card runs the kernels, the CPU the plain
    versions)."""
    cfg = tiny_config(2)
    res = cfg.grid.resolution_m
    w = torch.as_tensor(W.plank_course(256, res, n_planks=8, seed=0))
    gen = torch.Generator().manual_seed(3)
    st = FL.init_fleet_state(cfg, device="cpu", generator=gen)
    for _ in range(4):
        normals = torch.randn((2, 2), generator=gen)
        on_card = interop.fleet_state_from_numpy(
            interop.fleet_state_to_numpy(st), dev)
        gs, gd = FL.fleet_step(cfg, on_card, res, w.to(dev),
                               wheel_normals=normals)
        st, cd = FL.fleet_step(cfg, st, res, w, wheel_normals=normals)
        assert torch.equal(gd.is_key.cpu(), cd.is_key)
        # sin/cos of the simulated LiDAR and the matcher's convolution may
        # round differently on the two devices: a beam can move one sample
        # step and a match one fine step, so 1e-3 m / rad and at most 1e-3
        # of the cells.
        torch.testing.assert_close(gs.est_poses.cpu(), st.est_poses,
                                   rtol=0, atol=1e-3)
        assert (gs.grid.cpu() != st.grid).float().mean() <= 1e-3


def _window_batch(cfg, B, seed):
    """B scans on a small loop around a random centre: one shared patch."""
    g = torch.Generator().manual_seed(seed)
    s = cfg.scan
    half = cfg.grid.size_cells * cfg.grid.resolution_m / 4
    c = (torch.rand(2, generator=g) * 2 - 1) * half
    t = torch.linspace(0, 2 * math.pi, B + 1)[:B]
    rad = min(0.4, cfg.grid.resolution_m * 2)
    poses = torch.stack([c[0] + rad * torch.cos(t), c[1] + rad * torch.sin(t),
                         t + math.pi / 2], 1)
    ranges = 0.05 + torch.rand((B, s.padded_beams), generator=g) \
        * s.range_max_m
    ranges[torch.rand((B, s.padded_beams), generator=g) < 0.05] = 0.0
    ranges[:, s.n_beams:] = 0.0
    origin = G.patch_origin(cfg.grid, poses[:, :2].mean(dim=0))
    return ranges, poses, origin


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("B", [1, 16, 37])
def test_window_delta_equals_plain(dev, name, B):
    cfg = CONFIGS[name]()
    r, p, o = (x.to(dev).contiguous() for x in _window_batch(cfg, B, B))
    before = _cuda.LAUNCHES["window_delta"]
    got = SK.window_delta(cfg.grid, cfg.scan, r, p, o)
    assert _cuda.LAUNCHES["window_delta"] == before + 1
    want = SK.window_delta_plain(cfg.grid, cfg.scan, r, p, o)
    torch.cuda.synchronize()
    assert torch.equal(got, want), int((got != want).sum())
    assert bool((want != 0).any())


@pytest.mark.parametrize("name", list(CONFIGS))
@pytest.mark.parametrize("B", [0, 5, 40])
def test_window_apply_equals_plain(dev, name, B):
    cfg = CONFIGS[name]()
    r, p, o = (x.to(dev).contiguous() for x in _window_batch(cfg, B, B + 7))
    n = cfg.grid.size_cells
    g = torch.Generator().manual_seed(B)
    base = ((torch.rand((n, n), generator=g) * 8 - 4)
            * (torch.rand((n, n), generator=g) < 0.5)).to(dev)
    got, want = base.clone(), base.clone()
    before = _cuda.LAUNCHES["window_apply"]
    FK.window_apply(cfg.grid, cfg.scan, got, r, p, o)
    assert _cuda.LAUNCHES["window_apply"] == before + 1
    FK.window_apply_plain(cfg.grid, cfg.scan, want, r, p, o)
    torch.cuda.synchronize()
    assert torch.equal(got, want), int((got != want).sum())


def test_window_delta_subtotals_equal_plain(dev, monkeypatch):
    """Above the subtotal size, the kernel's subtotals add in order like
    the plain version's."""
    cfg = tiny_config(2)
    monkeypatch.setattr(SK, "_MAX_B_PER_CALL", 8)
    r, p, o = (x.to(dev).contiguous() for x in _window_batch(cfg, 21, 3))
    before = _cuda.LAUNCHES["window_delta"]
    got = SK.window_delta(cfg.grid, cfg.scan, r, p, o)
    assert _cuda.LAUNCHES["window_delta"] == before + 3
    want = SK.window_delta(cfg.grid, cfg.scan, r.cpu(), p.cpu(), o.cpu())
    assert torch.equal(got.cpu(), want)


def test_window_wrappers_check_their_inputs(dev):
    cfg = tiny_config(2)
    r, p, o = (x.to(dev) for x in _window_batch(cfg, 3, 0))
    with pytest.raises(ValueError):
        SK.window_delta(cfg.grid, cfg.scan, r, p, o.long())
    n = cfg.grid.size_cells
    with pytest.raises(ValueError):
        FK.window_apply(cfg.grid, cfg.scan, torch.zeros((n, n + 1),
                                                        device=dev), r, p, o)


def test_slam_steps_on_card_equal_cpu(dev):
    """Window and single steps of a tiny robot on the card and on the CPU
    from the same state and scans agree (the card runs K1, K4/K5, the CPU
    the plain versions); 1e-3 m / rad and at most 1e-3 of the cells, as
    the fleet check (the matcher's convolution rounds differently)."""
    cfg = tiny_config(2)
    res = cfg.grid.resolution_m
    w = torch.as_tensor(W.rooms_world(256, res))
    st = S.init_state(cfg, torch.tensor([1.4, 1.0, math.pi / 2]), "cpu")
    from jax_mapping_torch.ops.odometry import rk2_step, twist_to_wheel_units
    from jax_mapping_torch.sim import lidar
    wl, wr = twist_to_wheel_units(cfg.robot, 0.3, 0.75)
    truth = st.pose
    for t in range(6):
        n = 4 if t % 2 == 0 else 1
        tp = []
        for _ in range(n):
            truth = rk2_step(cfg.robot, truth, torch.tensor(wl),
                             torch.tensor(wr), torch.tensor(0.1))
            tp.append(truth)
        scans = lidar.simulate_scans(cfg.scan, w, res, 120, torch.stack(tp))
        wheels = torch.tensor([[wl, wr]] * n, dtype=torch.float32)
        on_card = interop.slam_state_from_numpy(
            interop.slam_state_to_numpy(st), dev)
        if n > 1:
            gs, gd = S.slam_step_window(cfg, on_card, scans.to(dev),
                                        wheels.to(dev), 0.1)
            st, cd = S.slam_step_window(cfg, st, scans, wheels, 0.1)
        else:
            gs, gd = S.slam_step(cfg, on_card, scans[0].to(dev), wl, wr, 0.1)
            st, cd = S.slam_step(cfg, st, scans[0], wl, wr, 0.1)
        assert bool(gd.key_added) == bool(cd.key_added)
        torch.testing.assert_close(gs.pose.cpu(), st.pose, rtol=0, atol=1e-3)
        assert (gs.grid.cpu() != st.grid).float().mean() <= 1e-3


# ---------------------------------------------------------------------------
# Voxel kernels K6 and K7
# ---------------------------------------------------------------------------

VOXEL_CONFIGS = {"tiny": lambda: tiny_config(2), "default": SlamConfig}


def _depth_batch(cfg, B, seed, spread):
    """B speckled depth images at poses within `spread` m of a random
    centre (one shared patch when spread is small)."""
    g = torch.Generator().manual_seed(seed)
    vox, cam = cfg.voxel, cfg.depthcam
    half = vox.size_x_cells * vox.resolution_m / 4
    c = (torch.rand(2, generator=g) * 2 - 1) * half
    poses = torch.stack([c[0] + (torch.rand(B, generator=g) * 2 - 1) * spread,
                         c[1] + (torch.rand(B, generator=g) * 2 - 1) * spread,
                         (torch.rand(B, generator=g) * 2 - 1) * math.pi], 1)
    depths = torch.rand((B, cam.height_px, cam.width_px), generator=g) \
        * cam.range_max_m * 1.2
    depths[torch.rand(depths.shape, generator=g) < 0.1] = 0.0
    return depths, poses, V.patch_origin(vox, poses[:, :2])


#: Batches around K7's 32-image launch and K6's per-image grid.
VOXEL_BATCHES = [1, 8, 31, 32, 33, 64]
#: "random", or a pose set at an edge of the kernels' (tile, image) cull
#: and z interval (tests/torch_kernel_inputs.py voxel_edge_case, 6 images).
VOXEL_CASES = ([f"random_b{B}" for B in VOXEL_BATCHES]
               + KI.VOXEL_EDGES)


def _voxel_case(cfg, case, seed, spread):
    if case.startswith("random_b"):
        return _depth_batch(cfg, int(case[len("random_b"):]), seed, spread)
    return KI.voxel_edge_case(cfg, case)


@pytest.mark.parametrize("name", list(VOXEL_CONFIGS))
@pytest.mark.parametrize("case", VOXEL_CASES)
def test_voxel_image_equals_plain(dev, name, case):
    cfg = VOXEL_CONFIGS[name]()
    d, p, o = (x.to(dev).contiguous()
               for x in _voxel_case(cfg, case, len(case), 2.0))
    before = _cuda.LAUNCHES["voxel_image"]
    got = VK.image_deltas(cfg.voxel, cfg.depthcam, d, p, o)
    assert _cuda.LAUNCHES["voxel_image"] == before + 1
    want = VK.image_deltas_plain(cfg.voxel, cfg.depthcam, d, VK.pose_table(p),
                                 o)
    torch.cuda.synchronize()
    assert torch.equal(got, want), int((got != want).sum())
    if case.startswith("random"):
        assert bool((want != 0).any())


@pytest.mark.parametrize("name", list(VOXEL_CONFIGS))
@pytest.mark.parametrize("case", VOXEL_CASES)
def test_voxel_window_equals_plain(dev, name, case):
    """K7 through window_delta, every image on the first one's patch;
    more than 32 images launch once per 32 and add the subtotals in
    order, as the plain path does."""
    cfg = VOXEL_CONFIGS[name]()
    d, p, o = (x.to(dev).contiguous()
               for x in _voxel_case(cfg, case, len(case), 0.1))
    B = d.shape[0]
    o = (V.patch_origin(cfg.voxel, p[:, :2].mean(dim=0))
         if case.startswith("random") else o[0])
    before = _cuda.LAUNCHES["voxel_summed"]
    got = VK.window_delta(cfg.voxel, cfg.depthcam, d, p, o)
    assert _cuda.LAUNCHES["voxel_summed"] == before + -(-B // 32)
    P = cfg.voxel.patch_cells
    table = VK.pose_table(p)
    origins = o.reshape(1, 2).expand(B, 2)
    want = torch.zeros_like(got)
    for i in range(0, B, 32):
        want = want + VK.summed_delta_plain(
            cfg.voxel, cfg.depthcam, d[i:i + 32], table[i:i + 32],
            origins[i:i + 32], P, P)
    torch.cuda.synchronize()
    assert torch.equal(got, want), int((got != want).sum())
    if case.startswith("random"):
        assert bool((want != 0).any())


@pytest.mark.parametrize("region", KI.VOXEL_REGIONS,
                         ids=["-".join(map(str, r))
                              for r in KI.VOXEL_REGIONS])
@pytest.mark.parametrize("case", ["random", *KI.VOXEL_EDGES])
def test_voxel_region_equals_plain(dev, region, case):
    """K7 over a region at rows y0, all images at cols 0 (region_delta's
    origins), from random poses (across the grid for a region of half the
    grid or more, else around the region) or the edge cases' poses."""
    name, y0, ny, nx = region
    cfg = VOXEL_CONFIGS[name]()
    vox = cfg.voxel
    if case == "random" and 2 * ny >= vox.size_y_cells:
        spread = vox.size_x_cells * vox.resolution_m / 5
        d, p, _ = _depth_batch(cfg, 8, 3, spread)
    elif case == "random":
        d, p = KI.cameras_around_region(cfg, y0, ny, nx, 8, 3)
    else:
        d, p, _ = KI.voxel_edge_case(cfg, case)
    d, p = d.to(dev).contiguous(), p.to(dev).contiguous()
    before = _cuda.LAUNCHES["voxel_summed"]
    got = VK.region_delta(vox, cfg.depthcam, d, p, y0, ny, nx)
    assert _cuda.LAUNCHES["voxel_summed"] == before + 1
    origins = torch.tensor([[y0, 0]] * d.shape[0], dtype=torch.int32,
                           device=dev)
    want = VK.summed_delta_plain(vox, cfg.depthcam, d, VK.pose_table(p),
                                 origins, ny, nx)
    torch.cuda.synchronize()
    assert torch.equal(got, want), int((got != want).sum())
    if case == "random":
        assert bool((want != 0).any())


def test_voxel_wrappers_check_their_inputs(dev):
    cfg = tiny_config(2)
    d, p, o = (x.to(dev) for x in _depth_batch(cfg, 2, 0, 1.0))
    with pytest.raises(ValueError):
        VK.image_deltas(cfg.voxel, cfg.depthcam, d.double(), p, o)
    with pytest.raises(ValueError):
        VK.image_deltas(cfg.voxel, cfg.depthcam, d, p, o.long())
    with pytest.raises(ValueError):
        VK.window_delta(cfg.voxel, cfg.depthcam, d[:, :, :-1].contiguous(),
                        p, o[0])


def test_voxel_drive_on_card_equals_cpu(dev):
    """Render and fuse a tiny two-robot drive on the card and on the CPU:
    renders agree to 1e-6 relative on >= 99% of the pixels (cos/sin and
    the sample arithmetic may round differently on the two devices), and
    the grids, fused from the same images, on all but 1e-4 of the
    voxels."""
    cfg = tiny_config(2)
    vox, cam = cfg.voxel, cfg.depthcam
    w = torch.as_tensor(W.rooms_world(128, vox.resolution_m, seed=1))
    n = D.n_samples_for(cam, vox.resolution_m)
    g_cpu = V.empty_voxel_grid(vox, device="cpu")
    g_dev = V.empty_voxel_grid(vox)
    assert g_dev.device.type == "cuda"
    before = _cuda.LAUNCHES["voxel_image"]
    for t in range(6):
        a = 0.15 * t
        poses = torch.tensor([[-1.6 + 0.5 * math.cos(a), -1.5 + 0.5 *
                               math.sin(a), a + math.pi / 2],
                              [1.7 - 0.5 * math.cos(a), 1.6 - 0.5 *
                               math.sin(a), a - math.pi / 2]])
        dc = D.render_depths(cam, w, vox.resolution_m, n, poses)
        dg = D.render_depths(cam, w.to(dev), vox.resolution_m, n,
                             poses.to(dev))
        close = (dg.cpu() - dc).abs() <= 1e-6 * dc.abs()
        assert close.float().mean() >= 0.99
        g_cpu = V.fuse_depths(vox, cam, g_cpu, dc, poses)
        g_dev = V.fuse_depths(vox, cam, g_dev, dc.to(dev), poses.to(dev))
    assert _cuda.LAUNCHES["voxel_image"] == before + 6
    assert (g_dev.cpu() != g_cpu).float().mean() <= 1e-4
    assert int((g_cpu > vox.occ_threshold).sum()) > 0


# ---------------------------------------------------------------------------
# K3 and K2 on the exploration-planning path: cost_to_go, the planner's
# field, the incremental publish
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed_blocked", [False, True])
@pytest.mark.parametrize("n,bfs_iters", [(256, 128), (64, 128), (48, 24),
                                         (1024, 16)])
def test_cost_to_go_equals_plain(dev, n, bfs_iters, seed_blocked):
    """K3 through `cost_to_go`: one field with the call's own blocked mask
    (its seed unblocked), 2 * bfs_iters + 1 sweeps (257 at the exact_bfs
    fleet's 256^2) along the maze's corridor; a seed inside a blocked cell
    radiates too."""
    blocked = KI.corridor_maze(n, seed=n)
    open_rc = torch.nonzero(torch.as_tensor(~blocked))
    r, c = (int(v) for v in open_rc[len(open_rc) // 3])
    if seed_blocked:
        c = c + 1 if blocked[r, c + 1] else c - 1    # the wall beside it
        assert blocked[r, c]
    passable = torch.as_tensor(~blocked).to(dev)
    cfg = dataclasses.replace(SlamConfig().frontier, bfs_iters=bfs_iters)
    rc = torch.tensor([[r, c]], dtype=torch.int32, device=dev)
    valid = torch.ones(1, dtype=torch.bool, device=dev)
    _cuda.reset_launches()
    got = F.cost_to_go(cfg, passable, rc, valid)
    _check_launches("costfield_relax", 2 * bfs_iters + 1, n)
    want = F.cost_to_go(cfg, passable, rc, valid,
                        relax=CF._relax_sweeps_plain)
    torch.cuda.synchronize()
    assert torch.equal(got, want), int((got != want).sum())
    assert float(got[r, c]) == 0.0
    assert int((got < CF._BIG).sum()) > 2 * bfs_iters


def _rooms_logodds(cfg, dev):
    """The default grid over rooms_world(seed=1): walls occupied, the rest
    free, a band along the west edge unknown."""
    n = cfg.grid.size_cells
    world = torch.as_tensor(W.rooms_world(n, cfg.grid.resolution_m, seed=1))
    lo = torch.where(world, 3.0, -1.0)
    lo[:, : n // 8] = 0.0
    return lo.to(dev)


def test_goal_field_global_route_equals_plain(dev):
    """The planner's field at the default config: the 4096^2 map coarsened
    to 1024^2, 2 * 512 + 1 = 1025 sweeps of K3 on the global route (one
    launch a sweep), equal to the plain sweeps on goal_field's own
    inputs; then a plan from behind the wall at x = -34.85 m (its door
    is at y = 2.15 m) reaches the goal through the door."""
    cfg = SlamConfig()
    lo = _rooms_logodds(cfg, dev)
    goal = torch.tensor([-29.0, -6.0], device=dev)
    _cuda.reset_launches()
    got = P.goal_field(cfg.planner, cfg.frontier, cfg.grid, lo, goal)
    assert _cuda.LAUNCHES["costfield_relax"] == 1025
    assert _cuda.ROUTES["costfield_relax"] == {"global": 1025}
    free, _occ, unknown = F.coarsen(cfg.frontier, cfg.grid, lo)
    passable = free | F.frontier_mask(free, unknown) | unknown
    n = passable.shape[0]
    res = cfg.grid.resolution_m * cfg.frontier.downsample
    goal_rc = P._world_to_cell(cfg.grid, res, goal, n)
    want = F.cost_to_go(
        dataclasses.replace(cfg.frontier, bfs_iters=cfg.planner.bfs_iters),
        passable, goal_rc[None], torch.ones(1, dtype=torch.bool, device=dev),
        relax=CF._relax_sweeps_plain)
    torch.cuda.synchronize()
    assert torch.equal(got, want), int((got != want).sum())
    plan = P.descend_field(cfg.planner, cfg.frontier, cfg.grid, got, goal,
                           torch.tensor([-40.0, -6.0], device=dev))
    assert bool(plan.reachable) and int(plan.n_steps) > 0
    path = plan.path_xy[plan.path_valid]
    assert float(path[:, 1].max()) > 2.0              # through the door
    assert float(torch.dist(path[-1], goal)) <= 0.3


def test_plan_on_card_equals_cpu(dev):
    """`plan_to_goal` on the walled tiny map (torch_kernel_inputs) on the
    card and on the CPU: every output equal."""
    cfg = tiny_config()
    lo, _sealed, pts = KI.walled_map(cfg)
    pcfg = dataclasses.replace(cfg.planner, bfs_iters=256)
    args = (pcfg, cfg.frontier, cfg.grid)
    want = P.plan_to_goal(*args, torch.as_tensor(lo),
                          torch.as_tensor(pts["goal"]),
                          torch.as_tensor(pts["start"]))
    got = P.plan_to_goal(*args, torch.as_tensor(lo).to(dev),
                         torch.as_tensor(pts["goal"]).to(dev),
                         torch.as_tensor(pts["start"]).to(dev))
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w)
    assert bool(want.reachable) and int(want.n_steps) > 0


@pytest.mark.parametrize("name", ["mg0", "exact0", "euclid0", "decay2"])
def test_incremental_publish_on_card_equals_cpu(dev, name):
    """The incremental publish of a seeded mission (torch_kernel_inputs)
    on the card and on the CPU: every publish and status counter equal,
    K2 and K3 on the card; sizes, targets and assignment equal the card's
    full recompute. Costs are exact min-plus fields (times the decay
    discount, one IEEE multiply on both devices), but Euclidean costs
    come from `torch.linalg.vector_norm`, whose CUDA and CPU reductions
    may round differently: 1e-6 relative there, as against JAX."""
    from jax_mapping_torch.ops.frontier_incremental import \
        IncrementalFrontierPipeline
    fcfg = KI.mission_frontier(**KI.MISSIONS[name][0])
    g = KI.mission_grid(512)
    card = IncrementalFrontierPipeline(fcfg, g, KI.MISSION_TILE, device=dev)
    cpu = IncrementalFrontierPipeline(fcfg, g, KI.MISSION_TILE, device="cpu")
    _cuda.reset_launches()
    for lo, poses, tile_rev, rev in KI.mission_steps(name):
        a = card.compute(lo, poses, tile_rev, rev)
        b = cpu.compute(lo, poses, tile_rev, rev)
        for f in ("targets", "sizes", "assignment", "crop_rc",
                  "recomputed"):
            assert np.array_equal(getattr(a, f), getattr(b, f)), f
        if name.startswith("euclid"):
            np.testing.assert_allclose(a.costs, b.costs, rtol=1e-6, atol=0)
        else:
            assert np.array_equal(a.costs, b.costs)
        full = F.compute_frontiers(fcfg, g, torch.as_tensor(lo).to(dev),
                                   torch.as_tensor(poses).to(dev))
        for f in ("targets", "sizes", "assignment"):
            assert np.array_equal(getattr(a, f), getattr(full, f).cpu()), f
    sa, sb = card.status(), cpu.status()
    sa.pop("last_recompute_ms"), sb.pop("last_recompute_ms")
    assert sa == sb
    assert _cuda.LAUNCHES["label_prop"] > 0
    if name != "euclid0":
        assert _cuda.LAUNCHES["costfield_relax"] > 0


# ---------------------------------------------------------------------------
# The recovery path: relocalization, the bucketed and touched fuses, the
# rendezvous merge (K1 on their batches)
# ---------------------------------------------------------------------------

def _near(a, b, m):
    d = np.abs(np.asarray(a) - np.asarray(b))
    return (d[:2].max() <= m.fine_step_m + 1e-5
            and d[2] <= m.fine_angle_step_rad + 1e-5)


@pytest.mark.parametrize("pruned", [True, False])
def test_relocalization_on_card_equals_cpu(dev, pruned):
    """Attempts on the card (K1 rasters) and on the CPU (plain) from the
    same numpy scan and guess: the same streak and cache counters, poses
    within the matcher's tolerance (its convolution rounds differently on
    the two devices). With the default device set to `meta`, the card's
    attempt still runs: it builds every tensor on the grid's device."""
    from jax_mapping_torch import recovery as RC
    cfg = tiny_config(2)
    cfg = cfg.replace(matcher=dataclasses.replace(cfg.matcher,
                                                  pruned=pruned))
    grid, ranges, guess = KI.reloc_inputs(cfg)
    card, cpu = (RC.Relocalizer(cfg.recovery, 1) for _ in range(2))
    grid_d = grid.to(dev)
    _cuda.reset_launches()
    verified = 0
    for k in range(4):
        kw = dict(region_rev_fn=lambda *a: 3)
        if k == 3:
            with torch.device("meta"):
                a = card.attempt_for(0, cfg, grid_d, ranges.numpy(),
                                     guess.numpy(), **kw)
        else:
            a = card.attempt_for(0, cfg, grid_d, ranges.numpy(),
                                 guess.numpy(), **kw)
        b = cpu.attempt_for(0, cfg, grid, ranges.numpy(), guess.numpy(),
                            **kw)
        assert (a is None) == (b is None)
        if a is not None:
            verified += 1
            assert _near(a, b, cfg.matcher)
    assert verified == 2
    assert card.snapshot() == cpu.snapshot()
    assert _cuda.LAUNCHES["sensor_model_raster"] > 0
    res = RC.relocalize_match(cfg, grid_d, ranges.to(dev), guess.to(dev))
    want = RC.relocalize_match(cfg, grid, ranges, guess)
    assert bool(res.accepted[0]) == bool(want.accepted[0])
    assert _near(res.pose[0].cpu(), want.pose[0], cfg.matcher)


@pytest.mark.parametrize("B", [0, 1, 5, 37, 100])
@pytest.mark.parametrize("name", ["tiny", "default"])
def test_fuse_scans_bucketed_on_card_equals_cpu(dev, name, B):
    cfg = CONFIGS[name]()
    r, p, _ = _scan_batch(cfg, B, seed=B + 3)
    m = torch.rand(B, generator=torch.Generator().manual_seed(B)) < 0.7
    g0 = torch.zeros((cfg.grid.size_cells,) * 2)
    g0[::7, ::5] = 1.5
    for mask in (None, m):
        want = G.fuse_scans_bucketed(cfg.grid, cfg.scan, g0, r, p, mask)
        got = G.fuse_scans_bucketed(
            cfg.grid, cfg.scan, g0.to(dev), r.to(dev), p.to(dev),
            None if mask is None else mask.to(dev))
        assert torch.equal(got.cpu(), want)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("name", ["tiny", "default"])
def test_fuse_scans_touched_on_card_equals_cpu(dev, name, masked):
    cfg = CONFIGS[name]()
    tile = 16 if name == "tiny" else 256
    r, p, _ = _scan_batch(cfg, 24, seed=5)
    m = (torch.rand(24, generator=torch.Generator().manual_seed(1)) < 0.5
         if masked else None)
    g0 = torch.zeros((cfg.grid.size_cells,) * 2)
    want, wt = FK.fuse_scans_touched(cfg.grid, cfg.scan, tile, g0, r, p, m)
    got, gt = FK.fuse_scans_touched(cfg.grid, cfg.scan, tile, g0.to(dev),
                                    r.to(dev), p.to(dev),
                                    None if m is None else m.to(dev))
    assert torch.equal(got.cpu(), want)
    assert torch.equal(gt.cpu(), wt) and gt.any()


def test_rendezvous_merge_on_card_equals_cpu(dev):
    """merge_fleets on the card (K1 deltas) and on the CPU: without an
    anchor the grids are equal; with one, graph poses agree to the
    Gauss-Newton tolerance (1e-3: the Cholesky solves round differently)
    and at most 1e-3 of the cells differ."""
    from jax_mapping_torch.scenarios import rendezvous as RV
    cfg = tiny_config(2)
    T = np.array([0.9, -0.7, 0.6], np.float32)
    a_cpu, b_cpu = KI.tiny_fleets(cfg, T)
    a_dev, b_dev = KI.tiny_fleets(cfg, T, dev)
    _cuda.reset_launches()
    g1, _ = RV.merge_fleets(cfg, a_dev, b_dev, T)
    g0, _ = RV.merge_fleets(cfg, a_cpu, b_cpu, T)
    assert torch.equal(g1.cpu(), g0)
    assert _cuda.LAUNCHES["sensor_model_delta"] > 0
    anchor = (1, a_cpu[1].graph.poses[5].numpy() + np.float32(0.02))
    g1, m1 = RV.merge_fleets(cfg, a_dev, b_dev, T, anchor=anchor)
    g0, m0 = RV.merge_fleets(cfg, a_cpu, b_cpu, T, anchor=anchor)
    for x, y in zip(m1, m0):
        torch.testing.assert_close(x.graph.poses.cpu(), y.graph.poses,
                                   rtol=0, atol=1e-3)
    assert (g1.cpu() != g0).float().mean() <= 1e-3


def _stack_cfg():
    t = tiny_config(2)
    return t.replace(robot=dataclasses.replace(t.robot, speed_noise_frac=0.0))


def _stack_run(device, steps: int):
    from jax_mapping_torch.bridge.launch import launch_sim_stack
    cfg = _stack_cfg()
    world = W.plank_course(96, cfg.grid.resolution_m, n_planks=4, seed=3)
    st = launch_sim_stack(cfg, world, n_robots=2, seed=0, device=device)
    fronts = []
    st.bus.subscribe("/frontiers",
                     callback=lambda f: fronts.append(
                         np.asarray(f.assignment)))
    st.brain.start_exploring()
    truth, est = [], []
    for _ in range(steps):
        st.run_steps(1)
        truth.append(st.sim.truth_poses())
        est.append(st.mapper._read_poses())
    return st, np.stack(truth), np.stack(est), np.stack(fronts)


def test_stack_on_card_equals_cpu(dev):
    """The mission stack at tiny_config(2) (no wheel noise), the same seed
    on the card and on the CPU for 30 steps: the truth to 1e-6 m, the
    mapper's estimates to 1e-4 m, every frontier assignment equal, the
    grids equal but for 1e-4 of the cells (sensor-model boundaries)."""
    a, ta, ea, fa = _stack_run(dev, 30)
    b, tb, eb, fb = _stack_run("cpu", 30)
    assert a.mapper.shared_grid.is_cuda and a.sim.world.is_cuda
    assert np.abs(ta - tb).max() <= 1e-6
    assert np.abs(ea - eb).max() <= 1e-4
    np.testing.assert_array_equal(fa, fb)
    assert (fb >= 0).any()
    ga, gb = a.mapper.shared_grid.cpu(), b.mapper.shared_grid
    assert int((ga != gb).sum()) <= 1e-4 * gb.numel()


def test_stack_burst_launches_window_kernel(dev):
    """Scans queued while the mapper stalls fuse as one window: K5."""
    st, *_ = _stack_run(dev, 5)
    W_ = max(2, st.cfg.fleet.batch_scans)
    n_win = st.mapper.n_windows_fused
    _cuda.reset_launches()
    for _ in range(W_):
        st.sim.step()
        st.brain.update_loop()
    st.mapper.tick()
    assert st.mapper.n_windows_fused - n_win == 2     # one a robot
    assert _cuda.LAUNCHES["window_apply"] >= 2


# ---------------------------------------------------------------------------
# The multi-rank mesh at 1 x 1 (one NCCL rank beside a CPU mesh)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", ["tiny", "trajectory"])
def test_sharded_step_on_card_equals_cpu(dev, name):
    """make_fleet_step on a 1 x 1 card mesh and a 1 x 1 CPU mesh from one
    state with the same wheel normals (tests/torch_sharded_drive.py):
    truth to 1e-6 m, estimates to 1e-4 m, assignments and loop counts
    equal, at most 1e-4 of the cells apart; K1 (both modes), K2 and K3
    launched on the card."""
    o = SD.step_card_and_cpu(name)
    assert SD.step_failures(name, o) == [], o
    for k in ("sensor_model_delta", "sensor_model_raster", "label_prop",
              "costfield_relax"):
        assert o["launches"][k] > 0, k


def test_sharded_voxel_fuse_on_card_equals_cpu(dev):
    """make_voxel_fuse_step on 1 x 1 meshes: the card's region route (K7)
    against the CPU's plain one, at most 1e-4 of the voxels apart."""
    v = SD.voxel_fuse_card_and_cpu()
    assert SD.voxel_failures(v) == [], v


# ---------------------------------------------------------------------------
# Serving: the tile store's device work and the HTTP API on the card
# ---------------------------------------------------------------------------

def _serving_arrays(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    f = rng.normal(0.0, 2.0, (512, 512)).astype(np.float32)
    f[0, :4] = [-0.0, 1e-45, np.inf, np.nan]
    return {"u8": rng.integers(0, 256, (512, 512)).astype(np.uint8),
            "f32": f,
            "i8": rng.choice(np.array([-1, 0, 100], np.int8), (256, 768))}


@pytest.mark.parametrize("name", ["u8", "f32", "i8"])
@pytest.mark.parametrize("t", [64, 256])
def test_tile_hashes_on_card_equal_cpu(dev, name, t):
    arr = torch.as_tensor(_serving_arrays(0)[name])
    got = G.tile_hashes(arr.to(dev), t)
    assert got.is_cuda
    assert torch.equal(got.cpu(), G.tile_hashes(arr, t))


def test_gray_pyramid_on_card_equals_cpu(dev):
    """`to_gray` of a seeded log-odds grid (with cells at the thresholds)
    and two `downsample_gray` levels, card against CPU, bit for bit."""
    cfg = SlamConfig()
    rng = np.random.default_rng(1)
    lo = rng.uniform(-3.0, 3.0, (1024, 1024)).astype(np.float32)
    lo[0, :2] = [cfg.grid.occ_threshold, cfg.grid.free_threshold]
    a = G.to_gray(cfg.grid, torch.as_tensor(lo).to(dev))
    b = G.to_gray(cfg.grid, torch.as_tensor(lo))
    assert a.is_cuda and a.dtype == torch.uint8
    for _ in range(3):
        assert torch.equal(a.cpu(), b)
        a, b = G.downsample_gray(a), G.downsample_gray(b)


def _store_manifests(device, hashed_on: list) -> str:
    """A TileStore over a seeded sequence of log-odds grids on `device`
    (the mapper's snapshot: `to_gray` of the grid): JSON of the full
    snapshot, the delta and the stats after each refresh. Records the
    device of every array `tile_hashes` is given."""
    import json
    from jax_mapping_torch.config import ServingConfig
    from jax_mapping_torch.serving.tiles import TileStore
    g = tiny_config().grid
    rng = np.random.default_rng(2)
    lo = np.zeros((g.size_cells,) * 2, np.float32)
    cur = {"rev": 0, "grid": torch.as_tensor(lo, device=device)}
    store = TileStore(ServingConfig(tile_cells=64, pyramid_levels=3),
                      "grid", lambda: cur["rev"],
                      lambda: (cur["rev"], G.to_gray(g, cur["grid"]), None))
    orig = G.tile_hashes

    def recording(arr, t):
        hashed_on.append(arr.device.type)
        return orig(arr, t)
    G.tile_hashes = recording
    out, prev = [], -1
    try:
        for k in range(6):
            r0, c0 = rng.integers(0, g.size_cells - 40, 2)
            lo = lo.copy()
            lo[r0:r0 + 40, c0:c0 + 40] = rng.uniform(-2, 2, (40, 40))
            cur.update(rev=k + 1, grid=torch.as_tensor(lo, device=device))
            store.refresh()
            full = store.tiles_since(-1)
            out.append([full, store.tiles_since(prev), store.stats()])
            prev = full[0]
    finally:
        G.tile_hashes = orig
    return json.dumps(out, sort_keys=True)


def test_tile_store_on_card_equals_cpu(dev):
    """The same grids through the store on the card and on the CPU give
    byte-equal manifests; on the card every hash is computed there."""
    on_card, on_cpu = [], []
    assert _store_manifests(dev, on_card) == _store_manifests("cpu", on_cpu)
    assert on_card and set(on_card) == {"cuda"}


def test_stack_http_routes_on_card(dev, tmp_path):
    """A tiny depth-camera stack on the card with `http_port=0` answers
    every route: delta clients rebuild the live map and the height map
    bit for bit (hashed on the card), /save then /load restores the grid,
    /save-map writes the thresholded grid, /goal reaches the brain."""
    import json
    import urllib.error
    import urllib.request
    from jax_mapping_torch.bridge.launch import launch_sim_stack
    from jax_mapping_torch.serving.client import DeltaMapClient
    cfg = tiny_config(2)
    world = W.plank_course(96, cfg.grid.resolution_m, n_planks=4, seed=3)
    st = launch_sim_stack(cfg, world, n_robots=2, seed=0, http_port=0,
                          depth_cam=True, device=dev)
    hashed_on, orig = [], G.tile_hashes

    def recording(arr, t):
        hashed_on.append(arr.device.type)
        return orig(arr, t)
    G.tile_hashes = recording
    base = f"http://127.0.0.1:{st.api.port}"

    def get(route):
        with urllib.request.urlopen(base + route, timeout=30) as r:
            return r.status, r.read()

    def post(route):
        req = urllib.request.Request(base + route, method="POST")
        with urllib.request.urlopen(req, timeout=30) as r:
            return r.status, json.loads(r.read())
    try:
        st.api.checkpoint_dir = str(tmp_path)
        st.brain.start_exploring()
        st.run_steps(10)
        st.mapper.publish_map()
        grid_c, vox_c = DeltaMapClient(base), \
            DeltaMapClient(base, route="/voxel-tiles")
        grid_c.poll()
        vox_c.poll()
        st.run_steps(5)
        grid_c.poll()
        vox_c.poll()
        assert np.array_equal(
            grid_c.image(0),
            G.to_gray(cfg.grid, st.mapper.merged_grid()).cpu().numpy())
        assert np.array_equal(vox_c.image(0),
                              st.voxel_mapper.serving_snapshot()[1])
        assert hashed_on and set(hashed_on) == {"cuda"}
        for route in ("/status", "/map-image", "/frontiers", "/metrics",
                      "/voxel-image", "/map-events?mode=poll&since=-1",
                      "/map-events?timeout_s=0.5"):
            code, body = get(route)
            assert code == 200 and body, route
        with pytest.raises(urllib.error.HTTPError) as ei:
            get("/trace")
        assert ei.value.code == 404
        grid_before = st.mapper.merged_grid().clone()
        assert post("/save")[1]["status"] == "saved"
        st.run_steps(3)
        assert post("/load")[1]["status"] == "loaded"
        assert torch.equal(st.mapper.merged_grid(), grid_before)
        body = post("/save-map?name=m")[1]
        from jax_mapping_torch.io import rosmap
        occ, _res, _origin = rosmap.load_map(body["yaml"])
        lo = st.mapper.merged_grid().cpu().numpy()
        want = np.full(lo.shape, -1, np.int8)
        want[lo <= cfg.grid.free_threshold] = 0
        want[lo >= cfg.grid.occ_threshold] = 100
        assert np.array_equal(occ, want)
        assert post("/goal?x=0.5&y=0.25&robot=1")[1]["robot"] == 1
        assert st.brain.status()["goals"][1] == {"x": 0.5, "y": 0.25}
        assert post("/goal/cancel?robot=1")[1]["status"] == \
            "goal cancelled"
        assert get("/stop")[0] == 200 and not st.brain.is_exploring
        assert get("/start")[0] == 200 and st.brain.is_exploring
    finally:
        G.tile_hashes = orig
        st.shutdown()



def test_sim_world_uploads_on_card(dev):
    """A scripted door and crowd through the sim on the card: after every
    step the card's world equals the host composition bit for bit, a quiet
    step uploads nothing, and an upload makes no host sync (the sync debug
    mode raises on one); both pinned staging buffers were used."""
    from jax_mapping_torch.bridge.bus import Bus
    from jax_mapping_torch.bridge.driver import SimulatedThymioDriver
    from jax_mapping_torch.bridge.sim_node import SimNode
    from jax_mapping_torch.scenarios import WorldDynamics
    cfg = tiny_config()
    world, doors = W.arena_with_door(96, 0.05)
    sim = SimNode(cfg, Bus(), SimulatedThymioDriver(n_robots=2), world,
                  0.05, realtime=False, device=dev)
    sim.attach_world_dynamics(WorldDynamics(world, 0.05, doors=doors,
                                            seed=1))
    shadow = WorldDynamics(world, 0.05, doors=doors, seed=1)
    upload = sim._upload_world

    def strict(w):
        torch.cuda.set_sync_debug_mode("error")
        try:
            upload(w)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sim._upload_world = strict
    script = {2: ("door", ("door0", True)), 5: ("crowd", (0, 0.25)),
              9: ("crowd", (0, None)), 12: ("door", ("door0", False))}
    uploads = []
    for step in range(16):
        if step in script:
            kind, args = script[step]
            getattr(sim, f"set_{kind}")(*args)
            getattr(shadow, f"set_{kind}")(*args)
        n0 = sim.n_world_updates
        sim.step()
        uploads.append(sim.n_world_updates - n0)
        assert sim.world.is_cuda
        np.testing.assert_array_equal(sim.world.cpu().numpy(),
                                      shadow.world_at(step))
    assert uploads == [1, 0, 1, 0, 0, 1, 1, 1, 1, 1, 0, 0, 1, 0, 0, 0]
    assert all(e is not None and e.query() for e in sim._staged)


def _sim_clock_run(cfg, dev, steps, seed):
    """tiny stack on the card with stamps from a simulated clock (one
    control period a step): (grid, estimates, truth, devprof snapshot)."""
    import types
    from jax_mapping_torch.bridge import brain as _brain
    from jax_mapping_torch.bridge import sim_node as _sim_node
    from jax_mapping_torch.bridge.launch import launch_sim_stack
    world, _doors = W.rooms_with_doors(96, cfg.grid.resolution_m, seed=1)
    st = launch_sim_stack(cfg, world, n_robots=2, seed=seed, device=dev)
    clock = [1000.0]
    saved = [(m, m.time) for m in (_brain, _sim_node)]
    for m, _ in saved:
        m.time = types.SimpleNamespace(monotonic=lambda: clock[0])
    step = st.sim.step

    def stepped():
        clock[0] += 1.0 / cfg.robot.control_rate_hz
        step()
    st.sim.step = stepped
    try:
        st.brain.start_exploring()
        st.run_steps(steps)
        torch.cuda.synchronize()
        return (st.mapper.shared_grid.cpu(),
                torch.stack([s.pose for s in st.mapper.states]).cpu(),
                st.sim.truth_poses().copy(),
                None if st.devprof is None else st.devprof.snapshot())
    finally:
        for m, t in saved:
            m.time = t
        st.shutdown()


def test_devprof_is_bit_inert_on_card(dev):
    """tiny_config(2), 40 steps on the card: the dispatch profiler armed
    gives bit-equal grids, estimates and truth to the stack without it,
    and attributes the mission's K1-K3 entry points."""
    from jax_mapping_torch.config import DevProfConfig
    cfg = tiny_config(2)
    off = _sim_clock_run(cfg, dev, 40, 0)
    on = _sim_clock_run(cfg.replace(obs=dataclasses.replace(
        cfg.obs, devprof=DevProfConfig(enabled=True))), dev, 40, 0)
    assert torch.equal(off[0], on[0]) and torch.equal(off[1], on[1])
    np.testing.assert_array_equal(off[2], on[2])
    assert off[3] is None
    assert on[3]["jax_mapping_torch.models.slam.slam_step"]["count"] > 0


def test_cost_ledger_counts_kernels_on_card(dev):
    """On the card the ledger sees K1 through its wrapper's arithmetic
    (the mode cannot see a ctypes launch): the entry's kernel bytes and
    operations equal `sensor_model_cost` on the same zeros."""
    from jax_mapping_torch.config import DevProfConfig
    from jax_mapping_torch.obs import CostLedger, DispatchProfiler
    from jax_mapping_torch.obs import ledger as L
    cfg = tiny_config()
    prof = DispatchProfiler(DevProfConfig(enabled=True))
    prof.install()
    try:
        ranges, poses, origins = (t.to(dev) for t in _scan_batch(cfg, 5, 1))
        SK.scan_deltas(cfg.grid, cfg.scan, ranges, poses, origins)
        name = "jax_mapping_torch.ops.sensor_kernel.scan_deltas"
        (entry,) = CostLedger(prof).collect()[name]
    finally:
        prof.uninstall()
    k = entry["kernels"]["sensor_model_delta"]
    z = torch.zeros_like
    want = L.sensor_model_cost(cfg.grid, cfg.scan, z(ranges), z(poses),
                               z(origins))
    assert k["launches"] == 1
    assert (k["bytes"], k["flops"]) == (float(want[0]), float(want[1]))
    assert entry["flops"] >= k["flops"]


def test_warmup_prewarms_kernel_signatures_on_card(dev, tmp_path):
    """A signature this process never dispatched pre-warms on zeros on
    the card: its kernels launch (counted in the report, apart from the
    mission's), its libraries are loaded, and a second warm-up finds it
    `in_process`."""
    from jax_mapping_torch.obs import devprof as DP
    from jax_mapping_torch.resilience.warmup import StagedWarmup
    cfg = tiny_config()
    name = "jax_mapping_torch.ops.sensor_kernel.scan_rasters"
    ranges, poses, origins = (t.to(dev) for t in _scan_batch(cfg, 7, 2))
    sig = DP.abstract_signature(
        (cfg.grid, cfg.scan, ranges, poses, origins), {},
        ("grid_cfg", "scan_cfg", "ranges_b", "poses_b", "origins_rc"),
        ("grid_cfg", "scan_cfg"))
    seen = DP._SEEN
    DP._SEEN = {}
    try:
        rep = StagedWarmup(device=dev).prewarm({name: [sig]})
        assert rep["n_prewarmed"] == 1 and rep["n_errors"] == 0
        assert rep["launches"] == {"sensor_model_raster": 1}
        assert _cuda.loaded("sensor_model")
        rep2 = StagedWarmup(device=dev).prewarm({name: [sig]})
        assert rep2["n_in_process"] == 1 and rep2["launches"] == {}
    finally:
        DP._SEEN = seen
