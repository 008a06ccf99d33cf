"""Kernel K8 (`ops/match_kernel.py`, `csrc/match_correlate.cu`): the
matcher's raster-window correlations.

On the CPU: the plain versions (the grouped `conv1d` and the gathers under
an einsum) against a float64 evaluation of the same sums with the edge
clamps written out; `kernel_order`, a PyTorch replay of K8's summation
order, against the same; the dispatch to the plain versions; the
matcher's call sites routed through the kernel's wrappers; the ctypes
signatures against the C source; the cost arithmetic.

On the card (marker `cuda`, skipped here; `python -m pytest
tests/test_torch_match_kernel.py -q` there): K8 against float64 within
1e-6 relative at every call site's shapes; K8 equal to `kernel_order` bit
for bit, which skips no zero tile and no zero cell, so the kernel's
skipping changes no bit; rows scored in 96-, 8- and 1-row launches bit
equal; a candidate's score equal to the dense score at the same start;
and a 12-tenant `match_batch` equal lane by lane to each lane's solo call,
with the same K8 launches.
"""

import math
import re

import pytest
import torch

from jax_mapping_torch.config import SlamConfig, tiny_config
from jax_mapping_torch.obs import ledger
from jax_mapping_torch.ops import _cuda
from jax_mapping_torch.ops import grid as G
from jax_mapping_torch.ops import match_kernel as MK
from jax_mapping_torch.ops import scan_match as M
from jax_mapping_torch.sim import lidar
from jax_mapping_torch.sim import world as W
from torch_kernel_inputs import dense_starts, direct64, k8_windows, \
    list_starts


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


# -- inputs ------------------------------------------------------------------

def band_rasters(R, A, P, seed, device="cpu"):
    """(R, A, P, P) rasters shaped like K1's: a ring of 360 hits at a
    smoothly varying range, each a cell and its right and lower
    neighbours with values in (0, 1]; most 32 x 32 tiles stay zero."""
    g = torch.Generator().manual_seed(seed)
    n = R * A
    th = torch.arange(360) * (2 * math.pi / 360)
    phase = torch.rand((n, 1), generator=g) * 2 * math.pi
    rad = P * (0.25 + 0.15 * torch.sin(3 * th + phase)
               + 0.05 * torch.rand((n, 360), generator=g))
    c = P / 2 + (torch.rand((n, 2), generator=g) - 0.5) * P * 0.1
    y = (c[:, :1] + rad * torch.sin(th)).long().clamp(0, P - 2)
    x = (c[:, 1:] + rad * torch.cos(th)).long().clamp(0, P - 2)
    out = torch.zeros((n, P, P))
    idx = torch.arange(n)[:, None]
    for dy, dx in ((0, 0), (0, 1), (1, 0)):
        out[idx, y + dy, x + dx] = torch.rand((n, 360), generator=g) + 0.01
    return out.reshape(R, A, P, P).to(device)


def block_sum(rasters, q):
    """q x q block sums, the matcher's coarser levels' rasters."""
    R, A, P, _ = rasters.shape
    return rasters.reshape(R, A, P // q, q, P // q, q).sum(dim=(3, 5))


def rand_field(R, H, W_, seed, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return torch.rand((R, H, W_), generator=g).to(device)


def rand_mass(R, seed, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return (torch.rand((R,), generator=g) * 500 + 50).to(device)


def _butterfly(x):
    for h in (16, 8, 4, 2, 1):
        x = x[..., :h] + x[..., h:2 * h]
    return x[..., 0]


def kernel_order(field, rasters, r, a, y0, x0, mass, chunk=64):
    """K8's sums replayed one float32 rounding an operation: a 32 x 32
    tile's column summed down its rows (from +0), the columns added in
    the warp's butterfly, then lane l adding tiles l, l + 32, ... in turn
    (from +0) and the butterfly, then one division. Starts already
    clamped. Skips nothing: a zero product adds +0."""
    T = MK.TILE
    P = rasters.shape[-1]
    n = -(-P // T)
    out = []
    for s in range(0, r.numel(), chunk):
        sl = slice(s, s + chunk)
        ra, fw = k8_windows(field, rasters, r[sl], a[sl], y0[sl], x0[sl])
        c = ra.shape[0]
        pad = (0, n * T - P, 0, n * T - P)
        ra, fw = (torch.nn.functional.pad(x, pad).reshape(c, n, T, n, T)
                  .permute(0, 1, 3, 2, 4) for x in (ra, fw))
        acc = torch.zeros((c, n, n, T), device=field.device)
        for i in range(T):
            acc = acc + ra[..., i, :] * fw[..., i, :]
        part = _butterfly(acc).reshape(c, n * n)
        rounds = -(-n * n // 32)
        part = torch.nn.functional.pad(part, (0, rounds * 32 - n * n))
        v = torch.zeros((c, 32), device=field.device)
        for k in range(rounds):
            v = v + part[:, k * 32:(k + 1) * 32]
        out.append(_butterfly(v) / mass[r[sl]])
    return torch.cat(out)


def assert_rel(got, want, tol):
    """Every element within `tol` of the float64 value, relative to it
    (the sums have no cancellation: every term is >= 0)."""
    got, want = got.double().reshape(-1), want.reshape(-1)
    err = (got - want).abs() / want.abs().clamp_min(1e-30)
    err = torch.where(want == 0, (got != 0).double(), err)
    assert float(err.max()) <= tol, float(err.max())


# -- the plain versions and the order replay, on the CPU ---------------------

DENSE_CASES = {
    # P, field side, n_out, stride: a fine stage, a top bound (L = n_out
    # + 1), a level-1 surface, strided, and rows clamped at the edge.
    "fine": (40, 42, 3, 1),
    "top": (10, 13, 3, 1),
    "surface": (20, 30, 11, 1),
    "strided": (24, 34, 6, 2),
    "clamped": (16, 21, 5, 2),
}


@pytest.mark.parametrize("case", list(DENSE_CASES))
def test_plain_dense_equals_float64_with_clamps(case):
    P, H, n_out, stride = DENSE_CASES[case]
    R, A = 3, 4
    ras, fld, mass = (band_rasters(R, A, P, 1), rand_field(R, H, H, 2),
                      rand_mass(R, 3))
    got = MK.window_scores_plain(fld, ras, mass, n_out, stride)
    (r, a, y0, x0), L = dense_starts(R, A, H, H, P, n_out, stride, "cpu")
    assert got.shape == (R, A, n_out, L) == (R, A, n_out,
                                             MK.n_columns(fld, P, stride))
    assert_rel(got, direct64(fld, ras, r, a, y0, x0, mass), 1e-5)
    if case == "clamped":
        assert int(y0.max()) == H - P < (n_out - 1) * stride


@pytest.mark.parametrize("K", [5, 16, 37])
def test_plain_candidates_equal_float64_with_clamps(K):
    """Starts below 0 and past H - P clamp; K off the plain version's
    16-window chunks."""
    R, A, P, H = 3, 5, 20, 29
    ras, fld, mass = (band_rasters(R, A, P, 4), rand_field(R, H, H, 5),
                      rand_mass(R, 6))
    g = torch.Generator().manual_seed(7)
    a_idx = torch.randint(0, A, (R, K), generator=g)
    oy = torch.randint(-4, H - P + 5, (R, K), generator=g)
    ox = torch.randint(-4, H - P + 5, (R, K), generator=g)
    got = MK.candidate_scores_plain(fld, ras, a_idx, oy, ox, mass)
    r, a, y0, x0 = list_starts(a_idx, oy, ox, H, H, P)
    assert bool((oy < 0).any() and (oy > H - P).any())
    assert_rel(got, direct64(fld, ras, r, a, y0, x0, mass), 1e-5)


@pytest.mark.parametrize("P", [10, 40, 72, 200])
def test_kernel_order_equals_float64(P):
    """The replay of K8's order against float64, with ragged tiles (P not
    a multiple of 32) and more than 32 tiles a raster (P = 200: 49)."""
    R, A, H = 2, 3, P + 6
    ras, fld, mass = (band_rasters(R, A, P, 8), rand_field(R, H, H, 9),
                      rand_mass(R, 10))
    (r, a, y0, x0), _ = dense_starts(R, A, H, H, P, 3, 3, "cpu")
    assert_rel(kernel_order(fld, ras, r, a, y0, x0, mass),
               direct64(fld, ras, r, a, y0, x0, mass), 1e-6)


def test_kernel_order_at_the_fine_stage_shape_within_1e6():
    """One robot's 21 fine-angle rasters at P = 640 with band rasters and
    a [0, 1] field: the replayed order stays within 1e-6 of float64."""
    P, H = 640, 642
    ras, fld, mass = (band_rasters(1, 21, P, 11), rand_field(1, H, H, 12),
                      rand_mass(1, 13))
    (r, a, y0, x0), _ = dense_starts(1, 21, H, H, P, 3, 1, "cpu")
    sel = slice(0, None, 4)
    r, a, y0, x0 = r[sel], a[sel], y0[sel], x0[sel]
    assert_rel(kernel_order(fld, ras, r, a, y0, x0, mass, chunk=8),
               direct64(fld, ras, r, a, y0, x0, mass, chunk=8), 1e-6)


def test_dense_and_candidate_plain_versions_agree():
    """The two plain code paths score the same windows alike."""
    R, A, P, H, n_out = 2, 3, 16, 22, 4
    ras, fld, mass = (band_rasters(R, A, P, 14), rand_field(R, H, H, 15),
                      rand_mass(R, 16))
    dense = MK.window_scores_plain(fld, ras, mass, n_out, 2)
    (r, a, y0, x0), L = dense_starts(R, A, H, H, P, n_out, 2, "cpu")
    k = A * n_out * L
    got = MK.candidate_scores_plain(fld, ras, a.reshape(R, k),
                                    y0.reshape(R, k), x0.reshape(R, k), mass)
    assert torch.allclose(got.reshape(dense.shape), dense, rtol=1e-6,
                          atol=0)


def test_wrappers_run_the_plain_versions_on_the_cpu():
    R, A, P, H = 2, 3, 16, 20
    ras, fld, mass = (band_rasters(R, A, P, 17), rand_field(R, H, H, 18),
                      rand_mass(R, 19))
    a_idx = torch.tensor([[0, 2, 1], [2, 2, 0]])
    oy = torch.tensor([[0, 3, -1], [9, 4, 2]])
    before = _cuda.LAUNCHES["match_correlate"]
    assert torch.equal(MK.window_scores(fld, ras, mass, 3, 2),
                       MK.window_scores_plain(fld, ras, mass, 3, 2))
    assert torch.equal(
        MK.candidate_scores(fld, ras, a_idx, oy, oy.flip(1), mass),
        MK.candidate_scores_plain(fld, ras, a_idx, oy, oy.flip(1), mass))
    assert _cuda.LAUNCHES["match_correlate"] == before


def _tiny_match_inputs(n_tenants=1):
    cfg = tiny_config(2)
    g, sc = cfg.grid, cfg.scan
    ns = int(sc.range_max_m / (g.resolution_m * 0.5))
    gen = torch.Generator().manual_seed(4)
    grids, scans, guesses = [], [], []
    for t in range(n_tenants):
        w = torch.as_tensor(W.rooms_world(256, g.resolution_m, seed=1 + t))
        poses = (torch.rand((2, 3), generator=gen) - 0.5) * torch.tensor(
            [4.0, 4.0, 6.0])
        r = lidar.simulate_scans(sc, w, g.resolution_m, ns, poses)
        grids.append(G.fuse_scans_masked(g, sc, G.empty_grid(g, "cpu"), r,
                                         poses, torch.ones(2, dtype=bool)))
        scans.append(r)
        guesses.append(poses + 0.03)
    return cfg, grids, scans, guesses


@pytest.mark.parametrize("pruned", [True, False])
def test_matcher_correlations_go_through_the_kernel_wrappers(monkeypatch,
                                                             pruned):
    """Every correlation of `match_batch` is a K8 wrapper call: pruned,
    the top bound, the fine angles and the level-1 surface (dense) and
    one candidate call a B&B level; unpruned, the sweep and the fine
    angles. On the CPU a 3-tenant batch calls them once a lane."""
    import dataclasses
    cfg, grids, scans, guesses = _tiny_match_inputs(3)
    cfg = cfg.replace(matcher=dataclasses.replace(cfg.matcher,
                                                  pruned=pruned))
    calls = {"dense": 0, "list": 0}

    def count(key, fn):
        def wrapped(*a, **k):
            calls[key] += 1
            return fn(*a, **k)
        return wrapped

    monkeypatch.setattr(MK, "window_scores",
                        count("dense", MK.window_scores))
    monkeypatch.setattr(MK, "candidate_scores",
                        count("list", MK.candidate_scores))
    stride, n_steps = M.window_params(cfg.grid, cfg.matcher)
    n_levels = M.bnb_num_levels(cfg.matcher, n_steps) if pruned else 0
    want = {"dense": 3, "list": n_levels} if n_levels else \
        {"dense": 2, "list": 0}
    M.match_batch(cfg.grid, cfg.scan, cfg.matcher, grids[0], scans[0],
                  guesses[0])
    assert calls == want
    calls.update(dense=0, list=0)
    M.match_batch(cfg.grid, cfg.scan, cfg.matcher, torch.stack(grids),
                  torch.cat(scans), torch.cat(guesses),
                  tenant=torch.arange(3).repeat_interleave(2))
    assert calls == {k: 3 * v for k, v in want.items()}


def _c_params(entry: str) -> int:
    src = (_cuda.CSRC / _cuda.SOURCES["match_correlate"]).read_text()
    m = re.search(r'extern "C" int ' + entry + r"\(([^)]*)\)", src)
    assert m, entry
    return len(m.group(1).split(","))


def test_k8_is_wired_like_the_other_kernels():
    """Built with the others (`SOURCES`), counted (`LAUNCHES`, `KERNELS`),
    and each ctypes signature as long as its C entry's parameter list."""
    assert (_cuda.CSRC / _cuda.SOURCES["match_correlate"]).exists()
    assert "match_correlate" in _cuda.LAUNCHES
    assert _cuda.libraries_of({"match_correlate"}) == {"match_correlate"}
    for entry, argtypes in _cuda._SIGNATURES["match_correlate"].items():
        assert _c_params(entry) == len(argtypes), entry


def test_k8_cost_at_the_fleet_fine_stage():
    """8 robots' 21 fine rasters at P = 640 against 642^2 fields, 9
    windows each: the rasters, fields, masses and scores, once."""
    ras = torch.empty((8, 21, 640, 640), device="meta")
    fld = torch.empty((8, 642, 642), device="meta")
    by, ops = ledger.match_correlate_cost(ras, fld, 8 * 21 * 9)
    assert by == 4 * (8 * 21 * 640 * 640 + 8 * 642 * 642 + 8 + 1512)
    assert ops == 2 * 640 * 640 * 1512
    by_k, _ = ledger.match_correlate_cost(ras, fld, 512, index_bytes=12288)
    assert by_k == 4 * (8 * 21 * 640 * 640 + 8 * 642 * 642 + 8 + 512) \
        + 12288


# -- on the card --------------------------------------------------------------

#: The matcher's call sites at the default config: (P, field side, n_out,
#: A, rows, raster block).
SITES = {
    "fine": (640, 642, 3, 21, 2, 1),
    "surface": (320, 330, 11, 1, 8, 2),
    "top": (80, 83, 3, 21, 8, 8),
}


def _site_inputs(site, device, seed=0):
    P, H, n_out, A, R, q = SITES[site]
    ras = band_rasters(R, A, P * q, 20 + seed)
    ras = (block_sum(ras, q) if q > 1 else ras).to(device).contiguous()
    return (ras, rand_field(R, H, H, 21 + seed, device),
            rand_mass(R, 22 + seed, device), n_out)


@pytest.mark.cuda
@pytest.mark.parametrize("site", list(SITES))
def test_k8_dense_within_1e6_of_float64_and_its_order(dev, site):
    ras, fld, mass, n_out = _site_inputs(site, dev)
    R, A, P, _ = ras.shape
    H = fld.shape[-1]
    before = _cuda.LAUNCHES["match_correlate"]
    got = MK.window_scores(fld, ras, mass, n_out, 1)
    assert _cuda.LAUNCHES["match_correlate"] == before + 2
    (r, a, y0, x0), L = dense_starts(R, A, H, H, P, n_out, 1, dev)
    assert got.shape == (R, A, n_out, L)
    torch.cuda.synchronize()
    assert_rel(got, direct64(fld, ras, r, a, y0, x0, mass), 1e-6)
    want = kernel_order(fld, ras, r, a, y0, x0, mass).reshape(got.shape)
    assert torch.equal(got, want), int((got != want).sum())


LEVELS = {0: (640, 660, 64), 1: (320, 330, 256), 2: (160, 165, 256)}


def _list_inputs(lv, R, device, seed=0):
    P, H, K = LEVELS[lv]
    q = 2 ** lv
    ras = band_rasters(R, 21, 640, 30 + seed)
    ras = (block_sum(ras, q) if q > 1 else ras).to(device).contiguous()
    g = torch.Generator().manual_seed(31 + seed)
    a_idx = torch.randint(0, 21, (R, K), generator=g)
    # Starts over the whole window and a few past each edge.
    oy = torch.randint(-3, H - P + 4, (R, K), generator=g)
    ox = torch.randint(-3, H - P + 4, (R, K), generator=g)
    return (ras, rand_field(R, H, H, 32 + seed, device),
            *(t.to(device) for t in (a_idx, oy, ox)),
            rand_mass(R, 33 + seed, device))


@pytest.mark.cuda
@pytest.mark.parametrize("lv", list(LEVELS))
def test_k8_candidates_within_1e6_of_float64_and_its_order(dev, lv):
    ras, fld, a_idx, oy, ox, mass = _list_inputs(lv, 2, dev)
    P, H = ras.shape[-1], fld.shape[-1]
    got = MK.candidate_scores(fld, ras, a_idx, oy, ox, mass)
    r, a, y0, x0 = list_starts(a_idx, oy, ox, H, H, P)
    assert bool((oy < 0).any() and (ox > H - P).any())
    torch.cuda.synchronize()
    assert_rel(got, direct64(fld, ras, r, a, y0, x0, mass), 1e-6)
    want = kernel_order(fld, ras, r, a, y0, x0, mass).reshape(got.shape)
    assert torch.equal(got, want), int((got != want).sum())


def test_band_rasters_leave_most_tiles_zero():
    """Most 32 x 32 tiles of a band raster are zero, as K1's are, so the
    card tests' bit-equality with `kernel_order` (which adds every tile)
    holds the kernel's skipping of zero tiles."""
    ras = band_rasters(1, 21, 640, 40)
    tiles = ras.reshape(21, 20, 32, 20, 32).abs().sum(dim=(2, 4))
    assert float((tiles == 0).double().mean()) > 0.5


def _rows_alike(fn, n_rows, chunks):
    whole = fn(slice(0, n_rows))
    for c in chunks:
        parts = torch.cat([fn(slice(s, s + c)) for s in range(0, n_rows, c)])
        assert torch.equal(parts, whole), (c, int((parts != whole).sum()))


@pytest.mark.cuda
def test_k8_rows_equal_in_96_8_and_1_row_launches(dev):
    """A row's scores do not depend on the rows beside it in a launch."""
    R = 96
    g = torch.Generator().manual_seed(50)
    base = band_rasters(8, 21, 640, 51, dev)
    ras = base[torch.randint(0, 8, (R,), generator=g).to(dev)].contiguous()
    fld = rand_field(R, 642, 642, 52, dev)
    mass = rand_mass(R, 53, dev)
    _rows_alike(lambda s: MK.window_scores(fld[s], ras[s], mass[s], 3, 1),
                R, (8, 1))
    lvl = rand_field(R, 660, 660, 54, dev)
    a_idx = torch.randint(0, 21, (R, 64), generator=g).to(dev)
    oy, ox = (torch.randint(0, 21, (R, 64), generator=g).to(dev)
              for _ in range(2))
    _rows_alike(lambda s: MK.candidate_scores(lvl[s], ras[s], a_idx[s],
                                              oy[s], ox[s], mass[s]),
                R, (8, 1))
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_k8_candidate_equals_dense_at_the_same_start(dev):
    ras, fld, mass, n_out = _site_inputs("surface", dev)
    R, A, P, _ = ras.shape
    dense = MK.window_scores(fld, ras, mass, n_out, 1)
    (r, a, y0, x0), L = dense_starts(R, A, fld.shape[-1], fld.shape[-1], P,
                                     n_out, 1, dev)
    k = A * n_out * L
    got = MK.candidate_scores(fld, ras, a.reshape(R, k), y0.reshape(R, k),
                              x0.reshape(R, k), mass)
    assert torch.equal(got.reshape(dense.shape), dense)


@pytest.mark.cuda
def test_match_batch_12_tenants_equal_solo_on_card(dev):
    """The default config's matcher over a 12-tenant stack (8 robots a
    mission, each map fused from its own rooms floor) equals each lane's
    solo `match_batch` bit for bit, every field; K8 launches the same
    count for the stack as for one mission."""
    cfg = SlamConfig()
    g, sc = cfg.grid, cfg.scan
    T, R = 12, 8
    ns = int(sc.range_max_m / (g.resolution_m * 0.5))
    gen = torch.Generator().manual_seed(60)
    grids, scans, guesses = [], [], []
    for t in range(T):
        w = torch.as_tensor(W.rooms_world(1024, g.resolution_m, seed=61 + t),
                            device=dev)
        poses = ((torch.rand((2 * R, 3), generator=gen) - 0.5)
                 * torch.tensor([30.0, 30.0, 6.0])).to(dev)
        r = lidar.simulate_scans(sc, w, g.resolution_m, ns, poses)
        grids.append(G.fuse_scans_masked(
            g, sc, G.empty_grid(g, dev), r, poses,
            torch.ones(2 * R, dtype=torch.bool, device=dev)))
        scans.append(r[:R])
        guesses.append(poses[:R] + torch.tensor([0.03, -0.02, 0.01],
                                                device=dev))
    before = _cuda.LAUNCHES["match_correlate"]
    got = M.match_batch(g, sc, cfg.matcher, torch.stack(grids),
                        torch.cat(scans), torch.cat(guesses),
                        tenant=torch.arange(T, device=dev)
                        .repeat_interleave(R))
    stacked = _cuda.LAUNCHES["match_correlate"] - before
    for t in range(T):
        before = _cuda.LAUNCHES["match_correlate"]
        want = M.match_batch(g, sc, cfg.matcher, grids[t], scans[t],
                             guesses[t])
        assert _cuda.LAUNCHES["match_correlate"] - before == stacked
        for f, x in zip(M.MatchResult._fields, want):
            y = getattr(got, f)[t * R:(t + 1) * R]
            assert torch.equal(y, x), (t, f)
    assert stacked == 2 * (3 + M.bnb_num_levels(
        cfg.matcher, M.window_params(g, cfg.matcher)[1]))
    assert bool(got.accepted.any())
