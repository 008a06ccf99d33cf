"""Correlative scan matching, batched over robots.

Port of the JAX package's `ops/scan_match.py`. A match builds a smooth
likelihood field from the map patch around the guess, rasterises the scan
at candidate angles with kernel K1 (raster mode), scores translation
shifts as one cross-correlation, and refines: fine angles, then sub-cell
translations. With `MatcherConfig.pruned` (the default) the coarse stage
is branch and bound over an admissible max-pyramid of the field.

Every function carries a leading robot axis R where the JAX package
vmaps. The tenant megabatch matches T missions' scans in one call
(`match_batch` with a `tenant` index into a (T, N, N) stack of maps).
Every correlation (the top bound, each B&B level, the fine angles, the
level-1 covariance surface, the exhaustive sweep) is kernel K8
(`ops/match_kernel.py`) on the card, in full f32: its sums follow the
shapes alone, so it takes every row at once and each mission's result is
its solo call's. K1 rasterises every row at once too, while the other
float reductions (raster masses, block sums, softmax moments, the
sub-cell einsum) and, on the CPU, the plain correlations run one
mission's rows at a time (`_per_lane`), at the solo call's shapes: run
whole, they may sum in another order than the solo calls.
`coarse_bf16` is a TPU-only knob and is ignored, as on the JAX CPU path.
Top-k keeps jax.lax.top_k's order (the lower index first among equal
values) through a stable sort. The cached entry points at the end
(`match_with_pyramid` and its coarse/refine split) match against a
prebuilt pyramid (ops/pyramid.py); the JAX package donates the refine's
buffers to XLA, which has no counterpart here.
"""

from __future__ import annotations

import contextlib
import threading
from typing import NamedTuple

import torch
import torch.nn.functional as Fn

from jax_mapping_torch._util import const, div, entry_point, full_f32
from jax_mapping_torch.config import GridConfig, MatcherConfig, ScanConfig
from jax_mapping_torch.ops import grid as G
from jax_mapping_torch.ops import match_kernel as MK
from jax_mapping_torch.ops import sensor_kernel as SK
from jax_mapping_torch.utils.profiling import span


class MatchResult(NamedTuple):
    pose: torch.Tensor             # (R, 3) refined [x, y, yaw]
    response: torch.Tensor         # (R,) fine-stage response in [0, 1]
    coarse_response: torch.Tensor  # (R,) coarse-stage response
    accepted: torch.Tensor         # (R,) bool: response >= min_response
    cov: torch.Tensor              # (R, 3) [var_x, var_y, var_th]
    n_candidates: torch.Tensor     # (R,) int32 coarse evaluations scored
    prune_ratio: torch.Tensor      # (R,) f32 share of the sweep pruned


def scan_points(scan_cfg: ScanConfig, ranges: torch.Tensor):
    """(..., padded_beams) ranges -> ((..., padded_beams, 2) points in the
    sensor frame, hit mask); only genuine hits are valid points."""
    r_m, hit = G.sanitize_ranges(scan_cfg, ranges)
    idx = torch.arange(scan_cfg.padded_beams, dtype=torch.float32,
                       device=ranges.device)
    ang = idx * idx.new_full((), scan_cfg.angle_increment_rad) \
        + scan_cfg.angle_min_rad
    if not scan_cfg.counterclockwise:
        ang = -ang
    pts = torch.stack([r_m * torch.cos(ang), r_m * torch.sin(ang)], dim=-1)
    return pts, hit


def _rows(R: int, dev) -> torch.Tensor:
    return torch.arange(R, device=dev)


#: Rows of one mission while a tenant megabatch is matching, else None.
_LANE = threading.local()


@contextlib.contextmanager
def _lanes(rows):
    prev = getattr(_LANE, "rows", None)
    _LANE.rows = rows
    try:
        yield
    finally:
        _LANE.rows = prev


def _per_lane(fn, *xs):
    """fn(*xs) over the leading axis, one mission's rows at a time while a
    tenant megabatch is matching (else one call); the results, tensors or
    tuples of tensors, are concatenated on axis 0."""
    rows = getattr(_LANE, "rows", None)
    B = xs[0].shape[0]
    if rows is None or B <= rows:
        return fn(*xs)
    outs = [fn(*(x[s:s + rows] for x in xs)) for s in range(0, B, rows)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(o) for o in zip(*outs))
    return torch.cat(outs)


def _lanes_on_cpu(fn, *xs):
    """fn(*xs) for K8's call sites: the whole batch in one call on the
    card, where K8 sums in an order of the shapes alone, and one
    mission's rows at a time (`_per_lane`) on the CPU, where the plain
    versions' sums may follow the batch."""
    if xs[0].device.type == "cuda":
        return fn(*xs)
    return _per_lane(fn, *xs)


# ---------------------------------------------------------------------------
# Likelihood field
# ---------------------------------------------------------------------------

def _blur_weights(sigma: float, radius: int):
    """exp(-0.5 (off/sigma)^2) per offset, each rounded once to f32."""
    return [float(torch.exp(torch.tensor(-0.5 * (off / sigma) ** 2,
                                         dtype=torch.float32, device="cpu")))
            for off in range(-radius, radius + 1)]


def likelihood_field(grid_cfg: GridConfig, m_cfg: MatcherConfig,
                     patch: torch.Tensor) -> torch.Tensor:
    """(..., P, P) log-odds patches -> [0, 1] fields: the occupied mask
    under a separable max-Gaussian smear."""
    occ = (patch > grid_cfg.occ_threshold).to(torch.float32)
    sigma = float(max(m_cfg.smear_cells, 1))
    radius = int(3 * sigma)
    weights = _blur_weights(sigma, radius)

    def max_blur(x: torch.Tensor, axis: int) -> torch.Tensor:
        pad = [0, 0, 0, 0]
        if axis == -1:
            pad[0:2] = [radius, radius]
        else:
            pad[2:4] = [radius, radius]
        xp = Fn.pad(x, pad)
        n = x.shape[axis]
        out = torch.zeros_like(x)
        for k, w in enumerate(weights):
            out = torch.maximum(out, w * xp.narrow(axis, k, n))
        return out

    return max_blur(max_blur(occ, -2), -1)


# ---------------------------------------------------------------------------
# Correlative search helpers
# ---------------------------------------------------------------------------

def _angle_grid(half: float, step: float, dev) -> torch.Tensor:
    n = int(round(half / step))
    return torch.arange(-n, n + 1, dtype=torch.float32, device=dev) * step


def _pen_dist(m_cfg: MatcherConfig, d2_m2: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(
        1.0 - div(0.2 * d2_m2, m_cfg.distance_variance_penalty_m2),
        m_cfg.min_distance_penalty)


def _pen_angle(m_cfg: MatcherConfig, dth: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(
        1.0 - div(0.2 * dth * dth, m_cfg.angle_variance_penalty_rad2),
        m_cfg.min_angle_penalty)


def _top_k(x: torch.Tensor, k: int):
    """Row-wise jax.lax.top_k: descending, lower index first on ties."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _raster_batch(grid_cfg: GridConfig, scan_cfg: ScanConfig,
                  ranges: torch.Tensor, poses: torch.Tensor,
                  origin_rc: torch.Tensor):
    """(R, A, P, P) soft rasters of each robot's scan at its A candidate
    poses (R, A, 3), and their (R, A) masses."""
    R, A, _ = poses.shape
    P = grid_cfg.patch_cells
    ranges_b = ranges[:, None, :].expand(R, A, ranges.shape[-1]).reshape(
        R * A, -1).contiguous()
    origins = origin_rc[:, None, :].expand(R, A, 2).reshape(
        R * A, 2).to(torch.int32).contiguous()
    rasters = SK.scan_rasters(grid_cfg, scan_cfg, ranges_b,
                              poses.reshape(R * A, 3).contiguous(), origins)
    rasters = rasters.reshape(R, A, P, P)
    mass = torch.clamp_min(
        _per_lane(lambda r: r.sum(dim=(2, 3)), rasters), 1e-6)
    return rasters, mass


def _conv_scores_grid(fpad: torch.Tensor, rasters: torch.Tensor,
                      mass_ref: torch.Tensor, n_out: int,
                      stride: int) -> torch.Tensor:
    """resp[r, a, my, mx] = <rasters[r, a], fpad[r, my*stride : +P,
    mx*stride : +P]> / mass_ref[r] (kernel K8's dense mode,
    `match_kernel.window_scores`). Window starts past the edge clamp, as
    jax.lax.dynamic_slice clamps them."""
    return _lanes_on_cpu(lambda f, r, m: MK.window_scores(f, r, m, n_out,
                                                          stride),
                         fpad, rasters, mass_ref)


def _conv_scores(field: torch.Tensor, rasters: torch.Tensor,
                 mass_ref: torch.Tensor, n_steps: int,
                 stride: int = 1) -> torch.Tensor:
    pad = n_steps * stride
    fpad = Fn.pad(field, (pad, pad, pad, pad))
    return _conv_scores_grid(fpad, rasters, mass_ref, 2 * n_steps + 1,
                             stride)


# ---------------------------------------------------------------------------
# Branch-and-bound coarse stage
# ---------------------------------------------------------------------------

def window_params(grid_cfg: GridConfig, m_cfg: MatcherConfig):
    """(stride_cells, n_steps) of the coarse window's leaf grid."""
    stride = max(1, int(round(m_cfg.coarse_step_m / grid_cfg.resolution_m)))
    n_steps = max(1, int(round(m_cfg.search_half_extent_m
                               / (stride * grid_cfg.resolution_m))))
    return stride, n_steps


def bnb_num_levels(m_cfg: MatcherConfig, n_steps: int) -> int:
    """Pyramid depth above level 0; 0 means too small to prune."""
    nw = 2 * n_steps + 1
    lv = m_cfg.bnb_levels
    if lv <= 0:
        lv = 0
        while lv < 6 and -(-nw // (2 ** (lv + 1))) >= 3:
            lv += 1
    while lv > 0 and -(-nw // (2 ** lv)) < 2:
        lv -= 1
    return lv


def _block_reduce(x: torch.Tensor, q: int, op: str) -> torch.Tensor:
    """q x q block max/sum over the last two axes, zero-padding the
    ragged edge (a sum one mission's rows at a time, `_per_lane`)."""
    if q == 1:
        return x
    if op == "sum":
        return _per_lane(lambda v: _block_reduce_one(v, q, op), x)
    return _block_reduce_one(x, q, op)


def _block_reduce_one(x: torch.Tensor, q: int, op: str) -> torch.Tensor:
    h, w = x.shape[-2], x.shape[-1]
    ph, pw = (-h) % q, (-w) % q
    if ph or pw:
        x = Fn.pad(x, (0, pw, 0, ph))
    blk = x.reshape(x.shape[:-2] + ((h + ph) // q, q, (w + pw) // q, q))
    return blk.amax(dim=(-3, -1)) if op == "max" else blk.sum(dim=(-3, -1))


def build_levels(field: torch.Tensor, n_steps: int, stride: int,
                 n_levels: int):
    """(R, P, P) fields -> (F_0, D_1, ..., D_L): the padded field and the
    admissible block-max pyramid of its sliding maxima."""
    pad = n_steps * stride
    full = Fn.pad(field, (pad, pad, pad, pad))
    levels = [full]
    for lv in range(1, n_levels + 1):
        s = stride * (2 ** (lv - 1))
        prev = full
        rows = Fn.pad(prev[..., s:, :], (0, 0, 0, s))
        m = torch.maximum(prev, rows)
        cols = Fn.pad(m[..., :, s:], (0, s))
        full = torch.maximum(m, cols)
        levels.append(_block_reduce(full, 2 ** lv, "max"))
    return tuple(levels)


def _raster_sums(rasters: torch.Tensor, n_levels: int) -> list:
    return [rasters] + [_block_reduce(rasters, 2 ** lv, "sum")
                        for lv in range(1, n_levels + 1)]


def _axis_min_off(i0: torch.Tensor, lv: int, n_steps: int) -> torch.Tensor:
    nw = 2 * n_steps + 1
    i1 = torch.clamp_max(i0 + (2 ** lv) - 1, nw - 1)
    lo = i0 - n_steps
    hi = i1 - n_steps
    return torch.where((lo <= 0) & (hi >= 0), 0,
                       torch.minimum(lo.abs(), hi.abs()))


def _bnb_scores(lvl: torch.Tensor, rasters: torch.Tensor, a_idx, oy, ox,
                mass_ref: torch.Tensor) -> torch.Tensor:
    """(R, K) scores <rasters[r, a_k], lvl[r, oy_k : +P, ox_k : +P]> /
    mass_ref[r] (kernel K8's candidate mode,
    `match_kernel.candidate_scores`); slice starts clamp like
    jax.lax.dynamic_slice."""
    return _lanes_on_cpu(MK.candidate_scores, lvl, rasters, a_idx, oy, ox,
                         mass_ref)


def _bnb_winner(m_cfg: MatcherConfig, levels, resp_top: torch.Tensor,
                rasters_c: torch.Tensor, mass_ref: torch.Tensor,
                dth_c: torch.Tensor, n_steps: int, stride: int,
                step_m: float, n_levels: int):
    """Branch-and-bound descent to the exact leaf winner per robot:
    (angle index, leaf iy, leaf ix, leaf response, n_scored)."""
    R = resp_top.shape[0]
    dev = resp_top.device
    A = dth_c.shape[0]
    nw = 2 * n_steps + 1
    M = resp_top.shape[-1]
    rr = _rows(R, dev)[:, None]
    pen_a = _pen_angle(m_cfg, dth_c)                            # (A,)
    iy0 = torch.arange(M, device=dev) * (2 ** n_levels)
    mo = _axis_min_off(iy0, n_levels, n_steps).to(torch.float32) * step_m
    pen_d = _pen_dist(m_cfg, mo[:, None] * mo[:, None]
                      + mo[None, :] * mo[None, :])              # (M, M)
    rank = resp_top * pen_d[None, None] * pen_a[None, :, None, None]
    K = min(m_cfg.bnb_topk, A * M * M)
    _, flat = _top_k(rank.reshape(R, -1), K)
    a = torch.div(flat, M * M, rounding_mode="floor")
    rem = flat % (M * M)
    iy = torch.div(rem, M, rounding_mode="floor") * (2 ** n_levels)
    ix = (rem % M) * (2 ** n_levels)
    n_scored = A * M * M

    rsums = _raster_sums(rasters_c, n_levels - 1)
    for lv in range(n_levels - 1, -1, -1):
        off = 2 ** lv
        ca = a.repeat(1, 4)
        dy = const((0, 0, off, off), dev, torch.int64).repeat_interleave(K)
        dx = const((0, off, 0, off), dev, torch.int64).repeat_interleave(K)
        ciy = iy.repeat(1, 4) + dy
        cix = ix.repeat(1, 4) + dx
        valid = (ciy < nw) & (cix < nw)
        scores = _bnb_scores(levels[lv], rsums[lv], ca,
                             torch.div(ciy, off, rounding_mode="floor")
                             * stride,
                             torch.div(cix, off, rounding_mode="floor")
                             * stride, mass_ref)
        my = _axis_min_off(ciy, lv, n_steps).to(torch.float32) * step_m
        mx = _axis_min_off(cix, lv, n_steps).to(torch.float32) * step_m
        pen = _pen_dist(m_cfg, my * my + mx * mx) * pen_a[ca]
        rank = torch.where(valid, scores * pen, -1.0)
        n_scored += 4 * K
        if lv > 0:
            K = min(m_cfg.bnb_leaf_topk if lv == 1 else m_cfg.bnb_topk,
                    4 * K)
            _, idx = _top_k(rank, K)
            a = ca.gather(1, idx)
            iy = ciy.gather(1, idx)
            ix = cix.gather(1, idx)
        else:
            best = rank.amax(dim=1, keepdim=True)
            flat_leaf = ca * (nw * nw) + ciy * nw + cix
            sel = torch.where(rank == best, flat_leaf, A * nw * nw)
            w = torch.argmin(sel, dim=1, keepdim=True)
            a, iy, ix = ca.gather(1, w)[:, 0], ciy.gather(1, w)[:, 0], \
                cix.gather(1, w)[:, 0]
            resp = scores.gather(1, w)[:, 0]
    return a, iy, ix, resp, n_scored


# ---------------------------------------------------------------------------
# Matching
# ---------------------------------------------------------------------------

@entry_point(static=("grid_cfg", "m_cfg", "scan_cfg"))
def match_batch(grid_cfg: GridConfig, scan_cfg: ScanConfig,
                m_cfg: MatcherConfig, grid_arr: torch.Tensor,
                ranges_b: torch.Tensor, guesses_b: torch.Tensor,
                tenant=None) -> MatchResult:
    """Match R scans (R, beams) at guesses (R, 3) against one shared map;
    or, with `tenant` (R,), scan r against map tenant[r] of a (T, N, N)
    stack, the rows being T missions' R / T each in tenant order (the
    tenant megabatch: each mission's result is its solo call's)."""
    full_f32()
    R = ranges_b.shape[0]
    P = grid_cfg.patch_cells
    dev = grid_arr.device
    stride, n_steps = window_params(grid_cfg, m_cfg)
    n_levels = bnb_num_levels(m_cfg, n_steps) if m_cfg.pruned else 0
    with span("match.field"):
        origin = G.patch_origin(grid_cfg, guesses_b[:, :2])      # (R, 2)
        ar = torch.arange(P, device=dev)
        rows = (origin[:, 0:1].long() + ar)[:, :, None]
        cols = (origin[:, 1:2].long() + ar)[:, None, :]
        if tenant is None:
            patch = grid_arr[rows, cols]                         # (R, P, P)
            lane_rows = None
        else:
            patch = grid_arr[tenant.long()[:, None, None], rows, cols]
            lane_rows = R // grid_arr.shape[0]
        field = likelihood_field(grid_cfg, m_cfg, patch)
        if n_levels > 0:
            levels = build_levels(field, n_steps, stride, n_levels)
    with _lanes(lane_rows):
        if n_levels > 0:
            return _match_bnb(grid_cfg, scan_cfg, m_cfg, levels, origin,
                              ranges_b, guesses_b, n_levels)
        return _match_exhaustive(grid_cfg, scan_cfg, m_cfg, field, origin,
                                 ranges_b, guesses_b)


@entry_point(static=("grid_cfg", "m_cfg", "scan_cfg"))
def match(grid_cfg: GridConfig, scan_cfg: ScanConfig, m_cfg: MatcherConfig,
          grid_arr: torch.Tensor, ranges: torch.Tensor,
          guess_pose: torch.Tensor) -> MatchResult:
    """One scan (beams,) at one guess (3,); fields keep a leading 1."""
    return match_batch(grid_cfg, scan_cfg, m_cfg, grid_arr, ranges[None],
                       guess_pose[None])


def _coarse_poses(guess: torch.Tensor, dth: torch.Tensor) -> torch.Tensor:
    """(R, A, 3) candidates: each guess's xy at each angle offset."""
    R, A = guess.shape[0], dth.shape[-1]
    return torch.cat([guess[:, None, :2].expand(R, A, 2),
                      (guess[:, 2:3] + dth)[..., None]], dim=-1)


def _softmax_moments(surf: torch.Tensor, offs: torch.Tensor):
    """(mean, variance) of offs under exp((surf - max) / 0.05) weights
    per leading row; surf (R, n) and offs (n,)."""
    return _per_lane(lambda s: _softmax_moments_one(s, offs), surf)


def _softmax_moments_one(surf: torch.Tensor, offs: torch.Tensor):
    # One memory layout whichever way `surf` came (a lane of a batched
    # call is contiguous, a solo call's a view): the sums below then
    # accumulate in one order.
    surf = surf.contiguous()
    w = torch.exp(div(surf - surf.amax(dim=-1, keepdim=True), 0.05))
    ws = w.sum(dim=-1)
    m = (w * offs).sum(dim=-1) / ws
    d = offs - m[:, None]
    return m, (w * (d * d)).sum(dim=-1) / ws


def _xy_cov(surf: torch.Tensor, offs: torch.Tensor):
    """Softmax second moments of an (R, ny, nx) surface along x and y."""
    return _per_lane(lambda s: _xy_cov_one(s, offs), surf)


def _xy_cov_one(surf: torch.Tensor, offs: torch.Tensor):
    surf = surf.contiguous()            # as in _softmax_moments_one
    w_t = torch.exp(div(surf - surf.amax(dim=(1, 2), keepdim=True), 0.05))
    wx = w_t.sum(dim=1)
    wy = w_t.sum(dim=2)

    def var(wv):
        s = wv.sum(dim=-1)
        mean = (wv * offs).sum(dim=-1) / s
        d = offs - mean[:, None]
        return (wv * (d * d)).sum(dim=-1) / s

    return var(wx), var(wy)


def _match_exhaustive(grid_cfg: GridConfig, scan_cfg: ScanConfig,
                      m_cfg: MatcherConfig, field: torch.Tensor,
                      origin: torch.Tensor, ranges: torch.Tensor,
                      guess: torch.Tensor) -> MatchResult:
    """The three-pass pipeline without pruning."""
    R = guess.shape[0]
    dev = guess.device
    res = grid_cfg.resolution_m
    stride, n_steps = window_params(grid_cfg, m_cfg)
    nw = 2 * n_steps + 1
    step_m = stride * res
    with span("match.search"):
        dth_c = _angle_grid(m_cfg.coarse_angle_half_rad,
                            m_cfg.coarse_angle_step_rad, dev)
        A_c = dth_c.shape[0]
        rasters_c, mass_c = _raster_batch(grid_cfg, scan_cfg, ranges,
                                          _coarse_poses(guess, dth_c),
                                          origin)
        mass_ref = torch.clamp_min(mass_c.amax(dim=1), 1e-6)
        resp_c = _conv_scores(field, rasters_c, mass_ref, n_steps, stride)
        offs = torch.arange(-n_steps, n_steps + 1, dtype=torch.float32,
                            device=dev) * step_m
        d2_c = offs[None, :] * offs[None, :] + offs[:, None] * offs[:, None]
        pen_c = _pen_dist(m_cfg, d2_c)[None] * \
            _pen_angle(m_cfg, dth_c)[:, None, None]
        best_c = torch.argmax((resp_c * pen_c[None]).reshape(R, -1), dim=1)
        ai_c = torch.div(best_c, nw * nw, rounding_mode="floor")
        sy_c = torch.div(best_c % (nw * nw), nw, rounding_mode="floor")
        sx_c = best_c % nw
        rr = _rows(R, dev)
        coarse_resp = resp_c[rr, ai_c, sy_c, sx_c]
    with span("match.refine"):
        dth0 = dth_c[ai_c]
        shift0 = torch.stack([(sx_c - n_steps).to(torch.float32) * step_m,
                              (sy_c - n_steps).to(torch.float32) * step_m],
                             -1)
        pose, fine_resp = _fine_stages(grid_cfg, scan_cfg, m_cfg, field,
                                       origin, ranges, guess, mass_ref,
                                       dth0, shift0)

        var_x, var_y = _xy_cov(resp_c[rr, ai_c], offs)
        _, var_th = _softmax_moments(resp_c.amax(dim=(2, 3)), dth_c)
        cov = torch.stack([
            torch.clamp_min(var_x, (step_m / 2) ** 2 / 3),
            torch.clamp_min(var_y, (step_m / 2) ** 2 / 3),
            torch.clamp_min(var_th,
                            (m_cfg.coarse_angle_step_rad / 2) ** 2 / 3),
        ], -1)
        return MatchResult(
            pose=pose, response=fine_resp, coarse_response=coarse_resp,
            accepted=fine_resp >= m_cfg.min_response, cov=cov,
            n_candidates=torch.full((R,), A_c * nw * nw, dtype=torch.int32,
                                    device=dev),
            prune_ratio=torch.zeros(R, dtype=torch.float32, device=dev))


def _fine_stages(grid_cfg: GridConfig, scan_cfg: ScanConfig,
                 m_cfg: MatcherConfig, field: torch.Tensor,
                 origin: torch.Tensor, ranges: torch.Tensor,
                 guess: torch.Tensor, mass_ref: torch.Tensor,
                 dth0: torch.Tensor, shift0: torch.Tensor):
    """Fine-angle, then sub-cell refinement around each coarse winner."""
    R = guess.shape[0]
    dev = guess.device
    rr = _rows(R, dev)
    res = grid_cfg.resolution_m
    stride, _ = window_params(grid_cfg, m_cfg)

    dth_f = dth0[:, None] + _angle_grid(m_cfg.coarse_angle_step_rad,
                                        m_cfg.fine_angle_step_rad, dev)
    A_f = dth_f.shape[1]
    poses_f = torch.cat([
        (guess[:, :2] + shift0)[:, None, :].expand(R, A_f, 2),
        (guess[:, 2:3] + dth_f)[..., None]], dim=-1)
    rasters_f, _ = _raster_batch(grid_cfg, scan_cfg, ranges, poses_f, origin)
    resp_f = _conv_scores(field, rasters_f, mass_ref, stride)
    ns = 2 * stride + 1
    offs_f = torch.arange(-stride, stride + 1, dtype=torch.float32,
                          device=dev) * res
    ex = shift0[:, 0, None, None] + offs_f[None, None, :]
    ey = shift0[:, 1, None, None] + offs_f[None, :, None]
    pen_f = _pen_dist(m_cfg, ex * ex + ey * ey)[:, None] * \
        _pen_angle(m_cfg, dth_f)[:, :, None, None]
    best_f = torch.argmax((resp_f * pen_f).reshape(R, -1), dim=1)
    ai_f = torch.div(best_f, ns * ns, rounding_mode="floor")
    sy_f = torch.div(best_f % (ns * ns), ns, rounding_mode="floor")
    sx_f = best_f % ns
    dth1 = dth_f[rr, ai_f]
    shift1 = shift0 + torch.stack([(sx_f - stride).to(torch.float32) * res,
                                   (sy_f - stride).to(torch.float32) * res],
                                  -1)

    k = max(1, int(round(0.5 * res / m_cfg.fine_step_m)) + 1)
    d1 = torch.arange(-k, k + 1, dtype=torch.float32,
                      device=dev) * m_cfg.fine_step_m
    ddy, ddx = torch.meshgrid(d1, d1, indexing="ij")
    deltas = torch.stack([ddx.reshape(-1), ddy.reshape(-1)], -1)  # (S, 2)
    S = deltas.shape[0]
    poses_s = torch.cat([
        (guess[:, None, :2] + shift1[:, None, :]) + deltas[None],
        (guess[:, 2] + dth1)[:, None, None].expand(R, S, 1)], dim=-1)
    rasters_s, _ = _raster_batch(grid_cfg, scan_cfg, ranges, poses_s, origin)
    resp_s = _per_lane(
        lambda r, f, m: torch.einsum("rbhw,rhw->rb", r, f) / m[:, None],
        rasters_s, field, mass_ref)
    e = shift1[:, None, :] + deltas[None]
    d2_s = (e * e).sum(dim=-1)
    si = torch.argmax(resp_s * _pen_dist(m_cfg, d2_s), dim=1)
    fine_resp = resp_s[rr, si]
    pose = torch.stack([
        guess[:, 0] + shift1[:, 0] + deltas[si, 0],
        guess[:, 1] + shift1[:, 1] + deltas[si, 1],
        guess[:, 2] + dth1], -1)
    return pose, fine_resp


def _bnb_setup(grid_cfg: GridConfig, scan_cfg: ScanConfig,
               m_cfg: MatcherConfig, origin: torch.Tensor,
               ranges: torch.Tensor, guess: torch.Tensor):
    """(dth_c, rasters_c, mass_ref) of the coarse angles."""
    dth_c = _angle_grid(m_cfg.coarse_angle_half_rad,
                        m_cfg.coarse_angle_step_rad, guess.device)
    rasters_c, mass_c = _raster_batch(grid_cfg, scan_cfg, ranges,
                                      _coarse_poses(guess, dth_c), origin)
    mass_ref = torch.clamp_min(mass_c.amax(dim=1), 1e-6)
    return dth_c, rasters_c, mass_ref


def _bnb_top(levels, rasters_c: torch.Tensor, mass_ref: torch.Tensor,
             n_steps: int, stride: int, n_levels: int) -> torch.Tensor:
    """Top-level upper-bound surface (R, A, M, M)."""
    nw = 2 * n_steps + 1
    M = -(-nw // (2 ** n_levels))
    rsum = _block_reduce(rasters_c, 2 ** n_levels, "sum")
    return _conv_scores_grid(levels[n_levels], rsum, mass_ref, M,
                             stride)[..., :M]


def _match_bnb(grid_cfg: GridConfig, scan_cfg: ScanConfig,
               m_cfg: MatcherConfig, levels, origin: torch.Tensor,
               ranges: torch.Tensor, guess: torch.Tensor,
               n_levels: int) -> MatchResult:
    stride, n_steps = window_params(grid_cfg, m_cfg)
    with span("match.search"):
        dth_c, rasters_c, mass_ref = _bnb_setup(grid_cfg, scan_cfg, m_cfg,
                                                origin, ranges, guess)
        resp_top = _bnb_top(levels, rasters_c, mass_ref, n_steps, stride,
                            n_levels)
    return _bnb_finish(grid_cfg, scan_cfg, m_cfg, levels, resp_top,
                       rasters_c, mass_ref, dth_c, origin, ranges, guess,
                       n_levels)


def _bnb_finish(grid_cfg: GridConfig, scan_cfg: ScanConfig,
                m_cfg: MatcherConfig, levels, resp_top: torch.Tensor,
                rasters_c: torch.Tensor, mass_ref: torch.Tensor,
                dth_c: torch.Tensor, origin: torch.Tensor,
                ranges: torch.Tensor, guess: torch.Tensor,
                n_levels: int) -> MatchResult:
    """Descend to the leaf winner, refine, and report the covariance of
    the winner angle's level-1 block surface."""
    R = guess.shape[0]
    dev = guess.device
    rr = _rows(R, dev)
    res = grid_cfg.resolution_m
    stride, n_steps = window_params(grid_cfg, m_cfg)
    nw = 2 * n_steps + 1
    step_m = stride * res
    A_c = dth_c.shape[0]
    pad = n_steps * stride

    with span("match.search"):
        ai_c, iy_b, ix_b, coarse_resp, n_scored = _bnb_winner(
            m_cfg, levels, resp_top, rasters_c, mass_ref, dth_c, n_steps,
            stride, step_m, n_levels)
    with span("match.refine"):
        field = levels[0][:, pad:-pad, pad:-pad]
        dth0 = dth_c[ai_c]
        shift0 = torch.stack([(ix_b - n_steps).to(torch.float32) * step_m,
                              (iy_b - n_steps).to(torch.float32) * step_m],
                             -1)
        pose, fine_resp = _fine_stages(grid_cfg, scan_cfg, m_cfg, field,
                                       origin, ranges, guess, mass_ref,
                                       dth0, shift0)

        Mb = -(-nw // 2)
        r1 = _block_reduce(rasters_c[rr, ai_c][:, None], 2, "sum")
        surf = _conv_scores_grid(levels[1], r1, mass_ref, Mb,
                                 stride)[:, 0, :, :Mb]
        n_scored += Mb * Mb
        offs = (torch.arange(Mb, dtype=torch.float32, device=dev) * 2.0
                + 0.5 - n_steps) * step_m
        var_x, var_y = _xy_cov(surf, offs)
        _, var_th = _softmax_moments(resp_top.amax(dim=(2, 3)), dth_c)
        cov = torch.stack([
            torch.clamp_min(var_x, step_m ** 2 / 3),
            torch.clamp_min(var_y, step_m ** 2 / 3),
            torch.clamp_min(var_th,
                            (m_cfg.coarse_angle_step_rad / 2) ** 2 / 3),
        ], -1)
        total = A_c * nw * nw
        return MatchResult(
            pose=pose, response=fine_resp, coarse_response=coarse_resp,
            accepted=fine_resp >= m_cfg.min_response, cov=cov,
            n_candidates=torch.full((R,), n_scored, dtype=torch.int32,
                                    device=dev),
            prune_ratio=torch.full((R,), max(0.0, 1.0 - n_scored / total),
                                   dtype=torch.float32, device=dev))


# ---------------------------------------------------------------------------
# Cached-pyramid entry points (ops/pyramid.PyramidCache)
# ---------------------------------------------------------------------------
# One scan in: ranges (beams,), guess_pose (3,), origin (2,) int32. As with
# `match`, every output keeps a leading axis of 1, and `levels` are the
# (1, ., .) levels of `build_levels` (ops/pyramid.build_match_pyramid).
# None of them writes into `levels`: the cache hands one pyramid to every
# later attempt.

@entry_point(static=("grid_cfg", "m_cfg", "n_levels", "scan_cfg"))
def pyramid_coarse_scores(grid_cfg: GridConfig, scan_cfg: ScanConfig,
                          m_cfg: MatcherConfig, n_levels: int, levels,
                          origin: torch.Tensor, ranges: torch.Tensor,
                          guess_pose: torch.Tensor):
    """Stage 1 of the cached pruned match: the coarse rasters and the
    top-level bound surface against a prebuilt pyramid. Returns
    (resp_top, rasters_c, mass_ref), the device tensors `pyramid_refine`
    takes."""
    full_f32()
    _, rasters_c, mass_ref = _bnb_setup(grid_cfg, scan_cfg, m_cfg,
                                        origin[None], ranges[None],
                                        guess_pose[None])
    stride, n_steps = window_params(grid_cfg, m_cfg)
    resp_top = _bnb_top(levels, rasters_c, mass_ref, n_steps, stride,
                        n_levels)
    return resp_top, rasters_c, mass_ref


def pyramid_refine(grid_cfg: GridConfig, scan_cfg: ScanConfig,
                   m_cfg: MatcherConfig, n_levels: int,
                   resp_top: torch.Tensor, levels, origin: torch.Tensor,
                   ranges: torch.Tensor, rasters_c: torch.Tensor,
                   mass_ref: torch.Tensor,
                   guess_pose: torch.Tensor) -> MatchResult:
    """Stage 2: the branch-and-bound descent and the fine stages, with no
    host read between levels."""
    full_f32()
    dth_c = _angle_grid(m_cfg.coarse_angle_half_rad,
                        m_cfg.coarse_angle_step_rad, guess_pose.device)
    return _bnb_finish(grid_cfg, scan_cfg, m_cfg, levels, resp_top,
                       rasters_c, mass_ref, dth_c, origin[None],
                       ranges[None], guess_pose[None], n_levels)


@entry_point(static=("grid_cfg", "m_cfg", "n_levels", "scan_cfg"))
def match_with_pyramid(grid_cfg: GridConfig, scan_cfg: ScanConfig,
                       m_cfg: MatcherConfig, n_levels: int, levels,
                       origin: torch.Tensor, ranges: torch.Tensor,
                       guess_pose: torch.Tensor) -> MatchResult:
    """The pruned match against a prebuilt pyramid in one call: the same
    result as `match` on the grid the pyramid was built from, bit for
    bit."""
    full_f32()
    return _match_bnb(grid_cfg, scan_cfg, m_cfg, levels, origin[None],
                      ranges[None], guess_pose[None], n_levels)
