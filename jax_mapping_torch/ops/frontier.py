"""Frontier detection, clustering and fleet assignment.

Port of the JAX package's `ops/frontier.py` for the branches the fleet
tick runs by default: hierarchical clustering (`cluster_downsample` > 1)
or single-level, obstacle-aware multigrid costs (`ops/costfield.py`) or
Euclidean ones. The `exact_bfs`, `decay_aware` and `planned_goals`
options raise NotImplementedError until a later slice ports them.

Kernel K2 (`csrc/label_prop.cu`, wrapped by `label_prop`) replaces the
Pallas kernel `_label_prop_pallas`; `_label_prop_plain` (sweeps of
`_neighbor_max_sweep`) is its plain PyTorch version.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from jax_mapping_torch._util import div, shift2d
from jax_mapping_torch.config import FrontierConfig, GridConfig
from jax_mapping_torch.ops import _cuda
from jax_mapping_torch.ops import costfield as CF

_BIG = 1e9


class FrontierResult(NamedTuple):
    mask: torch.Tensor        # (n, n) bool frontier cells
    labels: torch.Tensor      # (n, n) int32 component id, -1 none
    slots: torch.Tensor       # (n, n) int32 top-K slot per cell, -1 none
    centroids: torch.Tensor   # (K, 2) world-metre centroids
    targets: torch.Tensor     # (K, 2) world-metre goal cells
    sizes: torch.Tensor       # (K,) int32 cells per cluster, 0 = empty
    assignment: torch.Tensor  # (R,) int32 cluster per robot, -1 none
    costs: torch.Tensor       # (R, K) robot -> cluster travel cost (cells)


# ---------------------------------------------------------------------------
# Downsample + frontier mask
# ---------------------------------------------------------------------------

def _check_pool_divisible(x: torch.Tensor, c: int) -> None:
    if x.shape[0] % c or x.shape[1] % c:
        raise ValueError(f"shape {tuple(x.shape)} not divisible by pool "
                         f"factor {c}")


def _blocks(x: torch.Tensor, c: int) -> torch.Tensor:
    n0, n1 = x.shape
    return x.reshape(n0 // c, c, n1 // c, c)


def coarsen(cfg: FrontierConfig, grid_cfg: GridConfig, logodds: torch.Tensor):
    """Full-res log-odds -> coarse (free, occupied, unknown) masks: a
    coarse cell is occupied if any child is, free if any child is free
    and none occupied, else unknown."""
    d = cfg.downsample
    _check_pool_divisible(logodds, d)
    blk = _blocks(logodds, d)
    any_occ = blk.amax(dim=(1, 3)) > grid_cfg.occ_threshold
    any_free = blk.amin(dim=(1, 3)) < grid_cfg.free_threshold
    free = any_free & ~any_occ
    unknown = ~any_occ & ~any_free
    return free, any_occ, unknown


def frontier_mask(free: torch.Tensor, unknown: torch.Tensor) -> torch.Tensor:
    """Free cells with a 4-neighbour unknown cell."""
    near = (shift2d(unknown, 1, 0, False) | shift2d(unknown, -1, 0, False)
            | shift2d(unknown, 0, 1, False) | shift2d(unknown, 0, -1, False))
    return free & near


# ---------------------------------------------------------------------------
# Connected components by label propagation (kernel K2)
# ---------------------------------------------------------------------------

def _neighbor_max_sweep(lab: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """One 8-neighbour max propagation sweep (-1 shifted in, -1 off mask)."""
    best = lab
    for dr in (-1, 0, 1):
        for dc in (-1, 0, 1):
            if dr == 0 and dc == 0:
                continue
            best = torch.maximum(best, shift2d(lab, dr, dc, -1))
    return torch.where(m, best, -1)


def _label_prop_plain(mask: torch.Tensor, seed: torch.Tensor,
                      iters: int) -> torch.Tensor:
    """Plain version of K2: exactly 2 * iters + 1 Jacobi sweeps."""
    lab = _neighbor_max_sweep(seed, mask)
    for _ in range(iters):
        lab = _neighbor_max_sweep(_neighbor_max_sweep(lab, mask), mask)
    return lab


def label_prop(mask: torch.Tensor, seed: torch.Tensor,
               iters: int) -> torch.Tensor:
    """2 * iters + 1 label sweeps of an (n, n) grid: the plain version on
    a CPU tensor, kernel K2 on a CUDA tensor.

    K2 replaces `jax_mapping/ops/frontier.py::_label_prop_pallas`. Every
    sweep reads the whole previous one, so the chain of sweeps and the
    hand-over between them bound it, not bytes or operations. The labels
    are one thread-block cluster whose CTAs keep row slabs in shared
    memory (at 256^2 the int32 labels, 256 KB, exceed one block's) and
    send their edge rows into the neighbours' shared memory (distributed
    shared memory): one launch a call.
    Grids too large for 16 CTAs' shared memory (n above about 600)
    ping-pong two global buffers that stay in L2, one launch a sweep."""
    if mask.device.type == "cpu":
        return _label_prop_plain(mask, seed, iters)
    return label_sweeps(mask, seed, 2 * iters + 1)[0]


def label_sweeps(mask: torch.Tensor, seed: torch.Tensor, n_sweeps: int):
    """Kernel K2 on CUDA tensors: `n_sweeps` sweeps -> (labels, how it
    ran). The launcher chooses the route and cluster size by size; the
    route and counts are `_cuda.sweep_call`'s."""
    n = mask.shape[0]
    m = _cuda.mask_bytes(mask)
    seed = seed.to(torch.int32).contiguous()
    _cuda.check_cuda(m, "mask", torch.uint8, (n, n))
    _cuda.check_cuda(seed, "seed", torch.int32, (n, n))
    out, scratch = torch.empty((2, n, n), dtype=torch.int32,
                               device=seed.device)              # one alloc
    ran = _cuda.sweep_call("label_prop", _cuda.ptr(m), _cuda.ptr(seed),
                           _cuda.ptr(out), _cuda.ptr(scratch), n, n_sweeps)
    return out, ran


def label_components(cfg: FrontierConfig, mask: torch.Tensor) -> torch.Tensor:
    """8-connected components: every mask cell takes the max linear index
    reachable within `2 * label_prop_iters + 1` sweeps."""
    n = mask.shape[0]
    lin = torch.arange(n * n, dtype=torch.int32,
                       device=mask.device).reshape(n, n)
    seed = torch.where(mask, lin, -1).to(torch.int32)
    return label_prop(mask, seed, cfg.label_prop_iters)


# ---------------------------------------------------------------------------
# Cluster summarisation
# ---------------------------------------------------------------------------

def _top_k(x: torch.Tensor, k: int):
    """jax.lax.top_k order: descending, the lower index first among equal
    values (a stable sort; torch.topk promises no order on ties)."""
    vals, idx = torch.sort(x, descending=True, stable=True)
    return vals[:k], idx[:k]


def _summarize(cfg: FrontierConfig, grid_cfg: GridConfig,
               labels: torch.Tensor, weights, scale: int):
    """Top-K clusters of `labels` -> (centroids, targets, sizes,
    slot_of_cell, rep_rc).

    Per-slot sums are segment sums, accumulated in float64: they are sums
    of integers, so they are exact in any order and equal the JAX
    package's dense HIGHEST-precision product wherever that is exact."""
    n = labels.shape[0]
    K = cfg.max_clusters
    dev = labels.device
    flat = labels.reshape(-1).to(torch.int64)
    present = flat >= 0
    w = (present.to(torch.int64) if weights is None
         else torch.where(present, weights.reshape(-1).to(torch.int64), 0))
    lin = torch.arange(n * n, device=dev)
    is_rep = present & (flat == lin)
    seg_all = flat.clamp_min(0)
    sizes_by_cell = torch.zeros(n * n, dtype=torch.int64,
                                device=dev).index_add_(0, seg_all, w)
    rep_sizes = torch.where(is_rep, sizes_by_cell, 0)
    rep_sizes = torch.where(rep_sizes >= cfg.min_cluster_cells, rep_sizes, 0)

    top_sizes, top_idx = _top_k(rep_sizes, K)
    slot_valid = top_sizes > 0

    rows = torch.div(lin, n, rounding_mode="floor")
    cols = lin - rows * n
    slot_of_label = torch.full((n * n,), -1, dtype=torch.int64, device=dev)
    slot_of_label[top_idx] = torch.where(
        slot_valid, torch.arange(K, device=dev), -1)
    slot_of_cell = torch.where(present, slot_of_label[seg_all], -1)
    sel = slot_of_cell >= 0
    seg = slot_of_cell.clamp_min(0)
    wf = torch.where(sel, w, 0).to(torch.float64)
    sums = torch.zeros((3, K), dtype=torch.float64, device=dev)
    sums[0].index_add_(0, seg, wf)
    sums[1].index_add_(0, seg, wf * rows.to(torch.float64))
    sums[2].index_add_(0, seg, wf * cols.to(torch.float64))
    cnt, sr, sc = sums.to(torch.float32)
    cnt_safe = torch.clamp_min(cnt, 1.0)
    c_row = sr / cnt_safe
    c_col = sc / cnt_safe

    res = grid_cfg.resolution_m * cfg.downsample * scale
    ox, oy = grid_cfg.origin_m
    cx = (c_col + 0.5) * res + ox
    cy = (c_row + 0.5) * res + oy
    centroids = torch.where(slot_valid[:, None], torch.stack([cx, cy], -1),
                            _BIG)

    rows_f = rows.to(torch.float32)
    cols_f = cols.to(torch.float32)
    dr = rows_f - c_row[seg]
    dc = cols_f - c_col[seg]
    d2 = dr * dr + dc * dc
    inf = torch.full((K,), float("inf"), device=dev)
    min_d2 = inf.scatter_reduce(0, seg, torch.where(sel, d2, float("inf")),
                                reduce="amin", include_self=True)
    is_best = sel & (d2 <= min_d2[seg] + 0.5)
    rep_lin = torch.full((K,), n * n, dtype=torch.int64, device=dev
                         ).scatter_reduce(0, seg,
                                          torch.where(is_best, lin, n * n),
                                          reduce="amin", include_self=True)
    has_rep = rep_lin < n * n
    rep_lin = rep_lin.clamp(0, n * n - 1)
    rep_row = torch.div(rep_lin, n, rounding_mode="floor")
    rep_col = rep_lin - rep_row * n
    tx = (rep_col.to(torch.float32) + 0.5) * res + ox
    ty = (rep_row.to(torch.float32) + 0.5) * res + oy
    targets = torch.where((slot_valid & has_rep)[:, None],
                          torch.stack([tx, ty], -1), _BIG)
    rep_rc = torch.stack([rep_row, rep_col], -1)
    return (centroids, targets, top_sizes.to(torch.int32),
            slot_of_cell.reshape(n, n).to(torch.int32), rep_rc)


def _pool_any(x: torch.Tensor, c: int) -> torch.Tensor:
    _check_pool_divisible(x, c)
    return _blocks(x, c).any(dim=3).any(dim=1)


def _pool_sum(x: torch.Tensor, c: int) -> torch.Tensor:
    _check_pool_divisible(x, c)
    return _blocks(x.to(torch.int32), c).sum(dim=(1, 3), dtype=torch.int32)


def _upsample(x: torch.Tensor, c: int) -> torch.Tensor:
    return x.repeat_interleave(c, dim=0).repeat_interleave(c, dim=1)


def _cluster_hierarchical(cfg: FrontierConfig, grid_cfg: GridConfig,
                          mask: torch.Tensor):
    """Components and slots at `cluster_downsample`x coarser resolution,
    weighted by fine frontier-cell counts; each slot's target refined to
    a real fine frontier cell inside its representative block."""
    c = cfg.cluster_downsample
    mask2 = _pool_any(mask, c)
    w2 = _pool_sum(mask, c)
    cfg_c = dataclasses.replace(
        cfg, label_prop_iters=max(1, -(-cfg.label_prop_iters // c)))
    labels2 = label_components(cfg_c, mask2)
    centroids, targets2, sizes, slots2, rep_rc = _summarize(
        cfg, grid_cfg, labels2, weights=w2, scale=c)

    res1 = grid_cfg.resolution_m * cfg.downsample
    ox, oy = grid_cfg.origin_m
    ar = torch.arange(c, device=mask.device)
    rr = rep_rc[:, 0, None] * c + ar                           # (K, c)
    cc = rep_rc[:, 1, None] * c + ar
    win = mask[rr[:, :, None], cc[:, None, :]].reshape(-1, c * c)
    idx = torch.argmax(win.to(torch.uint8), dim=1)             # first True
    any_fine = win.any(dim=1)
    fr = rep_rc[:, 0] * c + torch.div(idx, c, rounding_mode="floor")
    fc = rep_rc[:, 1] * c + idx % c
    fine = torch.stack([(fc.to(torch.float32) + 0.5) * res1 + ox,
                        (fr.to(torch.float32) + 0.5) * res1 + oy], -1)
    targets = torch.where(any_fine[:, None], fine, targets2)
    targets = torch.where((sizes > 0)[:, None], targets, _BIG)

    labels = torch.where(mask, _upsample(labels2, c), -1)
    slots = torch.where(mask, _upsample(slots2, c), -1)
    return labels, slots, centroids, targets, sizes, rep_rc, mask2


# ---------------------------------------------------------------------------
# Assignment
# ---------------------------------------------------------------------------

def assign_frontiers(costs: torch.Tensor) -> torch.Tensor:
    """Greedy auction in robot order: each robot claims its cheapest
    untaken cluster (taken ones cost +1e6), -1 when nothing is reachable."""
    R, K = costs.shape
    taken = torch.zeros(K, dtype=torch.bool, device=costs.device)
    out = []
    for r in range(R):
        c = torch.where(taken, costs[r] + 1e6, costs[r])
        best = torch.argmin(c)
        ok = c[best] < _BIG
        taken[best] = taken[best] | ok
        out.append(torch.where(ok, best, -1))
    return torch.stack(out).to(torch.int32)


def bfs_passability(cfg: FrontierConfig, grid_cfg: GridConfig,
                    free: torch.Tensor, unknown: torch.Tensor,
                    mask: torch.Tensor):
    """(passable, cell size) the obstacle-aware costs run at; pooled
    conservatively (any blocked child blocks) at cluster_downsample > 1."""
    passable = free | mask | unknown
    res = grid_cfg.resolution_m * cfg.downsample
    c = cfg.cluster_downsample
    if c == 1:
        return passable, res
    return ~_pool_any(~passable, c) | _pool_any(mask, c), res * c


# ---------------------------------------------------------------------------
# Full pipeline
# ---------------------------------------------------------------------------

def compute_frontiers(cfg: FrontierConfig, grid_cfg: GridConfig,
                      logodds: torch.Tensor,
                      robot_poses: torch.Tensor) -> FrontierResult:
    """(N, N) log-odds + (R, 3) poses -> frontiers, clusters, assignment."""
    if cfg.decay_aware:
        raise NotImplementedError("FrontierConfig.decay_aware is not "
                                  "ported yet")
    free, _occ, unknown = coarsen(cfg, grid_cfg, logodds)
    return compute_frontiers_from_masks(cfg, grid_cfg, free, unknown,
                                        robot_poses)


def compute_frontiers_from_masks(cfg: FrontierConfig, grid_cfg: GridConfig,
                                 free: torch.Tensor, unknown: torch.Tensor,
                                 robot_poses: torch.Tensor) -> FrontierResult:
    """Mask-level entry point (no crop, no warm start)."""
    if cfg.obstacle_aware and cfg.exact_bfs:
        raise NotImplementedError("FrontierConfig.exact_bfs is not ported "
                                  "yet")
    mask = frontier_mask(free, unknown)
    c = cfg.cluster_downsample
    res = grid_cfg.resolution_m * cfg.downsample
    ox, oy = grid_cfg.origin_m
    n = free.shape[0]
    bfs_passable, bfs_res = bfs_passability(cfg, grid_cfg, free, unknown,
                                            mask)
    if c == 1:
        labels = label_components(cfg, mask)
        centroids, targets, sizes, slots, _ = _summarize(
            cfg, grid_cfg, labels, weights=None, scale=1)
        tgt_r = div(targets[:, 1] - oy, res).to(torch.int32).clamp(0, n - 1)
        tgt_c = div(targets[:, 0] - ox, res).to(torch.int32).clamp(0, n - 1)
        bfs_scale = 1.0
    else:
        labels, slots, centroids, targets, sizes, rep_rc, _ = \
            _cluster_hierarchical(cfg, grid_cfg, mask)
        tgt_r, tgt_c = rep_rc[:, 0], rep_rc[:, 1]
        bfs_scale = float(c)

    if cfg.obstacle_aware:
        rr = div(robot_poses[:, 1] - oy, bfs_res).to(torch.int32)
        cc = div(robot_poses[:, 0] - ox, bfs_res).to(torch.int32)
        fields = CF.cost_fields(~bfs_passable, torch.stack([rr, cc], dim=1),
                                cfg.mg_levels, cfg.mg_refine_iters)
        costs = fields[:, tgt_r.long(), tgt_c.long()] * bfs_scale
        costs = torch.clamp_max(costs, _BIG)
    else:
        diff = targets[None, :, :] - robot_poses[:, None, :2]
        costs = div(torch.linalg.vector_norm(diff, dim=-1), res)
        costs = torch.where(torch.isfinite(costs), costs, _BIG)
        costs = torch.clamp_max(costs, _BIG)
    costs = torch.where((sizes > 0)[None, :], costs, _BIG)
    assignment = assign_frontiers(costs)
    return FrontierResult(mask=mask, labels=labels, slots=slots,
                          centroids=centroids, targets=targets, sizes=sizes,
                          assignment=assignment, costs=costs)
