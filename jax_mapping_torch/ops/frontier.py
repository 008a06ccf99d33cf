"""Frontier detection, clustering, cost-to-go and fleet assignment.

Port of the JAX package's `ops/frontier.py`: hierarchical clustering
(`cluster_downsample` > 1) or single-level; obstacle-aware costs from
multigrid fields (`ops/costfield.py`), from one exact min-plus field per
robot (`exact_bfs`, `cost_to_go`) or Euclidean ones; the decay-aware
discount (`decay_aware`, `stale_mask`); the crop and warm-start
arguments the incremental publish uses (`ops/frontier_incremental.py`);
and the planned steering waypoints (`assigned_waypoints`).

Kernel K2 (`csrc/label_prop.cu`, wrapped by `label_prop`) replaces the
Pallas kernel `_label_prop_pallas`; `_label_prop_plain` (sweeps of
`_neighbor_max_sweep`) is its plain PyTorch version. `cost_to_go` runs
its sweeps on kernel K3 (`costfield.relax_sweeps`) on a CUDA tensor and
on `costfield._relax_once` on the CPU.

The tenant megabatch runs the pipeline over T grids at once: (T, N, N)
log-odds and (T, R, 3) poses give a `FrontierResult` whose every field
has a leading T, with one K2 launch and one K3 launch a level for all
tenants, and the auction run for every tenant in lockstep. Every option
runs batched (`exact_bfs`: one K3 launch for all T * R fields, each under
its own mask; `decay_aware`; `planned_goals` through
`assigned_waypoints`); only the incremental publish's crop and warm-start
arguments stay one grid at a time (`_refuse_batched`).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from jax_mapping_torch._util import const, div, entry_point, shift2d
from jax_mapping_torch.config import FrontierConfig, GridConfig
from jax_mapping_torch.obs import ledger
from jax_mapping_torch.ops import _cuda
from jax_mapping_torch.ops import costfield as CF
from jax_mapping_torch.utils.profiling import span

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
    if x.shape[-2] % c or x.shape[-1] % c:
        raise ValueError(f"shape {tuple(x.shape)} not divisible by pool "
                         f"factor {c}")


def _blocks(x: torch.Tensor, c: int) -> torch.Tensor:
    *lead, n0, n1 = x.shape
    return x.reshape(*lead, n0 // c, c, n1 // c, c)


def coarsen(cfg: FrontierConfig, grid_cfg: GridConfig, logodds: torch.Tensor):
    """Full-res (..., N, N) log-odds -> coarse (free, occupied, unknown)
    masks: a coarse cell is occupied if any child is, free if any child
    is free and none occupied, else unknown."""
    d = cfg.downsample
    _check_pool_divisible(logodds, d)
    blk = _blocks(logodds, d)
    any_occ = blk.amax(dim=(-3, -1)) > grid_cfg.occ_threshold
    any_free = blk.amin(dim=(-3, -1)) < grid_cfg.free_threshold
    free = any_free & ~any_occ
    unknown = ~any_occ & ~any_free
    return free, any_occ, unknown


def frontier_mask(free: torch.Tensor, unknown: torch.Tensor) -> torch.Tensor:
    """Free cells with a 4-neighbour unknown cell."""
    near = (shift2d(unknown, 1, 0, False) | shift2d(unknown, -1, 0, False)
            | shift2d(unknown, 0, 1, False) | shift2d(unknown, 0, -1, False))
    return free & near


#: Evidence floor below which a cell counts as never observed: map decay
#: shrinks log-odds toward 0 but never reaches it.
_STALE_EPS = 1e-4


def stale_mask(cfg: FrontierConfig, grid_cfg: GridConfig,
               logodds: torch.Tensor) -> torch.Tensor:
    """Coarse (n, n) bool mask of healed cells: unknown to `coarsen` yet
    holding residual non-zero log-odds (what decay leaves behind). Fresh
    unknown space (exact 0.0) never flags."""
    d = cfg.downsample
    _check_pool_divisible(logodds, d)
    blk = _blocks(logodds, d)
    unknown = ~(blk.amax(dim=(-3, -1)) > grid_cfg.occ_threshold) \
        & ~(blk.amin(dim=(-3, -1)) < grid_cfg.free_threshold)
    return unknown & (blk.abs().amax(dim=(-3, -1)) > _STALE_EPS)


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
    """2 * iters + 1 label sweeps of an (n, n) grid, or of T grids
    (T, n, n) each under its own mask: the plain version on a CPU tensor,
    kernel K2 on a CUDA tensor (one launch for all T grids).

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
    """Kernel K2 on CUDA tensors: `n_sweeps` sweeps of an (n, n) grid or
    of (T, n, n) grids, grid t under mask t, in one launch -> (labels,
    how it ran). The launcher chooses the route and cluster size by size;
    the route and counts are `_cuda.sweep_call`'s."""
    if mask.dim() not in (2, 3):
        raise ValueError(f"mask must be (n, n) or (T, n, n), got "
                         f"{tuple(mask.shape)}")
    shape = tuple(mask.shape)
    T = shape[0] if mask.dim() == 3 else 1
    n = shape[-1]
    m = _cuda.mask_bytes(mask)
    seed = seed.to(torch.int32).contiguous()
    _cuda.check_cuda(m, "mask", torch.uint8, shape)
    _cuda.check_cuda(seed, "seed", torch.int32, shape)
    out, scratch = torch.empty((2, *shape), dtype=torch.int32,
                               device=seed.device)              # one alloc
    ran = _cuda.sweep_call("label_prop", _cuda.ptr(m), _cuda.ptr(seed),
                           _cuda.ptr(out), _cuda.ptr(scratch), T, n,
                           n_sweeps)
    _cuda.note_cost("label_prop",
                    lambda: ledger.label_prop_cost(mask, n_sweeps))
    return out, ran


def label_components(cfg: FrontierConfig, mask: torch.Tensor) -> torch.Tensor:
    """8-connected components of an (..., n, n) mask: every mask cell
    takes the max linear index of its grid reachable within
    `2 * label_prop_iters + 1` sweeps."""
    n = mask.shape[-1]
    lin = torch.arange(n * n, dtype=torch.int32,
                       device=mask.device).reshape(n, n)
    seed = torch.where(mask, lin, -1).to(torch.int32)
    return label_prop(mask, seed, cfg.label_prop_iters)


# ---------------------------------------------------------------------------
# Cluster summarisation
# ---------------------------------------------------------------------------

def _top_k(x: torch.Tensor, k: int):
    """jax.lax.top_k order along the last axis: descending, the lower
    index first among equal values (a stable sort; torch.topk promises no
    order on ties)."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def summarize_clusters(cfg: FrontierConfig, grid_cfg: GridConfig,
                       labels: torch.Tensor, origin_rc=None):
    """Top-K clusters of `labels` by size -> (centroids (K, 2), targets
    (K, 2), sizes (K,), slot_of_cell (n, n)); empty slots have size 0
    and centroid and target at _BIG. `origin_rc` as in `_summarize`."""
    return tuple(x[0] for x in _summarize(cfg, grid_cfg, labels[None],
                                          weights=None, scale=1,
                                          origin_rc=origin_rc)[:4])


def _summarize(cfg: FrontierConfig, grid_cfg: GridConfig,
               labels: torch.Tensor, weights, scale: int, origin_rc=None):
    """Top-K clusters of each of T label grids (T, n, n) -> (centroids
    (T, K, 2), targets (T, K, 2), sizes (T, K), slot_of_cell (T, n, n),
    rep_rc (T, K, 2)).

    `origin_rc`: the (row, col) of `labels`' first-level coarse cell
    [0, 0] in the full coarse grid (a crop), a multiple of `scale`, as
    ints or an integer tensor. Cell coordinates become global before the
    world-metre conversion, so a crop's targets and centroids are the
    full grid's; slot order, tie-breaks and `rep_rc` stay local (cropping
    keeps row-major order).

    Per-slot sums are segment sums, accumulated in float64: they are sums
    of integers, so they are exact in any order and equal the JAX
    package's dense HIGHEST-precision product wherever that is exact.
    Grid t's segments are offset by t, so one index_add serves all."""
    T, n = labels.shape[0], labels.shape[-1]
    nn = n * n
    K = cfg.max_clusters
    dev = labels.device
    flat = labels.reshape(T, nn).to(torch.int64)
    present = flat >= 0
    w = (present.to(torch.int64) if weights is None
         else torch.where(present, weights.reshape(T, nn).to(torch.int64),
                          0))
    lin = torch.arange(nn, device=dev)
    t_off = torch.arange(T, device=dev)[:, None]
    is_rep = present & (flat == lin)
    seg_all = flat.clamp_min(0)
    sizes_by_cell = torch.zeros(T * nn, dtype=torch.int64,
                                device=dev).index_add_(
        0, (seg_all + t_off * nn).reshape(-1), w.reshape(-1)).reshape(T, nn)
    rep_sizes = torch.where(is_rep, sizes_by_cell, 0)
    rep_sizes = torch.where(rep_sizes >= cfg.min_cluster_cells, rep_sizes, 0)

    top_sizes, top_idx = _top_k(rep_sizes, K)
    slot_valid = top_sizes > 0

    rows = torch.div(lin, n, rounding_mode="floor")
    cols = lin - rows * n
    row_off = col_off = 0
    if origin_rc is not None:
        row_off = origin_rc[0] // scale
        col_off = origin_rc[1] // scale
    rows_g = rows + row_off
    cols_g = cols + col_off
    slot_of_label = torch.full((T, nn), -1, dtype=torch.int64, device=dev)
    slot_of_label.scatter_(1, top_idx, torch.where(
        slot_valid, torch.arange(K, device=dev), -1))
    slot_of_cell = torch.where(present, slot_of_label.gather(1, seg_all), -1)
    sel = slot_of_cell >= 0
    seg = slot_of_cell.clamp_min(0)
    seg_t = (seg + t_off * K).reshape(-1)
    wf = torch.where(sel, w, 0).to(torch.float64)
    sums = torch.zeros((3, T * K), dtype=torch.float64, device=dev)
    sums[0].index_add_(0, seg_t, wf.reshape(-1))
    sums[1].index_add_(0, seg_t, (wf * rows_g.to(torch.float64)).reshape(-1))
    sums[2].index_add_(0, seg_t, (wf * cols_g.to(torch.float64)).reshape(-1))
    cnt, sr, sc = sums.to(torch.float32).reshape(3, T, K)
    cnt_safe = torch.clamp_min(cnt, 1.0)
    c_row = sr / cnt_safe
    c_col = sc / cnt_safe

    res = grid_cfg.resolution_m * cfg.downsample * scale
    ox, oy = grid_cfg.origin_m
    cx = (c_col + 0.5) * res + ox
    cy = (c_row + 0.5) * res + oy
    centroids = torch.where(slot_valid[..., None],
                            torch.stack([cx, cy], -1), _BIG)

    rows_f = rows_g.to(torch.float32)
    cols_f = cols_g.to(torch.float32)
    dr = rows_f - c_row.gather(1, seg)
    dc = cols_f - c_col.gather(1, seg)
    d2 = dr * dr + dc * dc
    inf = torch.full((T, K), float("inf"), device=dev)
    min_d2 = inf.scatter_reduce(1, seg, torch.where(sel, d2, float("inf")),
                                reduce="amin", include_self=True)
    is_best = sel & (d2 <= min_d2.gather(1, seg) + 0.5)
    rep_lin = torch.full((T, K), nn, dtype=torch.int64, device=dev
                         ).scatter_reduce(1, seg,
                                          torch.where(is_best, lin, nn),
                                          reduce="amin", include_self=True)
    has_rep = rep_lin < nn
    rep_lin = rep_lin.clamp(0, nn - 1)
    rep_row = torch.div(rep_lin, n, rounding_mode="floor")
    rep_col = rep_lin - rep_row * n
    tx = ((rep_col + col_off).to(torch.float32) + 0.5) * res + ox
    ty = ((rep_row + row_off).to(torch.float32) + 0.5) * res + oy
    targets = torch.where((slot_valid & has_rep)[..., None],
                          torch.stack([tx, ty], -1), _BIG)
    rep_rc = torch.stack([rep_row, rep_col], -1)
    return (centroids, targets, top_sizes.to(torch.int32),
            slot_of_cell.reshape(T, n, n).to(torch.int32), rep_rc)


def _pool_any(x: torch.Tensor, c: int) -> torch.Tensor:
    _check_pool_divisible(x, c)
    return _blocks(x, c).any(dim=-1).any(dim=-2)


def _pool_sum(x: torch.Tensor, c: int) -> torch.Tensor:
    _check_pool_divisible(x, c)
    return _blocks(x.to(torch.int32), c).sum(dim=(-3, -1),
                                              dtype=torch.int32)


def _upsample(x: torch.Tensor, c: int) -> torch.Tensor:
    return x.repeat_interleave(c, dim=-2).repeat_interleave(c, dim=-1)


def _cluster_hierarchical(cfg: FrontierConfig, grid_cfg: GridConfig,
                          mask: torch.Tensor, origin_rc=None):
    """Components and slots of T (T, n, n) masks at `cluster_downsample`x
    coarser resolution, weighted by fine frontier-cell counts; each slot's
    target refined to a real fine frontier cell inside its representative
    block. `origin_rc` as in `_summarize`."""
    c = cfg.cluster_downsample
    T = mask.shape[0]
    with span("frontier.labels"):
        mask2 = _pool_any(mask, c)
        w2 = _pool_sum(mask, c)
        cfg_c = dataclasses.replace(
            cfg, label_prop_iters=max(1, -(-cfg.label_prop_iters // c)))
        labels2 = label_components(cfg_c, mask2)
    with span("frontier.clusters"):
        centroids, targets2, sizes, slots2, rep_rc = _summarize(
            cfg, grid_cfg, labels2, weights=w2, scale=c, origin_rc=origin_rc)

        res1 = grid_cfg.resolution_m * cfg.downsample
        ox, oy = grid_cfg.origin_m
        ar = torch.arange(c, device=mask.device)
        tt = torch.arange(T, device=mask.device)[:, None, None, None]
        rr = rep_rc[..., 0, None] * c + ar                         # (T, K, c)
        cc = rep_rc[..., 1, None] * c + ar
        win = mask[tt, rr[..., :, None], cc[..., None, :]].reshape(
            T, -1, c * c)
        idx = torch.argmax(win.to(torch.uint8), dim=-1)            # first True
        any_fine = win.any(dim=-1)
        fr = rep_rc[..., 0] * c + torch.div(idx, c, rounding_mode="floor")
        fc = rep_rc[..., 1] * c + idx % c
        if origin_rc is not None:
            fr = fr + origin_rc[0]
            fc = fc + origin_rc[1]
        fine = torch.stack([(fc.to(torch.float32) + 0.5) * res1 + ox,
                            (fr.to(torch.float32) + 0.5) * res1 + oy], -1)
        targets = torch.where(any_fine[..., None], fine, targets2)
        targets = torch.where((sizes > 0)[..., None], targets, _BIG)

        labels = torch.where(mask, _upsample(labels2, c), -1)
        slots = torch.where(mask, _upsample(slots2, c), -1)
        return labels, slots, centroids, targets, sizes, rep_rc, mask2


# ---------------------------------------------------------------------------
# Obstacle-aware cost-to-go (min-plus dilation, kernel K3) and descent
# ---------------------------------------------------------------------------

def _to_int32(x: torch.Tensor) -> torch.Tensor:
    """float -> int32 truncation that saturates out of range, as XLA's
    conversion does (PyTorch's CPU conversion wraps _BIG to INT_MIN)."""
    return x.clamp(-2.0 ** 31, 2147483520.0).to(torch.int32)


def cost_to_go(cfg: FrontierConfig, passable: torch.Tensor,
               seeds_rc: torch.Tensor, seed_valid: torch.Tensor,
               relax=CF.sweeps) -> torch.Tensor:
    """(n, n) distance field in coarse cells from the valid seeds
    (seeds_rc (S, 2)) through passable space: 2 * bfs_iters + 1 sweeps of
    the 8-neighbour min-plus relaxation. A valid seed's own cell is
    unblocked, so a seed hugging a wall still radiates.

    Batched: (F, n, n) passable masks with (F, S, 2) seeds and (F, S)
    flags give F fields, field f from its own seeds under its own mask
    (its seed cells unblocked in it alone), in one `relax` call.

    `relax` runs the sweeps: by default kernel K3 on a CUDA tensor (one
    launch, a mask per field) and the plain version on the CPU;
    `costfield._relax_sweeps_plain` runs the plain version on any
    device, which is how the card holds the kernel against it."""
    one = passable.dim() == 2
    if one:
        passable, seeds_rc, seed_valid = (passable[None], seeds_rc[None],
                                          seed_valid[None])
    nf, n = passable.shape[0], passable.shape[-1]
    rr = seeds_rc[..., 0].clamp(0, n - 1).long()
    cc = seeds_rc[..., 1].clamp(0, n - 1).long()
    f_off = torch.arange(nf, device=passable.device)[:, None] * (n * n)
    lin = (f_off + rr * n + cc).reshape(-1)
    valid = seed_valid.expand(rr.shape).reshape(-1)
    dist = torch.full((nf * n * n,), _BIG, device=passable.device)
    dist = dist.scatter_reduce(0, lin, torch.where(valid, 0.0, _BIG),
                               reduce="amin", include_self=True)
    blocked = (~passable).reshape(-1).clone()
    blocked[lin] = torch.where(valid, False, blocked[lin])
    blocked = blocked.reshape(nf, n, n)
    init = torch.where(blocked, _BIG, dist.reshape(nf, n, n))
    d = relax(blocked, init, 2 * cfg.bfs_iters + 1)
    return d[0] if one else d


#: 3 x 3 neighbourhood offsets in row-major order: index k of a patch's
#: argmin is the step D8[k].
_D8 = ((-1, -1), (-1, 0), (-1, 1), (0, -1), (0, 0), (0, 1),
       (1, -1), (1, 0), (1, 1))
D8 = torch.tensor(_D8, dtype=torch.int32)


def _patch3(padded: torch.Tensor, rc: torch.Tensor) -> torch.Tensor:
    """The 3 x 3 patch of a field padded by 1 whose corner is rc, read
    by tensor indices (no host sync): (n + 2, n + 2) with rc (2,) gives
    (3, 3); (B, n + 2, n + 2) with rc (B, 2) gives (B, 3, 3)."""
    ar = const((0, 1, 2), padded.device, torch.int64)
    r = rc[..., 0:1, None].long() + ar[:, None]
    c = rc[..., 1:2, None].long() + ar[None, :]
    if padded.dim() == 2:
        return padded[r, c]
    b = torch.arange(padded.shape[0], device=padded.device)[:, None, None]
    return padded[b, r, c]


def descent_step(padded_field: torch.Tensor, rc: torch.Tensor,
                 n: int) -> torch.Tensor:
    """One greedy descent step: to the argmin of rc's 3 x 3 neighbourhood
    in a field padded by 1 with _BIG, clipped into [0, n - 1]. The first
    minimum wins a tie, as in jnp.argmin, so at the goal (the field's
    minimum) the centre holds. Shared by the planner's descent and the
    fleet's waypoints; batched over a leading axis of both arguments."""
    patch = _patch3(padded_field, rc).flatten(-2)
    # keepdim: a 0-d index would be read on the host (a sync a step).
    k = torch.argmin(patch, dim=-1, keepdim=True)
    step = const(sum(_D8, ()), padded_field.device,
                 torch.int32).reshape(9, 2)[k].squeeze(-2)
    return (rc.to(torch.int32) + step).clamp(0, n - 1)


# ---------------------------------------------------------------------------
# Assignment
# ---------------------------------------------------------------------------

def assign_frontiers(costs: torch.Tensor) -> torch.Tensor:
    """Greedy auction in robot order: each robot claims its cheapest
    untaken cluster (taken ones cost +1e6), -1 when nothing is reachable.
    (R, K) costs give (R,); (T, R, K) give (T, R), every tenant's robot r
    claiming in the same step. Indices stay on the device: no host
    sync."""
    c3 = costs if costs.dim() == 3 else costs[None]
    T, R, K = c3.shape
    taken = torch.zeros((T, K), dtype=torch.bool, device=costs.device)
    out = []
    for r in range(R):
        c = torch.where(taken, c3[:, r] + 1e6, c3[:, r])
        best = torch.argmin(c, dim=1, keepdim=True)            # (T, 1)
        ok = c.gather(1, best) < _BIG
        taken.scatter_(1, best, taken.gather(1, best) | ok)
        out.append(torch.where(ok, best, -1)[:, 0])
    a = torch.stack(out, 1).to(torch.int32)
    return a if costs.dim() == 3 else a[0]


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

def _refuse_batched(**args) -> None:
    """The incremental publish's crop and warm-start arguments, which no
    entry point passes over a batch of grids: raise a ValueError that
    names the first one set."""
    for name, value in args.items():
        if value is not None and value is not False:
            raise ValueError(f"compute_frontiers_from_masks: `{name}` is "
                             "not supported over a batch of grids (the "
                             "tenant megabatch)")


@entry_point(static=("cfg", "grid_cfg"))
def compute_frontiers(cfg: FrontierConfig, grid_cfg: GridConfig,
                      logodds: torch.Tensor,
                      robot_poses: torch.Tensor) -> FrontierResult:
    """(N, N) log-odds + (R, 3) poses -> frontiers, clusters, assignment;
    (T, N, N) + (T, R, 3) -> the same with a leading T on every field.
    With `decay_aware` the stale mask comes from the raw log-odds (the
    masks alone cannot tell healed from fresh unknown)."""
    free, _occ, unknown = coarsen(cfg, grid_cfg, logodds)
    stale = stale_mask(cfg, grid_cfg, logodds) if cfg.decay_aware else None
    return compute_frontiers_from_masks(cfg, grid_cfg, free, unknown,
                                        robot_poses, stale=stale)


def _gather_costs(fields: torch.Tensor, tgt_r: torch.Tensor,
                  tgt_c: torch.Tensor) -> torch.Tensor:
    """(T, R, n, n) fields at each tenant's (T, K) target cells ->
    (T, R, K)."""
    T, R = fields.shape[:2]
    dev = fields.device
    return fields[torch.arange(T, device=dev)[:, None, None],
                  torch.arange(R, device=dev)[None, :, None],
                  tgt_r[:, None, :], tgt_c[:, None, :]]


def compute_frontiers_from_masks(cfg: FrontierConfig, grid_cfg: GridConfig,
                                 free: torch.Tensor, unknown: torch.Tensor,
                                 robot_poses: torch.Tensor, origin_rc=None,
                                 warm_fields=None,
                                 warm_iters: int | None = None,
                                 return_fields: bool = False,
                                 stale=None):
    """Mask-level entry point.

    origin_rc: the masks are a crop whose [0, 0] is this first-level
    coarse cell of the full grid (ints or an integer tensor, a multiple of
    cluster_downsample); targets and centroids come out global, masks,
    labels and slots crop-shaped.
    warm_fields: (R, n_bfs, n_bfs) previous cost fields, relaxed from an
    offset warm start (`costfield.warm_cost_fields`) instead of the
    multigrid solve; valid only while no blocked cell appeared since.
    warm_iters: that relaxation's doubled sweeps (None: warm_extra_iters;
    0: re-mask and re-seed only, exact when the blocked mask and every
    seed cell are unchanged).
    return_fields: return (result, fields or None, BFS blocked mask).
    stale: (n, n) bool healed mask (`stale_mask`); with `decay_aware`
    each slot's finite cost is scaled by 1 - stale_bonus x the stale
    share of its target's 3 x 3 clustering-cell neighbourhood.
    With every argument at its default this is the plain full-grid
    computation. (T, n, n) masks, (T, R, 3) poses and a (T, n, n) stale
    mask run T grids at once (the tenant megabatch), with every option;
    the crop and warm-start arguments take one grid."""
    batched = free.dim() == 3
    if batched:
        _refuse_batched(origin_rc=origin_rc, warm_fields=warm_fields,
                        warm_iters=warm_iters, return_fields=return_fields)
        if stale is not None and stale.shape != free.shape:
            raise ValueError(f"compute_frontiers_from_masks: `stale` "
                             f"{tuple(stale.shape)} over a batch of grids "
                             f"must match the masks {tuple(free.shape)}")
    else:
        free, unknown, robot_poses = free[None], unknown[None], \
            robot_poses[None]
        stale = None if stale is None else stale[None]
    mask = frontier_mask(free, unknown)
    c = cfg.cluster_downsample
    res = grid_cfg.resolution_m * cfg.downsample
    ox, oy = grid_cfg.origin_m
    n = free.shape[-1]
    with span("frontier.costs"):
        bfs_passable, bfs_res = bfs_passability(cfg, grid_cfg, free,
                                                unknown, mask)
    if c == 1:
        with span("frontier.labels"):
            labels = label_components(cfg, mask)
        with span("frontier.clusters"):
            centroids, targets, sizes, slots, _ = _summarize(
                cfg, grid_cfg, labels, weights=None, scale=1,
                origin_rc=origin_rc)
            tgt_r = _to_int32(div(targets[..., 1] - oy, res))
            tgt_c = _to_int32(div(targets[..., 0] - ox, res))
            if origin_rc is not None:
                tgt_r = tgt_r - origin_rc[0]
                tgt_c = tgt_c - origin_rc[1]
            tgt_r = tgt_r.clamp(0, n - 1)
            tgt_c = tgt_c.clamp(0, n - 1)
        bfs_scale = 1.0
    else:
        labels, slots, centroids, targets, sizes, rep_rc, _ = \
            _cluster_hierarchical(cfg, grid_cfg, mask, origin_rc=origin_rc)
        tgt_r, tgt_c = rep_rc[..., 0], rep_rc[..., 1]
        bfs_scale = float(c)
    tgt_r, tgt_c = tgt_r.long(), tgt_c.long()                  # (T, K)

    def to_bfs_rc(y, x):
        rr = div(y, bfs_res).to(torch.int32)
        cc = div(x, bfs_res).to(torch.int32)
        if origin_rc is not None:
            rr = rr - origin_rc[0] // c
            cc = cc - origin_rc[1] // c
        return rr, cc

    fields = None
    if cfg.obstacle_aware:
        rr, cc = to_bfs_rc(robot_poses[..., 1] - oy,
                           robot_poses[..., 0] - ox)           # (T, R)
        if cfg.exact_bfs:
            # One K3 launch for every tenant's robots: field (t, r) under
            # mask t with robot r's own seed cell unblocked.
            bfs_cfg = (cfg if c == 1 else dataclasses.replace(
                cfg, bfs_iters=max(1, -(-cfg.bfs_iters // c))))
            T, R = rr.shape
            nb = bfs_passable.shape[-1]
            with span("frontier.costs"):
                exact = cost_to_go(
                    bfs_cfg, bfs_passable[:, None].expand(T, R, nb, nb)
                    .reshape(T * R, nb, nb),
                    torch.stack([rr, cc], -1).reshape(T * R, 1, 2),
                    torch.ones((T * R, 1), dtype=torch.bool,
                               device=free.device))
            costs = _gather_costs(exact.reshape(T, R, nb, nb), tgt_r,
                                  tgt_c) * bfs_scale
        else:
            robot_rc = torch.stack([rr, cc], dim=-1)           # (T, R, 2)
            with span("frontier.costs"):
                if warm_fields is not None:
                    fields = CF.warm_cost_fields(
                        ~bfs_passable[0], robot_rc[0], warm_fields,
                        cfg.warm_extra_iters if warm_iters is None
                        else warm_iters)[None]
                elif batched:
                    fields = CF.cost_fields(~bfs_passable, robot_rc,
                                            cfg.mg_levels, cfg.mg_refine_iters)
                else:
                    fields = CF.cost_fields(~bfs_passable[0], robot_rc[0],
                                            cfg.mg_levels,
                                            cfg.mg_refine_iters)[None]
            costs = _gather_costs(fields, tgt_r, tgt_c) * bfs_scale
        costs = torch.clamp_max(costs, _BIG)
    else:
        diff = targets[:, None, :, :] - robot_poses[:, :, None, :2]
        costs = div(torch.linalg.vector_norm(diff, dim=-1), res)
        costs = torch.where(torch.isfinite(costs), costs, _BIG)
        costs = torch.clamp_max(costs, _BIG)
    if cfg.decay_aware and stale is not None:
        sb = (_pool_sum(stale, c).to(torch.float32) / float(c * c)
              if c > 1 else stale.to(torch.float32))
        padded = torch.nn.functional.pad(sb, (1, 1, 1, 1))
        # Each tenant's (K, 3, 3) neighbourhoods of its targets. The
        # stale shares are multiples of 1 / c^2, so their sum is exact in
        # any order.
        ar = const((0, 1, 2), padded.device, torch.int64)
        tt = torch.arange(padded.shape[0], device=padded.device)
        frac = padded[tt[:, None, None, None],
                      tgt_r[..., None, None] + ar[:, None],
                      tgt_c[..., None, None] + ar[None, :]
                      ].sum(dim=(-2, -1)) / 9.0                # (T, K)
        bonus = frac.new_full((), cfg.stale_bonus)
        scale = (1.0 - bonus * frac.clamp(0.0, 1.0))[:, None, :]
        # Only finite costs discount: a scaled _BIG would pass the
        # auction's `< _BIG` gate.
        costs = torch.where(costs < _BIG, costs * scale, costs)
    costs = torch.where((sizes > 0)[:, None, :], costs, _BIG)
    with span("frontier.assign"):
        assignment = assign_frontiers(costs)
    result = FrontierResult(mask=mask, labels=labels, slots=slots,
                            centroids=centroids, targets=targets,
                            sizes=sizes, assignment=assignment, costs=costs)
    if batched:
        return result
    result = FrontierResult(*(x[0] for x in result))
    if return_fields:
        return result, None if fields is None else fields[0], \
            ~bfs_passable[0]
    return result


# ---------------------------------------------------------------------------
# Planned steering waypoints (FrontierConfig.planned_goals)
# ---------------------------------------------------------------------------

def assigned_waypoints_from_masks(cfg: FrontierConfig, grid_cfg: GridConfig,
                                  free: torch.Tensor, unknown: torch.Tensor,
                                  robot_poses: torch.Tensor,
                                  targets: torch.Tensor,
                                  assignment: torch.Tensor):
    """Per-robot steering waypoints toward the assigned targets: one
    multigrid cost field per robot seeded at its target's cell (K3, the
    passability the assignment used), descended `waypoint_lookahead`
    steps from the robot's cell. Returns (waypoints_xy (R, 2), valid
    (R,)); invalid where unassigned, unreachable or not moved.

    (T, n, n) masks with (T, R, 3) poses, (T, K, 2) targets and (T, R)
    assignments give (T, R, 2) and (T, R): one `cost_fields` call over
    the T * R fields (a K3 launch a level) and one descent for all."""
    batched = free.dim() == 3
    if not batched:
        free, unknown, robot_poses, targets, assignment = (
            x[None] for x in (free, unknown, robot_poses, targets,
                              assignment))
    mask = frontier_mask(free, unknown)
    ox, oy = grid_cfg.origin_m
    bfs_passable, bfs_res = bfs_passability(cfg, grid_cfg, free, unknown,
                                            mask)
    T, R = assignment.shape
    n2 = bfs_passable.shape[-1]

    def to_rc(xy):
        return torch.stack(
            [_to_int32(div(xy[..., 1] - oy, bfs_res)).clamp(0, n2 - 1),
             _to_int32(div(xy[..., 0] - ox, bfs_res)).clamp(0, n2 - 1)], -1)

    a = assignment.long().clamp_min(0)
    t_xy = torch.gather(targets, 1, a[..., None].expand(T, R, 2))
    seeds_rc = to_rc(t_xy)                                     # (T, R, 2)
    robot_rc = to_rc(robot_poses[..., :2]).reshape(T * R, 2)
    fields = CF.cost_fields(~bfs_passable, seeds_rc, cfg.mg_levels,
                            cfg.mg_refine_iters)          # (T, R, n2, n2)
    padded = torch.nn.functional.pad(
        fields.reshape(T * R, n2, n2), (1, 1, 1, 1), value=_BIG)
    rc = robot_rc
    for _ in range(cfg.waypoint_lookahead):
        rc = descent_step(padded, rc, n2)
    start_min = _patch3(padded, robot_rc).amin(dim=(1, 2))
    wp_xy = torch.stack([(rc[:, 1].to(torch.float32) + 0.5) * bfs_res + ox,
                         (rc[:, 0].to(torch.float32) + 0.5) * bfs_res + oy],
                        1).reshape(T, R, 2)
    moved = (rc != robot_rc).any(dim=1).reshape(T, R)
    valid = (assignment >= 0) & (start_min < _BIG).reshape(T, R) & moved
    return (wp_xy, valid) if batched else (wp_xy[0], valid[0])


def assigned_waypoints(cfg: FrontierConfig, grid_cfg: GridConfig,
                       logodds: torch.Tensor, robot_poses: torch.Tensor,
                       targets: torch.Tensor, assignment: torch.Tensor):
    """`assigned_waypoints_from_masks` from a raw log-odds grid, or from
    T grids (T, N, N) with the batched arguments."""
    free, _occ, unknown = coarsen(cfg, grid_cfg, logodds)
    return assigned_waypoints_from_masks(cfg, grid_cfg, free, unknown,
                                         robot_poses, targets, assignment)
