"""The per-robot pose graphs and their Gauss-Newton solve: a frozen copy
of the port's `ops/posegraph.py`."""

from __future__ import annotations

from typing import NamedTuple

import torch

from ._util import const, entry_point, full_f32
from .config import LoopClosureConfig
from .odometry import (pose_between, pose_compose,
                                            wrap_angle)


class PoseGraph(NamedTuple):
    poses: torch.Tensor        # (R, N, 3) world poses
    pose_valid: torch.Tensor   # (R, N) bool
    n_poses: torch.Tensor      # (R,) int32 next free slot
    edge_ij: torch.Tensor      # (R, E, 2) int32 endpoints
    edge_meas: torch.Tensor    # (R, E, 3) relative pose of j in i's frame
    edge_weight: torch.Tensor  # (R, E, 3) information diag
    edge_valid: torch.Tensor   # (R, E) bool
    n_edges: torch.Tensor      # (R,) int32


def empty_graph(cfg: LoopClosureConfig, n_graphs: int, device) -> PoseGraph:
    R, N, E = n_graphs, cfg.max_poses, cfg.max_edges
    z = dict(device=device)
    return PoseGraph(
        poses=torch.zeros((R, N, 3), dtype=torch.float32, **z),
        pose_valid=torch.zeros((R, N), dtype=torch.bool, **z),
        n_poses=torch.zeros((R,), dtype=torch.int32, **z),
        edge_ij=torch.zeros((R, E, 2), dtype=torch.int32, **z),
        edge_meas=torch.zeros((R, E, 3), dtype=torch.float32, **z),
        edge_weight=torch.zeros((R, E, 3), dtype=torch.float32, **z),
        edge_valid=torch.zeros((R, E), dtype=torch.bool, **z),
        n_edges=torch.zeros((R,), dtype=torch.int32, **z),
    )


def select(flag: torch.Tensor, a: PoseGraph, b: PoseGraph) -> PoseGraph:
    """Per graph: a where flag[r] else b."""
    return PoseGraph(*(torch.where(flag.reshape((-1,) + (1,) * (x.dim() - 1)),
                                   x, y) for x, y in zip(a, b)))


def index(g: PoseGraph, r) -> PoseGraph:
    """The graphs at robot index (or index tensor) r."""
    return PoseGraph(*(x[r] for x in g))


def add_pose_if(g: PoseGraph, pose: torch.Tensor,
                enabled: torch.Tensor) -> PoseGraph:
    """Append pose[r] to graph r where enabled[r] and there is room."""
    R, N = g.pose_valid.shape
    rr = torch.arange(R, device=pose.device)
    i = g.n_poses.long()
    ok = enabled & (i < N)
    ic = i.clamp(max=N - 1)
    poses = g.poses.clone()
    valid = g.pose_valid.clone()
    poses[rr, ic] = torch.where(ok[:, None], pose, poses[rr, ic])
    valid[rr, ic] = torch.where(i < N, ok | valid[rr, ic], valid[rr, ic])
    return g._replace(poses=poses, pose_valid=valid,
                      n_poses=(i + ok.long()).to(torch.int32))


def add_edge_if(g: PoseGraph, i: torch.Tensor, j: torch.Tensor,
                meas: torch.Tensor, weight: torch.Tensor,
                enabled: torch.Tensor) -> PoseGraph:
    """Append edge (i[r] -> j[r], meas[r], weight) to graph r where
    enabled[r] and there is room."""
    R, E = g.edge_valid.shape
    rr = torch.arange(R, device=meas.device)
    e = g.n_edges.long()
    ok = enabled & (e < E)
    ec = e.clamp(max=E - 1)
    ij = torch.stack([i, j], -1).to(torch.int32)
    weight = weight.expand(R, 3)
    out = {}
    for name, new in (("edge_ij", ij), ("edge_meas", meas),
                      ("edge_weight", weight)):
        arr = getattr(g, name).clone()
        arr[rr, ec] = torch.where(ok[:, None], new.to(arr.dtype), arr[rr, ec])
        out[name] = arr
    valid = g.edge_valid.clone()
    valid[rr, ec] = torch.where(e < E, ok | valid[rr, ec], valid[rr, ec])
    return g._replace(edge_valid=valid,
                      n_edges=(e + ok.long()).to(torch.int32), **out)


def thin_keyframes(g: PoseGraph, scan_ring: torch.Tensor,
                   odo_weight_t: float = 50.0, odo_weight_th: float = 100.0):
    """Halve keyframe density of every graph: keep even-indexed poses and
    scans, rebuild the odometry chain between kept poses, keep long-range
    (and strong gap-1) edges remapped to the kept keyframe at-or-before
    each endpoint with their measurement adjusted by the estimated hop.
    Returns (thinned graphs, thinned (R, N, beams) rings)."""
    R, N, _ = g.poses.shape
    E = g.edge_ij.shape[1]
    dev = g.poses.device
    rr = torch.arange(R, device=dev)[:, None]
    n2 = torch.div(g.n_poses.long() + 1, 2, rounding_mode="floor")   # (R,)

    idx = torch.arange(N, device=dev)
    src = torch.clamp_max(2 * idx, N - 1)
    keep_slot = idx[None] < n2[:, None]
    poses2 = g.poses[:, src]
    valid2 = g.pose_valid[:, src] & keep_slot
    ring2 = scan_ring[:, src]

    m = torch.arange(E, device=dev)
    chain_on = m[None] < torch.clamp_min(n2 - 1, 0)[:, None]          # (R, E)
    ci = torch.clamp_max(m, N - 1)
    cj = torch.clamp_max(m + 1, N - 1)
    chain_meas = pose_between(poses2[:, ci], poses2[:, cj])           # (R,E,3)
    w_odo = const((odo_weight_t, odo_weight_t, odo_weight_th), dev)
    on = chain_on[..., None]
    edge_ij = torch.stack([ci, cj], 1)[None] * on
    edge_meas = chain_meas * on
    edge_weight = w_odo * on

    ij = g.edge_ij.long()
    gap = ij[..., 1] - ij[..., 0]
    strong = g.edge_weight[..., 2] > odo_weight_th
    is_loop = g.edge_valid & ((gap > 1) | ((gap == 1) & strong))
    i_new = torch.div(ij[..., 0], 2, rounding_mode="floor")
    j_new = torch.div(ij[..., 1], 2, rounding_mode="floor")
    P = g.poses
    adj = pose_compose(
        pose_between(P[rr, 2 * i_new], P[rr, ij[..., 0]]),
        pose_compose(g.edge_meas,
                     pose_between(P[rr, ij[..., 1]], P[rr, 2 * j_new])))
    adj = torch.cat([adj[..., :2], wrap_angle(adj[..., 2:3])], -1)
    is_loop = is_loop & (j_new > i_new)

    base = torch.clamp_min(n2 - 1, 0)
    tgt = base[:, None] + torch.cumsum(is_loop.long(), dim=1) - 1
    # Slot E is a spill slot, dropped: it takes the non-loop edges and
    # those past capacity (jnp's scatter mode="drop").
    tgt = torch.where(is_loop, tgt, E).clamp_max(E)

    def put(dst, new):
        buf = torch.cat([dst, dst.new_zeros((R, 1, dst.shape[-1]))], 1)
        buf.scatter_(1, tgt[..., None].expand(-1, -1, dst.shape[-1]),
                     new.to(buf.dtype))
        return buf[:, :E]

    edge_ij = put(edge_ij, torch.stack([i_new, j_new], -1))
    edge_meas = put(edge_meas, adj)
    edge_weight = put(edge_weight, g.edge_weight)
    n_edges2 = torch.clamp_max(base + is_loop.sum(dim=1), E)
    g2 = PoseGraph(poses=poses2, pose_valid=valid2,
                   n_poses=n2.to(torch.int32),
                   edge_ij=edge_ij.to(torch.int32), edge_meas=edge_meas,
                   edge_weight=edge_weight,
                   edge_valid=m[None] < n_edges2[:, None],
                   n_edges=n_edges2.to(torch.int32))
    return g2, ring2


def _dist2d(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    d = a - b
    return torch.sqrt(d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1])


def loop_candidate(cfg: LoopClosureConfig, g: PoseGraph,
                   query: torch.Tensor):
    """Per graph: the nearest old pose within search_radius_m, at least
    min_chain_size behind `query`, whose chain to the query left the
    search disc in between. Returns (index (R,), found (R,))."""
    R, N, _ = g.poses.shape
    dev = g.poses.device
    rr = torch.arange(R, device=dev)
    q = query.long().clamp(0, N - 1)
    idx = torch.arange(N, device=dev)[None]
    d = _dist2d(g.poses[..., :2], g.poses[rr, q, None, :2])     # (R, N)
    old_enough = idx <= query.long()[:, None] - cfg.min_chain_size
    in_chain = g.pose_valid & (idx <= query.long()[:, None])
    dm = torch.where(in_chain, d, float("-inf"))
    suffix_max = torch.flip(torch.cummax(torch.flip(dm, [1]), dim=1).values,
                            [1])
    departed = suffix_max > cfg.search_radius_m
    ok = g.pose_valid & old_enough & (d <= cfg.search_radius_m) & departed
    best = torch.argmin(torch.where(ok, d, float("inf")), dim=1)
    return best.to(torch.int32), ok.any(dim=1)


# ---------------------------------------------------------------------------
# Gauss-Newton optimisation (dense)
# ---------------------------------------------------------------------------

def _edge_residual_jac(poses: torch.Tensor, ij: torch.Tensor,
                       meas: torch.Tensor):
    """Residuals (R, E, 3) and Jacobian blocks Ji, Jj (R, E, 3, 3)."""
    R = poses.shape[0]
    rr = torch.arange(R, device=poses.device)[:, None]
    pi = poses[rr, ij[..., 0].long()]
    pj = poses[rr, ij[..., 1].long()]
    ci, si = torch.cos(pi[..., 2]), torch.sin(pi[..., 2])
    dx = pj[..., 0] - pi[..., 0]
    dy = pj[..., 1] - pi[..., 1]
    r = torch.stack([ci * dx + si * dy - meas[..., 0],
                     -si * dx + ci * dy - meas[..., 1],
                     wrap_angle(pj[..., 2] - pi[..., 2] - meas[..., 2])], -1)
    z = torch.zeros_like(ci)
    one = torch.ones_like(ci)
    Ji = torch.stack([
        torch.stack([-ci, -si, -si * dx + ci * dy], -1),
        torch.stack([si, -ci, -ci * dx - si * dy], -1),
        torch.stack([z, z, -one], -1)], -2)
    Jj = torch.stack([
        torch.stack([ci, si, z], -1),
        torch.stack([-si, ci, z], -1),
        torch.stack([z, z, one], -1)], -2)
    return r, Ji, Jj


def _assemble(g: PoseGraph):
    """Dense J (R, 3E, 3N), residuals r (R, 3E), weights w (R, 3E)."""
    R, N, _ = g.poses.shape
    E = g.edge_ij.shape[1]
    dev = g.poses.device
    r, Ji, Jj = _edge_residual_jac(g.poses, g.edge_ij, g.edge_meas)
    ev = g.edge_valid[..., None].to(torch.float32)
    w = (g.edge_weight * ev).reshape(R, -1)
    r = (r * ev).reshape(R, -1)
    a3 = torch.arange(3, device=dev)
    rows = (3 * torch.arange(E, device=dev)[:, None, None]
            + a3[None, :, None]).expand(E, 3, 3)
    J = torch.zeros((R, 3 * E, 3 * N), dtype=torch.float32, device=dev)
    rb = torch.arange(R, device=dev)[:, None, None, None].expand(R, E, 3, 3)
    rows = rows[None].expand(R, E, 3, 3)
    for k, blk in ((0, Ji), (1, Jj)):
        cols = (3 * g.edge_ij[..., k].long()[..., None, None]
                + a3[None, None, None, :]).expand(R, E, 3, 3)
        J.index_put_((rb.reshape(-1), rows.reshape(-1), cols.reshape(-1)),
                     blk.reshape(-1), accumulate=True)
    return J, r, w


@entry_point(static=("cfg",))
def optimize(cfg: LoopClosureConfig, g: PoseGraph) -> PoseGraph:
    """Damped Gauss-Newton over each whole graph, pose 0 gauge-fixed by
    a strong prior; `cfg.gn_iters` iterations, Cholesky solves."""
    full_f32()
    R, N, _ = g.poses.shape
    dev = g.poses.device
    gauge = torch.zeros(3 * N, dtype=torch.float32, device=dev)
    gauge[:3] = 1e6
    gauge = torch.diag(gauge)
    damp = cfg.damping * torch.eye(3 * N, dtype=torch.float32, device=dev)
    poses = g.poses
    for _ in range(cfg.gn_iters):
        J, r, w = _assemble(g._replace(poses=poses))
        Jt = J.transpose(1, 2)
        H = Jt @ (w[..., None] * J) + gauge + damp
        b = Jt @ (w * r)[..., None]
        L = torch.linalg.cholesky(H)
        delta = torch.cholesky_solve(-b, L).reshape(R, N, 3)
        delta = delta * g.pose_valid[..., None]
        poses = poses + delta
        poses = torch.cat([poses[..., :2], wrap_angle(poses[..., 2:3])], -1)
    return g._replace(poses=poses)


