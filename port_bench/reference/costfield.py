"""Cost-to-go fields by multigrid min-plus relaxation: a frozen copy of
the port's `ops/costfield.py`, every sweep in plain PyTorch (the plain
version of kernel K3)."""

from __future__ import annotations

import torch

from ._util import entry_point, shift2d

_BIG = 1e9
_SQ2 = 1.41421356

_NEIGHBOURS = ((1, 0, 1.0), (-1, 0, 1.0), (0, 1, 1.0), (0, -1, 1.0),
               (1, 1, _SQ2), (1, -1, _SQ2), (-1, 1, _SQ2), (-1, -1, _SQ2))


def _relax_once(d: torch.Tensor, blocked: torch.Tensor) -> torch.Tensor:
    """One 8-neighbour min-plus sweep on (..., n, n)."""
    best = d
    for dr, dc, w in _NEIGHBOURS:
        best = torch.minimum(best, shift2d(d, dr, dc, _BIG) + w)
    return torch.where(blocked, _BIG, best)


def _relax_sweeps_plain(blocked: torch.Tensor, init: torch.Tensor,
                        n_sweeps: int) -> torch.Tensor:
    """Plain version of K3: `n_sweeps` sweeps of (..., n, n) fields under
    an (n, n) mask, or of (T * G, n, n) fields under (T, n, n) masks,
    field f under mask f // G."""
    if blocked.dim() == 3:
        T, n = blocked.shape[0], blocked.shape[-1]
        d = _relax_sweeps_plain(blocked[:, None],
                                init.reshape(T, -1, n, n), n_sweeps)
        return d.reshape(init.shape)
    d = init
    for _ in range(n_sweeps):
        d = _relax_once(d, blocked)
    return d


def sweeps(blocked: torch.Tensor, init: torch.Tensor,
           n_sweeps: int) -> torch.Tensor:
    """`n_sweeps` sweeps of (R, n, n) fields (any count, odd included)
    under an (n, n) mask or (T, n, n) masks (field f under mask
    f // (R / T)): the plain version on a CPU tensor, kernel K3 on a CUDA
    tensor."""
    return _relax_sweeps_plain(blocked, init, n_sweeps)


def relax_level(blocked: torch.Tensor, init: torch.Tensor,
                iters: int) -> torch.Tensor:
    """`iters` doubled sweeps of (R, n, n) fields: the plain version on a
    CPU tensor, kernel K3 on a CUDA tensor.

    K3 replaces `jax_mapping/ops/costfield.py::_relax_level_pallas`. A
    level is a chain of 2 * iters dependent sweeps over little data, so
    the hand-over between sweeps bounds it, not bytes or arithmetic. Each
    robot's field is one thread-block cluster whose CTAs keep row slabs in
    shared memory and send their edge rows into the neighbours' shared
    memory (distributed shared memory): one launch a level. Fields too
    large for 16 CTAs' shared memory (n above about 600) ping-pong two
    global buffers, one launch a sweep."""
    return sweeps(blocked, init, 2 * iters)


def _pool_blocked(blocked: torch.Tensor) -> torch.Tensor:
    """2x conservative pooling of (..., n, n) masks: a parent is blocked
    if ANY child is."""
    *lead, n0, n1 = blocked.shape
    return blocked.reshape(*lead, n0 // 2, 2, n1 // 2, 2).any(
        dim=-1).any(dim=-2)


def _seed(init: torch.Tensor, robot_rc: torch.Tensor, blocked: torch.Tensor,
          neighbours: bool) -> torch.Tensor:
    """Seed each robot's own field: 0 at its cell where that cell is open;
    at the finest level also its open 8-neighbours with their step cost.
    Seeds only lower values (a scatter-min). `blocked` is one (n, n) mask
    or (T, n, n) masks, field f reading mask f // (R / T)."""
    R, n = init.shape[0], init.shape[-1]
    dev = init.device
    blk = blocked if blocked.dim() == 3 else blocked[None]
    rr = robot_rc[:, 0].clamp(0, n - 1).long()
    cc = robot_rc[:, 1].clamp(0, n - 1).long()
    ar = torch.arange(R, device=dev)
    tf = torch.div(ar, R // blk.shape[0], rounding_mode="floor")
    out = init.clone()
    seed_open = ~blk[tf, rr, cc]
    val = torch.where(seed_open, 0.0, _BIG)
    out[ar, rr, cc] = torch.minimum(out[ar, rr, cc], val)
    if neighbours:
        for dr, dc, w in _NEIGHBOURS:
            r2 = rr + dr
            c2 = cc + dc
            inb = (r2 >= 0) & (r2 < n) & (c2 >= 0) & (c2 < n)
            r2c = r2.clamp(0, n - 1)
            c2c = c2.clamp(0, n - 1)
            v = torch.where(inb & ~blk[tf, r2c, c2c], w, _BIG)
            out[ar, r2c, c2c] = torch.minimum(out[ar, r2c, c2c], v)
    return out


@entry_point(static=("levels", "refine_iters"))
def cost_fields(blocked: torch.Tensor, robot_rc: torch.Tensor,
                levels: int = 3, refine_iters: int = 8,
                relax=relax_level) -> torch.Tensor:
    """(n, n) blocked mask + (R, 2) robot cells -> (R, n, n) cost fields;
    or (T, n, n) masks + (T, R, 2) cells -> (T, R, n, n), tenant t's
    robots under mask t, each level one `relax` call over all T * R
    fields.

    `relax` runs each level's sweeps; the default is kernel K3 on a CUDA
    tensor. Passing `_relax_level_xla` runs the plain version on any
    device, which is how a check on the card holds the kernel against it."""
    batched = blocked.dim() == 3
    blk3 = blocked if batched else blocked[None]
    T, n = blk3.shape[0], blk3.shape[-1]
    rc = robot_rc.reshape(-1, 2)
    F = rc.shape[0]
    G = F // T
    dev = blocked.device
    max_levels = 1
    while n % (1 << max_levels) == 0 and (n >> max_levels) >= 8:
        max_levels += 1
    levels = max(1, min(levels, 6, max_levels))

    def arg(b):
        return b if batched else b[0]

    blocked_pyr = [blk3]
    for _ in range(levels - 1):
        blocked_pyr.append(_pool_blocked(blocked_pyr[-1]))
    rc_pyr = [torch.div(rc, 1 << lv, rounding_mode="floor")
              for lv in range(levels)]

    n_c = n >> (levels - 1)
    blk_c = blocked_pyr[-1]
    init = _seed(torch.full((F, n_c, n_c), _BIG, device=dev), rc_pyr[-1],
                 blk_c, neighbours=(levels == 1))
    d = relax(arg(blk_c), init, iters=max(1, n_c // 2))

    for lv in range(levels - 2, -1, -1):
        d = d.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        d = torch.where(d >= _BIG, _BIG, d * 2.0 + 2.0)
        blk = blocked_pyr[lv]
        m = blk.shape[-1]
        d = torch.where(blk[:, None], _BIG, d.reshape(T, G, m, m)
                        ).reshape(F, m, m)
        d = _seed(d, rc_pyr[lv], blk, neighbours=(lv == 0))
        d = relax(arg(blk), d, iters=refine_iters)

    rr = rc[:, 0].clamp(0, n - 1).long()
    cc = rc[:, 1].clamp(0, n - 1).long()
    d = d.clone()
    d[torch.arange(F, device=dev), rr, cc] = 0.0
    return d.reshape(T, G, n, n) if batched else d


@entry_point(static=("iters",))
def warm_cost_fields(blocked: torch.Tensor, robot_rc: torch.Tensor,
                     prev_fields: torch.Tensor, iters: int) -> torch.Tensor:
    """`cost_fields` warm-started from a previous solve's fields: each
    robot's previous field plus its value at the robot's new cell (an
    upper bound by the triangle inequality), re-masked, re-seeded and
    relaxed `iters` doubled sweeps. Valid only while `blocked` is a subset
    of the mask the previous fields were solved on."""
    R = prev_fields.shape[0]
    n = blocked.shape[0]
    rr = robot_rc[:, 0].clamp(0, n - 1).long()
    cc = robot_rc[:, 1].clamp(0, n - 1).long()
    ar = torch.arange(R, device=blocked.device)
    off = prev_fields[ar, rr, cc]
    init = torch.clamp_max(prev_fields + off[:, None, None], _BIG)
    init = torch.where(blocked[None], _BIG, init)
    init = _seed(init, robot_rc, blocked, neighbours=True)
    d = relax_level(blocked, init, iters).clone()
    d[ar, rr, cc] = 0.0
    return d
