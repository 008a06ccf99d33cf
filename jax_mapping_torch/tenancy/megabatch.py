"""Tenant megabatch: many independent missions ticked as one launch chain.

Port of the JAX package's `tenancy/megabatch.py`. Missions are stacked
along a leading tenant axis (`TenantBatch`): every `FleetState` leaf is
(B, ...), the worlds (B, H, W). `megabatch_step` runs the fleet tick's
stages (`models/fleet.py`: `_tick_sense`, `_tick_graph`, `_tick_finish`)
over all B lanes at once: the per-robot work on B * R robots, kernel K1
on every lane's scans in one launch a batch, K2 once and K3 once a level
for all lanes, the frontier auction in lockstep, and one host read of the
fold's origins a sub-batch. The loop-closure branch is hoisted out of the
batch: the step advances every lane down the no-closure path and reports
the lanes with a closure candidate (`pending`); `megabatch_tick` re-runs
each pending lane from its pre-tick state through the solo `fleet_step`,
with that lane's wheel normals of the same tick, so a closure tick is the
solo tick by construction.

Bit-identity contract: a lane inside a megabatch equals its solo
`fleet_step` bit for bit, on the buckets of `EXACT_BUCKETS`. The stages
compute each lane's values with the same operations as a solo call;
where a float reduction or a cuBLAS call could sum in another order at
another batch size (the matcher), it runs one lane's rows at a time at
the solo shapes (`ops/scan_match._per_lane`); the matcher's
correlations run every lane at once through kernel K8, whose sums follow
the shapes alone (`ops/match_kernel.py`). The ladder is
measured, not assumed: on the CPU by tests/test_torch_tenancy.py, on the
card by chip_smoke.py's tenancy phase.

Bucketing: the tenant axis is padded to {2^k} u {3 * 2^(k-1)}
(`bucket_capacity`), restricted to `EXACT_BUCKETS` while the bit-exact
contract is armed. Pad lanes copy lane 0 with `active` False, are
computed like any lane and are frozen by a final `torch.where` on
`active`: a pad lane's state never advances, and lanes are independent,
so pads cannot perturb active tenants.

Random draws are inputs, as everywhere in the port: the (B, R, 2) wheel
normals of a tick, or a `torch.Generator` `megabatch_tick` draws them
from. The JAX package's per-mission PRNG keys ride along in `keys` as
bookkeeping only.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from jax_mapping_torch._util import entry_point
from jax_mapping_torch.config import SlamConfig, ensure_valid_mode
from jax_mapping_torch.models import fleet as FL
from jax_mapping_torch.utils.profiling import global_metrics, span

#: The bit-exact tenant ladder: the subset of {2^k} u {3 * 2^(k-1)} whose
#: megabatch lanes are verified bit-identical to solo `fleet_step` runs.
#: The same buckets as the JAX package's XLA:CPU ladder, measured anew for
#: the port: on the CPU at micro_config by tests/test_torch_tenancy.py,
#: on the H100 at the default SlamConfig by chip_smoke.py's tenancy phase
#: (buckets 3 and 6).
EXACT_BUCKETS = (1, 2, 3, 6, 12)

counters = global_metrics.counters


def windowed_mission_config(cfg: SlamConfig) -> SlamConfig:
    """The per-tenant bounded-memory mission config: with
    `cfg.world.windowed` every lane's grid is the window
    (`world/store.window_slam_config`), not the logical extent, so B
    tenants cost B x window^2 cells. Identity when not windowed."""
    if not cfg.world.windowed:
        return cfg
    from jax_mapping_torch.world.store import window_slam_config
    return window_slam_config(cfg)


def bucket_capacity(n: int, cap: Optional[int] = None,
                    exact: bool = True) -> int:
    """Smallest allowed tenant capacity >= n. `exact=True` (the default,
    `TenancyConfig.bit_exact_buckets`) picks from `EXACT_BUCKETS` and
    refuses tenant counts past its top; `exact=False` serves the full
    {2^k} u {3 * 2^(k-1)} set. `cap` bounds the answer (max_tenants)."""
    if n < 1:
        raise ValueError(f"bucket_capacity needs n >= 1, got {n}")
    if exact:
        for b in EXACT_BUCKETS:
            if b >= n:
                break
        else:
            raise ValueError(
                f"{n} tenant(s) exceed the bit-exact bucket ladder "
                f"(top {EXACT_BUCKETS[-1]}); set "
                "TenancyConfig.bit_exact_buckets=False for larger "
                "megabatches (not verified bit-exact)")
    else:
        from jax_mapping_torch.ops.grid import _batch_bucket
        b = _batch_bucket(n)
    if cap is not None and b > cap:
        raise ValueError(f"{n} tenant(s) exceed max capacity {cap}")
    return b


class TenantBatch(NamedTuple):
    """Independent mission states stacked along a leading tenant axis B
    (every leaf of `states`, and `worlds`, `keys`, `active`)."""

    states: FL.FleetState       # every leaf (B, ...)
    worlds: torch.Tensor        # (B, H, W) bool per-tenant ground truth
    keys: torch.Tensor          # (B, ...) per-mission seed or PRNG key
    active: torch.Tensor        # (B,) bool; pad and suspended lanes False


def _tree_map(fn, *trees):
    """fn over the leaves of equally shaped NamedTuple trees."""
    t0 = trees[0]
    if isinstance(t0, tuple):
        return type(t0)(*(_tree_map(fn, *xs) for xs in zip(*trees)))
    return fn(*trees)


def _tree_set(tree, i: int, sub) -> None:
    """Write `sub`'s leaves into lane i of `tree`'s leaves, in place."""
    _tree_map(lambda x, y: x.__setitem__(i, y), tree, sub)


def stack_states(states: Sequence[FL.FleetState]) -> FL.FleetState:
    """Stack per-mission FleetStates along a new leading tenant axis."""
    return _tree_map(lambda *xs: torch.stack(xs), *states)


def make_tenant_batch(states: Sequence[FL.FleetState],
                      worlds: Sequence, keys: Sequence,
                      capacity: Optional[int] = None,
                      exact: bool = True) -> TenantBatch:
    """Bucket-pad N missions into a TenantBatch on their states' device.
    Pad lanes duplicate lane 0 and are inactive: `megabatch_step` freezes
    them, so a pad tick is an exact no-op on state."""
    n = len(states)
    if n == 0:
        raise ValueError("make_tenant_batch needs at least one mission")
    if not (len(worlds) == len(keys) == n):
        raise ValueError("states / worlds / keys length mismatch")
    b = capacity if capacity is not None else bucket_capacity(
        n, exact=exact)
    if b < n:
        raise ValueError(f"capacity {b} < {n} tenant(s)")
    dev = states[0].grid.device
    idx = list(range(n)) + [0] * (b - n)
    return TenantBatch(
        states=stack_states([states[i] for i in idx]),
        worlds=torch.stack([torch.as_tensor(worlds[i], device=dev)
                            for i in idx]),
        keys=torch.stack([torch.as_tensor(np.asarray(keys[i]).astype(
            np.int64)) for i in idx]).to(dev),
        active=torch.tensor([i < n for i in range(b)], device=dev))


#: Lane-health word bits, computed on the device in `megabatch_step` when
#: `TenancyConfig.lane_health` is armed and again on the host
#: (`lane_health_host`) for lanes a pending hop re-ran: the same predicate.
HEALTH_NONFINITE = 1    # NaN / Inf in the lane's poses or grid delta
HEALTH_POSE_JUMP = 2    # a within-tick estimate moved > pose_jump_max_m
HEALTH_MATCH_FLOOR = 4  # an accepted key match's response < match_floor


def _health_word(cfg: SlamConfig, batch: TenantBatch,
                 states2: FL.FleetState, diag: FL.FleetDiag
                 ) -> torch.Tensor:
    """The (B,) int32 health word of each lane, from the pre-freeze
    `states2` (0 on inactive lanes, and everywhere unless armed). It only
    reads the tick's outputs: arming it changes no lane's numbers."""
    t = cfg.tenancy
    active = batch.active
    B = active.shape[0]
    zero = torch.zeros(B, dtype=torch.int32, device=active.device)
    if not (t.enabled and t.lane_health):
        return zero
    # Bit 0: the grid DELTA (what the lane produced this tick) also
    # flags a lane whose input grid was already poisoned (NaN - NaN).
    pose_ok = torch.isfinite(states2.est_poses).reshape(B, -1).all(dim=1)
    gd = states2.grid - batch.states.grid
    grid_ok = torch.isfinite(gd).reshape(B, -1).all(dim=1)
    word = torch.where(pose_ok & grid_ok, zero, HEALTH_NONFINITE)
    # Bit 1: the largest within-tick estimate translation (NaN compares
    # False; bit 0 owns that failure).
    dxy = (states2.est_poses - batch.states.est_poses)[..., :2]
    jump = torch.sqrt((dxy * dxy).sum(dim=-1)).amax(dim=-1)
    word = word | torch.where(jump > t.pose_jump_max_m, HEALTH_POSE_JUMP,
                              zero)
    # Bit 2: charged only where a key-step match ran.
    if t.match_floor > 0.0:
        low = (diag.match_response < t.match_floor) & diag.is_key
        word = word | torch.where(low.reshape(B, -1).any(dim=1),
                                  HEALTH_MATCH_FLOOR, zero)
    return torch.where(active, word, zero).to(torch.int32)


def lane_health_host(cfg: SlamConfig, old_state: FL.FleetState,
                     new_state: FL.FleetState, diag=None) -> int:
    """Host twin of the device health word over ONE lane (no tenant
    axis), in numpy: for lanes a pending hop re-ran through the solo
    `fleet_step` (their device word described the discarded no-closure
    tick)."""
    def n(x):
        return x.detach().cpu().numpy() if torch.is_tensor(x) \
            else np.asarray(x)

    t = cfg.tenancy
    word = 0
    new_p = n(new_state.est_poses)
    old_p = n(old_state.est_poses)
    gd = n(new_state.grid) - n(old_state.grid)
    if not (np.isfinite(new_p).all() and np.isfinite(gd).all()):
        word |= HEALTH_NONFINITE
    dxy = (new_p - old_p)[..., :2]
    jump = np.sqrt((dxy * dxy).sum(axis=-1)).max()
    if jump > t.pose_jump_max_m:
        word |= HEALTH_POSE_JUMP
    if t.match_floor > 0.0 and diag is not None:
        low = (n(diag.match_response) < t.match_floor) & n(diag.is_key)
        if low.any():
            word |= HEALTH_MATCH_FLOOR
    return word


def _normals(batch: TenantBatch, wheel_normals, generator) -> torch.Tensor:
    """The tick's (B, R, 2) wheel normals on the batch's device: given,
    or drawn from `generator` on the CPU."""
    B, R = batch.states.est_poses.shape[:2]
    if wheel_normals is None:
        wheel_normals = torch.randn((B, R, 2), generator=generator)
    return torch.as_tensor(wheel_normals, dtype=torch.float32,
                           device=batch.states.grid.device).reshape(B, R, 2)


@entry_point(static=("cfg", "world_res_m"))
def megabatch_step(cfg: SlamConfig, batch: TenantBatch, world_res_m: float,
                   wheel_normals: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None):
    """One no-closure tick of every lane, with closure-pending flags and
    the health word: returns ``(batch', diag, pending, health)``. Every
    active lane advances as its solo `fleet_step` would on a tick whose
    closure branch stays off; inactive lanes are frozen. ``pending[i]``
    (device bool) means lane i had a loop-closure candidate: its lane in
    ``batch'`` is the no-closure evolution and the caller must resolve it
    (`megabatch_tick` does). ``health`` is the (B,) int32 word (HEALTH_*
    bits), zeros unless `TenancyConfig.lane_health` is armed. The diag
    carries the tenant axis; an inactive lane's rows mean nothing.

    wheel_normals: (B, R, 2) standard normals of this tick's wheel noise;
    None draws them from `generator`."""
    ensure_valid_mode(cfg)
    normals = _normals(batch, wheel_normals, generator)
    st = batch.states
    sense = FL._tick_sense(cfg, st, world_res_m, batch.worlds, normals)
    (graphs, rings, k_idx, cand, attempt, xrobot, xcand,
     xattempt) = FL._tick_graph(cfg, st.graphs, st.scan_rings, sense.est,
                                sense.is_key, sense.scans,
                                sense.res.accepted)
    pre = FL._TickPre(sim2=sense.sim2, pol=sense.pol, fr=sense.fr,
                      match_response=sense.res.response, est=sense.est,
                      is_key=sense.is_key, grid=sense.grid, graphs=graphs,
                      rings=rings, k_idx=k_idx, scans=sense.scans,
                      cand=cand, attempt=attempt, xrobot=xrobot,
                      xcand=xcand, xattempt=xattempt)
    pending = (attempt | xattempt).any(dim=-1) & batch.active

    def freeze(new, old):
        act = batch.active.reshape((-1,) + (1,) * (new.dim() - 1))
        return torch.where(act, new, old)

    with span("tick.finish"):
        states2, diag = FL._tick_finish(cfg, st, pre, pre.grid, pre.graphs,
                                        pre.est,
                                        torch.zeros_like(pre.is_key))
        health = _health_word(cfg, batch, states2, diag)
        states2 = _tree_map(freeze, states2, st)
    return batch._replace(states=states2), diag, pending, health


def megabatch_tick(cfg: SlamConfig, batch: TenantBatch, world_res_m: float,
                   wheel_normals: Optional[torch.Tensor] = None,
                   generator: Optional[torch.Generator] = None):
    """One tick of every lane, closure ticks included: `megabatch_step`,
    then each pending lane re-run from its pre-tick state through the
    solo `fleet_step` with the same tick's wheel normals, its state and
    diag rows written back. The pending flags and the health word come to
    the host in one read. Returns ``(batch, diag, health)``, health a
    numpy (B,) uint32 array; a re-run lane's word is derived on the host
    from the solo tick (`lane_health_host`)."""
    counters.inc("megabatch.ticks")
    with span("megabatch.tick"):
        normals = _normals(batch, wheel_normals, generator)
        new_batch, diag, pending, health = megabatch_step(
            cfg, batch, world_res_m, normals)
        with span("megabatch.read"):
            pending_l, health_l = torch.stack(
                [pending.to(torch.int32), health]).tolist()  # one host read
        counters.inc("megabatch.lanes_rerun", sum(pending_l))
        lane_armed = cfg.tenancy.enabled and cfg.tenancy.lane_health
        for i, p in enumerate(pending_l):
            if not p:
                continue
            with span("megabatch.rerun"):
                before = lane_state(batch, i)
                s1, d1 = FL.fleet_step(cfg, before, world_res_m,
                                       batch.worlds[i],
                                       wheel_normals=normals[i])
                # Every leaf of the step's output is a fresh tensor (the
                # freeze and the tick allocate), so lane i is written in
                # place.
                _tree_set(new_batch.states, i, s1)
                _tree_set(diag, i, d1)
                if lane_armed:
                    health_l[i] = lane_health_host(cfg, before, s1, d1)
        return new_batch, diag, np.asarray(health_l, np.uint32)


def lane_state(batch: TenantBatch, i: int) -> FL.FleetState:
    """Lane i's FleetState (views into the batch)."""
    return _tree_map(lambda x: x[i], batch.states)
