"""Tenant control plane: admit / suspend / resume / evict missions.

Port of the JAX package's `tenancy/controlplane.py`. The megabatch
(`tenancy/megabatch.py`) makes N missions cost one launch chain a tick;
this module is the host-side plane that feeds it over a mission's whole
lifetime:

* **admit** — a mission joins the batch. When the post-admission bucket
  has not run yet, admission first pre-warms it through the
  `StagedWarmup` ladder (`resilience/warmup.py`): `megabatch_step` runs
  once on a zeros batch of the bucket's width on the plane's device,
  which builds or loads its kernels' libraries (through the build cache
  when the cold-start tier is armed), then the readiness gate and the
  dispatch profiler's rebaseline run. Only then does the tenant join.
  The warm call draws no tenant's noise and touches no live lane.
* **suspend / resume** — a suspended tenant's state is held and the batch
  COMPACTS (bucket shrink when a smaller bucket fits). Resume re-admits
  the held state and bumps the tenant's serving epoch.
* **evict** — the mission leaves for good; its final state checkpoints
  through the generation-retention machinery (`io/checkpoint.py`).

Each tenant owns a serving **epoch/revision namespace**: `revision`
advances once per ticked step, `epoch` bumps on every (re-)admission, so
`/tiles?tenant=` delta sessions key cache validity on (epoch, revision).

Blast-radius containment adds lane health (`TenancyConfig.lane_health`:
the megabatch's health word folded through a per-tenant
`LaneHealthLadder`; a suspect tenant's revision freezes on its held
last-good state, a quarantined lane freezes in place through the pad
lanes' `active=False` select, and bounded probes re-admit it), the
durable registry (`TenancyConfig.journal`: `tenancy/journal.py`,
`checkpoint_all()`, `restore()`), and the chaos seams
(`set_tenant_poison`, `state_jump_tenant`) of `resilience/faultplan.py`'s
tenant kinds.

**Random draws per tenant.** JAX draws each lane's wheel noise from that
lane's own PRNG key, so a tenant's trajectory does not depend on its
slot, its bucket or its co-tenants. Here each mission owns a CPU
`torch.Generator` seeded with its `seed` (the `key` slot of `_Mission`):
it draws the spawn radii (`init_fleet_state(..., generator=)`) and each
tick's (R, 2) normals, exactly what a solo `fleet_step(...,
generator=)` loop draws, and `step()` assembles the (B, R, 2) block lane
by lane (zeros for pad and frozen lanes). A suspended or quarantined
tenant's generator does not advance; a lane rebuilt from a held state
gets back the generator state held with it. `step(wheel_normals=)`
teacher-forces chosen tenants instead. The `.live.ckpt` checkpoint's
`key` slot holds `generator.get_state()` and `restore()` sets it back,
so a restored tenant continues its stream. A JAX tenant checkpoint's
PRNG key cannot seed a port tenant: the two packages' streams differ.

**Host reads.** `megabatch_tick` brings the pending flags and the health
word to the host in one read; `step()` adds none per lane (its health
fold works on that numpy word, its normals go to the card in one
non-blocking copy from pinned memory, its world refresh uploads the
same way). The readmission probe checks every held float leaf for
non-finite values in one reduction and one read.

Thread contract: the mission registry, slot order and live batch mutate
only under `_lock` (the JAX package's `analysis/protection.py` group
for this class); flight-recorder events emit after the lock is released,
and counters are read lock-free by the /status convention. The health
ladder and the journal are leaf structures owned by `_lock`.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from jax_mapping_torch._util import resolve_device
from jax_mapping_torch.config import SlamConfig
from jax_mapping_torch.models import fleet as FM
from jax_mapping_torch.obs.recorder import flight_recorder
from jax_mapping_torch.tenancy import megabatch as MB
from jax_mapping_torch.tenancy.lanehealth import (HEALTHY, QUARANTINED,
                                                  LaneHealthLadder)
from jax_mapping_torch.utils.profiling import span

#: The megabatch entry point's registry-qualified name (the devprof /
#: compile-budget naming contract).
MEGABATCH_ENTRY = "jax_mapping_torch.tenancy.megabatch.megabatch_step"


class AdmissionRejected(RuntimeError):
    """Raised by `admit()` when `TenancyConfig.admission_queue_max`
    concurrent admissions are already in flight: bounded backpressure
    instead of unbounded serialization behind the commit lock."""


def _generator(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(int(seed))


def _lane_copy(batch: MB.TenantBatch, i: int) -> FM.FleetState:
    """Lane i's FleetState as fresh tensors: a held state must neither
    alias a later in-place write nor pin the whole batch."""
    return MB._tree_map(lambda x: x[i].clone(), batch.states)


def _dtype_name(dtype) -> str:
    """'bool', 'float32': the JAX package's journal spelling."""
    return str(dtype).replace("torch.", "")


class _Mission:
    """One tenant's host-side record (mutated only under the plane's
    `_lock`). `key` is the tenant's CPU generator; `held_key` the
    generator state that goes with `held_state`."""

    __slots__ = ("tid", "seed", "epoch", "revision", "state", "world",
                 "dynamics", "steps", "held_state", "key", "held_key")

    def __init__(self, tid: str, seed: int, world, key,
                 dynamics=None):
        self.tid = tid
        self.seed = seed
        self.epoch = -1            # first admit bumps to 0
        self.revision = 0
        self.state = "new"         # active | suspended | quarantined | evicted
        self.world = world
        self.dynamics = dynamics
        self.steps = 0
        self.held_state: Optional[FM.FleetState] = None
        self.key: torch.Generator = key
        self.held_key: Optional[torch.Tensor] = None


class TenantControlPlane:
    """Admit/evict/suspend for megabatched missions on one config, on
    `device` (None: the CUDA card, raising without one)."""

    def __init__(self, cfg: SlamConfig, world_res_m: Optional[float] = None,
                 checkpoint_dir: Optional[str] = None,
                 compile_cache=None, devprof=None, pipeline=None,
                 device=None):
        # Bounded-memory tenancy: under `cfg.world.windowed` every lane
        # runs at the window-sized grid; identity otherwise.
        cfg = MB.windowed_mission_config(cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        #: Pipeline latency ledger (obs/pipeline.py) or None: tenant
        #: revision bumps and tile-store commits stamp under the tenant's
        #: own label. Set-once wiring, read bare.
        self.pipeline = pipeline
        self.world_res_m = (cfg.grid.resolution_m if world_res_m is None
                            else world_res_m)
        self.checkpoint_dir = checkpoint_dir
        from jax_mapping_torch.resilience.warmup import StagedWarmup
        self.warmup = StagedWarmup(cache=compile_cache, devprof=devprof,
                                   device=self.device)
        self._lock = threading.Lock()
        self._missions: Dict[str, _Mission] = {}
        #: Active lane order: lane i of the batch is mission `_order[i]`;
        #: pad lanes (i >= len(_order)) are inactive.
        self._order: List[str] = []
        #: Lane order the live batch was last stacked under.
        self._prev_order: List[str] = []
        self._batch: Optional[MB.TenantBatch] = None
        self._last_diag = None
        self._warmed_buckets: set = set()
        self.n_admitted = 0
        self.n_evicted = 0
        self.n_suspended = 0
        self.n_resumed = 0
        self.n_prewarms = 0
        self.n_ticks = 0
        self.n_compactions = 0
        self.n_quarantined = 0
        self.n_admissions_rejected = 0
        self._tile_stores: Dict[str, object] = {}
        self._lanehealth = LaneHealthLadder(cfg.tenancy)
        self._poisoned: set = set()
        self._admissions_in_flight = 0
        self._journal = None
        if cfg.tenancy.journal and checkpoint_dir is not None:
            from jax_mapping_torch.tenancy.journal import ControlJournal
            self._journal = ControlJournal(
                os.path.join(checkpoint_dir, "controlplane"))

    # -- lifecycle -----------------------------------------------------------

    def admit(self, tid: str, world, seed: int = 0,
              state: Optional[FM.FleetState] = None,
              dynamics=None) -> None:
        """A mission joins the batch. `world` is the tenant's ground truth
        (one world shape for all tenants); `state` resumes from a given
        FleetState, otherwise the mission initialises from its seed. Its
        generator is seeded `seed` either way. Pre-warms the
        post-admission bucket first when it has not run yet.

        With `admission_queue_max > 0`, at most that many admissions may
        be in flight at once: excess admissions raise `AdmissionRejected`
        instead of queueing."""
        qmax = self.cfg.tenancy.admission_queue_max
        with self._lock:
            if qmax > 0 and self._admissions_in_flight >= qmax:
                self.n_admissions_rejected += 1
                in_flight = self._admissions_in_flight
            else:
                self._admissions_in_flight += 1
                in_flight = None
        if in_flight is not None:
            flight_recorder.record("tenancy_admission_rejected",
                                   tenant=tid, in_flight=in_flight,
                                   queue_max=qmax)
            raise AdmissionRejected(
                f"admission of {tid!r} rejected: {in_flight} "
                f"admission(s) already in flight "
                f"(admission_queue_max={qmax})")
        try:
            self._admit(tid, world, seed, state, dynamics)
        finally:
            with self._lock:
                self._admissions_in_flight -= 1

    def _admit(self, tid: str, world, seed: int,
               state: Optional[FM.FleetState], dynamics,
               gen_state=None) -> None:
        world = torch.as_tensor(world, device=self.device)
        key = _generator(seed)
        if gen_state is not None:
            key.set_state(gen_state)
        if state is None:
            state = FM.init_fleet_state(self.cfg, device=self.device,
                                        generator=key)
        with self._lock:
            if tid in self._missions \
                    and self._missions[tid].state in ("active",
                                                      "suspended"):
                # resume() is the path back for a suspended tenant: an
                # admit would reinitialise and destroy its held state.
                raise ValueError(
                    f"tenant {tid!r} is "
                    f"{self._missions[tid].state}; use resume()")
            n_next = len(self._order) + 1
            bucket = MB.bucket_capacity(
                n_next, self.cfg.tenancy.max_tenants,
                exact=self.cfg.tenancy.bit_exact_buckets)
        prewarmed = self._prewarm_bucket(bucket, state, world)
        with self._lock:
            # Re-check under the commit lock: the pre-warm ran outside it.
            existing = self._missions.get(tid)
            if existing is not None and existing.state in (
                    "active", "suspended"):
                raise ValueError(
                    f"tenant {tid!r} is {existing.state}; lost the "
                    "admission race")
            order2 = self._order + [tid]
            # Rebuild before any registry mutation: a failed admission
            # leaves the plane untouched.
            batch2, prev2, compacted = self._rebuilt(
                order2, extra={tid: (state, world, seed)})
            m = existing
            if m is None:
                m = _Mission(tid, seed, world, key, dynamics=dynamics)
                self._missions[tid] = m
            m.seed = seed
            m.world = world
            m.key = key
            if dynamics is not None:
                m.dynamics = dynamics
            m.epoch += 1
            if existing is not None:
                # Re-admission: epoch bump => revision bump, so an
                # (epoch, revision) ETag pair never recurs with other
                # content.
                m.revision += 1
            m.state = "active"
            m.held_state = None
            m.held_key = None
            self._order = order2
            self._batch = batch2
            self._prev_order = prev2
            if compacted:
                self.n_compactions += 1
            self.n_admitted += 1
            epoch = m.epoch
            self._tile_stores.pop(tid, None)
            self._journal_append("admit", m)
            key_state = key.get_state()
        if self._journal is not None:
            # A journal-armed admission durably exists from tick zero.
            self._checkpoint_tenant(tid, state, world, key_state)
        flight_recorder.record("tenancy_admit", tenant=tid, seed=seed,
                               epoch=epoch, bucket=bucket,
                               prewarmed=prewarmed)

    def suspend(self, tid: str) -> None:
        """Remove a tenant from the batch, holding its state; the batch
        compacts (bucket shrink when a smaller bucket fits)."""
        with self._lock:
            m = self._require(tid, "active")
            held = self._lane_copy_locked(tid)
            order2 = [t for t in self._order if t != tid]
            batch2, prev2, compacted = self._rebuilt(order2)
            if m.held_state is None:
                # A SUSPECT tenant already holds its last-good state.
                m.held_state = held
                m.held_key = m.key.get_state()
            m.state = "suspended"
            self._order = order2
            self._batch = batch2
            self._prev_order = prev2
            if compacted:
                self.n_compactions += 1
            self.n_suspended += 1
            self._lanehealth.forget(tid)
            self._journal_append("suspend", m)
        flight_recorder.record("tenancy_suspend", tenant=tid)

    def resume(self, tid: str) -> None:
        """Re-admit a suspended tenant from its held state; its serving
        epoch bumps."""
        with self._lock:
            m = self._require(tid, "suspended")
            held, world, seed = m.held_state, m.world, m.seed
            bucket = MB.bucket_capacity(
                len(self._order) + 1, self.cfg.tenancy.max_tenants,
                exact=self.cfg.tenancy.bit_exact_buckets)
        prewarmed = self._prewarm_bucket(bucket, held, world)
        with self._lock:
            # Re-require under the commit lock: a concurrent evict wins.
            m = self._require(tid, "suspended")
            order2 = self._order + [tid]
            batch2, prev2, compacted = self._rebuilt(
                order2, extra={tid: (held, world, seed)})
            m.key.set_state(m.held_key)
            m.epoch += 1
            m.revision += 1
            m.state = "active"
            m.held_state = None
            m.held_key = None
            self._order = order2
            self._batch = batch2
            self._prev_order = prev2
            if compacted:
                self.n_compactions += 1
            self.n_resumed += 1
            epoch = m.epoch
            self._tile_stores.pop(tid, None)
            self._journal_append("resume", m)
        flight_recorder.record("tenancy_resume", tenant=tid,
                               epoch=epoch, bucket=bucket,
                               prewarmed=prewarmed)

    def evict(self, tid: str,
              checkpoint: Optional[bool] = None) -> Optional[str]:
        """A mission leaves for good: its final state (a plain FleetState;
        the generator's state is not in it) checkpoints through the
        generation-retention machinery when a checkpoint dir is
        configured, and its lane compacts out. Returns the checkpoint
        path, if one was written."""
        if checkpoint is None:
            checkpoint = self.cfg.tenancy.checkpoint_on_evict
        with self._lock:
            m = self._require(tid, ("active", "suspended",
                                    "quarantined"))
            if m.state in ("active", "quarantined"):
                # A quarantined lane is frozen (possibly poisoned): the
                # held last-good state is what the checkpoint keeps.
                final = (m.held_state if m.state == "quarantined"
                         else self._lane_copy_locked(tid))
                order2 = [t for t in self._order if t != tid]
                batch2, prev2, compacted = self._rebuilt(order2)
                self._order = order2
                self._batch = batch2
                self._prev_order = prev2
                if compacted:
                    self.n_compactions += 1
            else:
                final = m.held_state
            m.held_state = None
            m.held_key = None
            m.state = "evicted"
            self._lanehealth.forget(tid)
            self._poisoned.discard(tid)
            self._journal_append("evict", m)
            # The record stays as a tombstone (epoch continuity across a
            # later re-admission); the heavy references go.
            m.world = None
            m.dynamics = None
            self.n_evicted += 1
            self._tile_stores.pop(tid, None)
        path = None
        if checkpoint and self.checkpoint_dir is not None \
                and final is not None:
            from jax_mapping_torch.io.checkpoint import save_checkpoint
            os.makedirs(self.checkpoint_dir, exist_ok=True)
            path = os.path.join(self.checkpoint_dir,
                                f"tenant_{tid}.ckpt")
            save_checkpoint(
                path, final, config_json=self.cfg.to_json(),
                retain_generations=(
                    self.cfg.resilience.checkpoint_retain_generations))
        flight_recorder.record("tenancy_evict", tenant=tid,
                               checkpointed=path is not None)
        return path

    # -- stepping ------------------------------------------------------------

    def step(self, n: int = 1, wheel_normals=None):
        """Advance every active tenant `n` ticks (one megabatch launch
        chain a tick). Returns the last tick's FleetDiag (leading tenant
        axis; inactive lanes meaningless), or None when no tenant is
        active.

        wheel_normals: optional {tid: normals} teacher-forcing chosen
        tenants, (R, 2) for n == 1 or (n, R, 2); those tenants' generators
        do not draw. Every other active tenant draws its (R, 2) from its
        own generator.

        The tick runs under `_lock` (device work inside the guarded
        section), so concurrent /status and tile snapshots wait up to one
        tick."""
        diag = None
        armed = (self.cfg.tenancy.enabled
                 and self.cfg.tenancy.lane_health)
        for k in range(n):
            stamped = []
            events = []
            with self._lock, span("plane.tick"):
                if not self._order:
                    return None
                refreshed = self._refreshed_worlds()
                if refreshed is not None:
                    self._batch = self._batch._replace(worlds=refreshed)
                # Last-good capture point: before the chaos seam.
                batch_before = self._batch
                if self._poisoned:
                    self._inject_poison_locked()
                batch = self._batch
                normals, pre_keys = self._tick_normals_locked(
                    batch, wheel_normals, k, armed)
                self._batch, diag, health = MB.megabatch_tick(
                    self.cfg, batch, self.world_res_m,
                    wheel_normals=normals)
                tick = self.n_ticks + 1
                with span("plane.health"):
                    frozen = (self._fold_health_locked(
                        health, batch_before, pre_keys, tick, events)
                        if armed else ())
                for tid in self._order:
                    m = self._missions[tid]
                    if m.state != "active" or tid in frozen:
                        # Quarantined lanes are frozen; suspect lanes do
                        # not publish: their revision stays on the held
                        # last-good content.
                        continue
                    m.revision += 1
                    m.steps += 1
                    stamped.append((tid, m.revision, m.steps))
                if armed:
                    with span("plane.health"):
                        self._run_probes_locked(tick, events)
                self._last_diag = diag
                self.n_ticks = tick
            for name, kw in events:
                flight_recorder.record(name, **kw)
            if self.pipeline is not None:
                for tid, rev, steps in stamped:
                    self.pipeline.installed(rev, tick=steps, tenant=tid)
        return diag

    def _tick_normals_locked(self, batch, forced, k: int, armed: bool):
        """The tick's (B, R, 2) wheel normals on the batch's device, lane
        by lane: the teacher-forced tenants' given rows, every other
        active tenant's draw from its own generator, zeros for frozen
        and pad lanes. Returns (normals, {tid: generator state before
        the draw}) — the latter only when lane health is armed, for the
        suspect hold."""
        B = int(batch.active.shape[0])
        R = self.cfg.fleet.n_robots
        host = torch.zeros((B, R, 2), dtype=torch.float32)
        pre_keys = {}
        for i, tid in enumerate(self._order):
            m = self._missions[tid]
            if m.state != "active":
                continue
            if forced is not None and tid in forced:
                nm = torch.as_tensor(np.asarray(forced[tid], np.float32))
                host[i] = nm.reshape(-1, R, 2)[k if nm.dim() == 3 else 0]
                continue
            if armed:
                pre_keys[tid] = m.key.get_state()
            host[i] = torch.randn((R, 2), generator=m.key)
        if self.device.type == "cuda":
            return host.pin_memory().to(self.device,
                                        non_blocking=True), pre_keys
        return host.to(self.device), pre_keys

    def _refreshed_worlds(self):
        """The batch's worlds with any changed-geometry tenant rows
        re-uploaded (the SimNode `world_if_changed` idiom, one
        non-blocking copy from pinned memory each), or None when nothing
        changed. The caller installs the result under `_lock`."""
        worlds = None
        for i, tid in enumerate(self._order):
            m = self._missions[tid]
            if m.dynamics is None:
                continue
            w = m.dynamics.world_if_changed(m.steps)
            if w is None:
                continue
            m.world = self._upload_world(w)
            if worlds is None:
                worlds = self._batch.worlds.clone()
            worlds[i] = m.world
        return worlds

    def _upload_world(self, w) -> torch.Tensor:
        src = torch.from_numpy(np.ascontiguousarray(w))
        if self.device.type != "cuda":
            return src.to(self.device)
        # The caching host allocator keeps the pinned block until its copy
        # has run, so the host never waits here.
        buf = torch.empty(src.shape, dtype=src.dtype, pin_memory=True)
        buf.copy_(src)
        return buf.to(self.device, non_blocking=True)

    # -- blast-radius containment --------------------------------------------

    def _fold_health_locked(self, health, batch_before, pre_keys,
                            tick: int, events: list):
        """Fold one tick's (B,) health words (numpy) through the ladder;
        returns the set of tids whose revision freezes this tick (suspect
        or newly quarantined). Caller holds `_lock`; flight events append
        to `events`."""
        frozen = set()
        for i, tid in enumerate(self._order):
            m = self._missions[tid]
            if m.state != "active":
                continue
            word = int(health[i])
            if word and m.held_state is None:
                # Entering suspect: hold the PRE-tick lane, the content of
                # the published revision, with the generator before this
                # tick's draw.
                m.held_state = _lane_copy(batch_before, i)
                m.held_key = pre_keys.get(tid, m.key.get_state())
            verdict = self._lanehealth.observe(tid, word, tick)
            if word:
                frozen.add(tid)
            elif m.held_state is not None \
                    and self._lanehealth.state(tid) == HEALTHY:
                # Clean tick after a transient: the lane is its own truth
                # again.
                m.held_state = None
                m.held_key = None
            if verdict == QUARANTINED:
                # Freeze in place with the pad lanes' inactive select: an
                # exact no-op, so co-tenants keep their trajectory.
                act = self._batch.active.clone()
                act[i] = False
                self._batch = self._batch._replace(active=act)
                m.state = "quarantined"
                self.n_quarantined += 1
                self._poisoned.discard(tid)
                self._journal_append("quarantine", m, word=word)
                events.append(("tenancy_quarantine",
                               dict(tenant=tid, tick=tick, word=word,
                                    streak=self.cfg.tenancy
                                    .quarantine_persist_ticks)))
        return frozen

    def _run_probes_locked(self, tick: int, events: list) -> None:
        """Bounded re-admission probes for quarantined tenants on the
        deterministic tick clock. A passing probe re-activates the lane
        from the held state and bumps the epoch; a failing one burns one
        unit of the probe budget."""
        for tid in self._lanehealth.quarantined():
            m = self._missions.get(tid)
            if m is None or m.state != "quarantined":
                continue
            if not self._lanehealth.probe_due(tid, tick):
                continue
            ok = self._probe_locked(m)
            readmit = self._lanehealth.note_probe(tid, ok, tick)
            events.append(("tenancy_readmit_probe",
                           dict(tenant=tid, tick=tick, ok=ok)))
            if readmit:
                self._readmit_locked(tid, m, tick, events)

    def _probe_locked(self, m: "_Mission") -> bool:
        """One re-admission verdict: every float leaf of the held state
        finite (one reduction, one read) AND one solo `fleet_step` from it
        with a clean health word. The probe's normals come from a copy of
        the held generator state: the tenant's own stream does not
        move."""
        held = m.held_state
        if held is None or m.world is None:
            return False
        leaves = []
        MB._tree_map(leaves.append, held)
        flags = [torch.isfinite(x).all() for x in leaves
                 if torch.is_floating_point(x)]
        if flags and not bool(torch.stack(flags).all()):
            return False
        g = torch.Generator()
        g.set_state(m.held_key if m.held_key is not None
                    else m.key.get_state())
        s1, d1 = FM.fleet_step(self.cfg, held, self.world_res_m, m.world,
                               generator=g)
        return MB.lane_health_host(self.cfg, held, s1, d1) == 0

    def _readmit_locked(self, tid: str, m: "_Mission", tick: int,
                        events: list) -> None:
        """Re-activate a probe-verified tenant from its held state. An
        in-batch lane is rewritten on fresh leaves (co-tenant values
        untouched); a restored-quarantined tenant without a live lane
        re-joins through the resume-style rebuild. The generator goes
        back to the held state's; the epoch and revision bump."""
        if tid in self._order:
            i = self._order.index(tid)

            def put(b, s):
                out = b.clone()
                out[i] = s
                return out

            states = MB._tree_map(put, self._batch.states, m.held_state)
            act = self._batch.active.clone()
            act[i] = True
            self._batch = self._batch._replace(states=states, active=act)
        else:
            order2 = self._order + [tid]
            batch2, prev2, compacted = self._rebuilt(
                order2, extra={tid: (m.held_state, m.world, m.seed)})
            self._order = order2
            self._batch = batch2
            self._prev_order = prev2
            if compacted:
                self.n_compactions += 1
        if m.held_key is not None:
            m.key.set_state(m.held_key)
        m.state = "active"
        m.held_state = None
        m.held_key = None
        m.epoch += 1
        m.revision += 1
        self._tile_stores.pop(tid, None)
        self._journal_append("readmit", m)
        events.append(("tenancy_readmit",
                       dict(tenant=tid, tick=tick, epoch=m.epoch)))

    def _inject_poison_locked(self) -> None:
        """Chaos seam (`tenant_poison`): NaN every poisoned ACTIVE
        tenant's est-pose lane input before the tick, on a fresh leaf."""
        for tid in sorted(self._poisoned):
            m = self._missions.get(tid)
            if m is None or m.state != "active" \
                    or tid not in self._order:
                continue
            i = self._order.index(tid)
            states = self._batch.states
            est = states.est_poses.clone()
            est[i] = float("nan")
            self._batch = self._batch._replace(
                states=states._replace(est_poses=est))

    def set_tenant_poison(self, tid: str, active: bool) -> None:
        """Arm/clear NaN poisoning of one tenant's lane inputs (the
        `tenant_poison` FaultPlan kind)."""
        with self._lock:
            if active:
                self._poisoned.add(tid)
            else:
                self._poisoned.discard(tid)

    def state_jump_tenant(self, tid: str, value_m: float) -> None:
        """Teleport one tenant's estimated poses by `value_m` metres (the
        `tenant_state_jump` FaultPlan kind)."""
        with self._lock:
            m = self._missions.get(tid)
            if m is None or m.state != "active" \
                    or tid not in self._order:
                return
            i = self._order.index(tid)
            states = self._batch.states
            est = states.est_poses.clone()
            est[i, :, :2] += np.float32(value_m)
            self._batch = self._batch._replace(
                states=states._replace(est_poses=est))

    # -- durable control plane -----------------------------------------------

    def _journal_append(self, kind: str, m: "_Mission",
                        **extra) -> None:
        """Append one lifecycle record (caller holds `_lock`); compaction
        every `journal_compact_every` appends. No-op when unarmed."""
        if self._journal is None:
            return
        fields = dict(seed=m.seed, epoch=m.epoch, revision=m.revision,
                      steps=m.steps, **extra)
        if m.world is not None:
            fields["world_shape"] = [int(s) for s in m.world.shape]
            fields["world_dtype"] = _dtype_name(m.world.dtype)
        self._journal.append(kind, m.tid, **fields)
        every = max(1, self.cfg.tenancy.journal_compact_every)
        if self._journal.n_appends % every == 0:
            self._journal.compact()

    def _live_ckpt_path(self, tid: str) -> str:
        """The containment checkpoint slot (`{fleet, key, world}`),
        distinct from evict's plain-FleetState `tenant_{tid}.ckpt`."""
        return os.path.join(self.checkpoint_dir,
                            f"tenant_{tid}.live.ckpt")

    def _checkpoint_tenant(self, tid: str, state, world,
                           key_state) -> str:
        from jax_mapping_torch.io.checkpoint import save_checkpoint
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        path = self._live_ckpt_path(tid)
        save_checkpoint(
            path, {"fleet": state, "key": key_state, "world": world},
            config_json=self.cfg.to_json(),
            retain_generations=(
                self.cfg.resilience.checkpoint_retain_generations))
        return path

    def checkpoint_all(self) -> List[str]:
        """Checkpoint every live tenant's current state (active: its lane;
        suspect/suspended/quarantined: the held state) with its generator
        state, then journal a per-tenant watermark record. Returns the
        paths written."""
        if self.checkpoint_dir is None:
            return []
        with self._lock:
            todo = []
            for tid, m in self._missions.items():
                if m.state == "evicted" or m.world is None:
                    continue
                if m.held_state is not None:
                    state, key = m.held_state, m.held_key
                elif m.state == "active":
                    state = self._lane_copy_locked(tid)
                    key = m.key.get_state()
                else:
                    continue
                todo.append((tid, m, state, m.world, key))
        paths = [self._checkpoint_tenant(tid, state, world, key)
                 for tid, m, state, world, key in todo]
        with self._lock:
            for tid, m, *_ in todo:
                self._journal_append("checkpoint", m, state=m.state)
        return paths

    def restore(self) -> dict:
        """Replay snapshot+journal and re-admit the recorded tenant set
        from its containment checkpoints: active tenants re-join through
        the admission path, suspended and quarantined tenants restore
        held-state-only. Every restored tenant's epoch and revision
        advance past their journaled watermarks and its generator
        continues from the checkpointed state. A tenant whose checkpoint
        generations are all unreadable is reported `lost`.

        Returns ``{"restored": [...], "lost": [...], "meta": {...}}``."""
        if self._journal is None:
            return {"restored": [], "lost": [],
                    "meta": {"journal": False}}
        from jax_mapping_torch.io.checkpoint import (
            load_checkpoint_with_fallback)
        # Copies: re-admission appends records whose fold mutates the
        # live registry's rows.
        registry = {tid: dict(row)
                    for tid, row in self._journal.registry().items()}
        restored, lost = [], []
        R = self.cfg.fleet.n_robots
        for tid, row in registry.items():
            if row.get("state") in ("evicted", "new", None):
                continue
            shape = row.get("world_shape")
            dtype = row.get("world_dtype", "float32")
            if shape is None:
                lost.append(tid)
                continue
            template = {
                "fleet": FM.init_fleet_state(
                    self.cfg, device=self.device,
                    radius_uniforms=torch.zeros(R)),
                "key": torch.Generator().get_state(),
                "world": torch.zeros(tuple(shape),
                                     dtype=getattr(torch, dtype),
                                     device=self.device),
            }
            try:
                payload, _, _ = load_checkpoint_with_fallback(
                    self._live_ckpt_path(tid), template)
            except Exception:                    # noqa: BLE001
                # Missing, corrupt, or a template mismatch down the
                # generation chain: this tenant's state is gone.
                lost.append(tid)
                continue
            fleet = payload["fleet"]
            world = payload["world"]
            key_state = payload["key"]
            seed = int(row.get("seed", 0))
            if row["state"] == "active":
                self._admit(tid, world, seed, fleet, None,
                            gen_state=key_state)
                with self._lock:
                    m = self._missions[tid]
                    m.epoch = int(row.get("epoch", -1)) + 1
                    m.revision = int(row.get("revision", 0)) + 1
                    m.steps = int(row.get("steps", 0))
                    self._journal_append("restore", m,
                                         state="active")
            else:
                with self._lock:
                    m = _Mission(tid, seed, world, _generator(seed))
                    m.key.set_state(key_state)
                    m.epoch = int(row.get("epoch", -1)) + 1
                    m.revision = int(row.get("revision", 0)) + 1
                    m.steps = int(row.get("steps", 0))
                    m.state = row["state"]
                    m.held_state = fleet
                    m.held_key = key_state
                    self._missions[tid] = m
                    if row["state"] == "quarantined":
                        self._lanehealth.mark_quarantined(
                            tid, self.n_ticks)
                    self._journal_append("restore", m,
                                         state=row["state"])
            restored.append(tid)
        flight_recorder.record("tenancy_restore",
                               restored=len(restored), lost=len(lost))
        return {"restored": restored, "lost": lost,
                "meta": {"journal": True}}

    def tenant_lifecycle(self, tid: str) -> str:
        """`active` / `suspended` / `quarantined` / `evicted` /
        `unknown`: the /tiles status stamp's source."""
        with self._lock:
            m = self._missions.get(tid)
            return "unknown" if m is None else m.state

    # -- state access --------------------------------------------------------

    def live_batch(self) -> Optional[MB.TenantBatch]:
        """The current device batch (None when no tenant is active)."""
        with self._lock:
            return self._batch

    def tenant_state(self, tid: str) -> FM.FleetState:
        """The tenant's current FleetState: its live lane when active and
        healthy, the held last-good state when suspect / suspended /
        quarantined."""
        with self._lock:
            m = self._missions[tid]
            if m.held_state is not None:
                return m.held_state
            if m.state == "active":
                return self._lane_state_locked(tid)
            raise ValueError(f"tenant {tid!r} is {m.state}; no state held")

    def tenant_grid(self, tid: str):
        return self.tenant_state(tid).grid

    def epoch(self, tid: str) -> int:
        with self._lock:
            return self._missions[tid].epoch

    def revision(self, tid: str) -> int:
        with self._lock:
            return self._missions[tid].revision

    def tile_store(self, tid: str):
        """Per-tenant serving TileStore (lazily built): the tenant's grid
        through `to_gray`, revisioned by the tenant's own (epoch,
        revision) namespace."""
        with self._lock:
            store = self._tile_stores.get(tid)
            if store is None:
                # Validate before building anything: unknown ids must not
                # grow the dict.
                self._require(tid, ("active", "suspended",
                                    "quarantined"))
        if store is not None:
            return store
        from jax_mapping_torch.ops import grid as G
        from jax_mapping_torch.serving.tiles import TileStore

        def _revision() -> int:
            return self.revision(tid)

        def _snapshot():
            with self._lock:
                m = self._missions[tid]
                if m.state == "evicted" or (
                        m.state != "active" and m.held_state is None):
                    raise ValueError(
                        f"tenant {tid!r} is {m.state}; nothing to serve")
                # Revision before content; a held state serves in
                # preference to the live lane.
                rev = m.revision
                grid = (m.held_state.grid
                        if m.held_state is not None
                        else self._lane_state_locked(tid).grid)
            return rev, G.to_gray(self.cfg.grid, grid), None

        on_install = None
        if self.pipeline is not None:
            ledger = self.pipeline

            def on_install(rev, _tid=tid):
                ledger.encoded(rev, tenant=_tid)

        store = TileStore(self.cfg.serving, f"tenant:{tid}",
                          _revision, _snapshot, on_install=on_install)
        with self._lock:
            # First builder wins under concurrent HTTP readers.
            store = self._tile_stores.setdefault(tid, store)
        return store

    # -- internals -----------------------------------------------------------

    def _require(self, tid: str, states) -> _Mission:
        m = self._missions.get(tid)
        if m is None:
            raise KeyError(f"unknown tenant {tid!r}")
        allowed = (states,) if isinstance(states, str) else states
        if m.state not in allowed:
            raise ValueError(
                f"tenant {tid!r} is {m.state}, need {allowed}")
        return m

    def _lane_state_locked(self, tid: str) -> FM.FleetState:
        i = self._order.index(tid)
        return MB.lane_state(self._batch, i)

    def _lane_copy_locked(self, tid: str) -> FM.FleetState:
        return _lane_copy(self._batch, self._order.index(tid))

    def _rebuilt(self, order, extra: Optional[dict] = None):
        """(batch, prev_order, compacted) re-stacked for `order`: lanes in
        the old batch slice out of it, `extra` maps not-yet-registered
        tids to (state, world, seed). Pure compute that can raise without
        touching plane state; callers install the triple under `_lock`.
        The batch's `keys` hold the missions' seeds (bookkeeping)."""
        old_cap = (0 if self._batch is None
                   else int(self._batch.active.shape[0]))
        if not order:
            return None, [], old_cap > 0
        states, worlds, keys = [], [], []
        for tid in order:
            if extra is not None and tid in extra:
                s, w, k = extra[tid]
            else:
                m = self._missions[tid]
                if m.state == "quarantined" \
                        and m.held_state is not None:
                    # A quarantined lane's live state may be poisoned;
                    # the held state carries across the rebuild.
                    s, w, k = m.held_state, m.world, m.seed
                else:
                    s, w, k = self._old_lane(tid), m.world, m.seed
            states.append(s)
            worlds.append(w)
            keys.append(k)
        cap = MB.bucket_capacity(len(order),
                                 self.cfg.tenancy.max_tenants,
                                 exact=self.cfg.tenancy.bit_exact_buckets)
        batch = MB.make_tenant_batch(states, worlds, keys, capacity=cap)
        frozen = [i for i, tid in enumerate(order)
                  if tid in self._missions
                  and self._missions[tid].state == "quarantined"
                  and not (extra is not None and tid in extra)]
        if frozen:
            # Quarantined lanes come back frozen. A lane given in `extra`
            # is live: the readmission of a restored quarantined tenant
            # rebuilds while its record still says quarantined (the JAX
            # package freezes that lane too, so it stays frozen there
            # until the next rebuild while its revision counts on).
            act = batch.active.clone()
            act[frozen] = False
            batch = batch._replace(active=act)
        return batch, list(order), cap < old_cap

    def _old_lane(self, tid: str) -> FM.FleetState:
        if self._batch is None or tid not in self._prev_order:
            raise KeyError(f"tenant {tid!r} has no live lane to carry")
        return MB.lane_state(self._batch, self._prev_order.index(tid))

    def _prewarm_signature(self, bucket: int, template: FM.FleetState,
                           world) -> tuple:
        """The abstract `megabatch_step` call of a `bucket`-wide batch of
        `template`'s shapes, laid out as `megabatch_tick` makes it
        (normals passed positionally, zeros when materialised: the warm
        call draws from no generator), so that its signature key is the
        live tick's."""
        from jax_mapping_torch.obs import devprof as DP
        dev = str(world.device)

        def spec(x):
            return DP.TensorSpec((bucket,) + tuple(x.shape),
                                 _dtype_name(x.dtype), str(x.device))

        batch = MB.TenantBatch(
            states=MB._tree_map(spec, template), worlds=spec(world),
            keys=DP.TensorSpec((bucket,), "int64", dev),
            active=DP.TensorSpec((bucket,), "bool", dev))
        normals = DP.TensorSpec((bucket, self.cfg.fleet.n_robots, 2),
                                "float32", dev)
        return ((self.cfg, batch, self.world_res_m, normals), {})

    def _prewarm_bucket(self, bucket: int, template: FM.FleetState,
                        world) -> bool:
        """Run the megabatch once at `bucket`'s width BEFORE the tenant
        joins, through the StagedWarmup ladder: begin_warming -> zeros
        pre-warm (builds or loads the kernels' libraries) -> readiness
        gate + devprof rebaseline -> ready. Returns True when a warm-up
        ran."""
        with self._lock:
            if not self.cfg.tenancy.prewarm_on_admit \
                    or bucket in self._warmed_buckets:
                return False
        sig = self._prewarm_signature(bucket, template, world)
        self.warmup.begin_warming()
        # manifest=False: warm only this bucket's signature, not the
        # persisted warm sweep (the restart path's job).
        self.warmup.prewarm(signatures={MEGABATCH_ENTRY: [sig]},
                            force=True, manifest=False)
        self.warmup.mark_ready()
        with self._lock:
            self._warmed_buckets.add(bucket)
            self.n_prewarms += 1
        return True

    # -- exports -------------------------------------------------------------

    def status(self) -> dict:
        """The /status `tenancy` object (one consistent section)."""
        with self._lock:
            # Quarantined tenants keep their frozen lane: occupancy counts
            # slots, n_active counts live missions.
            occupied = len(self._order)
            n_active = sum(
                1 for t in self._order
                if self._missions[t].state == "active")
            cap = (0 if self._batch is None
                   else int(self._batch.active.shape[0]))
            tenants = {
                tid: {"state": m.state, "epoch": m.epoch,
                      "revision": m.revision, "steps": m.steps,
                      "seed": m.seed}
                for tid, m in sorted(self._missions.items())}
            counters = dict(
                n_admitted=self.n_admitted, n_evicted=self.n_evicted,
                n_suspended=self.n_suspended, n_resumed=self.n_resumed,
                n_prewarms=self.n_prewarms, n_ticks=self.n_ticks,
                n_compactions=self.n_compactions,
                n_quarantined=self.n_quarantined)
            warmed = sorted(self._warmed_buckets)
            health = self._lanehealth.snapshot()
            admission = {
                "in_flight": self._admissions_in_flight,
                "queue_max": self.cfg.tenancy.admission_queue_max,
                "n_rejected": self.n_admissions_rejected,
            }
            journal = None
            if self._journal is not None:
                journal = {"seq": self._journal.seq,
                           "n_appends": self._journal.n_appends,
                           "n_compactions": self._journal.n_compactions}
        n_susp = sum(1 for t in tenants.values()
                     if t["state"] == "suspended")
        n_evic = sum(1 for t in tenants.values()
                     if t["state"] == "evicted")
        n_quar = sum(1 for t in tenants.values()
                     if t["state"] == "quarantined")
        return {
            "n_active": n_active,
            "n_suspended": n_susp,
            "n_evicted": n_evic,
            "n_quarantined_now": n_quar,
            "bucket_capacity": cap,
            "bucket_occupancy": (occupied / cap) if cap else 0.0,
            "pad_waste_frac": ((cap - occupied) / cap) if cap else 0.0,
            "warmed_buckets": warmed,
            "warmup": self.warmup.snapshot(),
            "tenants": tenants,
            "health": health,
            "admission": admission,
            "journal": journal,
            **counters,
        }

    def metric_families(self):
        """`jax_mapping_tenant_*` gauge families for the /metrics registry
        (obs/registry.py), from one status snapshot per render."""
        from jax_mapping_torch.obs.registry import Family
        s = self.status()
        return (
            Family("jax_mapping_tenant_active", "gauge",
                   (("", str(s["n_active"])),)),
            Family("jax_mapping_tenant_suspended", "gauge",
                   (("", str(s["n_suspended"])),)),
            Family("jax_mapping_tenant_evicted", "gauge",
                   (("", str(s["n_evicted"])),)),
            Family("jax_mapping_tenant_bucket_capacity", "gauge",
                   (("", str(s["bucket_capacity"])),)),
            Family("jax_mapping_tenant_bucket_occupancy", "gauge",
                   (("", f"{s['bucket_occupancy']:.4f}"),)),
            Family("jax_mapping_tenant_pad_waste_frac", "gauge",
                   (("", f"{s['pad_waste_frac']:.4f}"),)),
            Family("jax_mapping_tenant_ticks_total", "counter",
                   (("", str(s["n_ticks"])),)),
            Family("jax_mapping_tenant_quarantined", "gauge",
                   (("", str(s["n_quarantined_now"])),)),
            Family("jax_mapping_tenant_quarantines_total", "counter",
                   (("", str(s["n_quarantined"])),)),
            Family("jax_mapping_tenant_admission_rejected_total",
                   "counter",
                   (("", str(s["admission"]["n_rejected"])),)),
        )
