"""The lock-protection map: which lock guards which correlated state.

The JAX package's `analysis/protection.py` on the port's classes (their
names, locks and fields are JAX's, except where the group says). The
map's rationale, as in JAX:

The B-family checkers *derive* lock/state relations from syntax (any
attr touched under ``with self.<lock>``). That is the right default for
"is this write guarded at all" (B3), but two hazard families need more
than derivation can give:

* **Snapshot tears (C2)** are about *correlation*: ``poses`` and
  ``grid`` are each individually guarded, yet reading them in two
  separate lock regions produces a pose/grid pairing no writer ever
  created (the historical ``publish_frontiers`` tear). Which fields
  form one consistent snapshot is a *design fact*, not a syntactic one
  — so it is declared here, reviewed like code.
* **The dynamic race detector (racewatch)** implements Eraser's lockset
  refinement, which needs to know which fields are *supposed* to be
  lock-protected shared state (fields deliberately read lock-free by
  the /status counter convention must not be watched — Eraser would
  correctly empty their candidate lockset and incorrectly call it a
  bug).

One map feeds both: a :class:`LockGroup` names a class, the lock
attribute, and the set of instance fields that form one correlated
snapshot under it. `REPO_PROTECTION` is the committed map for this
repo's bridge/serving classes; checkers and racewatch default to it
but accept a custom list so fixture tests declare their own.

Curation rules (enforced by tests/test_torch_analysis_selfcheck.py):

* every named class must exist in the package and own the named lock;
* every named field must be assigned somewhere in that class;
* fields read lock-free BY DESIGN (monotonic counters: `map_revision`
  via `serving_revision()`, `n_images_fused`, tick counters) are listed
  in `lockfree_ok`, NOT in `fields` — the C2 checker still treats their
  *in-region* reads as part of the snapshot, but racewatch must not
  watch them.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Sequence


@dataclass(frozen=True)
class LockGroup:
    """One correlated-snapshot declaration.

    `cls`: class name (matches `ClassInfo.name`).
    `lock_attr`: the instance lock attribute guarding the group.
    `fields`: instance attributes forming ONE consistent snapshot —
        reading two of them in two separate atomic sections is a tear,
        and EVERY access must hold the lock (racewatch instruments
        exactly these).
    `lockfree_ok`: attributes in the same consistency story whose
        design sanctions lock-free accesses — monotonic counters read
        by the /status convention, set-once references None-checked
        before locking, single-writer fields whose owning thread reads
        its own state bare (the baselined-B3 discipline). C2 counts
        their in-region reads as part of the snapshot; racewatch must
        NOT watch them (Eraser would empty their candidate lockset and
        report the *convention*).
    `extra_locks`: further lock attributes racewatch must instrument so
        held-locksets are accurate (e.g. the TileStore's
        `_refresh_lock`, under which `_install` legitimately reads hash
        state before committing under `_lock`).
    """
    cls: str
    lock_attr: str
    fields: FrozenSet[str]
    lockfree_ok: FrozenSet[str] = frozenset()
    extra_locks: FrozenSet[str] = frozenset()

    @property
    def all_fields(self) -> FrozenSet[str]:
        return self.fields | self.lockfree_ok

    def watchable_fields(self) -> FrozenSet[str]:
        """What racewatch instruments: strictly lock-guarded fields."""
        return self.fields


def group(cls: str, lock_attr: str, fields: Sequence[str],
          lockfree_ok: Sequence[str] = (),
          extra_locks: Sequence[str] = ()) -> LockGroup:
    return LockGroup(cls=cls, lock_attr=lock_attr,
                     fields=frozenset(fields),
                     lockfree_ok=frozenset(lockfree_ok),
                     extra_locks=frozenset(extra_locks))


#: The committed map. Each entry documents a consistency contract the
#: code comments already state in prose; a PR that changes the contract
#: must change this map in the same diff (the selfcheck pins existence
#: of every class/lock/field so renames can't silently orphan a row).
REPO_PROTECTION: List[LockGroup] = [
    # The 2D mapper's publish/serving snapshot: poses, shared grid,
    # revision and the dirty-tile bookkeeping move together — the
    # tear fix put all four under ONE _state_lock section. `states` is
    # single-writer (the tick thread reads its own entries bare, the
    # baselined-B3 `_prev_paired` discipline) and `map_revision` is a
    # /status-convention counter: both are snapshot members for C2 but
    # out of racewatch's scope.
    group("MapperNode", "_state_lock",
          ["shared_grid", "_dirty_tiles"],
          lockfree_ok=["map_revision", "states", "_tile_rev",
                       # Serving restart epoch: set once before the
                       # replacement node serves (launch.restart_mapper),
                       # then read-only. Decay clock: tick-thread-only
                       # state, the _prev_paired single-writer
                       # discipline (its grid swap runs under
                       # _state_lock like every install).
                       "restart_epoch", "_decay_ticks"],
          extra_locks=["_dirty_lock"]),
    # Scripted world dynamics (scenarios/dynamics.py): the door/crowd
    # registries and the change flag move together — FaultPlan mutators
    # and the SimNode composer may live on different threads in
    # realtime stacks. n_recomposes is a /status-convention counter.
    group("WorldDynamics", "_lock",
          ["_door_closed", "_crowds", "_dirty"],
          lockfree_ok=["n_recomposes"]),
    # Rendezvous merger (scenarios/rendezvous.py): the verification
    # streak is the guarded correlated state; the published merge
    # result is single-writer (the stack-driving thread) and set-once —
    # post-merge readers take it bare by design, like the mapper's
    # states.
    group("RendezvousMerger", "_lock",
          ["_streak", "n_attempts", "n_accepted"],
          lockfree_ok=["transform", "merged_grid", "merged_states",
                       "merged"]),
    # The voxel mapper's grid/revision pair (the ordering hazard)
    # plus the keyframe ring the closure re-fuse reads with them.
    group("VoxelMapperNode", "_lock",
          ["grid", "_keyframes"],
          lockfree_ok=["map_revision", "n_images_fused"]),
    # Tile store: bytes, stamps, hash state and the store revision are
    # installed atomically — a reader pairing tiles from one install
    # with the revision of another would violate the no-stale-serve
    # contract in serving/tiles.py's module docstring. `_refresh_lock`
    # is instrumented too: `_install` legitimately reads `_hashes`
    # under it alone (single-flighted), so without it in the lockset
    # the candidate for `_hashes` empties spuriously.
    group("TileStore", "_lock",
          ["_tiles", "_hashes", "_level_sizes", "revision"],
          extra_locks=["_refresh_lock"]),
    # Event channel: subscriber list + the closed-subscriber drop
    # carry-over (n_dropped_total must stay Prometheus-monotonic).
    group("EventChannel", "_lock",
          ["_subs", "_n_dropped_closed"]),
    # Per-client event mailbox: queue contents and the closed flag.
    group("EventSubscription", "_lock",
          ["_queue", "_closed"]),
    # Causal tracer (obs/trace.py): the span ring, the ever-recorded
    # counter (also the per-span `seq` stamp `/trace?since=` filters
    # on) and the per-scope sequence table mutate together — spans are
    # emitted from the bus delivery, mapper tick, brain tick AND HTTP
    # handler threads at once, which is exactly the cross-thread
    # emission the obs racewatch gate hammers (tests/test_obs.py).
    group("Tracer", "_lock",
          ["_spans", "n_spans", "_seq"]),
    # Flight recorder (obs/recorder.py): event ring + counter move
    # together under `_lock`; the dump bookkeeping is read lock-free by
    # design (MissionReport links `dumps` basenames post-mission, the
    # /status counter convention), and the configure() targets are
    # re-pointed between stacks but always under the lock.
    group("FlightRecorder", "_lock",
          ["_ring", "n_events", "_dump_dir", "_tracer", "_dump_seq",
           "_pipeline"],
          lockfree_ok=["n_dumps", "dumps"]),
    # Pipeline latency ledger (obs/pipeline.py): the pending waypoint
    # table, hop histograms, sample windows, record ring and the
    # last-install/last-delivered marks mutate together under `_lock`
    # from the mapper tick thread (installed/notified), HTTP workers
    # (encoded on tile-store refresh, delivered on /tiles responses)
    # and the tenancy stepping thread at once — exactly the
    # cross-thread stamp emission the ledger racewatch gate hammers
    # (tests/test_obs.py). `n_stamps` is the setattr write witness
    # (container mutation records as a read — the documented racewatch
    # limit); the completion counters read lock-free by the /status
    # convention.
    group("PipelineLedger", "_lock",
          ["_pending", "_hists", "_samples", "_records", "_ages",
           "_last_install_tick", "_last_delivered", "_delivered_epoch",
           "_tick", "_notified_rev", "_encoded_rev", "n_stamps"],
          lockfree_ok=["n_completed", "n_evicted"]),
    # Freshness SLO engine (obs/slo.py): per-objective window state
    # and the alert history move together — the mapper tick thread
    # evaluates while HTTP workers read status()/metric_families().
    group("SloEngine", "_lock",
          ["_objs", "_alerts", "n_evaluations"]),
    # Declarative /metrics registry (obs/registry.py): the source list
    # is append-only under `_lock`; render() snapshots it there, then
    # collects outside (no foreign collector code under our lock).
    group("MetricsRegistry", "_lock",
          ["_sources"]),
    # Dispatch profiler (obs/devprof.py): the per-function profile
    # table mutates under `_lock` from every thread that dispatches a
    # wrapped jitted function at once — mapper tick, HTTP workers
    # (serving tile hashing), test drivers — exactly the cross-thread
    # emission the devprof racewatch gate hammers (tests/test_obs.py).
    # `_bindings`/`installed` are install-time state serialized by the
    # module-level _INSTALL_LOCK (not an instance attribute, so out of
    # racewatch's instance scope — the lockfree_ok escape documents
    # that, it does not sanction bare mutation).
    group("DispatchProfiler", "_lock",
          ["_profiles"],
          lockfree_ok=["_bindings", "installed"]),
    # Cost ledger (obs/ledger.py): ONE keyed structure holds both the
    # reservation (None entry, AOT compile in flight) and the finished
    # cost entries — deliberately a single field so there is no
    # correlated pair to tear across collect()'s two lock sections
    # (the C2 class this layout exists to avoid).
    group("CostLedger", "_lock",
          ["_collected"]),
    # Staged warm-up state machine (resilience/warmup.py): the stage,
    # the warmed-entry log and the report install together at each
    # transition; HTTP workers read snapshot()/state() while the
    # restarting step thread moves the machine — exactly the
    # cross-thread window the warm-up racewatch gate hammers. The
    # wiring references (cache/devprof/budget_path) are set-once at
    # construction, read-only after (the lockfree_ok convention).
    group("StagedWarmup", "_lock",
          ["_state", "_warmed", "_report"],
          lockfree_ok=["cache", "devprof", "budget_path"]),
    # Compile-cache manager (io/compile_cache.py): wipe refcount +
    # counters move together under `_lock` (a cache_wipe window racing
    # a status read must never tear refs from counts); `enabled` and
    # `fingerprint` are set-once-per-enable flags read bare by the
    # status convention, file I/O runs outside the lock entirely.
    group("CompileCacheManager", "_lock",
          ["_wipe_refs", "_counts"],
          lockfree_ok=["enabled", "fingerprint"]),
    # Tenant control plane (tenancy/controlplane.py): the mission
    # registry, lane order, live batch, warmed-bucket set, per-tenant
    # tile stores and the lifecycle counters form ONE consistent
    # snapshot under `_lock` — admissions/evictions from operator or
    # HTTP threads race the stepping thread, which is exactly the
    # cross-thread churn the tenancy racewatch gate hammers
    # (tests/test_tenancy.py), joined by the lane-health
    # ladder, the poison set and the quarantine/admission counters —
    # the sentinel fold and the /status reader race across threads
    # (tests/test_tenant_containment.py's racewatch gate). The wiring
    # references (cfg, world_res_m, checkpoint_dir, warmup, pipeline,
    # _journal) are set-once at construction, read-only after (the
    # StagedWarmup convention; the journal's own file state is only
    # ever touched under `_lock`).
    group("TenantControlPlane", "_lock",
          ["_missions", "_order", "_prev_order", "_batch",
           "_warmed_buckets", "_tile_stores", "_last_diag",
           "_lanehealth", "_poisoned", "_admissions_in_flight",
           "n_admitted", "n_evicted", "n_suspended", "n_resumed",
           "n_prewarms", "n_ticks", "n_compactions",
           "n_quarantined", "n_admissions_rejected"],
          lockfree_ok=["cfg", "world_res_m", "checkpoint_dir",
                       "warmup", "pipeline", "_journal"]),
    # Warm pool (io/compile_cache.py): the port's pool serves no call
    # and installs no wrapper (the warm-up pre-warms its entries on
    # zeros), so the entry table and its drop counter are the whole
    # group — JAX's serve/fallthrough counters and install-time
    # bindings have no counterpart. `installed` is a constant kept for
    # JAX's `stats()` shape.
    group("WarmPool", "_lock",
          ["_entries", "n_dropped"],
          lockfree_ok=["installed"]),
    # Sliding-window world store (world/store.py): the host LRU, the
    # away-set (the serving evicted-marker mask), the in-flight
    # prefetch table and the admission generation stamp mutate
    # together under `_lock` — the mapper tick thread evicts and
    # rehydrates while HTTP workers compose serving mosaics and read
    # /status, exactly the evict-vs-serve pair the world racewatch
    # gate hammers (tests/test_world.py). `origin_tile` and
    # `decay_epoch` are tick-thread single-writer (shift()/
    # note_decay_pass() run only on the mapper tick, which also owns
    # the device grid; foreign readers take the point-in-time value by
    # the /status convention); `eviction_epoch` bumps under the lock
    # but is read bare as the serving ETag suffix; the schedule log is
    # appended from both in- and out-of-lock sites by design (the
    # shift note stamps on the single-writer tick thread). `spill` and
    # `governor` are set-once wiring references.
    group("WorldStore", "_lock",
          ["_host", "_away", "_pending", "_gen"],
          lockfree_ok=["origin_tile", "decay_epoch", "eviction_epoch",
                       "schedule", "n_schedule_events", "n_shifts",
                       "n_evictions", "n_rehydrated_host",
                       "n_rehydrated_disk", "n_lost",
                       "n_corrupt_spills", "spill", "governor"]),
    # Memory-pressure governor (world/governor.py): its own `_lock`
    # guards only the named-hold table (FaultPlan threads arm/clear
    # squeezes while the tick thread reads the worst-of). The rung and
    # the shed counters are serialized by the STORE's `_lock` instead
    # (observe()/_shed() run only inside WorldStore lock sections) and
    # read bare by /status — out of this lock's racewatch scope, same
    # as the DispatchProfiler's module-lock escape.
    group("MemoryGovernor", "_lock",
          ["_pressure"],
          lockfree_ok=["rung", "n_spills", "n_drops", "n_coarsened",
                       "n_refused", "n_rung_changes", "cfg"]),
    # Disk spill tier (world/spill.py): the offset index is the
    # guarded state — eviction appends from the tick thread while
    # prefetch threads seek-read and chaos rewrites frames. `_f` is
    # opened once at (single-threaded) construction and thereafter a
    # read-only reference whose file OPERATIONS serialize under
    # `_lock`; the read/corrupt counters follow the /status
    # convention (n_reads deliberately increments outside the lock —
    # a monotonic gauge, not snapshot state).
    group("SpillStore", "_lock",
          ["_index"],
          lockfree_ok=["_f", "n_appends", "n_reads",
                       "n_corrupt_reads", "n_truncated_bytes"]),
]


def groups_by_class(protection: Sequence[LockGroup] = None
                    ) -> Dict[str, List[LockGroup]]:
    out: Dict[str, List[LockGroup]] = {}
    for g in (REPO_PROTECTION if protection is None else protection):
        out.setdefault(g.cls, []).append(g)
    return out
