"""Tenant blast-radius containment on the port's control plane: the
quarantine cycle, the durable journal and crash restore, bounded
admission, the serving client's tenant signals, the tenant FaultPlan
kinds through the stack, and the drill.

These are the JAX package's tests/test_tenant_containment.py (from its
journal tests on, plus the quarantine cycle) run on the port, with one
change: the solo oracle draws its wheel noise from the tenant's seeded
generator, as the port's plane does. The journal is also held to the JAX
package's `ControlJournal` byte for byte (that module imports no JAX; it
is loaded from its file, without the package).
"""

import dataclasses
import hashlib
import importlib.util
import json
import os
import threading

import numpy as np
import pytest
import torch

from jax_mapping_torch.config import (SloObjective, TenancyConfig,
                                      micro_config)
from jax_mapping_torch.models import fleet as FL
from jax_mapping_torch.sim import world as W
from jax_mapping_torch.tenancy import megabatch as MB
from jax_mapping_torch.tenancy.controlplane import (AdmissionRejected,
                                                    TenantControlPlane)
from jax_mapping_torch.tenancy.journal import (ControlJournal, read_journal,
                                               read_registry)
from jax_mapping_torch.tenancy.lanehealth import (HEALTHY, QUARANTINED,
                                                  SUSPECT)
from tests.torch_jaxref import REPO
from tests.torch_threads import one_intra_op_thread  # noqa: F401

#: The one armed shape (buckets {1, 2}): persist 2 and probe cadence 3
#: give the canonical timeline — poison at tick 4 -> suspect(4) ->
#: quarantined(5) -> probe + readmit(8).
_ARMED = TenancyConfig(
    enabled=True, prewarm_on_admit=False, lane_health=True,
    quarantine_persist_ticks=2, readmit_probe_ticks=3,
    max_readmit_probes=2, journal=True)
ACFG = micro_config().replace(tenancy=_ARMED)
RES = ACFG.grid.resolution_m


@pytest.fixture(scope="module")
def world_np():
    return W.empty_arena(ACFG.grid.size_cells, RES)


def _plane(cfg=ACFG, **kw):
    return TenantControlPlane(cfg, device="cpu", **kw)


def _solo_run(cfg, world, seed, n_steps):
    g = torch.Generator().manual_seed(seed)
    s = FL.init_fleet_state(cfg, device="cpu", generator=g)
    for _ in range(n_steps):
        s, _ = FL.fleet_step(cfg, s, RES, torch.as_tensor(world),
                             generator=g)
    return s


def _leaves(tree):
    out = []
    MB._tree_map(out.append, tree)
    return out


def _assert_bit_equal(a, b, what):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert torch.equal(x, y), what


def _tile_digest(cp, tid: str) -> str:
    store = cp.tile_store(tid)
    store.refresh()
    _, entries, _ = store.tiles_since(-1)
    return hashlib.sha256(
        json.dumps(entries, sort_keys=True).encode()).hexdigest()


# ------------------------------------------------------------ quarantine

def test_quarantine_probe_readmit_cycle(world_np, tmp_path):
    """A poisoned tenant walks suspect -> quarantined on the canonical
    timeline, its revision freezes on the held last-good content, the
    co-tenant equals a no-fault twin (state and served tile bytes), a
    probe re-admits with an epoch bump, and the readmitted lane continues
    its solo run (its generator back at the held state)."""
    from jax_mapping_torch.obs.recorder import flight_recorder

    cp = _plane(checkpoint_dir=str(tmp_path / "a"))
    twin = _plane(checkpoint_dir=str(tmp_path / "b"))
    for plane in (cp, twin):
        plane.admit("sick", world_np, seed=0)
        plane.admit("ok", world_np, seed=1)
    cp.step(3)
    twin.step(3)
    mark = flight_recorder.mark()
    cp.set_tenant_poison("sick", True)
    cp.step(2)
    twin.step(2)
    assert cp.tenant_lifecycle("sick") == "quarantined"
    assert cp.status()["n_quarantined_now"] == 1
    assert cp.revision("sick") == 3
    assert cp.revision("ok") == 5
    _assert_bit_equal(cp.tenant_state("sick"), _solo_run(ACFG, world_np, 0, 3),
                      "held last-good != pre-fault content")
    cp.set_tenant_poison("sick", False)
    cp.step(3)
    twin.step(3)
    assert cp.tenant_lifecycle("sick") == "active"
    assert cp.epoch("sick") == 1
    cp.step(1)
    twin.step(1)
    _assert_bit_equal(cp.tenant_state("sick"), _solo_run(ACFG, world_np, 0, 4),
                      "readmitted lane != held-state solo run")
    _assert_bit_equal(cp.tenant_state("ok"), twin.tenant_state("ok"),
                      "co-tenant state diverged from twin")
    assert _tile_digest(cp, "ok") == _tile_digest(twin, "ok")
    kinds = [e["kind"] for e in flight_recorder.events_since(mark)]
    assert {"tenancy_quarantine", "tenancy_readmit_probe",
            "tenancy_readmit"} <= set(kinds)
    assert [(t, a, b) for t, _tid, a, b in cp._lanehealth.transitions] == [
        (4, HEALTHY, SUSPECT), (5, SUSPECT, QUARANTINED),
        (8, QUARANTINED, HEALTHY)]


def test_state_jump_is_survivable_state_fault(world_np):
    cp = _plane()
    cp.admit("t", world_np, seed=0)
    cp.step(1)
    before = cp.tenant_state("t").est_poses.clone()
    cp.state_jump_tenant("t", 1.5)
    after = cp.tenant_state("t").est_poses
    d = (after - before)[..., :2].numpy()
    np.testing.assert_allclose(d, 1.5, rtol=1e-6)
    assert bool(torch.isfinite(after).all())
    cp.evict("t", checkpoint=False)


# ------------------------------------------------------------ journal

def _jax_journal_module():
    """The JAX package's journal module, loaded from its file (it imports
    no JAX) without importing the package."""
    path = REPO / "jax_mapping" / "tenancy" / "journal.py"
    spec = importlib.util.spec_from_file_location("_jax_journal", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


JOURNAL_SEQUENCE = [
    ("admit", "a", dict(seed=3, epoch=0, revision=1, steps=0,
                        world_shape=[64, 64], world_dtype="bool")),
    ("admit", "b", dict(seed=4, epoch=0, revision=1, steps=0)),
    ("suspend", "b", dict(epoch=0, revision=5, steps=4)),
    ("quarantine", "a", dict(epoch=0, revision=7, steps=9, word=1)),
    ("compact", "", {}),
    ("checkpoint", "a", dict(state="quarantined", epoch=0, revision=7,
                             steps=9)),
    ("evict", "b", dict(epoch=0, revision=5, steps=4)),
]


def test_journal_bytes_equal_jax_journal(tmp_path):
    """The same record sequence (with a compaction) writes the same
    journal and snapshot bytes, and folds the same registry, in both
    packages."""
    J = _jax_journal_module()
    files = {}
    for name, cls in (("port", ControlJournal), ("jax", J.ControlJournal)):
        d = tmp_path / name
        j = cls(str(d))
        for kind, tid, fields in JOURNAL_SEQUENCE:
            if kind == "compact":
                j.compact()
            else:
                j.append(kind, tid, **fields)
        files[name] = ((d / "control.journal").read_bytes(),
                       (d / "registry.json").read_bytes(), j.registry())
    assert files["port"] == files["jax"]
    assert read_registry(str(tmp_path / "port"))[:2] == \
        J.read_registry(str(tmp_path / "jax"))[:2]


def test_journal_roundtrip_compaction_and_reopen(tmp_path):
    d = str(tmp_path)
    j = ControlJournal(d)
    j.append("admit", "a", seed=3, epoch=0, revision=1, steps=0,
             world_shape=[64, 64], world_dtype="float32")
    j.append("admit", "b", seed=4, epoch=0, revision=1, steps=0)
    j.append("suspend", "b", epoch=0, revision=5, steps=4)
    j.append("quarantine", "a", epoch=0, revision=7, steps=9, word=1)
    reg = j.registry()
    assert reg["a"]["state"] == "quarantined"
    assert reg["a"]["world_shape"] == [64, 64]
    assert reg["b"]["state"] == "suspended"
    with pytest.raises(ValueError, match="unknown journal record"):
        j.append("frobnicate", "a")
    j.compact()
    assert os.path.getsize(j.journal_path) == 0
    reg2, seq, meta = read_registry(d)
    assert reg2 == reg and seq == j.seq
    assert meta["snapshot"] and meta["n_replayed"] == 0
    j.append("evict", "b", epoch=0, revision=5, steps=4)
    reg3, _, meta3 = read_registry(d)
    assert reg3["b"]["state"] == "evicted"
    assert meta3["n_replayed"] == 1
    j2 = ControlJournal(d)
    assert j2.seq == j.seq
    assert j2.registry()["a"]["state"] == "quarantined"
    assert j2.append("resume", "b") == j.seq + 1


def test_journal_torn_tail_truncates(tmp_path):
    d = str(tmp_path)
    j = ControlJournal(d)
    j.append("admit", "a", seed=0)
    j.append("admit", "b", seed=1)
    good_size = os.path.getsize(j.journal_path)
    with open(j.journal_path, "ab") as f:
        f.write(b"\xff\x00\x00\x00partial")
    recs, truncated = read_journal(j.journal_path)
    assert [r["tid"] for r in recs] == ["a", "b"]
    assert truncated > 0
    assert os.path.getsize(j.journal_path) == good_size
    with open(j.journal_path, "rb+") as f:
        f.seek(good_size - 5)
        f.write(b"\x00")
    recs2, _ = read_journal(j.journal_path)
    assert [r["tid"] for r in recs2] == ["a"]
    reg, _, meta = read_registry(d)
    assert set(reg) == {"a"}
    assert meta["torn_bytes_truncated"] == 0


def test_snapshot_newer_than_journal_tail(tmp_path):
    d = str(tmp_path)
    j = ControlJournal(d)
    j.append("admit", "a", seed=0)
    j.append("suspend", "a")
    j.compact()
    stale = ControlJournal(str(tmp_path / "scratch"))
    stale.append("evict", "a")
    with open(stale.journal_path, "rb") as f:
        raw = f.read()
    with open(j.journal_path, "ab") as f:
        f.write(raw)
    reg, seq, meta = read_registry(d)
    assert reg["a"]["state"] == "suspended"
    assert seq == 2 and meta["n_replayed"] == 0


# ------------------------------------------------------------ restore

def test_restore_crash_roundtrip(world_np, tmp_path):
    """Plane crash -> rebuild -> restore: the same tenant set, every
    epoch advanced, states bit-equal to the checkpointed ones, the
    restored quarantine probing on the new plane's clock."""
    ckdir = str(tmp_path)
    cp = _plane(checkpoint_dir=ckdir)
    cp.admit("a", world_np, seed=0)
    cp.admit("q", world_np, seed=1)
    cp.step(3)
    cp.set_tenant_poison("q", True)
    cp.step(2)
    assert cp.tenant_lifecycle("q") == "quarantined"
    cp.checkpoint_all()
    a_state = cp.tenant_state("a")
    q_held = cp.tenant_state("q")
    a_epoch, q_epoch = cp.epoch("a"), cp.epoch("q")
    a_rev = cp.revision("a")
    cp2 = _plane(checkpoint_dir=ckdir)
    report = cp2.restore()
    assert sorted(report["restored"]) == ["a", "q"]
    assert report["lost"] == []
    assert cp2.tenant_lifecycle("a") == "active"
    assert cp2.tenant_lifecycle("q") == "quarantined"
    assert cp2.epoch("a") == a_epoch + 1
    assert cp2.epoch("q") == q_epoch + 1
    assert cp2.revision("a") == a_rev + 1
    _assert_bit_equal(cp2.tenant_state("a"), a_state, "restored active")
    _assert_bit_equal(cp2.tenant_state("q"), q_held, "restored held")
    cp2.step(3)
    assert cp2.tenant_lifecycle("q") == "active"
    assert cp2.epoch("q") == q_epoch + 2
    cp2.step(1)
    assert cp2.revision("a") > a_rev + 1
    # Both continue their generator streams from the checkpoints.
    _assert_bit_equal(cp2.tenant_state("a"), _solo_run(ACFG, world_np, 0, 9),
                      "restored a's stream")
    _assert_bit_equal(cp2.tenant_state("q"), _solo_run(ACFG, world_np, 1, 4),
                      "readmitted q's stream")


def test_restore_all_corrupt_checkpoints_reports_lost(world_np, tmp_path):
    ckdir = str(tmp_path)
    cp = _plane(checkpoint_dir=ckdir)
    cp.admit("keep", world_np, seed=0)
    cp.admit("gone", world_np, seed=1)
    cp.step(2)
    cp.checkpoint_all()
    for name in os.listdir(ckdir):
        if name.startswith("tenant_gone.live."):
            p = os.path.join(ckdir, name)
            with open(p, "rb+") as f:
                f.truncate(max(1, os.path.getsize(p) // 3))
    cp2 = _plane(checkpoint_dir=ckdir)
    report = cp2.restore()
    assert report["restored"] == ["keep"]
    assert report["lost"] == ["gone"]
    assert cp2.tenant_lifecycle("keep") == "active"
    cp2.step(1)


def test_restore_with_torn_journal_tail(world_np, tmp_path):
    ckdir = str(tmp_path)
    cp = _plane(checkpoint_dir=ckdir)
    cp.admit("a", world_np, seed=0)
    cp.step(1)
    cp.checkpoint_all()
    jpath = os.path.join(ckdir, "controlplane", "control.journal")
    with open(jpath, "ab") as f:
        f.write(b"\x40\x00\x00\x00torn-mid-record")
    cp2 = _plane(checkpoint_dir=ckdir)
    report = cp2.restore()
    assert report["restored"] == ["a"] and report["lost"] == []


# ------------------------------------------------------------ admission

def test_admission_backpressure_rejects(world_np):
    """With `admission_queue_max=1`, a second admission entering while
    one is in flight raises AdmissionRejected, counts it, records it and
    leaves no trace of the rejected tenant."""
    from jax_mapping_torch.obs.recorder import flight_recorder

    cfg = ACFG.replace(tenancy=dataclasses.replace(
        _ARMED, journal=False, admission_queue_max=1))
    cp = _plane(cfg)
    inner = cp._admit
    entered = threading.Event()
    release = threading.Event()

    def gated(tid, world, seed, state, dynamics):
        entered.set()
        assert release.wait(30)
        return inner(tid, world, seed, state, dynamics)

    cp._admit = gated
    mark = flight_recorder.mark()
    t = threading.Thread(target=cp.admit, args=("slow", world_np),
                         kwargs={"seed": 0})
    t.start()
    try:
        assert entered.wait(30)
        with pytest.raises(AdmissionRejected, match="in flight"):
            cp.admit("burst", world_np, seed=1)
    finally:
        release.set()
        t.join(timeout=60)
    assert not t.is_alive()
    cp._admit = inner
    st = cp.status()
    assert st["admission"] == {"in_flight": 0, "queue_max": 1,
                               "n_rejected": 1}
    events = [e for e in flight_recorder.events_since(mark)
              if e["kind"] == "tenancy_admission_rejected"]
    assert len(events) == 1 and events[0]["tenant"] == "burst"
    fams = {f.name for f in cp.metric_families()}
    assert "jax_mapping_tenant_admission_rejected_total" in fams
    assert cp.tenant_lifecycle("slow") == "active"
    assert cp.tenant_lifecycle("burst") == "unknown"


def test_admission_backpressure_concurrent_consistency(world_np):
    cfg = ACFG.replace(tenancy=dataclasses.replace(
        _ARMED, journal=False, admission_queue_max=1))
    cp = _plane(cfg)
    outcomes = []
    gate = threading.Barrier(4)

    def admit_one(i):
        try:
            gate.wait(30)
            cp.admit(f"c{i}", world_np, seed=i)
            outcomes.append(("ok", i))
        except AdmissionRejected:
            outcomes.append(("rejected", i))
        except Exception as e:                   # noqa: BLE001
            outcomes.append(("error", repr(e)))

    threads = [threading.Thread(target=admit_one, args=(i,))
               for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not [o for o in outcomes if o[0] == "error"], outcomes
    ok = [i for k, i in outcomes if k == "ok"]
    st = cp.status()
    assert len(ok) >= 1
    assert st["n_admitted"] == len(ok)
    assert st["admission"]["n_rejected"] == 4 - len(ok)
    assert st["admission"]["in_flight"] == 0
    for i in ok:
        assert cp.tenant_lifecycle(f"c{i}") == "active"
        cp.tenant_state(f"c{i}")


# ---------------------------------------------------------- serving client

def test_client_tenant_gone_and_quarantine_stamp(world_np):
    """DeltaMapClient on a tenant route: steady polls, the quarantined
    tenant's frozen revision with the `state=quarantined` stamp and the
    `-quarantined` ETag, and typed TenantGone after eviction."""
    from jax_mapping_torch.bridge.launch import launch_sim_stack
    from jax_mapping_torch.serving.client import DeltaMapClient, TenantGone

    st = launch_sim_stack(ACFG, world_np, n_robots=1, http_port=0,
                          realtime=False, seed=0, device="cpu")
    try:
        plane = st.tenancy
        plane.admit("m0", world_np, seed=0)
        plane.step(3)
        base = f"http://127.0.0.1:{st.api.port}"
        client = DeltaMapClient(base, route="/tiles?tenant=m0")
        body = client.poll()
        assert client.revision == 3 and client.state is None
        assert body["tiles"]
        plane.set_tenant_poison("m0", True)
        plane.step(2)
        assert plane.tenant_lifecycle("m0") == "quarantined"
        body = client.poll()
        assert client.state == "quarantined"
        assert body["revision"] == 3
        assert "-quarantined" in client._etag
        body = client.poll()
        assert body.get("not_modified") is True
        plane.evict("m0", checkpoint=False)
        with pytest.raises(TenantGone) as ei:
            client.poll()
        assert ei.value.route == "/tiles?tenant=m0"
        assert ei.value.detail
        ghost = DeltaMapClient(base, route="/tiles?tenant=ghost")
        with pytest.raises(TenantGone):
            ghost.poll()
    finally:
        st.shutdown()


# ------------------------------------------------------------ threads

def test_racewatch_quarantine_vs_status(world_np):
    """/status and /metrics polling races the stepping thread through
    poison, quarantine, probes and readmission: no race report, and the
    ladder's lockset converges on `_lock` (the port's
    `analysis/racewatch.py`)."""
    from jax_mapping_torch.analysis.protection import groups_by_class
    from jax_mapping_torch.analysis.racewatch import RaceWatch

    cp = _plane()
    cp.admit("sick", world_np, seed=0)
    cp.admit("ok", world_np, seed=1)
    cp.step(3)
    watch = RaceWatch()
    errors = []
    try:
        watch.watch_object(cp, groups_by_class()["TenantControlPlane"][0],
                           name="containment")
        stop = threading.Event()

        def poller():
            while not stop.is_set():
                try:
                    assert "health" in cp.status()
                    cp.metric_families()
                    cp.tenant_lifecycle("sick")
                except Exception as e:           # noqa: BLE001
                    errors.append(f"status: {e}")
                stop.wait(0.002)

        threads = [threading.Thread(target=poller) for _ in range(2)]
        for t in threads:
            t.start()
        cp.set_tenant_poison("sick", True)
        cp.step(2)
        cp.set_tenant_poison("sick", False)
        cp.step(4)
        stop.set()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        watch.unwatch_all()
    assert not errors, errors
    assert watch.reports() == []
    assert cp.tenant_lifecycle("sick") == "active"
    lh = [s for name, s in watch.field_states().items()
          if "_lanehealth" in name]
    assert lh, "racewatch never saw the lane-health field"
    for s in lh:
        assert s.candidate is None or any(
            "_lock" in c for c in s.candidate), s.candidate


# ------------------------------------------------------------ faultplan

def test_faultplan_tenant_kinds_act_on_the_stack(world_np, tmp_path):
    """The tenant kinds through the real stack wiring: `tenant_poison`
    quarantines, `tenant_state_jump` teleports, and `controlplane_crash`
    rebuilds the plane (Stack.crash_controlplane) inside a `cache_wipe`
    window: the same tenant set with epochs advanced, the API swapped to
    the new plane, the wipe window cleared."""
    from jax_mapping_torch.bridge.launch import launch_sim_stack
    from jax_mapping_torch.io.compile_cache import CompileCacheManager
    from jax_mapping_torch.resilience.faultplan import FaultEvent, FaultPlan

    st = launch_sim_stack(ACFG, world_np, n_robots=1, http_port=0,
                          realtime=False, seed=0,
                          checkpoint_dir=str(tmp_path), device="cpu")
    try:
        st.compile_cache = CompileCacheManager(
            ACFG.cold_start, str(tmp_path / "cc"), device="cpu")
        plane0 = st.tenancy
        assert plane0.checkpoint_dir == str(tmp_path / "tenants")
        plane0.admit("m0", world_np, seed=0)
        plane0.admit("m1", world_np, seed=1)
        plane0.step(2)
        epochs0 = {t: plane0.epoch(t) for t in ("m0", "m1")}
        plan = FaultPlan([
            FaultEvent(step=1, kind="tenant_poison", name="m1",
                       duration=3),
            FaultEvent(step=1, kind="cache_wipe", duration=6),
            FaultEvent(step=2, kind="tenant_state_jump", name="m0",
                       value=0.5),
            FaultEvent(step=4, kind="controlplane_crash"),
        ])
        for step in range(8):
            plan.apply(st, step)
            if step < 4:
                st.tenancy.step(1)
        assert plan.done()
        assert plane0.tenant_lifecycle("m1") == "quarantined"
        assert st.tenancy is not plane0 and st.api.tenancy is st.tenancy
        assert st.tenancy.tenant_lifecycle("m0") == "active"
        assert st.tenancy.tenant_lifecycle("m1") == "quarantined"
        for t, e0 in epochs0.items():
            assert st.tenancy.epoch(t) > e0
        st.tenancy.step(1)
        logs = [d for _, d in plan.log]
        assert "tenant_poison m1" in logs
        assert "tenant_state_jump m0=0.5m" in logs
        assert any(d.startswith("controlplane_crash restored=2 lost=0")
                   for d in logs), logs
        assert st.compile_cache._wipe_refs == 0
        body = json.loads(st.api.handle("/status")[2])
        assert body["tenancy"]["n_quarantined_now"] == 1
    finally:
        st.shutdown()


def test_faultplan_tenant_poison_refcount_composes():
    from jax_mapping_torch.resilience.faultplan import FaultEvent, FaultPlan

    class _Plane:
        def __init__(self):
            self.calls = []

        def set_tenant_poison(self, tid, active):
            self.calls.append((tid, active))

    class _Stack:
        def __init__(self):
            self.tenancy = _Plane()
        bus = None
        brain = None

    stack = _Stack()
    plan = FaultPlan([
        FaultEvent(step=1, kind="tenant_poison", name="t", duration=4),
        FaultEvent(step=3, kind="tenant_poison", name="t", duration=4),
    ])
    for step in range(0, 9):
        plan.apply(stack, step)
    assert stack.tenancy.calls == [("t", True), ("t", True),
                                   ("t", False)]
    assert plan.done()


def test_save_auto_checkpoint_checkpoints_the_plane(world_np, tmp_path):
    """The supervisor's checkpoint hook also checkpoints the plane's live
    tenants (a watermark record per tenant)."""
    from jax_mapping_torch.bridge.launch import launch_sim_stack

    st = launch_sim_stack(ACFG, world_np, n_robots=1, realtime=False,
                          seed=0, checkpoint_dir=str(tmp_path),
                          device="cpu")
    try:
        st.tenancy.admit("m0", world_np, seed=0)
        st.tenancy.step(1)
        n0 = st.tenancy.status()["journal"]["n_appends"]
        st.save_auto_checkpoint()
        assert st.tenancy.status()["journal"]["n_appends"] == n0 + 1
        assert os.path.exists(tmp_path / "tenants" / "tenant_m0.live.ckpt")
    finally:
        st.shutdown()


# ------------------------------------------------------------ the drill

def test_tenant_blast_radius_drill(world_np, tmp_path):
    """The JAX package's drill at 6 tenants (its 12 cost 2x the CPU
    time): the poisoned tenant quarantines within the hysteresis budget,
    every co-tenant equals a no-fault twin (state and served tiles), a
    crash restores the full set with epochs advanced, the per-tenant SLO
    ingest-stall burn fires only under the poisoned tenant's label, and
    two same-seed runs give the same sequences."""
    from jax_mapping_torch.obs.pipeline import PipelineLedger
    from jax_mapping_torch.obs.slo import SloEngine

    N, SICK, PERSIST = 6, "t03", 2
    cfg = micro_config().replace(tenancy=TenancyConfig(
        enabled=True, prewarm_on_admit=False, lane_health=True,
        quarantine_persist_ticks=PERSIST, readmit_probe_ticks=4,
        max_readmit_probes=2, journal=True))
    obj = SloObjective(name="tenant_fresh", metric="scan_to_served_p99_ms",
                       max_silent_ticks=2, fast_window_ticks=4,
                       slow_window_ticks=8, fast_burn=0.5, slow_burn=0.25)
    tids = [f"t{i:02d}" for i in range(N)]

    def run(tag, fault):
        ck = str(tmp_path / tag)
        ledger = PipelineLedger()
        cp = _plane(cfg, checkpoint_dir=ck, pipeline=ledger)
        for i, t in enumerate(tids):
            cp.admit(t, world_np, seed=i)
        slos = {t: SloEngine([obj], pipeline=ledger, tenant=t)
                for t in (SICK, "t00")}
        seq = []

        def tick(n):
            for _ in range(n):
                cp.step(1)
                for t, eng in slos.items():
                    eng.evaluate(cp.n_ticks)
                    seen = len([s for s in seq
                                if s[0] == "slo" and s[3] == t])
                    for a in eng.alerts()[seen:]:
                        seq.append(("slo", a[0], a[1] + ":" + a[2], t))

        tick(3)
        if fault:
            cp.set_tenant_poison(SICK, True)
        tick(PERSIST + 1)
        if fault:
            assert cp.tenant_lifecycle(SICK) == "quarantined"
            seq.append(("quarantine", cp.n_ticks, SICK, ""))
        tick(2)
        if fault:
            cp.checkpoint_all()
            epochs = {t: cp.epoch(t) for t in tids}
            cp2 = _plane(cfg, checkpoint_dir=ck, pipeline=ledger)
            report = cp2.restore()
            assert sorted(report["restored"]) == tids, report
            assert report["lost"] == []
            for t, e0 in epochs.items():
                assert cp2.epoch(t) == e0 + 1
            assert cp2.tenant_lifecycle(SICK) == "quarantined"
            seq.append(("restore", cp2.n_ticks,
                        ",".join(sorted(report["restored"])), ""))
            cp2.step(1)
        digests = {}
        for t in tids:
            if t == SICK and fault:
                continue
            sh = hashlib.sha256(b"".join(
                x.numpy().tobytes()
                for x in _leaves(cp.tenant_state(t)))).hexdigest()
            digests[t] = (sh, _tile_digest(cp, t))
        return digests, seq, list(cp._lanehealth.transitions)

    d_fault, seq1, trans1 = run("fault_a", True)
    d_twin, _, _ = run("twin", False)
    assert [t for t in d_fault if d_fault[t] != d_twin[t]] == []
    assert len(d_fault) == N - 1
    assert any(k == "slo" and t == SICK and "firing" in v
               for k, _, v, t in seq1), seq1
    assert not any(k == "slo" and t == "t00" and "firing" in v
                   for k, _, v, t in seq1), seq1
    d2, seq2, trans2 = run("fault_b", True)
    assert seq2 == seq1
    assert trans2 == trans1
    assert d2 == d_fault


def test_faultplan_tenant_kind_validation_and_sampling():
    """The tenant kinds' refusals, and `random_plan`'s seeded sampling of
    them: same seed, same plan; no overlapping window on one tenant; at
    most one crash; none of them without tenant ids."""
    from jax_mapping_torch.resilience.faultplan import (TENANT_KINDS,
                                                        FaultEvent,
                                                        _fault_resource,
                                                        random_plan)

    assert TENANT_KINDS == {"tenant_poison", "tenant_state_jump",
                            "controlplane_crash"}
    with pytest.raises(ValueError, match="needs name"):
        FaultEvent(step=1, kind="tenant_poison")
    with pytest.raises(ValueError, match="needs name"):
        FaultEvent(step=1, kind="tenant_state_jump", value=1.0)
    with pytest.raises(ValueError, match="value > 0"):
        FaultEvent(step=1, kind="tenant_state_jump", name="t")
    FaultEvent(step=1, kind="controlplane_crash")
    tenants = [f"m{i}" for i in range(4)]
    p1 = random_plan(200, n_faults=12, seed=7, tenant_ids=tenants,
                     allow_controlplane_crash=True)
    p2 = random_plan(200, n_faults=12, seed=7, tenant_ids=tenants,
                     allow_controlplane_crash=True)
    assert p1.events == p2.events
    tenant_events = [e for e in p1.events
                     if e.kind in ("tenant_poison", "tenant_state_jump")]
    assert tenant_events and all(e.name in tenants for e in tenant_events)
    windows = {}
    for e in p1.events:
        res = _fault_resource(e.kind, e.robot, e.name)
        for s, en in windows.get(res, []):
            assert not (e.step <= en and s <= e.step + e.duration), res
        windows.setdefault(res, []).append((e.step, e.step + e.duration))
    assert sum(e.kind == "controlplane_crash" for e in p1.events) <= 1
    p3 = random_plan(200, n_faults=6, seed=3)
    assert all(e.kind not in TENANT_KINDS for e in p3.events)
