"""The warm-restart tier on the CPU: the build cache and the signature
manifest (`io/compile_cache.py`), the staged warm-up
(`resilience/warmup.py`), the `cache_wipe` fault kind, and the profiler's
warm-process baseline.

The JAX package's `tests/test_coldstart.py` (its fingerprint, priority,
`materialize_zeros`, manifest round trip and degrade, `evict_lru` and
husks, `cache_wipe`, rebaseline, staged stages and report, readiness
gate, racewatch and in-process-skip tests), held on the port. The pool's
two wrapper-chain tests become one: the pool installs no wrapper, and a
stack's shutdown with both tiers armed restores every alias. Beside them:
the build-directory redirect and its counts, the libraries a manifest
save copies into the cache, and a resume in a fresh process that
pre-warms the manifest's signatures as `aot` and resumes the same map.
The decay and checkpoint tests of that file were ported earlier.
"""

import json
import os
import shutil
import subprocess
import sys
import threading
import types

import numpy as np
import pytest
import torch

from jax_mapping_torch._util import entry_point
from jax_mapping_torch.config import (ColdStartConfig, DevProfConfig,
                                      ObsConfig, tiny_config)
from jax_mapping_torch.io.compile_cache import (CompileCacheManager,
                                                WarmPool,
                                                cache_fingerprint,
                                                materialize_zeros)
from jax_mapping_torch.obs import devprof as DP
from jax_mapping_torch.ops import _cuda
from jax_mapping_torch.resilience.warmup import (StagedWarmup,
                                                 warmup_class,
                                                 warmup_order)
from tests.torch_jaxref import REPO, clean_cpu_env

FUSE = "jax_mapping_torch.ops.grid.fuse_scans_masked"


@pytest.fixture(autouse=True)
def _default_build_dir():
    """Every test leaves `_cuda`'s build directory at the default."""
    yield
    _cuda.set_build_dir(None)


# ---------------------------------------------------------------- fingerprint

def test_fingerprint_keys_and_infra_normalization():
    """Same config -> same fingerprint; a state-shape change -> a new
    one; flipping bit-inert infra (obs, cold_start itself) -> the SAME
    one, so arming telemetry never orphans a manifest."""
    cfg = tiny_config()
    fp = cache_fingerprint(cfg.to_json())
    assert fp == cache_fingerprint(cfg.to_json())
    assert fp != cache_fingerprint(tiny_config(n_robots=3).to_json())
    traced = cfg.replace(obs=ObsConfig(enabled=True,
                                       devprof=DevProfConfig(enabled=True)),
                         cold_start=ColdStartConfig(enabled=True,
                                                    cache_dir="/x"))
    assert fp == cache_fingerprint(traced.to_json())
    # The kernel sources are part of it.
    old = _cuda.NVCC_FLAGS
    try:
        _cuda.NVCC_FLAGS = old + ["-DPROBE"]
        assert fp != cache_fingerprint(cfg.to_json())
    finally:
        _cuda.NVCC_FLAGS = old


# ------------------------------------------------------------- priority order

def test_warmup_priority_fusion_then_match_then_frontier():
    names = ["jax_mapping_torch.ops.frontier.compute_frontiers",
             "jax_mapping_torch.sim.lidar.simulate_scans",
             "jax_mapping_torch.ops.scan_match.match",
             "jax_mapping_torch.models.slam.slam_step",
             "jax_mapping_torch.ops.grid.fuse_scans_masked",
             "jax_mapping_torch.ops.costfield.cost_fields"]
    ordered = warmup_order(names)
    classes = [warmup_class(n) for n in ordered]
    assert classes == sorted(classes)
    assert ordered[0] in ("jax_mapping_torch.models.slam.slam_step",
                          "jax_mapping_torch.ops.grid.fuse_scans_masked")
    assert ordered.index(FUSE) \
        < ordered.index("jax_mapping_torch.ops.scan_match.match") \
        < ordered.index("jax_mapping_torch.ops.frontier.compute_frontiers") \
        < ordered.index("jax_mapping_torch.sim.lidar.simulate_scans")


def test_materialize_zeros_concretizes_only_arrays():
    sig = ((DP.TensorSpec((2, 3), "float32", "cpu"), 7, "static"),
           {"m": DP.TensorSpec((2,), "bool", "cpu")})
    args, kwargs = materialize_zeros(sig)
    assert args[0].shape == (2, 3) and args[1] == 7 and args[2] == "static"
    assert kwargs["m"].dtype == torch.bool
    assert not args[0].any()


# ------------------------------------------- the manifest ladder, in-process

@pytest.fixture(scope="module")
def aot_workspace(tmp_path_factory):
    """ONE manifest pass shared by the ladder tests: a profiled fuse
    dispatch captures the signature, a manager saves the manifest, the
    profiler uninstalls. Yields (cache_root, signatures, live args, live
    output)."""
    from jax_mapping_torch.ops import grid as G
    cfg = tiny_config()
    prof = DP.DispatchProfiler(DevProfConfig(enabled=True))
    prof.install()
    try:
        gcfg, scfg = cfg.grid, cfg.scan
        gen = torch.Generator().manual_seed(0)
        args = (gcfg, scfg, G.empty_grid(gcfg, "cpu"),
                torch.rand((4, scfg.padded_beams), generator=gen) * 3,
                torch.zeros((4, 3)), torch.ones((4,), dtype=torch.bool))
        out = G.fuse_scans_masked(*args)
        sigs = prof.signatures()
        if FUSE not in sigs:
            # This process dispatched the variant before the profiler
            # was armed: synthesize the capture a cold process records.
            fn = prof.raw_fn(FUSE)
            sigs = {FUSE: [DP.abstract_signature(
                args, {}, list(__import__("inspect").signature(fn)
                               .parameters), fn.__entry_point__)]}
        root = str(tmp_path_factory.mktemp("aot_ws") / "cache")
        mgr = CompileCacheManager(
            ColdStartConfig(enabled=True, cache_dir=root), root,
            config_json=cfg.to_json())
        rep = mgr.save_aot(sigs)
        assert rep["n_saved"] >= 1 and rep["n_failed"] == 0
    finally:
        prof.uninstall()
    yield root, sigs, args, out.clone()


def test_aot_manifest_roundtrip_and_prewarm(aot_workspace, monkeypatch):
    """The whole warm tier on one entry point: the manifest loads in
    another manager, a warm-up that has never seen the signature
    pre-warms it as `aot` on zeros, and the next live call gives the
    same output; the pool installs no wrapper."""
    from jax_mapping_torch.ops import grid as G
    root, _sigs, args, out_cold = aot_workspace
    monkeypatch.setattr(DP, "_SEEN", {})          # a fresh process
    cfg = tiny_config()
    mgr = CompileCacheManager(
        ColdStartConfig(enabled=True, cache_dir=root), root,
        config_json=cfg.to_json())
    raw = G.fuse_scans_masked
    wu = StagedWarmup(cache=mgr)
    rep = wu.prewarm()
    assert rep["n_aot"] >= 1 and rep["n_errors"] == 0
    assert (FUSE, "aot") in wu.snapshot()["warmed"]
    assert mgr.status()["counts"]["aot_n_loaded"] >= 1
    assert mgr.pool.n_entries() >= 1
    assert G.fuse_scans_masked is raw             # no wrapper installed
    np.testing.assert_array_equal(G.fuse_scans_masked(*args).numpy(),
                                  out_cold.numpy())
    # A second warm-up in the same process finds it warm.
    rep2 = StagedWarmup(cache=mgr).prewarm()
    assert rep2["n_aot"] == 0 and rep2["n_in_process"] >= 1


def test_aot_corrupt_and_fingerprint_mismatch_degrade(tmp_path,
                                                      aot_workspace):
    """A truncated manifest file counts corrupt and is skipped; a
    different config's fingerprint directory is counted and never read —
    both degrade, neither raises."""
    root, _sigs, _args, _out = aot_workspace
    copy = str(tmp_path / "cache")
    shutil.copytree(root, copy)
    cfg = tiny_config()
    mgr = CompileCacheManager(
        ColdStartConfig(enabled=True, cache_dir=copy), copy,
        config_json=cfg.to_json())
    mgr.fingerprint = cache_fingerprint(cfg.to_json())
    victim = sorted(f for f in os.listdir(mgr.aot_dir())
                    if f.endswith(".aot"))[0]
    with open(os.path.join(mgr.aot_dir(), victim), "r+b") as f:
        f.truncate(16)
    m2 = mgr.load_aot()
    assert m2["n_corrupt"] >= 1

    other = CompileCacheManager(
        ColdStartConfig(enabled=True, cache_dir=copy), copy,
        config_json=tiny_config(n_robots=3).to_json())
    m3 = other.load_aot()
    assert m3["n_fingerprint_mismatch"] >= 1
    assert m3["n_loaded"] == 0 and not m3["signatures"]


def test_manifest_skips_an_opaque_argument(tmp_path):
    """A signature holding a live object (a method's receiver) cannot be
    rebuilt in another process: it counts as uncallable, the rest save."""
    root = str(tmp_path / "cache")
    mgr = CompileCacheManager(ColdStartConfig(enabled=True), root)
    sigs = {"jax_mapping_torch.x.f": [
        ((DP.OpaqueSpec(threading.Lock()),), {}),
        ((DP.TensorSpec((2,), "float32", "cpu"),), {})]}
    rep = mgr.save_aot(sigs)
    assert rep["n_uncallable"] == 1 and rep["n_saved"] == 1


def test_warm_pool_installs_no_wrapper_and_shutdown_restores_aliases(
        tmp_path):
    """The pool holds loaded entries and serves no call: it has no
    install. A stack with both tiers armed wraps the entry points while
    it runs, and its shutdown leaves every alias the raw function."""
    pool = WarmPool()
    pool.add("jax_mapping_torch.x.f", "k", ((), {}))
    assert pool.keys_for("jax_mapping_torch.x.f") == {"k"}
    assert pool.stats() == {"n_entries": 1, "n_dropped": 0,
                            "installed": False}
    assert not hasattr(pool, "install")
    pool.drop("jax_mapping_torch.x.f", "k")
    assert pool.n_entries() == 0

    from jax_mapping_torch.bridge.launch import launch_sim_stack
    from jax_mapping_torch.sim import world as W
    cfg = tiny_config(2).replace(
        obs=ObsConfig(devprof=DevProfConfig(enabled=True)),
        cold_start=ColdStartConfig(enabled=True,
                                   cache_dir=str(tmp_path / "cc")))
    st = launch_sim_stack(cfg, W.empty_arena(32, 0.05), n_robots=2,
                          device="cpu")
    try:
        assert _cuda.BUILD_DIR == _cuda.Path(str(tmp_path / "cc" / "cuda"))
        sites = DP.entry_sites()
        assert len(sites) >= 40
        assert all(isinstance(vars(owner)[attr], DP._ProfiledFn)
                   for _raw, ss in sites.values() for owner, attr, _ in ss)
        st.run_steps(2)
    finally:
        st.shutdown()
    assert _cuda.BUILD_DIR == _cuda.DEFAULT_BUILD_DIR
    for raw, ss in DP.entry_sites().values():
        for owner, attr, _ in ss:
            assert vars(owner)[attr] is raw, (owner, attr)


# --------------------------------------------------------- LRU + husk scrub

def test_evict_lru_bounds_disk_and_scrubs_husks(tmp_path):
    root = str(tmp_path / "cache")
    mgr = CompileCacheManager(
        ColdStartConfig(enabled=True, cache_dir=root,
                        max_cache_bytes=3000), root)
    os.makedirs(mgr.cuda_dir)
    for i in range(5):
        p = os.path.join(mgr.cuda_dir, f"entry{i}")
        with open(p, "wb") as f:
            f.write(b"x" * 1000)
        os.utime(p, (1000 + i, 1000 + i))      # oldest first
    husk = os.path.join(mgr.cuda_dir, "husk")
    open(husk, "wb").close()
    tmp = os.path.join(mgr.cuda_dir, "k-0123.4242.tmp")   # a crashed nvcc
    with open(tmp, "wb") as f:
        f.write(b"partial")
    assert mgr._scrub_husks(mgr.root) == 2
    assert not os.path.exists(husk) and not os.path.exists(tmp)
    n, freed = mgr.evict_lru()
    assert n == 2 and freed == 2000
    left = sorted(os.listdir(mgr.cuda_dir))
    assert left == ["entry2", "entry3", "entry4"]   # oldest evicted
    assert mgr.disk_usage_bytes() <= 3000


# ------------------------------------------- the build cache and its counts

def test_enable_redirects_builds_and_save_copies_loaded_libraries(
        tmp_path, monkeypatch):
    """enable() points the builds at <root>/cuda and disable() back at the
    default; a manifest save copies each loaded library the cache lacks
    (a library built before the cache was enabled); status() reports the
    libraries built and found since the manager was made."""
    root = str(tmp_path / "cache")
    mgr = CompileCacheManager(ColdStartConfig(enabled=True), root)
    assert mgr.enable()
    assert _cuda.BUILD_DIR == _cuda.Path(mgr.cuda_dir)
    assert _cuda._target("label_prop").parent == _cuda.Path(mgr.cuda_dir)
    lib = tmp_path / "built" / f"label_prop-{_cuda.source_hash('label_prop')}.so"
    lib.parent.mkdir()
    lib.write_bytes(b"\x7fELF" + b"0" * 60)
    monkeypatch.setitem(_cuda._libs, "label_prop",
                        types.SimpleNamespace(_name=str(lib)))
    rep = mgr.save_aot({})
    assert rep["n_libraries"] == 1
    assert os.path.exists(os.path.join(mgr.cuda_dir, lib.name))
    assert mgr.save_aot({})["n_libraries"] == 0   # already there
    monkeypatch.setitem(_cuda.BUILDS, "found", _cuda.BUILDS["found"] + 1)
    st = mgr.status()
    assert st["counts"]["builds"] == 0 and st["counts"]["builds_found"] == 1
    assert st["counts"]["libraries_saved"] == 1
    mgr.disable()
    assert _cuda.BUILD_DIR == _cuda.DEFAULT_BUILD_DIR


# ------------------------------------------------------------- cache_wipe

def test_cache_wipe_faultplan_refcount_composes(tmp_path):
    """Two overlapping cache_wipe windows: files go at first fire, builds
    go to the default directory until the LAST window clears, then the
    (empty) cache re-enables."""
    from jax_mapping_torch.resilience.faultplan import FaultEvent, FaultPlan
    root = str(tmp_path / "cache")
    mgr = CompileCacheManager(
        ColdStartConfig(enabled=True, cache_dir=root), root)
    mgr.enable()
    with open(os.path.join(mgr.cuda_dir, "e"), "wb") as f:
        f.write(b"x" * 10)
    stack = types.SimpleNamespace(bus=None, compile_cache=mgr)
    plan = FaultPlan([
        FaultEvent(step=1, kind="cache_wipe", duration=4),
        FaultEvent(step=2, kind="cache_wipe", duration=6),
    ], seed=0)
    plan.apply(stack, 1)
    assert not os.listdir(mgr.cuda_dir)
    assert _cuda.BUILD_DIR == _cuda.DEFAULT_BUILD_DIR
    plan.apply(stack, 2)
    assert mgr.status()["wipe_refs"] == 2
    plan.apply(stack, 5)                     # first window clears
    assert mgr.status()["wipe_refs"] == 1 and not mgr.enabled
    # Saves are suppressed while any window holds: nothing under root.
    assert mgr.save_aot({"f": [((), {})]})["n_saved"] == 0
    assert not os.path.exists(os.path.join(root, "aot"))
    plan.apply(stack, 8)                     # last window clears
    assert mgr.status()["wipe_refs"] == 0 and mgr.enabled
    assert _cuda.BUILD_DIR == _cuda.Path(mgr.cuda_dir)
    st = mgr.status()["counts"]
    assert st["wipes"] == 2 and st["files_wiped"] == 1
    assert plan.done()
    mgr.disable()


def test_cache_wipe_skips_without_manager():
    from jax_mapping_torch.resilience.faultplan import FaultEvent, FaultPlan
    stack = types.SimpleNamespace(bus=None)
    plan = FaultPlan([FaultEvent(step=0, kind="cache_wipe")], seed=0)
    plan.apply(stack, 0)
    assert any("cache_wipe skipped" in d for _s, d in plan.log)


def test_cache_wipe_has_a_resource_and_samples():
    from jax_mapping_torch.resilience import faultplan as FP
    assert FP._fault_resource("cache_wipe", 0) == ("cache",)
    plan = FP.random_plan(200, n_faults=12, seed=7, allow_cache_wipe=True)
    kinds = {e.kind for e in plan.events}
    default_plan = FP.random_plan(200, n_faults=12, seed=7)
    assert "cache_wipe" not in {e.kind for e in default_plan.events}
    assert kinds <= set(FP.KINDS)


# ------------------------------------------- devprof warm-process baseline

def test_devprof_rebaseline_excludes_warm_variants():
    """Variants the warm-up dispatched through the RAW function (as
    StagedWarmup.prewarm does) must not count as live recompiles once
    `rebaseline()` runs — and without it they would."""
    mod = types.ModuleType("jax_mapping_torch._coldstart_probe")

    @entry_point
    def probe_fn(x):
        return x * 2 + 1

    mod.probe_fn = probe_fn
    sys.modules["jax_mapping_torch._coldstart_probe"] = mod
    prof = DP.DispatchProfiler(DevProfConfig(enabled=True))
    try:
        prof.install()
        name = [n for n in prof.recompiles()
                if n.endswith("probe_fn")][0]
        raw = prof.raw_fn(name)
        wu = StagedWarmup()
        sig = DP.abstract_signature((torch.ones(3),), {})
        wu.prewarm({name: [sig]})            # unprofiled warm-up
        assert prof.rebaseline() == 1
        mod.probe_fn(torch.ones(3))          # first live call, same variant
        assert prof.recompiles()[name] == 0  # NOT a live recompile
        # Control: a variant the warm-up never saw counts.
        raw(torch.ones(4))                   # raw call: not a warm-up
        mod.probe_fn(torch.ones(4))
        assert prof.recompiles()[name] == 1
    finally:
        prof.uninstall()
        del sys.modules["jax_mapping_torch._coldstart_probe"]


# ------------------------------------------------- staged warm-up machine

def test_staged_warmup_walks_stages_and_reports():
    from jax_mapping_torch.obs.recorder import flight_recorder
    mark = flight_recorder.mark()
    wu = StagedWarmup()
    assert wu.state() == "idle"
    wu.begin_restore()
    wu.begin_warming()
    rep = wu.prewarm({})
    wu.mark_ready()
    assert wu.state() == "ready"
    snap = wu.snapshot()
    assert snap["report"]["n_errors"] == 0
    kinds = [e["kind"] for e in flight_recorder.events_since(mark)]
    assert kinds.count("warmup_stage") == 3
    assert "warmup_ready" in kinds
    assert rep["readiness_violations"] == []


def test_staged_warmup_readiness_gate_flags_over_budget(tmp_path):
    """A variant THIS warm-up added past its budget maximum is REPORTED
    (not raised); variants the process held before the warm-up are not
    its doing and stay quiet."""
    mod = types.ModuleType("jax_mapping_torch._readiness_probe")

    @entry_point
    def readiness_fn(x):
        return x - 1

    mod.readiness_fn = readiness_fn
    sys.modules["jax_mapping_torch._readiness_probe"] = mod
    try:
        name = "jax_mapping_torch._readiness_probe.readiness_fn"
        budget = tmp_path / "budget.json"
        budget.write_text(json.dumps(
            {"version": 1, "budgets": [{"name": name, "max": 0}]}))
        sig = DP.abstract_signature((torch.ones(3),), {})
        wu = StagedWarmup(budget_path=str(budget))
        rep = wu.prewarm({name: [sig]})      # warm-up adds it: 1 > 0
        assert any(name in v for v in rep["readiness_violations"])
        assert rep["n_prewarmed"] == 1
        rep2 = StagedWarmup(budget_path=str(budget)).prewarm({})
        assert rep2["readiness_violations"] == []
    finally:
        del sys.modules["jax_mapping_torch._readiness_probe"]


def test_staged_warmup_records_error_and_never_falls_back():
    """A signature whose call fails is an `error` entry, not a silent
    plain-version run; the warm-up still reaches its report."""
    mod = types.ModuleType("jax_mapping_torch._error_probe")

    @entry_point
    def needs_two(x):
        return x.reshape(2, -1)

    mod.needs_two = needs_two
    sys.modules["jax_mapping_torch._error_probe"] = mod
    try:
        name = "jax_mapping_torch._error_probe.needs_two"
        sig = DP.abstract_signature((torch.ones(3),), {})
        rep = StagedWarmup().prewarm({name: [sig],
                                      "jax_mapping_torch.gone.fn": [sig]})
        assert rep["n_errors"] == 2 and rep["n_warmed"] == 0
    finally:
        del sys.modules["jax_mapping_torch._error_probe"]


def test_staged_warmup_racewatch_converges_on_declared_lock():
    """Eraser refinement over the warm-up state machine: a reader thread
    hammers state()/snapshot() while the driver walks the stages — zero
    reports, every watched field's candidate lockset converges on
    `_lock` (the port's protection map, `analysis/protection.py`)."""
    from jax_mapping_torch.analysis.protection import groups_by_class
    from jax_mapping_torch.analysis.racewatch import RaceWatch
    wu = StagedWarmup()
    watch = RaceWatch()
    try:
        watch.watch_object(wu, groups_by_class()["StagedWarmup"][0],
                           name="warmup")
        stop = threading.Event()

        def reader():
            while not stop.is_set():
                wu.state()
                wu.snapshot()
                stop.wait(0.001)

        t = threading.Thread(target=reader)
        t.start()
        for _ in range(8):
            wu.begin_restore()
            wu.begin_warming()
            wu.prewarm({})
            wu.mark_ready()
        stop.set()
        t.join(timeout=10)
    finally:
        watch.unwatch_all()
    assert watch.reports() == []
    states = watch.field_states()
    moved = [st for st in states.values()
             if st.state == "shared-modified"]
    assert moved, "nothing went shared-modified — the gate saw no race"
    for st in moved:
        assert "StagedWarmup._lock@warmup" in st.candidate, st


def test_staged_warmup_prewarm_skips_in_process_warm(aot_workspace):
    """An in-process restart (this process dispatched the signature and
    holds its kernels) pre-warms nothing: every name is `in_process`."""
    _root, sigs, _args, _out = aot_workspace
    from jax_mapping_torch.io.compile_cache import resolve_entry_point
    fn = resolve_entry_point(FUSE)
    for s in sigs[FUSE]:
        DP.note_dispatch(fn, FUSE, DP.signature_key(s))
    wu = StagedWarmup()
    rep = wu.prewarm(sigs)
    assert rep["n_in_process"] >= 1
    assert rep["n_prewarmed"] == 0 and rep["n_errors"] == 0
    assert rep["launches"] == {}


# ------------------------------------------- a resume in a fresh process

RESUME = r'''
import json, sys, time
t0 = time.perf_counter()
import numpy as np
from jax_mapping_torch.bridge.launch import launch_sim_stack
from jax_mapping_torch.config import SlamConfig
from jax_mapping_torch.sim import world as W
d, root = sys.argv[1], sys.argv[2]
cfg = SlamConfig.from_json(open(d + "/cfg.json").read())
assert cfg.cold_start.enabled and cfg.cold_start.cache_dir == root
st = launch_sim_stack(cfg, W.plank_course(96, 0.05, n_planks=4, seed=3),
                      n_robots=2, seed=0, checkpoint_dir=d, device="cpu")
rep = st.warmup.snapshot()
st.kill_node("jax_mapper")
st.restart_mapper()
grid = st.mapper.merged_grid().numpy()
np.save(d + "/resumed.npy", grid)
print(json.dumps({"launch": rep, "restart": st.warmup.snapshot()["report"],
                  "seconds": time.perf_counter() - t0}))
st.shutdown()
'''


def test_resume_in_fresh_process_prewarms_the_manifest(tmp_path,
                                                       monkeypatch):
    """A mission with both tiers armed saves a checkpoint and its
    manifest; a fresh process launched on the same root pre-warms the
    manifest's signatures as `aot` at launch, and its restart resumes the
    checkpoint's map exactly."""
    from jax_mapping_torch.bridge.launch import launch_sim_stack
    # The mission process starts cold: what earlier tests in this worker
    # dispatched would otherwise be its profiler's baseline, uncaptured.
    monkeypatch.setattr(DP, "_SEEN", {})
    from jax_mapping_torch.sim import world as W
    d = tmp_path / "run"
    root = str(d / "cc")
    cfg = tiny_config(2).replace(
        obs=ObsConfig(devprof=DevProfConfig(enabled=True)),
        cold_start=ColdStartConfig(enabled=True, cache_dir=root))
    st = launch_sim_stack(cfg, W.plank_course(96, 0.05, n_planks=4, seed=3),
                          n_robots=2, seed=0, checkpoint_dir=str(d),
                          device="cpu")
    st.brain.start_exploring()
    st.run_steps(8)
    st.save_auto_checkpoint()
    saved = st.save_compile_snapshots()
    assert saved["n_saved"] >= 5 and saved["n_failed"] == 0, saved
    variants = {n: len(s) for n, s in st.devprof.signatures().items()}
    from jax_mapping_torch.io.checkpoint import load_checkpoint
    states, _ = load_checkpoint(st.auto_checkpoint_path,
                                st.mapper.checkpoint_template())
    st.shutdown()
    (d / "cfg.json").write_text(cfg.to_json())
    env = clean_cpu_env()
    env["PYTHONPATH"] = str(REPO)
    r = subprocess.run([sys.executable, "-c", RESUME, str(d), root],
                       capture_output=True, text=True, cwd=str(REPO),
                       env=env, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    out = json.loads(r.stdout.strip().splitlines()[-1])
    launch = out["launch"]["report"]
    assert launch["n_aot"] == saved["n_saved"], (out["launch"], saved)
    assert launch["n_errors"] == 0
    # The gate is absolute in a fresh process: it reports exactly the
    # entry points whose variants in this mission exceed the budget
    # (warm_cost_fields' 1- and 2-robot sub-batches here, where the
    # canonical scenario makes one).
    from jax_mapping_torch.analysis.compilebudget import (
        Budget, default_budget_path)
    over = sorted(e["name"] for e in
                  Budget.load(default_budget_path()).entries
                  if variants.get(e["name"], 0) > e["max"])
    assert sorted(v.split(":")[0] for v in
                  launch["readiness_violations"]) == over
    restart = out["restart"]
    assert restart["n_errors"] == 0
    resumed = np.load(d / "resumed.npy")
    want = states[0].grid.numpy()
    np.testing.assert_array_equal(resumed, want)
