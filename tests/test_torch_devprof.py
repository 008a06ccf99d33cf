"""The obs tier's device half on the CPU: the dispatch profiler
(`obs/devprof.py`), the cost ledger (`obs/ledger.py`) and the entry-point
registry they walk.

The JAX package's `tests/test_devprof.py` up to
`test_devprof_config_json_roundtrip`, held on the port: a synthetic module
of marked entry points stands in for `fixture_mod`'s jitted ones. Beside
them: the keying rules (a traced scalar by type, a static argument by
value), a method entry point, the registry against the JAX package's 63
jitted functions (listed in a fresh `JAX_PLATFORMS=cpu` subprocess), the
kernels' arithmetic at every smoke row's shape against the smoke's former
formulas, and the canonical scenario through `python -m
jax_mapping_torch.obs cost-ledger --device cpu`, within every budget
maximum of the port's copy.
"""

import json
import sys
import types

import numpy as np
import pytest
import torch

from jax_mapping_torch._util import entry_point
from jax_mapping_torch.config import DevProfConfig
from jax_mapping_torch.obs import CostLedger, DispatchProfiler
from jax_mapping_torch.obs import devprof as DP
from jax_mapping_torch.obs import ledger as L
from tests import torch_budget_run
from tests.torch_jaxref import run_reference

_FIXTURE_PREFIX = "devprof_fixture"


@pytest.fixture()
def fixture_mod():
    """A synthetic module under its own prefix holding marked entry
    points (plus an alias — the from-import case), so install() can be
    exercised without wrapping the real package."""
    mod = types.ModuleType(_FIXTURE_PREFIX)

    @entry_point(static=("k",))
    def scaled(k, x):
        return x * k

    @entry_point
    def double(x):
        return x + x

    mod.scaled = scaled
    mod.double = double
    mod.scaled_alias = scaled                    # from-import binding
    mod.not_marked = lambda x: x
    sys.modules[_FIXTURE_PREFIX] = mod
    try:
        yield mod
    finally:
        sys.modules.pop(_FIXTURE_PREFIX, None)


def _install(mod, **cfg_kw):
    prof = DispatchProfiler(DevProfConfig(enabled=True, **cfg_kw))
    n = prof.install(prefix=_FIXTURE_PREFIX)
    return prof, n


# ------------------------------------------------------ dispatch profiler

def test_wrapper_wraps_counts_and_times(fixture_mod):
    prof, n = _install(fixture_mod)
    try:
        assert n == 2                            # scaled(+alias), double
        x = torch.ones((8, 8))
        fixture_mod.scaled(2, x)
        fixture_mod.scaled_alias(2, x)           # alias -> same profile
        fixture_mod.double(x)
        snap = prof.snapshot()
        sc = snap[f"{_FIXTURE_PREFIX}.scaled"]
        assert sc["count"] == 2
        assert sc["total_ms"] > 0 and sc["max_ms"] >= sc["mean_ms"] / 2
        assert snap[f"{_FIXTURE_PREFIX}.double"]["count"] == 1
        from jax_mapping_torch.utils.profiling import HIST_EDGES_S
        h = prof.histograms()[f"{_FIXTURE_PREFIX}.scaled"]
        assert h["edges_s"] == HIST_EDGES_S
        assert sum(h["buckets"]) == h["count"] == 2
        # The unmarked callable was left alone.
        assert fixture_mod.not_marked(3) == 3
        assert not isinstance(fixture_mod.not_marked, DP._ProfiledFn)
    finally:
        prof.uninstall()


def test_wrapper_is_transparent(fixture_mod):
    prof, _ = _install(fixture_mod)
    try:
        w = fixture_mod.scaled
        assert isinstance(w, DP._ProfiledFn)
        # Introspection forwards: the registry walk sees the function's
        # own surface (its mark, name and module).
        assert w.__entry_point__ == ("k",)
        assert w.__name__ == "scaled"
        assert w.__module__.endswith("test_torch_devprof")
    finally:
        prof.uninstall()


def test_profiled_call_is_a_span_in_the_trace(fixture_mod, tmp_path):
    """Under a recording profiler each profiled call is an annotation
    named by its entry point (nested calls are not), so a trace puts the
    device's own time on each entry point; the `/metrics` histogram's
    HELP line says it is host time."""
    from torch.profiler import ProfilerActivity, profile

    from jax_mapping_torch.obs.registry import Family, MetricsRegistry
    prof, _ = _install(fixture_mod)
    try:
        p = profile(activities=[ProfilerActivity.CPU])
        p.start()
        fixture_mod.scaled(2, torch.ones((4, 4)))
        p.stop()
        p.export_chrome_trace(str(tmp_path / "t.json"))
    finally:
        prof.uninstall()
    ev = json.loads((tmp_path / "t.json").read_text())["traceEvents"]
    names = [e["name"] for e in ev if e.get("cat") == "user_annotation"]
    assert names == [f"{_FIXTURE_PREFIX}.scaled"]
    reg = MetricsRegistry().add_source(lambda: (
        Family("a_seconds", "histogram", (("_count", "1"),), "Host time."),
        Family("b_total", "counter", (("", "2"),))))
    assert reg.render() == ("# HELP a_seconds Host time.\n"
                            "# TYPE a_seconds histogram\na_seconds_count 1\n"
                            "# TYPE b_total counter\nb_total 2\n")


def test_recompile_detection_and_signature_capture(fixture_mod):
    prof, _ = _install(fixture_mod)
    try:
        fixture_mod.scaled(2, torch.ones((8, 8)))
        fixture_mod.scaled(2, torch.ones((8, 8)))   # same key: no growth
        fixture_mod.scaled(2, torch.ones((4, 4)))   # second variant
        fixture_mod.scaled(3, torch.ones((4, 4)))   # third (static arg)
        recs = prof.recompiles()
        assert recs[f"{_FIXTURE_PREFIX}.scaled"] == 3
        assert recs[f"{_FIXTURE_PREFIX}.double"] == 0
        sigs = prof.signatures()[f"{_FIXTURE_PREFIX}.scaled"]
        assert len(sigs) == 3
    finally:
        prof.uninstall()


def test_signature_capture_is_bounded(fixture_mod):
    prof, _ = _install(fixture_mod, max_signatures_per_fn=2)
    try:
        for n in range(2, 7):                    # 5 distinct variants
            fixture_mod.scaled(n, torch.ones((4, 4)))
        assert prof.recompiles()[f"{_FIXTURE_PREFIX}.scaled"] == 5
        assert len(prof.signatures()[f"{_FIXTURE_PREFIX}.scaled"]) == 2
    finally:
        prof.uninstall()


def test_trace_time_calls_bypass_recording(fixture_mod):
    """A marked function called while another profiled call is active on
    the thread is part of its caller (JAX traces it into the caller's
    program) — the recorder must not see it."""
    prof, _ = _install(fixture_mod)
    try:
        x = torch.ones((8, 8))
        fixture_mod.double(x)
        before = prof.snapshot()[f"{_FIXTURE_PREFIX}.double"]["count"]

        @entry_point
        def outer(x):
            return fixture_mod.double(x) + 1

        fixture_mod.outer = outer
        assert prof.install(prefix=_FIXTURE_PREFIX) == 1   # incremental
        fixture_mod.outer(x)
        snap = prof.snapshot()
        assert snap[f"{_FIXTURE_PREFIX}.double"]["count"] == before
        assert snap[f"{_FIXTURE_PREFIX}.outer"]["count"] == 1
    finally:
        prof.uninstall()


def test_uninstall_restores_every_alias(fixture_mod):
    orig = fixture_mod.scaled
    prof, _ = _install(fixture_mod)
    assert fixture_mod.scaled is not orig        # wrapped
    assert fixture_mod.scaled is fixture_mod.scaled_alias
    prof.uninstall()
    assert fixture_mod.scaled is orig
    assert fixture_mod.scaled_alias is orig
    assert fixture_mod.double.__name__ == "double"
    prof.uninstall()                             # idempotent


def test_second_live_profiler_is_refused(fixture_mod):
    prof, _ = _install(fixture_mod)
    try:
        other = DispatchProfiler(DevProfConfig(enabled=True))
        with pytest.raises(RuntimeError, match="another"):
            other.install(prefix=_FIXTURE_PREFIX)
        # Re-install by the OWNER is incremental, not an error.
        assert prof.install(prefix=_FIXTURE_PREFIX) == 0
    finally:
        prof.uninstall()


def test_memory_stats_graceful_none_on_cpu(fixture_mod):
    prof, _ = _install(fixture_mod)
    try:
        assert prof.memory_stats() is None       # no CUDA device in use
        off = DispatchProfiler(DevProfConfig(enabled=True,
                                             memory_stats=False))
        assert off.memory_stats() is None        # knob off: same shape
    finally:
        prof.uninstall()


# ----------------------------------------------------- the keying rules

def test_traced_scalar_keys_by_type_and_static_by_value(fixture_mod):
    """A float that changes every call is a traced scalar: one variant.
    A static argument keys by value; a new dtype or device of a tensor
    is a new variant."""
    @entry_point(static=("n",))
    def step(x, dt, n):
        return x * dt + n

    fixture_mod.step = step
    prof, _ = _install(fixture_mod)
    try:
        name = f"{_FIXTURE_PREFIX}.step"
        for i in range(5):
            fixture_mod.step(torch.ones(3), 0.1 * (i + 1), 2)
        assert prof.recompiles()[name] == 1
        fixture_mod.step(torch.ones(3), 0.5, 3)          # static value
        fixture_mod.step(torch.ones(3, dtype=torch.float64), 0.5, 3)
        assert prof.recompiles()[name] == 3
        sig = prof.signatures()[name][0]
        assert sig[0][1] == DP.ScalarSpec("float") and sig[0][2] == 2
        args, _ = DP.materialize_zeros(sig)
        assert args[1] == 0.0 and args[2] == 2 and not args[0].any()
    finally:
        prof.uninstall()


def test_namedtuple_leaves_key_by_field_and_roundtrip():
    """A NamedTuple is walked by field; its abstract signature keeps the
    type, and its zeros come back as that type."""
    from jax_mapping_torch.models.slam import init_state
    from jax_mapping_torch.config import tiny_config
    cfg = tiny_config()
    st = init_state(cfg, device="cpu")
    sig = DP.abstract_signature((cfg, st, 0.1), {}, ("cfg", "state", "dt"),
                                ("cfg",))
    assert type(sig[0][1]) is type(st) and sig[0][0] is cfg
    zargs, _ = DP.materialize_zeros(sig)
    assert type(zargs[1]) is type(st)
    for a, b in zip(zargs[1], st):
        if isinstance(b, torch.Tensor):
            assert a.shape == b.shape and a.dtype == b.dtype
            assert not a.any()
    assert DP.signature_key(sig) == DP.signature_key(
        DP.abstract_signature((cfg, st, 0.7), {}, ("cfg", "state", "dt"),
                              ("cfg",)))


def test_method_entry_point_wrapped_and_bound(fixture_mod):
    """A marked method is wrapped on its class and binds to instances;
    its receiver keys by type."""
    class Store:
        @entry_point
        def fuse(self, x):
            return x + self.bias

    Store.__module__ = _FIXTURE_PREFIX
    fixture_mod.Store = Store
    a, b = Store(), Store()
    a.bias, b.bias = 1.0, 2.0
    prof, n = _install(fixture_mod)
    try:
        assert n == 3
        assert isinstance(vars(Store)["fuse"], DP._ProfiledFn)
        assert float(a.fuse(torch.zeros(2))[0]) == 1.0
        assert float(b.fuse(torch.zeros(2))[0]) == 2.0
        name = [k for k in prof.snapshot() if k.endswith("fuse")][0]
        assert prof.snapshot()[name]["count"] == 2
        assert prof.recompiles()[name] == 1
    finally:
        prof.uninstall()
    assert not isinstance(vars(Store)["fuse"], DP._ProfiledFn)


# ------------------------------------------------------------ cost ledger

def test_cost_ledger_reports_flops_and_bytes(fixture_mod):
    prof, _ = _install(fixture_mod)
    try:
        fixture_mod.scaled(2, torch.ones((8, 8)))
        fixture_mod.scaled(2, torch.ones((4, 4)))
        ledger = CostLedger(prof)
        assert ledger.n_uncollected() == 2
        got = ledger.collect()
        variants = got[f"{_FIXTURE_PREFIX}.scaled"]
        assert len(variants) == 2
        for v in variants:
            assert v["flops"] > 0
            assert v["bytes_accessed"] > 0
            assert "8x8" in v["signature"] or "4x4" in v["signature"]
        # x * k on an (8, 8) f32: one mul an element, 256 bytes read and
        # written.
        big = [v for v in variants if "8x8" in v["signature"]][0]
        assert big["flops"] == 64 and big["bytes_accessed"] == 512
        assert ledger.n_uncollected() == 0
    finally:
        prof.uninstall()


def test_cost_ledger_collect_is_cached(fixture_mod, monkeypatch):
    prof, _ = _install(fixture_mod)
    try:
        fixture_mod.double(torch.ones((8, 8)))
        ledger = CostLedger(prof)
        calls = []
        real = CostLedger._collect_one

        def counting(fn, sig):
            calls.append(1)
            return real(fn, sig)

        monkeypatch.setattr(CostLedger, "_collect_one",
                            staticmethod(counting))
        ledger.collect()
        ledger.collect()                         # second pass: all cached
        assert len(calls) == 1
    finally:
        prof.uninstall()


def test_cost_ledger_cross_check_against_budget(fixture_mod, tmp_path):
    prof, _ = _install(fixture_mod)
    try:
        fixture_mod.scaled(2, torch.ones((8, 8)))
        ledger = CostLedger(prof)
        ledger.collect()
        budget = tmp_path / "budget.json"
        budget.write_text(json.dumps({"version": 1, "budgets": [
            {"name": f"{_FIXTURE_PREFIX}.scaled", "max": 1},
        ]}))
        assert ledger.cross_check(str(budget)) == []
        # A budgeted function with no coverage is a violation; so is a
        # variant count above budget.
        budget.write_text(json.dumps({"version": 1, "budgets": [
            {"name": f"{_FIXTURE_PREFIX}.scaled", "max": 1},
            {"name": f"{_FIXTURE_PREFIX}.double", "max": 1},
        ]}))
        (viol,) = ledger.cross_check(str(budget))
        assert "double" in viol and "no cost-ledger coverage" in viol
        fixture_mod.scaled(2, torch.ones((4, 4)))
        ledger.collect()
        viols = ledger.cross_check(str(budget))
        assert any("exceeds budget" in v for v in viols)
    finally:
        prof.uninstall()


def test_devprof_config_json_roundtrip():
    """The port's DevProfConfig round-trips through JSON and writes the
    JAX package's JSON for the same settings."""
    from jax_mapping import config as JC
    from jax_mapping_torch.config import ObsConfig, SlamConfig, tiny_config

    cfg = tiny_config().replace(obs=ObsConfig(
        enabled=True,
        devprof=DevProfConfig(enabled=True, max_signatures_per_fn=3)))
    back = SlamConfig.from_json(cfg.to_json())
    assert isinstance(back.obs.devprof, DevProfConfig)
    assert back == cfg
    jcfg = JC.tiny_config().replace(obs=JC.ObsConfig(
        enabled=True,
        devprof=JC.DevProfConfig(enabled=True, max_signatures_per_fn=3)))
    assert json.loads(cfg.to_json())["obs"] == \
        json.loads(jcfg.to_json())["obs"]
    # devprof defaults OFF — the shipped bit-exact default.
    assert not tiny_config().obs.devprof.enabled


# ------------------------------------------------- the entry-point registry

#: JAX entry points whose port counterpart has another name.
RENAMED = {
    "ops.fuse_kernel._window_apply_pallas": "ops.fuse_kernel.window_apply",
    "ops.sensor_kernel._per_scan_call": "ops.sensor_kernel._launch",
    "world.store.extract_tile": "world.store.extract_tiles",
    "world.store.scatter_tile": "world.store.scatter_tiles",
    "world.store.fuse_patch_global":
        "world.store.WorldStore.fuse_scan_global",
}
#: Static arguments renamed with their function, or static in the port
#: only (`scatter_tiles` takes the tile size JAX reads off the tile).
STATIC_RENAMED = {
    "ops.sensor_kernel._per_scan_call": {"mode": "raster"},
}
STATIC_ADDED = {"world.store.scatter_tile": {"t"}}
#: JAX entry points with no port counterpart, with the reason. Empty:
#: every one has one (the XLA engines the port keeps, `fuse_depths_xla`,
#: are plain PyTorch "general engines").
NOT_PORTED: dict = {}

REGISTRY_REF = '''
import importlib, inspect, json, os, pkgutil
import jax_mapping
for m in pkgutil.walk_packages(jax_mapping.__path__,
                               prefix="jax_mapping."):
    try:
        importlib.import_module(m.name)
    except Exception:
        pass
seen, static, names = set(), {}, []
for mod_name, mod in sorted(sys.modules.items()):
    if mod is None or not mod_name.startswith("jax_mapping"):
        continue
    for attr in sorted(vars(mod)):
        fn = vars(mod)[attr]
        if not callable(getattr(fn, "_cache_size", None)) or id(fn) in seen:
            continue
        seen.add(id(fn))
        params = list(inspect.signature(fn.__wrapped__).parameters)
        ji = fn._jit_info
        st = set(ji.static_argnames or ()) | {
            params[i] for i in (ji.static_argnums or ()) if i < len(params)}
        owner = fn.__module__ if fn.__module__.startswith("jax_mapping") \\
            else mod_name
        static[f"{owner}.{fn.__name__}"] = sorted(st)
        try:
            fn._cache_size()
        except Exception:
            continue
        names.append(f"{owner}.{fn.__name__}")
names.sort()
with open(os.path.join(os.path.dirname(jax_mapping.__file__), "analysis",
                       "compile_budget.json")) as f:
    budget = json.load(f)
OUT["names"] = np.array(json.dumps(names))
OUT["static"] = np.array(json.dumps(static))
OUT["budget"] = np.array(json.dumps(budget))
'''


@pytest.fixture(scope="module")
def jax_registry(tmp_path_factory):
    ref = run_reference(REGISTRY_REF,
                        tmp_path_factory.mktemp("registry") / "ref.npz")
    return {k: json.loads(str(ref[k])) for k in ("names", "static",
                                                 "budget")}


def _port_name(jax_name: str) -> str:
    short = jax_name[len("jax_mapping."):]
    return "jax_mapping_torch." + RENAMED.get(short, short)


def test_registry_marks_every_jax_entry_point(jax_registry):
    """Each of the JAX package's jitted functions (63 with every module
    imported) has a marked port counterpart, with JAX's static argument
    names, or a listed reason."""
    L.import_all()
    table = {q: fn for fn, sites in DP.entry_sites().values()
             for _, _, q in sites}
    names = jax_registry["names"]
    assert len(names) == 63
    for jname in names:
        short = jname[len("jax_mapping."):]
        if short in NOT_PORTED:
            continue
        port = _port_name(jname)
        assert port in table, (jname, port)
        want = {STATIC_RENAMED.get(short, {}).get(s, s)
                for s in jax_registry["static"][jname]}
        want |= STATIC_ADDED.get(short, set())
        assert set(table[port].__entry_point__) == want, (jname, want)


def test_budget_copy_is_jax_budget_on_port_names(jax_registry):
    """The port's compile_budget.json is JAX's: the same entries in the
    same order, names mapped to the port's, maxima and notes unchanged."""
    with open(L.default_budget_path()) as f:
        port = json.load(f)
    jax = jax_registry["budget"]
    assert port["version"] == jax["version"] == 1
    assert len(port["budgets"]) == len(jax["budgets"])
    for p, j in zip(port["budgets"], jax["budgets"]):
        assert p["name"] == _port_name(j["name"])
        assert p["max"] == j["max"] and p.get("note") == j.get("note")


# ------------------------------------------- the kernels' arithmetic

def _k1_inputs(B, gen):
    from jax_mapping_torch.config import SlamConfig
    cfg = SlamConfig()
    nb, P = cfg.scan.padded_beams, cfg.grid.patch_cells
    poses = torch.cat([torch.rand(B, 2, generator=gen) * 8 - 4,
                       torch.rand(B, 1, generator=gen) * 6 - 3], 1)
    from jax_mapping_torch.ops import grid as G
    origins = G.patch_origin(cfg.grid, poses[:, :2]).to(torch.int32)
    ranges = torch.rand(B, nb, generator=gen) * 10
    return cfg, nb, P, ranges, poses, origins


@pytest.mark.parametrize("B", [64, 8, 1, 168, 392, 21, 49, 48, 24])
def test_ledger_k1_arithmetic_equals_smoke_rows(B):
    """K1's bytes and operations at each smoke row's batch equal the
    smoke's former `bound` arithmetic: B * (nb*4 + 12 + 8 + P*P*4) bytes,
    55 operations per cell within range."""
    from jax_mapping_torch.ops import sensor_kernel as SK
    gen = torch.Generator().manual_seed(B)
    cfg, nb, P, ranges, poses, origins = _k1_inputs(B, gen)
    cells = SK.model_cells(cfg.grid, poses, origins)
    assert L.sensor_model_cost(cfg.grid, cfg.scan, ranges, poses,
                               origins) == (
        B * (nb * 4 + 12 + 8 + P * P * 4), cells * 55)


@pytest.mark.parametrize("B", [15, 16, 17, 256])
def test_ledger_k4_k5_arithmetic_equals_smoke_rows(B):
    from jax_mapping_torch.ops import sensor_kernel as SK
    gen = torch.Generator().manual_seed(100 + B)
    cfg, nb, P, ranges, poses, _ = _k1_inputs(B, gen)
    origin = torch.tensor([1728, 1728], dtype=torch.int32)
    cells = SK.model_cells(cfg.grid, poses, origin.reshape(1, 2).expand(
        B, 2))
    tables = B * (nb * 4 + 12) + 8
    assert L.window_delta_cost(cfg.grid, cfg.scan, ranges, poses,
                               origin) == (tables + P * P * 4, cells * 56)
    assert L.window_apply_cost(cfg.grid, cfg.scan, ranges, poses,
                               origin) == (tables + 2 * P * P * 4,
                                           cells * 56 + 3 * P * P)


@pytest.mark.parametrize("shape,sweeps", [((256, 256), 49),
                                          ((192, 192), 49),
                                          ((3, 256, 256), 49),
                                          ((64, 64), 49)])
def test_ledger_k2_arithmetic_equals_smoke_rows(shape, sweeps):
    n = shape[-1]
    T = shape[0] if len(shape) == 3 else 1
    mask = torch.zeros(shape, dtype=torch.bool)
    assert L.label_prop_cost(mask, sweeps) == (T * n * n * (1 + 4 + 4),
                                               T * sweeps * n * n * 9)


@pytest.mark.parametrize("mask_shape,init_shape,sweeps", [
    ((64, 64), (8, 64, 64), 16),            # fleet levels
    ((128, 128), (8, 128, 128), 32),
    ((256, 256), (8, 256, 256), 32),
    ((1024, 1024), (1, 1024, 1024), 2050),  # the planner's global route
    ((8, 256, 256), (8, 256, 256), 514),    # exact_bfs, a mask a field
    ((3, 64, 64), (24, 64, 64), 16),        # three tenants' fields
])
def test_ledger_k3_arithmetic_equals_smoke_rows(mask_shape, init_shape,
                                                sweeps):
    """K3: the smoke's `_sweep_row` (masks = the mask's leading size, R
    fields) and the tenants' levels (T masks, T * R fields)."""
    n = init_shape[-1]
    R = init_shape[0]
    masks = mask_shape[0] if len(mask_shape) == 3 else 1
    mask = torch.zeros(mask_shape, dtype=torch.bool)
    init = torch.zeros(init_shape)
    assert L.relax_cost(mask, init, sweeps) == (
        n * n * (masks + 2 * 4 * R), 17 * R * sweeps * n * n)


@pytest.mark.parametrize("B", [8, 32])
def test_ledger_k6_k7_arithmetic_equals_smoke_rows(B):
    """K6 and K7: the image bytes and the cull's operations as the
    smoke's `_k6_row` and `voxel_kernel_rows` computed them."""
    from jax_mapping_torch.config import tiny_config
    from jax_mapping_torch.ops import voxel_kernel as VK
    cfg = tiny_config()
    vox, cam = cfg.voxel, cfg.depthcam
    Z, P = vox.size_z_cells, vox.patch_cells
    gen = torch.Generator().manual_seed(B)
    poses = torch.cat([torch.rand(B, 2, generator=gen) * 2 - 1,
                       torch.rand(B, 1, generator=gen) * 6 - 3], 1)
    origins = torch.zeros((B, 2), dtype=torch.int32)
    img = cam.height_px * cam.width_px * 4 + 16 + 8
    for ny, nx, group in ((P, P, 1), (P, P, VK.Z_CHUNK),
                          (vox.size_y_cells, vox.size_x_cells,
                           VK.Z_CHUNK)):
        c = VK.cull_counts(vox, cam, VK.pose_table(poses), origins, ny, nx,
                           group=group)
        ops = (B * ny * nx * 26 + B * Z * 6
               + c["model_voxels"] * (19 + (group > 1)))
        if group == 1:
            assert L.voxel_image_cost(vox, cam, poses, origins) == (
                B * (Z * P * P * 4 + img), ops)
        else:
            assert L.voxel_summed_cost(vox, cam, poses, origins, ny,
                                       nx) == (Z * ny * nx * 4 + B * img,
                                               ops)


# ------------------------------------------- the canonical scenario

@pytest.fixture(scope="module")
def cost_ledger_run(tmp_path_factory):
    """`python -m jax_mapping_torch.obs cost-ledger --device cpu --budget
    <the port's budget>` in a fresh process (cold, as the budget is
    defined): its exit code and JSON, shared with the analysis self-check
    (`tests/torch_budget_run.py`)."""
    return torch_budget_run.cost_ledger_run(tmp_path_factory)


def test_cost_ledger_cli_passes_the_budget(cost_ledger_run):
    r, doc = cost_ledger_run
    assert r.returncode == 0, r.stderr[-3000:]
    assert doc["violations"] == []


def test_canonical_scenario_within_every_budget_maximum(cost_ledger_run):
    """Every budgeted entry point dispatched in the canonical scenario,
    within its maximum, and costed with FLOPs and bytes for each
    variant."""
    _r, doc = cost_ledger_run
    budget = L.Budget.load(L.default_budget_path())
    over, _unknown, stale = budget.check(doc["measured"])
    assert over == [] and stale == []
    for e in budget.entries:
        entries = doc["ledger"][e["name"]]
        assert 0 < len(entries) <= e["max"]
        for v in entries:
            assert v["flops"] > 0 and v["bytes_accessed"] > 0, (e, v)
    # Bucketing holds: B = 3, 5, 6 land in two fuse buckets, tenant
    # counts 3, 5, 6 in two megabatch buckets.
    assert doc["measured"]["jax_mapping_torch.ops.grid.fuse_scans_masked"] \
        == 2
    assert doc["measured"][
        "jax_mapping_torch.tenancy.megabatch.megabatch_step"] == 2


def test_measured_counts_are_steady_in_the_scenario(cost_ledger_run):
    """The scenario's recompiles equal its measured variants: nothing
    compiled outside the profiled window, and no function grew a variant
    per call (the dispatch counts exceed the variant counts)."""
    _r, doc = cost_ledger_run
    for name, n in doc["measured"].items():
        assert doc["recompiles"][name] == n
    for name in ("jax_mapping_torch.sim.lidar.simulate_scans",
                 "jax_mapping_torch.bridge.brain.brain_tick"):
        assert doc["dispatch"][name]["count"] >= 16
        assert doc["dispatch"][name]["compiled_variants"] == 1


def test_np_arrays_key_by_shape_and_dtype():
    sig = DP.abstract_signature((np.zeros((3, 2), np.float32),
                                 np.int32(4)), {})
    assert sig[0][0] == DP.ArraySpec((3, 2), "float32")
    assert sig[0][1] == DP.ScalarSpec("int32")
    args, _ = DP.materialize_zeros(sig)
    assert args[0].dtype == np.float32 and args[0].shape == (3, 2)
    assert args[1] == 0 and isinstance(args[1], np.int32)
