"""The port's FaultPlan against the JAX package's.

`resilience/faultplan.py` is host Python in both packages, so the JAX
one runs in this process (it imports no jitted code): every refusal of
`FaultEvent`, `random_plan` and `day_plan` over seeds 0-7 and the argument
ladders of the JAX suite, and both packages' plans driven against the same
recording stub stack — the same boundary calls in the same order, the same
logs — over scripts that overlap every composable resource (partitions,
bus weather, sensor faults, doors, crowds, pressure holds). Then the
port's chaos smoke on its CPU stack and the memory kinds against the
port's windowed store.
"""

import dataclasses
import os

import numpy as np
import pytest

from jax_mapping_torch.config import tiny_config
from jax_mapping_torch.resilience import faultplan as FP
from jax_mapping_torch.resilience.health import NO_LIDAR, OK
from jax_mapping_torch.scenarios.lifelong import day_plan
from jax_mapping_torch.sim import world as W
from tests.torch_threads import one_intra_op_thread  # noqa: F401


@pytest.fixture(scope="module")
def jfp():
    from jax_mapping.resilience import faultplan
    return faultplan


# ------------------------------------------------------------- refusals

REFUSED = [
    dict(step=0, kind="nope"),
    dict(step=-1, kind="bus_drop"),
    dict(step=0, kind="bus_drop", duration=-2),
    dict(step=0, kind="wheel_slip"),
    dict(step=0, kind="wheel_slip", value=-1.0),
    dict(step=0, kind="lidar_miscal"),
    dict(step=0, kind="ghost_returns"),
    dict(step=0, kind="door_close"),
    dict(step=0, kind="crowd"),
    dict(step=0, kind="crowd", value=-0.2),
    dict(step=0, kind="tenant_poison"),
    dict(step=0, kind="tenant_state_jump", name="t0"),
    dict(step=0, kind="tenant_state_jump", value=1.0),
    dict(step=0, kind="memory_pressure"),
    dict(step=0, kind="memory_pressure", value=1.5),
    dict(step=0, kind="spill_corrupt"),
    dict(step=0, kind="spill_corrupt", value=0.5),
]


@pytest.mark.parametrize("kw", REFUSED,
                         ids=[f"{k['kind']}{i}" for i, k in
                              enumerate(REFUSED)])
def test_fault_event_refusals_match_jax(jfp, kw):
    with pytest.raises(ValueError) as mine:
        FP.FaultEvent(**kw)
    with pytest.raises(ValueError) as theirs:
        jfp.FaultEvent(**kw)
    assert str(mine.value) == str(theirs.value)


def test_kind_sets_match_jax(jfp):
    for name in ("KINDS", "SENSOR_KINDS", "WORLD_KINDS", "TENANT_KINDS",
                 "MEMORY_KINDS"):
        assert getattr(FP, name) == getattr(jfp, name), name


# ------------------------------------------------------- generated plans

RANDOM_LADDER = [
    dict(mission_steps=100, n_faults=5, n_robots=2),
    dict(mission_steps=120, n_faults=8, n_robots=2),
    dict(mission_steps=150, n_faults=6, n_robots=2),
    dict(mission_steps=150, n_faults=6, n_robots=2,
         allow_world_faults=False),
    dict(mission_steps=200, n_faults=8, n_robots=2,
         allow_world_faults=True),
    dict(mission_steps=200, n_faults=10, n_robots=2,
         door_names=["door0", "door1"], n_crowds=2),
    dict(mission_steps=30, n_faults=40, n_robots=3,
         door_names=["d"], n_crowds=1, allow_cache_wipe=True,
         tenant_ids=["t0", "t1"], allow_controlplane_crash=True,
         allow_world_faults=True),
]


def _rows(events):
    return [dataclasses.astuple(e) for e in events]


@pytest.mark.parametrize("kw", RANDOM_LADDER,
                         ids=[f"ladder{i}" for i in range(len(RANDOM_LADDER))])
def test_random_plan_equals_jax(jfp, kw):
    for seed in range(8):
        mine = FP.random_plan(seed=seed, **kw)
        theirs = jfp.random_plan(seed=seed, **kw)
        assert _rows(mine.events) == _rows(theirs.events), seed
        assert mine.generation_shortfall == theirs.generation_shortfall
        assert mine.seed == theirs.seed


DAY_LADDER = [
    dict(mission_steps=150, door_names=["door_h0", "door_v1"], n_crowds=2,
         door_cycle=60, crowd_cycle=90, kill_steps=(100,)),
    dict(mission_steps=72, door_names=["door0"]),
    dict(mission_steps=400, door_names=["a", "b", "c"], n_crowds=3,
         door_cycle=40, crowd_cycle=50, kill_steps=(50, 200), start=5),
    dict(mission_steps=8, door_names=[], n_crowds=0),
]


@pytest.mark.parametrize("kw", DAY_LADDER,
                         ids=[f"day{i}" for i in range(len(DAY_LADDER))])
def test_day_plan_equals_jax(kw):
    from jax_mapping.scenarios.lifelong import day_plan as jax_day_plan
    assert _rows(day_plan(**kw)) == _rows(jax_day_plan(**kw))


# -------------------------------------------- boundary calls, refcounts

class _Rec:
    """Records every boundary call into one shared trace."""

    def __init__(self, trace, who):
        self._trace, self._who = trace, who

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)

        def call(*args, **kw):
            self._trace.append((self._who, name, args,
                                tuple(sorted(kw.items()))))
            if name == "corrupt_spill":
                return [(0, i) for i in range(min(int(args[0]), 2))]
            return None
        return call


class _Bus(_Rec):
    drop_prob = 0.05
    reorder_prob = 0.0

    def set_fault_injection(self, **kw):
        for k, v in kw.items():
            setattr(self, k, v)
        self._trace.append(("bus", "set_fault_injection", (),
                            tuple(sorted(kw.items()))))


class _Driver(_Rec):
    _n_reads = 7

    def __setattr__(self, name, value):
        if name == "fail_reads_after":
            self._trace.append(("driver", "fail_reads_after", (value,),
                                ()))
        object.__setattr__(self, name, value)


def _stub_stack(ckpt_path):
    trace = []
    st = type("Stack", (), {})()
    st.bus = _Bus(trace, "bus")
    st.driver = _Driver(trace, "driver")
    st.sim = _Rec(trace, "sim")
    st.world = _Rec(trace, "world")
    st.brain = type("Brain", (), {"n_robots": 3})()
    st.kill_node = lambda name: trace.append(("stack", "kill_node",
                                              (name,), ()))
    st.auto_checkpoint_path = ckpt_path
    return st, trace


#: Scripts that overlap every composable resource.
SCRIPTS = {
    "partitions": [
        dict(step=1, kind="lidar_dead", robot=0, duration=10),
        dict(step=3, kind="lidar_dead", robot=0, duration=3),
        dict(step=4, kind="kill_robot", robot=1, duration=5),
        dict(step=5, kind="kill_robot", robot=1),
        dict(step=7, kind="rejoin_robot", robot=1),
        dict(step=8, kind="rejoin_robot", robot=2),
        dict(step=2, kind="driver_offline", duration=4),
        dict(step=3, kind="driver_offline", duration=8),
        dict(step=9, kind="kill_node", name="jax_mapper"),
    ],
    "weather_and_sensors": [
        dict(step=0, kind="bus_drop", value=0.3, duration=6),
        dict(step=2, kind="bus_drop", value=0.6, duration=2),
        dict(step=1, kind="bus_reorder", value=0.2, duration=3),
        dict(step=1, kind="wheel_slip", robot=0, value=1.3, duration=6),
        dict(step=2, kind="wheel_slip", robot=0, value=0.6, duration=2),
        dict(step=3, kind="lidar_miscal", robot=1, value=-0.2,
             duration=4),
        dict(step=4, kind="lidar_miscal", robot=1, value=0.1, duration=5),
        dict(step=2, kind="ghost_returns", robot=2, value=0.3, duration=3),
        dict(step=3, kind="scan_jam", robot=2, duration=2),
        dict(step=4, kind="scan_jam", robot=2, duration=5),
    ],
    "world": [
        dict(step=2, kind="door_close", name="door0", duration=6),
        dict(step=4, kind="door_close", name="door0", duration=10),
        dict(step=5, kind="door_close", name="door1", duration=2),
        dict(step=1, kind="crowd", robot=0, value=0.2, duration=8),
        dict(step=3, kind="crowd", robot=0, value=0.4, duration=2),
        dict(step=6, kind="crowd", robot=1, value=0.3, duration=3),
    ],
    "memory_and_skips": [
        dict(step=0, kind="memory_pressure", value=0.7, duration=10),
        dict(step=5, kind="memory_pressure", value=0.4, duration=10),
        dict(step=6, kind="spill_corrupt", value=3.0),
        dict(step=7, kind="corrupt_checkpoint"),
        dict(step=8, kind="corrupt_checkpoint", name="missing.npz"),
        dict(step=2, kind="cache_wipe", duration=3),
        dict(step=3, kind="tenant_poison", name="t0", duration=2),
        dict(step=3, kind="tenant_state_jump", name="t0", value=1.0),
        dict(step=4, kind="controlplane_crash"),
    ],
}


def _drive(mod, events, ckpt_path, steps=22):
    st, trace = _stub_stack(ckpt_path)
    plan = mod.FaultPlan([mod.FaultEvent(**e) for e in events], seed=3)
    done = []
    for t in range(steps):
        plan.apply(st, t)
        done.append(plan.done())
    return plan, trace, done


@pytest.mark.parametrize("name", list(SCRIPTS))
def test_boundary_calls_and_logs_equal_jax(jfp, name, tmp_path):
    """Both packages' plans, driven against the same recording stub,
    make the same boundary calls in the same order and log the same
    (step, description) rows; the scripts' overlapping windows compose
    by refcount (partitions, doors, pressure holds) and worst-of (bus
    weather, sensor faults, crowd radii)."""
    ck = []
    for k in range(2):
        p = tmp_path / f"ck{k}.npz"
        p.write_bytes(b"x" * 1000)
        ck.append(str(p))
    mine = _drive(FP, SCRIPTS[name], ck[0])
    theirs = _drive(jfp, SCRIPTS[name], ck[1])
    assert mine[1] == theirs[1]
    norm = [(s, d.replace(ck[0], "CK")) for s, d in mine[0].log]
    assert norm == [(s, d.replace(ck[1], "CK")) for s, d in theirs[0].log]
    assert mine[2] == theirs[2] and mine[2][-1]
    trace = mine[1]
    if name == "partitions":
        heals = [i for i, c in enumerate(trace) if c[1] == "heal"
                 and c[2] == ("robot0/scan",)]
        parts = [i for i, c in enumerate(trace) if c[1] == "partition"
                 and c[2] == ("robot0/scan",)]
        assert len(parts) == 2 and len(heals) == 1      # last window out
        enabled = [c[2] for c in trace if c[1] == "set_robot_enabled"]
        assert enabled == [(1, False), (1, False), (1, True)]
        offline = [c[2][0] for c in trace if c[1] == "fail_reads_after"]
        assert offline == [7, 7, None]
    elif name == "weather_and_sensors":
        drops = [dict(c[3])["drop_prob"] for c in trace
                 if c[1] == "set_fault_injection"
                 and "drop_prob" in dict(c[3])]
        assert drops == [0.3, 0.6, 0.3, 0.05]           # worst, then base
        slips = [c[2][1] for c in trace if c[1] == "set_wheel_slip"]
        assert slips == [1.3, 0.6, 1.3, 1.0]             # farthest from 1
        jams = [c[2][1] for c in trace if c[1] == "set_scan_jam"]
        assert jams == [True, True, True, False]
    elif name == "world":
        doors = [c[2] for c in trace if c[1] == "set_door"]
        # door0's first clear (step 8) leaves it shut: the second window
        # holds it to step 14.
        assert doors == [("door0", True), ("door0", True),
                         ("door1", True), ("door1", False),
                         ("door0", False)]
        crowd0 = [c[2][1] for c in trace if c[1] == "set_crowd"
                  and c[2][0] == 0]
        assert crowd0 == [0.2, 0.4, 0.2, None]
    else:
        holds = [c for c in trace if c[0] == "world"]
        assert [c[1] for c in holds] == [
            "hold_pressure", "hold_pressure", "corrupt_spill",
            "release_pressure", "release_pressure"]
        assert holds[3][2] == ("chaos@0",) and holds[4][2] == ("chaos@5",)
        skipped = [d for _, d in mine[0].log if "skipped" in d]
        assert len(skipped) == 5      # cache, 2 tenant, plane, no file
        assert os.path.getsize(ck[0]) == 600


def test_notes_reach_the_flight_recorder():
    from jax_mapping_torch.obs.recorder import flight_recorder
    st, _trace = _stub_stack("")
    mark = flight_recorder.mark()
    plan = FP.FaultPlan([FP.FaultEvent(step=0, kind="bus_drop", value=0.5,
                                       duration=2)])
    for t in range(3):
        plan.apply(st, t)
    evs = [(e["step"], e["desc"]) for e in flight_recorder.events_since(mark)
           if e["kind"] == "fault"]
    assert evs == list(plan.log) == [(0, "bus_drop=0.5"),
                                     (2, "clear: bus_drop")]
    assert plan.summary() == ["step 0: bus_drop=0.5",
                              "step 2: clear: bus_drop"]


# ------------------------------------------------- on the port's stack

def test_chaos_smoke_single_fault(tmp_path):
    """One scripted lidar outage mid-mission on the port's CPU stack: the
    robot walks the NO_LIDAR ladder and back, mapping continues after
    the heal, and the fault log is exactly the scripted schedule."""
    from jax_mapping_torch.bridge.launch import launch_sim_stack
    cfg = tiny_config()
    world = W.plank_course(96, cfg.grid.resolution_m, n_planks=4, seed=3)
    st = launch_sim_stack(cfg, world, n_robots=1, realtime=False,
                          checkpoint_dir=str(tmp_path), seed=0,
                          device="cpu")
    try:
        st.brain.start_exploring()
        st.brain.reconnect_period_s = 0.0
        plan = FP.FaultPlan([FP.FaultEvent(step=8, kind="lidar_dead",
                                           robot=0, duration=15)], seed=0)
        st.attach_fault_plan(plan)
        st.run_steps(45)
        grid = st.mapper.merged_grid().cpu().numpy()
    finally:
        st.shutdown()
    assert plan.done()
    assert [d for _, d in plan.log] == ["lidar_dead robot0",
                                        "clear: lidar_dead robot0"]
    ladder = [(a, b) for _, a, b in st.health.transitions_for("robot0")]
    assert (OK, NO_LIDAR) in ladder
    assert ladder[-1][1] == OK
    assert st.mapper.n_scans_fused > 0
    assert int((np.abs(grid) > 0.5).sum()) > 200


def _windowed_store(tmp_path):
    """The port's windowed store with one scan fused at the origin and
    the window shifted away, so three tiles spilled to disk."""
    import torch

    from jax_mapping_torch.config import WorldConfig
    from jax_mapping_torch.ops import grid as G
    from jax_mapping_torch.world.store import WorldStore
    cfg = tiny_config()
    cfg = cfg.replace(
        grid=dataclasses.replace(cfg.grid, size_cells=768),
        world=WorldConfig(windowed=True, window_tiles=4, margin_tiles=1,
                          host_tile_budget=1, retention_coarsen=1))
    store = WorldStore(cfg, spill_dir=str(tmp_path))
    win = G.empty_grid(store.cfg.grid, "cpu")
    ranges = torch.full((cfg.scan.padded_beams,), 1.5)
    ranges[cfg.scan.n_beams:] = 0.0
    win = store.fuse_scan_global(win, ranges, np.zeros(3, np.float32))
    return store, store.shift(win, 0, 4)


def test_memory_kinds_against_the_windowed_store(tmp_path):
    """memory_pressure holds compose worst-of in the port's governor
    under per-event names, each clear releasing its own; spill_corrupt
    rots real spilled tiles, and their rehydrate degrades to unknown with
    a flight event, never an exception."""
    from jax_mapping_torch.obs.recorder import flight_recorder
    store, win = _windowed_store(tmp_path)
    assert len(store.spill.tiles()) == 3
    stack = type("S", (), {"world": store, "bus": None})()
    plan = FP.FaultPlan([
        FP.FaultEvent(step=0, kind="memory_pressure", value=0.7,
                      duration=10),
        FP.FaultEvent(step=5, kind="memory_pressure", value=0.4,
                      duration=10),
        FP.FaultEvent(step=6, kind="spill_corrupt", value=2.0),
    ], seed=0)
    plan.apply(stack, 0)
    assert store.governor.status()["pressure_holds"] == 1
    plan.apply(stack, 5)
    assert store.governor.status()["pressure_holds"] == 2
    mark = flight_recorder.mark()
    plan.apply(stack, 6)
    (desc,) = [d for s, d in plan.log if s == 6]
    assert desc.startswith("spill_corrupt 2 tile(s)")
    plan.apply(stack, 10)
    assert store.governor.status()["pressure_holds"] == 1
    plan.apply(stack, 15)
    assert store.governor.status()["pressure_holds"] == 0
    assert plan.done()
    win = store.shift(win, 0, -4)
    win, _ = store.poll_prefetch(win)
    assert store.n_corrupt_spills == 2
    evs = [e for e in flight_recorder.events_since(mark)
           if e["kind"] == "world_spill_corrupt"]
    assert len(evs) == 2
    store.close()
