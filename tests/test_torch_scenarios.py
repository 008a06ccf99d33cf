"""The scenario engine of the port against the JAX package's: dynamic
worlds, the sim's world uploads and the shared scenario mission.

`WorldDynamics` composes on the host in both packages, so the port's
composed world must equal JAX's bit for bit at every step, over doors x
crowds x steps, and the registrations refuse the same things.

The shared mission is the JAX suite's (`tests/test_scenarios.py`,
`scenario_mission`): tiny_config with `DecayConfig(True, 8, 0.9, 1.5)`,
the obs tier with its staleness SLO, `arena_with_door(96)`, 2 robots, a
`door_close` at step 4 for 16 steps, a `crowd` at step 26 for 10 steps, a
`kill_node` of the mapper at step 48, 72 steps, a delta client polling at
step 18 and at the end, and a `warmup_hook` that probes `/status` and
`/tiles` inside the staged restart's warming window. The dispatch profiler
is armed on the port's side only: JAX's fails under jax 0.9.0
(`obs/devprof.py:71`), and the profiler is bit-inert, so the span streams
must stay equal. Wheel noise is off
(`speed_noise_frac=0`: JAX's PRNG draws cannot be reproduced) and the
message stamps come from a simulated clock, one control period a step, in
both packages (ROADMAP C.4). The JAX reference runs in a fresh
`JAX_PLATFORMS=cpu` subprocess (`tests/torch_jaxref.py`); the port's
mission runs on the CPU from the JAX stack's spawn state. The port is held
to it: plan logs, world updates, decay passes, restarts, the restart
epoch and the SLO alert schedule equal; truth within 1e-5 m and 1e-5 rad
at every step; the grid at the door-closed snapshot and at the end within
ROADMAP C's window tolerances (cells off by more than 2e-6: at most 1e-4
of them); and JAX's own mission assertions hold on the port's mission.
"""

import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from jax_mapping_torch.config import (DecayConfig, DevProfConfig, ObsConfig,
                                      SloObjective, tiny_config)
from jax_mapping_torch.resilience.faultplan import FaultEvent, FaultPlan
from jax_mapping_torch.scenarios import (DoorSpec, WorldDynamics,
                                         launch_scenario_stack)
from jax_mapping_torch.sim import world as W
from tests.torch_jaxref import run_reference
from tests.torch_threads import one_intra_op_thread  # noqa: F401

#: Shared by the reference script and the port's side.
SETUP = '''
DOOR_CLOSE_AT, DOOR_STEPS = 4, 16
CROWD_AT, CROWD_STEPS = 26, 10
KILL_AT = 48
MISSION_STEPS = 72
POLL_AT = DOOR_CLOSE_AT + DOOR_STEPS - 2        # the door still closed


def mission_config(tiny_config, DecayConfig, ObsConfig, SloObjective):
    import dataclasses
    cfg = tiny_config()
    return cfg.replace(
        robot=dataclasses.replace(cfg.robot, speed_noise_frac=0.0),
        decay=DecayConfig(enabled=True, every_n_ticks=8, factor=0.9,
                          evidence_cap=1.5),
        obs=ObsConfig(enabled=True,
                      slo=(SloObjective(name="staleness",
                                        metric="tile_staleness_revs",
                                        threshold=30.0,
                                        fast_window_ticks=8,
                                        slow_window_ticks=24,
                                        fast_burn=0.5, slow_burn=0.25),)))


def mission_events(FaultEvent):
    return [FaultEvent(step=DOOR_CLOSE_AT, kind="door_close", name="door0",
                       duration=DOOR_STEPS),
            FaultEvent(step=CROWD_AT, kind="crowd", robot=0,
                       duration=CROWD_STEPS, value=0.25),
            FaultEvent(step=KILL_AT, kind="kill_node", name="jax_mapper")]


def sim_clock(modules, st, cfg):
    """Stamps from a simulated clock (ROS's sim time): every read in a sim
    step gives that step's time, one control period after the last.
    Returns the patched modules' previous `time` attributes."""
    import types
    clock = [1000.0]
    saved = [(m, m.time) for m in modules]
    for m in modules:
        m.time = types.SimpleNamespace(monotonic=lambda: clock[0])
    step = st.sim.step

    def stepped():
        clock[0] += 1.0 / cfg.robot.control_rate_hz
        step()
    st.sim.step = stepped
    return saved


def drive_mission(st, plan, client, to_numpy):
    """The mission's steps and polls; returns its artifacts."""
    import json
    st.brain.start_exploring()
    st.brain.reconnect_period_s = 0.0
    st.attach_fault_plan(plan)
    probe = {}

    def probe_warming_window(stack):
        # Inside the staged restart's warming stage: the old node
        # destroyed, the new one not yet bound.
        s = json.loads(stack.api.handle("/status")[2])
        t = json.loads(stack.api.handle("/tiles?since=-1")[2])
        probe.update(status_state=s.get("state"),
                     tiles_state=t.get("state"), tiles_epoch=t.get("epoch"),
                     n_tiles=len(t.get("tiles", [])),
                     warmup_state=stack.warmup.state(),
                     old_epoch=stack.mapper.restart_epoch)

    st.warmup_hook = probe_warming_window
    art = {"truth": []}
    for k in range(MISSION_STEPS):
        st.run_steps(1)
        art["truth"].append(st.sim.truth_poses().copy())
        if k + 1 == POLL_AT:
            client.poll()
            art["pre_restart_epoch"] = client.epoch
            art["grid_closed"] = to_numpy(st.mapper.merged_grid())
    art["grid_end"] = to_numpy(st.mapper.merged_grid())
    client.poll()
    art["truth"] = np.stack(art["truth"])
    art["counts"] = np.array([
        st.sim.n_world_updates, st.mapper.n_decay_passes,
        st.supervisor.n_restarts("jax_mapper"), st.mapper.restart_epoch,
        st.mapper.n_scans_fused, st.mapper.map_revision])
    art["client_state"] = np.array([client.epoch, client.n_epoch_resyncs,
                              client.revision,
                              st.mapper.serving_revision()])
    art["warm_probe"] = json.dumps(probe, sort_keys=True)
    return art


def span_rows(spans):
    """The deterministic content of a span stream, one row a span."""
    return [(s["name"], s["trace_id"], s["span_id"], s["parent_span"])
            for s in spans]
'''
exec(SETUP)

REFERENCE = '''
import os
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_cpu_multi_thread_eigen=false")
import json
import tempfile
''' + SETUP + '''
from jax_mapping.bridge import brain as _brain, sim_node as _sim_node
from jax_mapping.config import (DecayConfig, ObsConfig, SloObjective,
                                tiny_config)
from jax_mapping.obs.recorder import flight_recorder
from jax_mapping.resilience.faultplan import FaultEvent, FaultPlan
from jax_mapping.scenarios import WorldDynamics, launch_scenario_stack
from jax_mapping.serving.client import DeltaMapClient
from jax_mapping.sim import lidar
from jax_mapping.sim import world as W

cfg = mission_config(tiny_config, DecayConfig, ObsConfig, SloObjective)
world, doors = W.arena_with_door(96, cfg.grid.resolution_m)
mark = flight_recorder.mark()
st = launch_scenario_stack(cfg, world, doors=doors, n_robots=2,
                           realtime=False, seed=0, http_port=0,
                           checkpoint_dir=tempfile.mkdtemp())
sim_clock((_brain, _sim_node), st, cfg)
OUT["init_truth"] = st.sim.truth_poses().copy()
OUT["init_wheels"] = np.asarray(st.sim.sim_state.wheel_speeds)
plan = FaultPlan(mission_events(FaultEvent), seed=0)
client = DeltaMapClient(f"http://127.0.0.1:{st.api.port}")
art = drive_mission(st, plan, client,
                    lambda g: np.array(np.asarray(g), copy=True))
for k, v in art.items():
    OUT[k] = np.asarray(v)
OUT["plan_log"] = np.array(json.dumps(plan.log))
OUT["spans"] = np.array(json.dumps(span_rows(st.tracer.spans_since(0))))
events = flight_recorder.events_since(mark)
OUT["slo_alerts"] = np.array(json.dumps(
    [(e["tick"], e["objective"], e["state"]) for e in events
     if e["kind"] == "slo_alert"]))
OUT["faults"] = np.array(json.dumps(
    [e["desc"] for e in events if e["kind"] == "fault"]))
st.shutdown()

# Scans of a composed world: the door closed and a crowd out.
dyn = WorldDynamics(world, 0.05, doors=doors, seed=0)
dyn.set_door("door0", True)
dyn.set_crowd(0, 0.25)
composed = dyn.world_at(30)
OUT["composed"] = composed
rng = np.random.default_rng(5)
poses = np.concatenate([rng.uniform(-1.5, 1.5, (6, 2)),
                        rng.uniform(-3.1, 3.1, (6, 1))], 1)
OUT["scan_poses"] = poses.astype(np.float32)
n_samples = int(cfg.scan.range_max_m / (0.05 * 0.5))
OUT["scans"] = np.asarray(lidar.simulate_scans(
    cfg.scan, composed, 0.05, n_samples, poses.astype(np.float32)))
'''


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(REFERENCE,
                         tmp_path_factory.mktemp("scenario") / "ref.npz")


@pytest.fixture(scope="module")
def mission(ref, tmp_path_factory):
    """The port's shared mission on the CPU, from the JAX stack's spawn,
    with the dispatch profiler armed."""
    import dataclasses
    import json

    from jax_mapping_torch import interop
    from jax_mapping_torch.bridge import brain as _brain
    from jax_mapping_torch.bridge import sim_node as _sim_node
    from jax_mapping_torch.obs.recorder import flight_recorder
    from jax_mapping_torch.serving.client import DeltaMapClient

    cfg = mission_config(tiny_config, DecayConfig, ObsConfig, SloObjective)
    cfg = cfg.replace(obs=dataclasses.replace(
        cfg.obs, devprof=DevProfConfig(enabled=True)))
    world, doors = W.arena_with_door(96, cfg.grid.resolution_m)
    td = str(tmp_path_factory.mktemp("scenario_ckpt"))
    mark = flight_recorder.mark()
    st = launch_scenario_stack(cfg, world, doors=doors, n_robots=2,
                               realtime=False, seed=0, http_port=0,
                               checkpoint_dir=td, device="cpu")
    saved = sim_clock((_brain, _sim_node), st, cfg)
    try:
        st.sim.sim_state = interop.fleet_sim_state_from_numpy(
            SimpleNamespace(poses=ref["init_truth"],
                            wheel_speeds=ref["init_wheels"]), "cpu")
        st.brain.poses = st.sim.truth_poses().copy()
        for i, s in enumerate(st.mapper.states):
            st.mapper.states[i] = s._replace(
                pose=torch.as_tensor(st.brain.poses[i]))
        plan = FaultPlan(mission_events(FaultEvent), seed=0)
        client = DeltaMapClient(f"http://127.0.0.1:{st.api.port}")
        art = drive_mission(st, plan, client,
                            lambda g: g.cpu().numpy().copy())
    finally:
        for m, t in saved:
            m.time = t
    d = doors[0]
    off = (cfg.grid.size_cells - world.shape[0]) // 2
    m = st.mapper
    with m._state_lock:
        poses = torch.stack([s.pose for s in m.states]).numpy()
        lo = m.shared_grid
        rev = m.map_revision
        tile_rev = m._tile_rev.copy()
    pipe = m._frontier_incremental()
    from jax_mapping_torch.ops import frontier as F
    from jax_mapping_torch.ops import grid as G
    art.update(
        cfg=cfg, stack=st, plan=plan, client=client, ckpt_dir=td,
        rect=(d["r0"] + off, d["r1"] + off, d["c0"] + off, d["c1"] + off),
        gray_end=G.to_gray(cfg.grid, lo).numpy(),
        pub=None if pipe is None else pipe.compute(lo, poses, tile_rev,
                                                   rev),
        full=F.compute_frontiers(cfg.frontier, cfg.grid, lo,
                                 torch.as_tensor(poses)),
        spans=st.tracer.spans_since(0),
        events=flight_recorder.events_since(mark),
        metrics=st.api.handle("/metrics")[2].decode(),
        trace=st.api.handle("/trace?since=0"),
        slo_status=json.loads(st.api.handle("/status")[2]).get("slo"),
        tiles_probe=st.api.handle("/tiles?since=-1"))
    yield art
    st.shutdown()


# ------------------------------------------------------------- dynamics

DOOR_SETS = [(), ("door0",)]
CROWD_SETS = [{}, {0: 0.25}, {0: 0.2, 3: 0.4}]


@pytest.mark.parametrize("doors_closed", DOOR_SETS, ids=["open", "closed"])
@pytest.mark.parametrize("crowds", CROWD_SETS,
                         ids=["no_crowd", "one_crowd", "two_crowds"])
def test_world_at_bit_equal_to_jax(doors_closed, crowds):
    """The composed world equals JAX's bit for bit at every step, over
    the world generators' doors, crowd sets and seeds."""
    from jax_mapping.scenarios.dynamics import WorldDynamics as JaxDyn
    for seed, (world, doors) in enumerate(
            [W.arena_with_door(96, 0.05), W.rooms_with_doors(128, 0.05, 1)]):
        a = WorldDynamics(world, 0.05, doors=doors, seed=seed)
        b = JaxDyn(world, 0.05, doors=doors, seed=seed)
        names = [d["name"] for d in doors] if doors_closed else []
        for dyn in (a, b):
            for n in names:
                dyn.set_door(n, True)
            for cid, r in crowds.items():
                dyn.set_crowd(cid, r)
        for step in (0, 1, 7, 30, 123):
            assert a.crowd_center(3, step) == b.crowd_center(3, step)
            np.testing.assert_array_equal(a.world_at(step),
                                          b.world_at(step))
        assert a.snapshot() == b.snapshot()


def test_registration_refusals_match_jax():
    from jax_mapping.scenarios.dynamics import WorldDynamics as JaxDyn
    world, _ = W.arena_with_door(96, 0.05)
    bad = [[{"name": "d", "r0": 5, "r1": 5, "c0": 0, "c1": 2}],
           [{"name": "d", "r0": 0, "r1": 200, "c0": 0, "c1": 2}],
           [{"name": "d", "r0": 1, "r1": 3, "c0": 1, "c1": 3},
            {"name": "d", "r0": 4, "r1": 6, "c0": 1, "c1": 3}]]
    for doors in bad:
        for cls in (WorldDynamics, JaxDyn):
            with pytest.raises(ValueError):
                cls(world, 0.05, doors=doors)
    dyn = WorldDynamics(world, 0.05, doors=[DoorSpec("d", 1, 3, 1, 3)])
    with pytest.raises(ValueError, match="unknown door"):
        dyn.set_door("nope", True)


def test_rooms_with_doors_reports_real_gaps():
    from jax_mapping.sim import world as JW
    world, doors = W.rooms_with_doors(96, 0.05, seed=1)
    jworld, jdoors = JW.rooms_with_doors(96, 0.05, seed=1)
    np.testing.assert_array_equal(world, jworld)
    assert doors == jdoors and len(doors) == 4
    np.testing.assert_array_equal(W.rooms_world(96, 0.05, seed=1), world)
    for d in doors:
        assert (~world[d["r0"]:d["r1"], d["c0"]:d["c1"]]).mean() >= 0.5


def test_rooms_wide_doors_reports_widened_doors():
    """The kernel inputs' 2 m-door rooms also return the widened door
    rectangles; the world is the one its callers had."""
    from tests import torch_kernel_inputs as KI
    w = KI.rooms_wide_doors(256, 0.05, door_m=2.0, seed=1)
    w2, doors = KI.rooms_wide_doors(256, 0.05, door_m=2.0, seed=1,
                                    return_doors=True)
    np.testing.assert_array_equal(w, w2)
    assert len(doors) == 4
    for d in doors:
        assert not w[d["r0"]:d["r1"], d["c0"]:d["c1"]].any()
        assert max(d["r1"] - d["r0"], d["c1"] - d["c0"]) == 40


def _script():
    return [(2, "door", ("door0", True)), (5, "crowd", (0, 0.25)),
            (9, "crowd", (0, None)), (12, "door", ("door0", False)),
            (14, "door", ("door0", False))]


def test_sim_node_uploads_as_jax_counts():
    """The sim's uploads follow `world_if_changed` on the same script as
    the JAX package's: one at the first step (the fresh dynamics is
    dirty), one a toggle, one a step while a crowd is out, none on a
    quiet step; the sim's world is the composed one after each."""
    from jax_mapping.scenarios.dynamics import WorldDynamics as JaxDyn
    from jax_mapping_torch.bridge.bus import Bus
    from jax_mapping_torch.bridge.driver import SimulatedThymioDriver
    from jax_mapping_torch.bridge.sim_node import SimNode
    cfg = tiny_config()
    world, doors = W.arena_with_door(96, 0.05)
    sim = SimNode(cfg, Bus(), SimulatedThymioDriver(n_robots=1), world,
                  0.05, realtime=False, device="cpu")
    with pytest.raises(RuntimeError, match="no world dynamics"):
        sim.set_door("door0", True)
    sim.attach_world_dynamics(WorldDynamics(world, 0.05, doors=doors))
    jdyn = JaxDyn(world, 0.05, doors=doors)
    script = {s: (k, a) for s, k, a in _script()}
    want = 0
    for step in range(18):
        if step in script:
            kind, args = script[step]
            getattr(sim, f"set_{kind}")(*args)
            getattr(jdyn, f"set_{kind}")(*args)
        before = sim.n_world_updates
        sim.step()
        composed = jdyn.world_if_changed(step)
        want += composed is not None
        assert sim.n_world_updates == want, step
        if composed is not None:
            np.testing.assert_array_equal(sim.world.numpy(), composed)
        else:
            assert sim.n_world_updates == before
    assert want == 1 + 1 + 4 + 1 + 1


def test_scans_of_composed_world_match_jax(ref):
    """The port's raycast of the composed world (door closed, a crowd out)
    matches JAX's to the `simulate_scans` tolerance of ROADMAP C: at least
    99% of beams identical to 1e-6 relative."""
    from jax_mapping_torch.sim import lidar
    world, doors = W.arena_with_door(96, 0.05)
    dyn = WorldDynamics(world, 0.05, doors=doors, seed=0)
    dyn.set_door("door0", True)
    dyn.set_crowd(0, 0.25)
    composed = dyn.world_at(30)
    np.testing.assert_array_equal(composed, ref["composed"])
    cfg = tiny_config()
    n_samples = int(cfg.scan.range_max_m / (0.05 * 0.5))
    got = lidar.simulate_scans(cfg.scan, torch.as_tensor(composed), 0.05,
                               n_samples,
                               torch.as_tensor(ref["scan_poses"])).numpy()
    same = np.isclose(got, ref["scans"], rtol=1e-6, atol=0)
    assert same.mean() >= 0.99, same.mean()


def test_quiet_scenario_stack_equals_plain_stack():
    """A scenario stack with no event fired equals the plain stack: the
    grid bit-equal, the estimates within the 1e-6 same-seed tolerance
    (ROADMAP C), and the sim made no upload past its first step's."""
    from jax_mapping_torch.bridge.launch import launch_sim_stack
    cfg = tiny_config(2)
    world, doors = W.arena_with_door(96, cfg.grid.resolution_m)
    runs = []
    for scenario in (False, True):
        if scenario:
            st = launch_scenario_stack(cfg, world, doors=doors, n_robots=2,
                                       seed=0, device="cpu")
        else:
            st = launch_sim_stack(cfg, world, n_robots=2, seed=0,
                                  device="cpu")
        st.brain.start_exploring()
        st.run_steps(12)
        runs.append(st)
    plain, scen = runs
    assert scen.sim.n_world_updates == 1 and plain.sim.n_world_updates == 0
    assert torch.equal(plain.mapper.shared_grid, scen.mapper.shared_grid)
    np.testing.assert_array_equal(plain.sim.truth_poses(),
                                  scen.sim.truth_poses())
    for a, b in zip(plain.mapper.states, scen.mapper.states):
        assert float((a.pose - b.pose).abs().max()) <= 1e-6
    for st in runs:
        st.shutdown()


@pytest.mark.parametrize("seed", [0, 3])
def test_devprof_is_bit_inert(seed):
    """tiny_config(2), 40 steps on rooms_with_doors(96): the stack with
    the dispatch profiler armed gives bit-equal grids, estimates and
    truth to the stack without it. (Before the shared mission, which
    holds the process's one profiler while it lives.)"""
    import dataclasses

    from jax_mapping_torch.bridge import brain as _brain
    from jax_mapping_torch.bridge import sim_node as _sim_node
    from jax_mapping_torch.bridge.launch import launch_sim_stack
    cfg = tiny_config(2)
    world, _doors = W.rooms_with_doors(96, cfg.grid.resolution_m, seed=1)
    runs = []
    for on in (False, True):
        c = cfg.replace(obs=dataclasses.replace(
            cfg.obs, devprof=DevProfConfig(enabled=on)))
        st = launch_sim_stack(c, world, n_robots=2, seed=seed,
                              device="cpu")
        # Stamps from the simulated clock: wall-clock stamp intervals
        # move the estimates by an ulp between any two runs (ROADMAP C).
        saved = sim_clock((_brain, _sim_node), st, c)
        try:
            st.brain.start_exploring()
            st.run_steps(40)
            runs.append((st.mapper.shared_grid.clone(),
                         torch.stack([s.pose for s in st.mapper.states]),
                         st.sim.truth_poses().copy(),
                         st.mapper.n_scans_fused,
                         None if st.devprof is None
                         else st.devprof.snapshot()))
        finally:
            for m, t in saved:
                m.time = t
            st.shutdown()
    (g0, p0, t0, n0, off), (g1, p1, t1, n1, on) = runs
    assert off is None and len(on) >= 4
    assert torch.equal(g0, g1) and torch.equal(p0, p1)
    np.testing.assert_array_equal(t0, t1)
    assert n0 == n1 > 0


# ----------------------------------------- the shared mission, held to JAX

def test_mission_plan_log_and_counters_equal_jax(ref, mission):
    import json
    assert [list(e) for e in mission["plan"].log] \
        == json.loads(str(ref["plan_log"]))
    np.testing.assert_array_equal(mission["counts"], ref["counts"])
    np.testing.assert_array_equal(mission["client_state"],
                                  ref["client_state"])
    faults = [e["desc"] for e in mission["events"] if e["kind"] == "fault"]
    assert faults == json.loads(str(ref["faults"]))


def test_mission_slo_alert_schedule_equals_jax(ref, mission):
    import json
    got = [[e["tick"], e["objective"], e["state"]]
           for e in mission["events"] if e["kind"] == "slo_alert"]
    assert got == json.loads(str(ref["slo_alerts"]))
    assert [s for _, _, s in got] == ["firing", "clear"]


def test_mission_truth_equals_jax(ref, mission):
    """Truth within 1e-5 m and 1e-5 rad at every step of the mission
    (sin/cos differ by ulps, ROADMAP C)."""
    err = np.abs(mission["truth"] - ref["truth"])
    assert err[..., :2].max() <= 1e-5, np.unravel_index(
        err[..., :2].argmax(), err[..., :2].shape)
    assert err[..., 2].max() <= 1e-5


@pytest.mark.parametrize("snapshot", ["grid_closed", "grid_end"])
def test_mission_grid_equals_jax(ref, mission, snapshot):
    """At the door-closed snapshot and at the end, the grid within
    ROADMAP C's window tolerances: cells off by more than 2e-6 at most
    1e-4 of them."""
    got, want = mission[snapshot], ref[snapshot]
    off = np.abs(got - want) > 2e-6
    assert off.sum() <= 1e-4 * got.size, int(off.sum())
    assert (np.abs(want) > 0.5).sum() > 500


def test_mission_span_stream_equals_jax(ref, mission):
    """The port's span stream equals JAX's under `obs/diff.py`, volatile
    fields aside: the same publishes, ticks, fuses and HTTP handlers with
    the same trace and span ids, in the same order."""
    import json

    from jax_mapping_torch.obs.diff import diff_streams
    keys = ("name", "trace_id", "span_id", "parent_span")
    want = [dict(zip(keys, r)) for r in json.loads(str(ref["spans"]))]
    got = [dict(zip(keys, r)) for r in span_rows(mission["spans"])]
    div = diff_streams(got, want)
    assert div is None, div.describe()
    assert len(got) > 500


# ----------------------------------- JAX's mission assertions, on the port

def test_scenario_door_maps_closed_then_heals(mission):
    a = mission
    g = a["cfg"].grid
    r0, r1, c0, c1 = a["rect"]
    closed = a["grid_closed"][r0:r1, c0:c1]
    end = a["grid_end"][r0:r1, c0:c1]
    assert (closed > g.occ_threshold).sum() >= 5, \
        "closed door never got mapped"
    interior = end[2:-2]
    assert (interior > g.occ_threshold).sum() == 0, interior
    assert (interior < g.free_threshold).sum() >= interior.size // 2
    assert a["stack"].mapper.n_decay_passes > 0
    assert a["stack"].sim.n_world_updates > 0


def test_scenario_heal_propagates_to_delta_clients(mission):
    client = mission["client"]
    np.testing.assert_array_equal(client.image(0), mission["gray_end"])
    r0, r1, c0, c1 = mission["rect"]
    assert (client.image(0)[r0 + 2:r1 - 2, c0:c1] != 0).all()


def test_scenario_heal_propagates_to_frontier_pipeline(mission):
    pub, full = mission["pub"], mission["full"]
    assert pub is not None, "incremental pipeline never built"
    np.testing.assert_array_equal(pub.targets, full.targets.numpy())
    np.testing.assert_array_equal(pub.assignment, full.assignment.numpy())


def test_scenario_client_epoch_resync_across_restart(mission):
    st, client = mission["stack"], mission["client"]
    assert st.supervisor.n_restarts("jax_mapper") == 1
    assert st.mapper.restart_epoch == 1
    assert mission["pre_restart_epoch"] == 0
    assert client.epoch == 1 and client.n_epoch_resyncs == 1
    assert client.revision == st.mapper.serving_revision()


def test_scenario_restart_checkpoint_fallback_is_visible(mission):
    evs = [e for e in mission["events"] if e["kind"] == "checkpoint_fallback"]
    assert evs, "restart resumed without recording its slot"
    assert evs[-1]["slot"] == "primary" and not evs[-1]["fell_back"]
    (ep,) = [e for e in mission["events"] if e["kind"] == "restart_epoch"]
    assert ep["epoch"] == 1 and ep["resumed_from_checkpoint"]
    assert 'jax_mapping_checkpoint_fallback_total{slot="primary"}' \
        in mission["metrics"]


def test_scenario_plan_log_is_the_script(mission):
    descs = [d for _, d in mission["plan"].log]
    assert descs == ["door_close door0", "clear: door_close door0",
                     "crowd 0 r=0.25m", "clear: crowd 0",
                     "kill_node jax_mapper"]
    assert mission["plan"].done()


def test_scenario_checkpoint_files_are_generations_only(mission):
    names = sorted(os.listdir(mission["ckpt_dir"]))
    assert "auto_checkpoint.npz" in names and "postmortem" in names


def test_mission_warming_window_equals_jax(ref, mission):
    """The staged restart's warming window answered the same in both
    packages: states, the prior epoch and its tile count."""
    import json
    assert json.loads(mission["warm_probe"]) == \
        json.loads(str(ref["warm_probe"]))


def test_scenario_degraded_serving_window_reports_warming(mission):
    """DURING the staged restart's warming stage, /status and /tiles keep
    answering — from the prior epoch — and stamp `state=warming` instead
    of blocking. The probe ran inside the warmup_hook, after the old node
    was destroyed and before the new one was bound."""
    import json
    probe = json.loads(mission["warm_probe"])
    assert probe, "warmup_hook never fired — staged restart regressed"
    assert probe["warmup_state"] == "warming"
    assert probe["status_state"] == "warming"
    assert probe["tiles_state"] == "warming"
    # Prior-epoch content: the window serves the PRE-restart epoch (0)
    # with real tiles; after the mission the stack serves epoch 1.
    assert probe["old_epoch"] == 0
    assert probe["tiles_epoch"] == 0
    assert probe["n_tiles"] > 0, "warming window served no content"
    st = mission["stack"]
    post = json.loads(st.api.handle("/tiles?since=-1")[2])
    assert post["epoch"] == 1 and "state" not in post
    post_status = json.loads(st.api.handle("/status")[2])
    assert "state" not in post_status
    assert st.warmup is not None and st.warmup.state() == "ready"


def test_scenario_staged_warmup_recorded_and_clean(mission):
    """The staged restart walked restore -> warming -> ready on the flight
    recorder, and the in-process warm-up reported no errors (this process
    dispatched every signature: everything skips as in_process)."""
    kinds = [e["kind"] for e in mission["events"]]
    assert "warmup_stage" in kinds and "warmup_ready" in kinds
    stages = [(e["old"], e["new"]) for e in mission["events"]
              if e["kind"] == "warmup_stage"]
    assert stages == [("idle", "restoring"), ("restoring", "warming"),
                      ("warming", "ready")]
    snap = mission["stack"].warmup.snapshot()
    assert snap["state"] == "ready"
    rep = snap["report"]
    assert rep["n_errors"] == 0 and rep["n_in_process"] == rep["n_warmed"]
    assert rep["n_in_process"] >= 4 and rep["launches"] == {}


# ------------------------------------- JAX's devprof mission tests, on the port

def test_devprof_live_dispatch_attribution(mission):
    """The dispatch profiler attributed wall time and call counts to the
    real entry points, and `/status.perf` + the `/metrics` device families
    expose them (memory absent on the CPU)."""
    import json
    import re
    st = mission["stack"]
    assert st.devprof is not None and st.devprof.installed
    snap = st.devprof.snapshot()
    assert len(snap) >= 4, sorted(snap)
    for fn in ("jax_mapping_torch.sim.lidar.simulate_scans",
               "jax_mapping_torch.bridge.brain.brain_tick"):
        assert snap[fn]["count"] > 10, (fn, snap.get(fn))
        assert snap[fn]["total_ms"] > 0
    status = json.loads(st.api.handle("/status")[2])
    perf = status["perf"]
    assert perf["dispatch"] and perf["recompiles"] is not None
    assert perf["memory"] is None                # CPU: graceful None
    assert isinstance(perf["cost_ledger_uncollected"], int)
    assert perf["cost_ledger_uncollected"] > 0 and perf["cost_ledger"] == {}
    text = st.api.handle("/metrics")[2].decode()
    assert "# TYPE jax_mapping_device_dispatch_total counter" in text
    assert ("# TYPE jax_mapping_device_dispatch_seconds histogram"
            in text)
    assert "# TYPE jax_mapping_jit_recompiles_total counter" in text
    assert re.search(
        r'jax_mapping_device_dispatch_seconds_bucket\{fn="jax_mapping_'
        r'torch\.[A-Za-z_.]+",le="0.00025"\} \d+', text)
    assert "jax_mapping_device_memory_bytes" not in text  # CPU


def test_devprof_live_recompile_guard(mission):
    """After the mission's warm-up, continued stepping of the live stack
    mints ZERO new variants in any profiled entry point; the budgeted
    entry points the mission dispatched all carry recompile telemetry."""
    from jax_mapping_torch.analysis.compilebudget import (
        Budget, default_budget_path)
    st = mission["stack"]
    before = st.devprof.recompiles()
    st.run_steps(4)
    after = st.devprof.recompiles()
    grew = {fn: (before.get(fn, 0), n) for fn, n in after.items()
            if n > before.get(fn, 0)}
    assert not grew, (
        f"steady-state stepping recompiled: {grew} — runtime shape "
        "churn")
    budget = Budget.load(default_budget_path())
    dispatched = set(st.devprof.snapshot())
    covered = [e["name"] for e in budget.entries
               if e["name"] in dispatched]
    assert covered, "mission dispatched no budget-listed functions?"
    for name in covered:
        assert name in after


def test_devprof_mission_metrics_include_stage_fold(mission):
    """The folded hot stages report from the live mission: frontier
    recomputes ran, so the `frontier.recompute` stage histogram is in the
    exposition (and the retired hand-built gauge is not)."""
    text = mission["metrics"]
    assert "jax_mapping_stage_frontier_recompute_seconds_count" in text
    assert "jax_mapping_frontier_recompute_ms " not in text




# ------------------------------ JAX's obs-tier mission tests, on the port

def test_obs_trace_propagation_reaches_sim_publish(mission):
    """Every fused scan's span chain reaches back to its sim publish."""
    spans = mission["spans"]
    by_id = {s["span_id"]: s for s in spans}
    fuses = [s for s in spans if s["name"] == "mapper.fuse"]
    assert len(fuses) > 10
    for f in fuses:
        hops, cur = 0, f
        while cur["parent_span"] != 0:
            cur = by_id[cur["parent_span"]]
            hops += 1
            assert hops < 16
        assert cur["name"].startswith("publish:") \
            and cur["name"].endswith("scan"), cur["name"]
        assert cur["trace_id"] == f["trace_id"]
    names = {s["name"] for s in spans}
    assert {"mapper.tick", "brain.tick", "http:/tiles"} <= names


def test_obs_recorder_covers_mission_transitions(mission):
    events = mission["events"]
    kinds = {e["kind"] for e in events}
    assert {"fault", "map_revision", "decay_pass", "supervisor_dead",
            "supervisor_restart", "restart_epoch", "checkpoint_save",
            "postmortem_dump", "slo_alert"} <= kinds, kinds
    segments, cur = [], []
    for e in events:
        if e["kind"] == "restart_epoch":
            segments.append(cur)
            cur = []
        elif e["kind"] == "map_revision":
            cur.append(e["revision"])
    segments.append(cur)
    assert len(segments) == 2
    for seg in segments:
        assert seg and all(a < b for a, b in zip(seg, seg[1:])), seg
    assert segments[1][0] <= segments[0][-1]


def test_obs_postmortem_dump_artifact(mission):
    """The supervisor restart dumped to `<ckpt>/postmortem/` with spans
    and the ledger's records; the dump feeds the exporter and the CLI."""
    import glob
    import json

    from jax_mapping_torch.obs import dump_to_chrome
    from jax_mapping_torch.obs.__main__ import main
    dumps = sorted(glob.glob(os.path.join(mission["ckpt_dir"], "postmortem",
                                          "flight_*.json")))
    assert dumps
    doc = json.load(open(dumps[0]))
    assert doc["reason"].startswith("supervisor_restart")
    assert "supervisor_dead" in {e["kind"] for e in doc["events"]}
    assert doc["spans"] and "pipeline" in doc
    chrome = dump_to_chrome(doc)
    assert len(chrome["traceEvents"]) == len(doc["spans"]) \
        + len(doc["events"])
    assert main(["diff", dumps[0], dumps[0]]) == 0
    assert main(["critical-path", dumps[-1]]) in (0, 2)


def test_obs_trace_endpoint_serves_the_mission(mission):
    import json
    status, ctype, body, headers = mission["trace"]
    assert status == 200 and ctype == "application/json"
    doc = json.loads(body)
    assert doc["next"] > 0
    names = {e["name"] for e in doc["traceEvents"]}
    assert "mapper.tick" in names
    assert any(n.startswith("publish:/") for n in names)
    for e in doc["traceEvents"][:50]:
        assert e["ph"] == "X"
        int(e["args"]["trace_id"], 16)
    # The poller is not traced: at the same ring head the ETag answers
    # 304.
    st = mission["stack"]
    first = st.api.handle("/trace?since=0")
    again = st.api.handle("/trace?since=0", headers={
        "If-None-Match": first[3]["ETag"]})
    assert again[0] == 304
    assert st.api.handle("/trace?since=x")[0] == 400


def test_slo_mission_fires_exactly_one_deterministic_alert(mission):
    evs = [e for e in mission["events"] if e["kind"] == "slo_alert"]
    fires = [e for e in evs if e["state"] == "firing"]
    clears = [e for e in evs if e["state"] == "clear"]
    assert len(fires) == 1 and len(clears) == 1, evs
    assert fires[0]["objective"] == "staleness"
    assert fires[0]["tick"] < KILL_AT
    st = mission["stack"]
    assert st.slo.firing() == []
    assert [(a[1], a[2]) for a in st.slo.alerts()] == [
        ("staleness", "firing"), ("staleness", "clear")]


def test_slo_mission_status_and_metrics_surface(mission):
    slo = mission["slo_status"]
    (obj,) = slo["objectives"]
    assert obj["name"] == "staleness"
    assert obj["metric"] == "tile_staleness_revs"
    assert obj["n_fired"] == 1 and obj["n_cleared"] == 1
    assert obj["breach_ticks"] > 0 and slo["alerts"]
    text = mission["metrics"]
    assert 'jax_mapping_slo_firing{objective="staleness"}' in text
    assert 'jax_mapping_slo_alerts_fired_total{objective="staleness"} 1' \
        in text
    assert "jax_mapping_pipeline_hop_seconds_bucket" in text
    assert 'hop="fuse"' in text and 'hop="deliver"' in text
    assert "jax_mapping_scan_to_served_seconds_bucket" in text
    assert "jax_mapping_obs_trace_spans_total" in text


def test_pipeline_mission_ledger_completed_scan_to_served(mission):
    import json
    st = mission["stack"]
    recs = st.pipeline.records()
    assert recs
    with_scan = [r for r in recs if "fuse" in r["hops_ms"]]
    assert with_scan
    for r in with_scan[:5]:
        assert set(r["hops_ms"]) <= {"fuse", "notify", "encode", "deliver"}
        assert r["critical"] in r["hops_ms"]
    status = json.loads(st.api.handle("/status")[2])["pipeline"]
    assert status["completed_revisions"] >= len(recs)
    assert "scan_to_served_p99_ms" in status


def test_pipeline_mission_server_timing_header(mission):
    from jax_mapping_torch.serving.client import parse_revision_age_ms
    probe = mission["tiles_probe"]
    assert probe[0] == 200
    age = parse_revision_age_ms(probe[3]["Server-Timing"])
    assert age is not None and age >= 0.0


def test_obs_disabled_constructs_no_freshness_tier(mission):
    from jax_mapping_torch.bridge.bus import Bus
    from jax_mapping_torch.bridge.mapper import MapperNode
    cfg = tiny_config().replace(obs=ObsConfig(
        enabled=False, slo=(SloObjective(name="x", metric="tick_deadline_ms",
                                         threshold=1.0),)))
    m = MapperNode(cfg, Bus(), n_robots=1, device="cpu")
    assert m._pipeline is None and m._slo is None and m._tracer is None
    m.destroy()
    st = mission["stack"]
    assert st.pipeline is not None and st.slo is not None
    assert st.mapper._pipeline is st.pipeline
    assert st.api.pipeline is st.pipeline and st.api.slo is st.slo
    assert st.bus.tracer is st.tracer


# ------------------------------------------------------ lifelong missions

def test_run_lifelong_mission_reports_the_mission(tmp_path):
    """`run_lifelong_mission` on the CPU: a day_plan of door cycles, a
    crowd and a mapper kill; the report carries the scripted plan log, the
    world updates, the restart from the checkpoint, the postmortem dump,
    the SLO alerts from the flight recorder and the distance series; a
    windowless stack's series has no world footprint."""
    from jax_mapping_torch.scenarios import MissionReport, day_plan
    from jax_mapping_torch.scenarios.lifelong import run_lifelong_mission
    cfg = mission_config(tiny_config, DecayConfig, ObsConfig, SloObjective)
    cfg = cfg.replace(obs=ObsConfig(enabled=True, slo=(SloObjective(
        name="staleness", metric="tile_staleness_revs", threshold=5.0,
        fast_window_ticks=4, slow_window_ticks=8),)))
    world, doors = W.arena_with_door(96, cfg.grid.resolution_m)
    events = day_plan(40, ["door0"], n_crowds=1, door_cycle=20,
                      crowd_cycle=30, kill_steps=(22,), start=2)
    rep = run_lifelong_mission(cfg, world, doors, events, 40, seed=0,
                               checkpoint_dir=str(tmp_path), n_robots=2,
                               sample_every=10, device="cpu")
    assert isinstance(rep, MissionReport)
    assert [d for _, d in rep.plan_log] == [
        "door_close door0", "clear: door_close door0", "crowd 0 r=0.25m",
        "door_close door0", "kill_node jax_mapper", "clear: crowd 0",
        "clear: door_close door0"]
    assert rep.n_mapper_restarts == 1 and rep.restart_epoch == 1
    assert rep.n_world_updates >= 10 + 2
    assert any(p.startswith("flight_") and "supervisor_restart" in p
               for p in rep.postmortem_dumps), rep.postmortem_dumps
    assert rep.slo_alerts and rep.slo_alerts[0][1:] == ("staleness",
                                                        "firing")
    assert [s["step"] for s in rep.world_series] == [10, 20, 30, 40]
    assert "device_window_bytes" not in rep.world_series[0]
    assert rep.peak_device_window_bytes() == 0
    assert rep.distance_traveled_m > 0.0
    assert "auto_checkpoint.npz" in rep.checkpoint_files
    assert rep.grid.shape == (cfg.grid.size_cells,) * 2
    assert rep.known_cells() > 500


def test_obs_metrics_registry_preserves_historical_document(mission):
    """JAX's registry acceptance on the port's live exposition: every
    historical family present, in the historical order, with its type,
    and the obs tier's families after the historical tail."""
    import re

    from tests.test_scenarios import HISTORICAL_METRIC_FAMILIES
    text = mission["metrics"]
    types = []
    for line in text.strip().split("\n"):
        if line.startswith("# TYPE "):
            name, mtype = line[len("# TYPE "):].rsplit(" ", 1)
            types.append((name, mtype))
    assert len(types) == len({n for n, _ in types}), "duplicate family"
    head = [(n, t) for n, t in types
            if not n.startswith(("jax_mapping_stage_",
                                 "jax_mapping_bus_subscription_",
                                 "jax_mapping_obs_"))
            and (n, t) in HISTORICAL_METRIC_FAMILIES]
    assert head == [f for f in HISTORICAL_METRIC_FAMILIES if f in head]
    assert set(HISTORICAL_METRIC_FAMILIES) <= set(types), \
        sorted(set(HISTORICAL_METRIC_FAMILIES) - set(types))
    first_new = min(i for i, (n, _) in enumerate(types)
                    if n.startswith(("jax_mapping_bus_subscription_",
                                     "jax_mapping_obs_"))
                    or n.endswith("_seconds")
                    and n.startswith("jax_mapping_stage_"))
    last_hist = max(i for i, f in enumerate(types)
                    if f in HISTORICAL_METRIC_FAMILIES)
    assert last_hist < first_new
    assert re.search(r'jax_mapping_bus_subscription_dropped_total'
                     r'\{topic="robot0/scan"\} \d+', text)
    assert "jax_mapping_obs_recorder_events_total" in text
    assert "jax_mapping_obs_trace_spans_total" in text
