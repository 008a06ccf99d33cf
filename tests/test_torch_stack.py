"""The simulated mission stack of the port against the JAX package's.

One JAX reference run (a fresh `JAX_PLATFORMS=cpu` subprocess,
`tests/torch_jaxref.py`) launches the JAX `launch_sim_stack` at tiny_config(2)
with `speed_noise_frac=0` on plank_course(96, 0.05, n_planks=4, seed=3),
explores for 30 steps, then runs three 5-scan bursts with no mapper tick
inside them (robot 1's scans all ghost returns in the second, which the
mapper's agreement gate rejects; robot 0's in the third, which the watchdog
quarantines until the relocalizer re-admits the robot) and 8 more steps. It
records every `/scan` and `/odom` message in delivery order with the mapper
ticks between them, the mapper's poses after each tick, every `/frontiers`
assignment, the truth poses, the final shared grid and graph sizes, and
`brain_tick` on numpy-seeded inputs.

The port's `MapperNode`, on the CPU, is fed the same messages in the same
order (teacher-forced) and held to the reference: poses to 1e-3 m at every
tick, the grid within the window tolerances of ROADMAP C (cells off by more
than 2e-6: at most 1e-4 of them), graph sizes, the window, rejection and
quarantine counts, and every frontier assignment exactly. The port's whole
stack, from the reference's spawn state, must put the robots where the JAX
stack put them after 30 steps (1e-5 m and 1e-5 rad: sin/cos differ by ulps,
ROADMAP C). Two same-seed runs of the port's stack are bit-equal but for the
mapper's estimates (1e-6 m, ROADMAP C); the demo runs and refuses what is not
ported.
"""

import dataclasses
import os
import subprocess
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from jax_mapping_torch import interop
from jax_mapping_torch.bridge import brain as B
from jax_mapping_torch.bridge.bus import Bus
from jax_mapping_torch.bridge.launch import launch_sim_stack
from jax_mapping_torch.bridge.mapper import MapperNode
from jax_mapping_torch.bridge.messages import (Header, LaserScan, Odometry,
                                               Pose2D, Twist)
from jax_mapping_torch.config import tiny_config
from jax_mapping_torch.recovery import RecoveryManager
from jax_mapping_torch.resilience.health import FleetHealth
from jax_mapping_torch.sim import world as W
from tests.torch_jaxref import REPO, run_reference
from tests.torch_threads import one_intra_op_thread  # noqa: F401

EXPLORE_STEPS = 30
BURST = 5
BRAIN_SEEDS = (0, 1, 2, 3)
BRAIN_R = 8

#: Shared by the reference script and the port's side.
SETUP = '''
def stack_config(tiny_config):
    import dataclasses
    cfg = tiny_config(2)
    return cfg.replace(robot=dataclasses.replace(cfg.robot,
                                                 speed_noise_frac=0.0))


def brain_inputs(seed, R, n_beams):
    rng = np.random.default_rng(seed)
    poses = np.concatenate([rng.uniform(-2, 2, (R, 2)),
                            rng.uniform(-3.1, 3.1, (R, 1))], 1)
    speeds = rng.integers(-300, 300, (R, 2))
    wheel_raw = np.where(speeds < 0, speeds + 65536, speeds)
    prox = rng.integers(0, 2500, (R, 7)) * (rng.random((R, 7)) < 0.3)
    ranges = rng.uniform(0.05, 3.0, (R, n_beams)) * \\
        (rng.random((R, n_beams)) < 0.9)
    exploring = rng.random(R) < 0.8
    goals = rng.uniform(-3, 3, (R, 2))
    goal_valid = rng.random(R) < 0.6
    return (poses.astype(np.float32), wheel_raw.astype(np.int32),
            prox.astype(np.int32), ranges.astype(np.float32), exploring,
            goals.astype(np.float32), goal_valid)
'''
exec(SETUP)

REFERENCE = '''
import os
# One XLA thread: the suite's parallel workers share the cores.
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_cpu_multi_thread_eigen=false")
''' + SETUP + f'''
from jax_mapping.bridge.brain import brain_tick
from jax_mapping.bridge.launch import launch_sim_stack
from jax_mapping.bridge.qos import qos_sensor_data
from jax_mapping.config import tiny_config
from jax_mapping.sim import world as W

cfg = stack_config(tiny_config)
for seed in {BRAIN_SEEDS!r}:
    out = brain_tick(cfg, *brain_inputs(seed, {BRAIN_R}, cfg.scan.n_beams),
                     np.float32(1.0 / cfg.robot.control_rate_hz))
    for name, v in zip(("poses", "twists", "targets", "leds", "state"),
                       out):
        OUT[f"brain{{seed}}_{{name}}"] = np.asarray(v)

world = W.plank_course(96, cfg.grid.resolution_m, n_planks=4, seed=3)
st = launch_sim_stack(cfg, world, n_robots=2, seed=0)
OUT["init_truth"] = st.sim.truth_poses().copy()
OUT["init_wheels"] = np.asarray(st.sim.sim_state.wheel_speeds)
OUT["init_mapper_poses"] = np.stack([np.asarray(s.pose)
                                     for s in st.mapper.states])
events, scans, odoms, fronts, poses_after = [], [], [], [], []


def on_msg(kind, store, i, m):
    events.append((kind, i, len(store)))
    store.append(m)


for i in range(2):
    st.bus.subscribe(f"robot{{i}}/scan", qos_sensor_data,
                     callback=lambda m, i=i: on_msg(0, scans, i, m))
    st.bus.subscribe(f"robot{{i}}/odom",
                     callback=lambda m, i=i: on_msg(1, odoms, i, m))
st.bus.subscribe("/frontiers",
                 callback=lambda m: fronts.append(np.asarray(m.assignment)))
mapper_tick = st.mapper.tick


def tick():
    events.append((2, -1, -1))
    mapper_tick()
    poses_after.append(np.stack([np.asarray(s.pose)
                                 for s in st.mapper.states]))


st.mapper.tick = tick
st.brain.start_exploring()
truth = []
for _ in range({EXPLORE_STEPS}):
    st.run_steps(1)
    truth.append(st.sim.truth_poses().copy())


def burst():
    for _ in range({BURST}):
        st.sim.step()
        st.brain.update_loop()
    st.mapper.tick()


burst()
for robot in (1, 0):
    st.sim.set_ghost_returns(robot, 1.0)
    burst()
    st.sim.set_ghost_returns(robot, 0.0)
st.run_steps(8)
m = st.mapper
snap = m.snapshot_states()
OUT["grid"] = np.asarray(snap[0].grid)
OUT["truth"] = np.stack(truth)
OUT["mapper_poses"] = np.stack(poses_after)
OUT["fronts"] = np.stack(fronts)
OUT["n_poses"] = np.array([int(s.graph.n_poses) for s in snap])
OUT["n_keyscans"] = np.array([int(s.n_keyscans) for s in snap])
OUT["counts"] = np.array([m.n_scans_fused, m.n_windows_fused,
                          m.n_windows_rejected_low_agreement,
                          m.n_scans_quarantined, m.n_loops_closed,
                          m.n_relocalizations, m.map_revision])
OUT["events"] = np.array(events, np.int64)
OUT["scan_stamp"] = np.array([s.header.stamp for s in scans])
OUT["scan_ranges"] = np.stack([np.asarray(s.ranges, np.float32)
                               for s in scans])
OUT["odom_stamp"] = np.array([o.header.stamp for o in odoms])
OUT["odom_pose"] = np.array([[o.pose.x, o.pose.y, o.pose.theta]
                             for o in odoms])
OUT["odom_twist"] = np.array([[o.twist.linear_x, o.twist.angular_z]
                              for o in odoms])
'''


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(REFERENCE,
                         tmp_path_factory.mktemp("stack") / "ref.npz")


def _counts(m) -> list:
    return [m.n_scans_fused, m.n_windows_fused,
            m.n_windows_rejected_low_agreement, m.n_scans_quarantined,
            m.n_loops_closed, m.n_relocalizations, m.map_revision]


@pytest.fixture(scope="module")
def replay(ref):
    return teacher_forced(ref)


def teacher_forced(ref) -> SimpleNamespace:
    """The port's MapperNode fed the reference's messages."""
    cfg = stack_config(tiny_config)
    bus = Bus()
    m = MapperNode(cfg, bus, n_robots=2,
                   health=FleetHealth(cfg.resilience, 2),
                   recovery=RecoveryManager(cfg.recovery, 2, robot=cfg.robot),
                   device="cpu")
    for i, s in enumerate(m.states):
        m.states[i] = s._replace(
            pose=torch.as_tensor(ref["init_mapper_poses"][i]))
    fronts, poses = [], []
    bus.subscribe("/frontiers",
                  callback=lambda f: fronts.append(np.asarray(f.assignment)))
    pubs, sc = {}, cfg.scan
    # Feed the health registry as the brain does: scans at the control
    # tick they arrive in, the tick clock before the brain's odometry.
    brain_tick_no = [0]
    for i in range(2):
        bus.subscribe(f"robot{i}/scan", callback=lambda _m, i=i:
                      m._health.note_scan(i, brain_tick_no[0]))
    bus.subscribe("robot0/odom", callback=lambda _m:
                  m._health.note_tick(brain_tick_no[0]))
    bus.subscribe("robot1/odom", callback=lambda _m:
                  brain_tick_no.__setitem__(0, brain_tick_no[0] + 1))

    def publish(topic, msg):
        pubs.setdefault(topic, bus.publisher(topic)).publish(msg)

    for kind, i, j in ref["events"]:
        if kind == 0:
            publish(f"robot{i}/scan", LaserScan(
                header=Header(stamp=float(ref["scan_stamp"][j]),
                              frame_id=f"robot{i}/base_laser"),
                angle_min=sc.angle_min_rad,
                angle_increment=sc.angle_increment_rad,
                range_min=sc.range_min_m, range_max=sc.range_max_m,
                ranges=ref["scan_ranges"][j].copy()))
        elif kind == 1:
            p, tw = ref["odom_pose"][j], ref["odom_twist"][j]
            publish(f"robot{i}/odom", Odometry(
                header=Header(stamp=float(ref["odom_stamp"][j]),
                              frame_id=f"robot{i}/odom"),
                child_frame_id=f"robot{i}/base_link",
                pose=Pose2D(*(float(v) for v in p)),
                twist=Twist(linear_x=float(tw[0]), angular_z=float(tw[1]))))
        else:
            m.tick()
            poses.append(np.stack([s.pose.numpy() for s in m.states]))
    return SimpleNamespace(mapper=m, fronts=np.stack(fronts),
                           poses=np.stack(poses))


def test_teacher_forced_poses_every_tick(ref, replay):
    want = ref["mapper_poses"]
    assert replay.poses.shape == want.shape
    err = np.abs(replay.poses[..., :2] - want[..., :2]).max()
    assert err <= 1e-3, err
    assert np.abs(replay.poses[..., 2] - want[..., 2]).max() <= 1e-3


def test_teacher_forced_grid(ref, replay):
    got = replay.mapper.shared_grid.numpy()
    off = np.abs(got - ref["grid"]) > 2e-6
    assert off.sum() <= 1e-4 * got.size, int(off.sum())
    assert (np.abs(got) > 0).sum() > 1000


def test_teacher_forced_graph_sizes(ref, replay):
    snap = replay.mapper.snapshot_states()
    assert [int(s.graph.n_poses) for s in snap] == list(ref["n_poses"])
    assert [int(s.n_keyscans) for s in snap] == list(ref["n_keyscans"])


def test_teacher_forced_frontier_assignment(ref, replay):
    np.testing.assert_array_equal(replay.fronts, ref["fronts"])
    assert (ref["fronts"] >= 0).sum() > len(ref["fronts"])


def test_teacher_forced_window_and_agreement_gate(ref, replay):
    """The bursts went through `_step_window`, robot 1's ghost burst was
    rejected by the agreement gate, robot 0's was quarantined and the
    robot relocalized, and every counter (scans fused, windows,
    rejections, quarantined scans, closures, relocalizations, map
    revision) is the reference's."""
    counts = _counts(replay.mapper)
    assert counts == list(ref["counts"])
    assert counts[1] >= 2 and counts[2] >= 1
    assert counts[3] >= 5 and counts[5] >= 1


@pytest.mark.parametrize("seed", BRAIN_SEEDS)
def test_brain_tick_matches_jax(ref, seed):
    """brain_tick on seeded inputs: poses and twists to 1e-6 (sin/cos
    ulps, ROADMAP C), wheel targets, LEDs and navigation states exact."""
    cfg = stack_config(tiny_config)
    args = [torch.as_tensor(a) for a in
            brain_inputs(seed, BRAIN_R, cfg.scan.n_beams)]
    out = B.brain_tick(cfg, *args, float(np.float32(0.1)))
    names = ("poses", "twists", "targets", "leds", "state")
    got = dict(zip(names, (o.numpy() for o in out)))
    want = {n: ref[f"brain{seed}_{n}"] for n in names}
    np.testing.assert_allclose(got["poses"], want["poses"], atol=1e-6)
    np.testing.assert_allclose(got["twists"], want["twists"], atol=1e-6,
                               rtol=1e-6)
    for n in ("targets", "leds", "state"):
        np.testing.assert_array_equal(got[n], want[n])
    assert len(np.unique(want["state"])) >= 3


def _stack(cfg, steps: int, spawn=None):
    world = W.plank_course(96, cfg.grid.resolution_m, n_planks=4, seed=3)
    st = launch_sim_stack(cfg, world, n_robots=2, seed=0, device="cpu")
    if spawn is not None:
        # The JAX stack's spawn (its PRNG draws cannot be reproduced).
        st.sim.sim_state = interop.fleet_sim_state_from_numpy(spawn, "cpu")
        st.brain.poses = st.sim.truth_poses().copy()
        for i, s in enumerate(st.mapper.states):
            st.mapper.states[i] = s._replace(
                pose=torch.as_tensor(st.brain.poses[i]))
    p0 = st.sim.truth_poses().copy()
    st.brain.start_exploring()
    st.run_steps(steps)
    return st, p0


@pytest.fixture(scope="module")
def twin_runs():
    cfg = stack_config(tiny_config)
    return [_stack(cfg, EXPLORE_STEPS) for _ in range(2)]


def test_stack_same_seed_runs_bit_equal(twin_runs):
    """Truth, odometry, map, key scans and counters are bit-equal. The
    mapper's estimates are held to 1e-6 m (ROADMAP C): the mapper turns
    each odometry pair into wheel speeds over the pair's wall-clock stamp
    interval (`MapperNode._odom_motion`, as in the JAX package), so their
    last bit follows the host's timing."""
    (a, _), (b, _) = twin_runs
    np.testing.assert_array_equal(a.sim.truth_poses(), b.sim.truth_poses())
    np.testing.assert_array_equal(a.brain.poses, b.brain.poses)
    assert torch.equal(a.mapper.shared_grid, b.mapper.shared_grid)
    for sa, sb in zip(a.mapper.states, b.mapper.states):
        assert torch.equal(sa.n_keyscans, sb.n_keyscans)
        assert float((sa.pose - sb.pose).abs().max()) <= 1e-6
    assert _counts(a.mapper) == _counts(b.mapper)


def test_stack_robots_move_and_map(twin_runs):
    st, p0 = twin_runs[0]
    p1 = st.sim.truth_poses()
    assert np.linalg.norm(p1[:, :2] - p0[:, :2], axis=1).min() > 0.02
    lo = st.mapper.merged_grid()
    g = st.cfg.grid
    assert int((lo >= g.occ_threshold).sum()) > 20
    assert int((lo <= g.free_threshold).sum()) > 200
    assert st.planner.n_frontier_plans > 0
    # Dead reckoning without wheel noise stays on the truth.
    assert np.abs(st.brain.poses - p1).max() < 0.05


def test_stack_tf_chain_complete(twin_runs):
    """map->odom->base_link->base_laser resolves for every robot."""
    st, _ = twin_runs[0]
    for i in range(2):
        tfm = st.tf.lookup("map", f"robot{i}/base_laser")
        assert abs(tfm.z - 0.12) < 1e-9


def test_stack_truth_matches_jax_stack(ref):
    """From the JAX stack's spawn, the port's stack drives the robots
    where the JAX stack drove them, step by step for 30 steps."""
    cfg = stack_config(tiny_config)
    st, _ = _stack(cfg, 0, spawn=SimpleNamespace(
        poses=ref["init_truth"], wheel_speeds=ref["init_wheels"]))
    for k in range(EXPLORE_STEPS):
        st.run_steps(1)
        err = np.abs(st.sim.truth_poses() - ref["truth"][k]).max()
        assert err <= 1e-5, (k, err)


def test_demo_runs_and_writes_png(tmp_path):
    from jax_mapping_torch import demo
    from jax_mapping_torch.bridge import png
    out = tmp_path / "m.png"
    assert demo.main(["--device", "cpu", "--steps", "10", "--robots", "2",
                      "--out", str(out)]) == 0
    img = png.decode_gray(out.read_bytes())
    assert img.shape == (256, 256)
    assert set(np.unique(img)) <= {0, 127, 255} and (img == 255).any()


#: (flags, exit code, what the demo says): --resume and --save-final
#: refuse, as the JAX demo does, a checkpoint that is not there. --depth-cam is
#: ported (it runs and reports its images), and --voxel-out without it
#: is refused as the JAX demo refuses it. --record, --replay and
#: --map-prior are ported: the demo refuses --replay beside a flag of a
#: simulated run, and a --map-prior it cannot read, as the JAX demo does
#: (tests/test_torch_io.py drives them). --serve and --http-port are
#: ported: --http-port serves while the stack steps and puts the URL in the
#: summary, and --serve is refused beside --replay as the JAX demo refuses
#: it (tests/test_torch_http_api.py drives the API).
DEMO_REFUSED = [(["--record", "b", "--replay", "b"], 2,
                 "--replay cannot be combined with --record"),
                (["--replay", "b", "--save-final", "c"], 2,
                 "--replay cannot be combined with --save-final"),
                (["--resume", "c"], 2, "no checkpoint at c"),
                (["--save-final", "c", "--resume", "missing.npz"], 2,
                 "no checkpoint at missing.npz"),
                (["--map-prior", "m.yaml"], 2,
                 "cannot seed --map-prior m.yaml"),
                (["--serve", "--replay", "b"], 2,
                 "--replay cannot be combined with --serve"),
                (["--http-port", "0"], 0, '"http": "http://127.0.0.1:'),
                (["--depth-cam"], 0, '"depth_images_fused": 1'),
                (["--voxel-out", "v.png"], 2, "requires --depth-cam")]


@pytest.mark.parametrize("flag,rc,says", DEMO_REFUSED,
                         ids=[f[0] for f, _, _ in DEMO_REFUSED])
def test_demo_refuses_unported_flags(flag, rc, says, capsys):
    from jax_mapping_torch import demo
    assert demo.main(["--device", "cpu", "--steps", "1"] + flag) == rc
    out = capsys.readouterr()
    assert says in (out.err if rc else out.out)


LAUNCH_REFUSED = {
    "http_port": dict(http_port=0),
    "depth_cam": dict(depth_cam=True),
    "world.windowed": dict(cfg="world", windowed=True),
    "obs.enabled": dict(cfg="obs", enabled=True),
    "obs.devprof.enabled": dict(cfg="devprof"),
    "cold_start.enabled": dict(cfg="cold_start", enabled=True),
    "tenancy.enabled": dict(cfg="tenancy", enabled=True),
}


@pytest.mark.parametrize("what", list(LAUNCH_REFUSED))
def test_launch_refuses_unported(what):
    """Each unported option raises, naming its ROADMAP item; depth_cam,
    ported since, launches the voxel mapper and wires the planner's
    overlay into the mapper's frontier basis; http_port, ported since,
    serves the HTTP API on a free port until the stack shuts down;
    obs.enabled, ported since, launches with the tracer on the bus and
    the pipeline ledger in the mapper (the SLO engine only with declared
    objectives); obs.devprof.enabled, ported since, launches with the
    dispatch profiler installed over the entry points, exported on
    /status.perf, and uninstalled at shutdown; cold_start.enabled, ported
    since, launches with the build cache under <checkpoint_dir>/
    compile_cache and a launch-time warm-up on /status.cold_start, and
    shutdown points the builds back at the package's default;
    tenancy.enabled, ported since, launches the tenancy control plane
    (its checkpoints under <checkpoint_dir>/tenants) on /status.tenancy
    and /tiles?tenant=, and crash_controlplane rebuilds it."""
    cfg = tiny_config(2)
    if what == "obs.devprof.enabled":
        import json

        from jax_mapping_torch.models import slam as S
        from jax_mapping_torch.obs import devprof as DP
        cfg = cfg.replace(obs=dataclasses.replace(
            cfg.obs, devprof=dataclasses.replace(cfg.obs.devprof,
                                                 enabled=True)))
        st = launch_sim_stack(cfg, W.empty_arena(32, 0.05), n_robots=2,
                              device="cpu", http_port=0)
        try:
            assert st.devprof is not None and st.devprof.installed
            assert isinstance(vars(S)["slam_step"], DP._ProfiledFn)
            st.run_steps(2)
            assert st.devprof.snapshot()[
                "jax_mapping_torch.sim.lidar.simulate_scans"]["count"] == 2
            perf = json.loads(st.api.handle("/status")[2])["perf"]
            assert perf["memory"] is None and perf["dispatch"]
        finally:
            st.shutdown()
        assert not st.devprof.installed
        assert not isinstance(vars(S)["slam_step"], DP._ProfiledFn)
        return
    if what == "cold_start.enabled":
        import json
        import tempfile

        from jax_mapping_torch.ops import _cuda
        cfg = cfg.replace(cold_start=dataclasses.replace(
            cfg.cold_start, enabled=True))
        with tempfile.TemporaryDirectory() as td:
            st = launch_sim_stack(cfg, W.empty_arena(32, 0.05),
                                  n_robots=2, device="cpu", http_port=0,
                                  checkpoint_dir=td)
            try:
                root = os.path.join(td, "compile_cache")
                assert st.compile_cache.root == root
                assert st.compile_cache.enabled
                assert _cuda.BUILD_DIR == _cuda.Path(root, "cuda")
                assert st.warmup.state() == "ready"
                cs = json.loads(st.api.handle("/status")[2])["cold_start"]
                assert cs["cache"]["fingerprint"] and \
                    cs["warmup"]["state"] == "ready"
                st.run_steps(2)
            finally:
                st.shutdown()
            assert _cuda.BUILD_DIR == _cuda.DEFAULT_BUILD_DIR
        return
    if what == "tenancy.enabled":
        import json
        import tempfile
        cfg = cfg.replace(tenancy=dataclasses.replace(
            cfg.tenancy, enabled=True, journal=True,
            prewarm_on_admit=False))
        world = W.empty_arena(32, 0.05)
        with tempfile.TemporaryDirectory() as td:
            st = launch_sim_stack(cfg, world, n_robots=2, device="cpu",
                                  http_port=0, checkpoint_dir=td)
            try:
                plane = st.tenancy
                assert st.api.tenancy is plane
                assert plane.checkpoint_dir == os.path.join(td, "tenants")
                plane.admit("m0", world, seed=0)
                plane.step(1)
                body = json.loads(st.api.handle("/status")[2])
                assert body["tenancy"]["tenants"]["m0"]["revision"] == 1
                assert st.api.handle("/tiles?tenant=m0&since=-1")[0] == 200
                report = st.crash_controlplane()
                assert report["restored"] == ["m0"]
                assert st.tenancy is not plane
                assert st.api.tenancy is st.tenancy
                assert st.tenancy.epoch("m0") == 1
            finally:
                st.shutdown()
        return
    if what == "obs.enabled":
        cfg = cfg.replace(obs=dataclasses.replace(cfg.obs, enabled=True))
        st = launch_sim_stack(cfg, W.empty_arena(32, 0.05), n_robots=2,
                              device="cpu")
        assert st.tracer is not None and st.bus.tracer is st.tracer
        assert st.pipeline is not None and st.mapper._pipeline is st.pipeline
        assert st.slo is None
        st.run_steps(2)
        assert st.tracer.last_seq() > 0
        st.shutdown()
        return
    if what == "http_port":
        import json
        import urllib.request
        st = launch_sim_stack(cfg, W.empty_arena(32, 0.05), n_robots=2,
                              device="cpu", http_port=0)
        url = f"http://127.0.0.1:{st.api.port}/status"
        with urllib.request.urlopen(url, timeout=10) as r:
            assert json.loads(r.read())["n_robots"] == 2
        st.shutdown()
        with pytest.raises(OSError):
            urllib.request.urlopen(url, timeout=10)
        return
    if what == "depth_cam":
        st = launch_sim_stack(cfg, W.empty_arena(32, 0.05), n_robots=2,
                              device="cpu", depth_cam=True)
        assert st.voxel_mapper is not None and st.sim.depth_cam
        assert st.mapper.frontier_grid_provider == st.planner._planning_grid
        st.shutdown()
        return
    kw = dict(LAUNCH_REFUSED[what])
    section = kw.pop("cfg", None)
    if section is not None:
        cfg = cfg.replace(**{section: dataclasses.replace(
            getattr(cfg, section), **kw)})
        kw = {}
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        launch_sim_stack(cfg, W.empty_arena(32, 0.05), n_robots=2,
                         device="cpu", **kw)


def test_launch_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        launch_sim_stack(tiny_config(2), W.empty_arena(32, 0.05),
                         n_robots=2)


def test_demo_and_launch_import_no_jax():
    code = ("import sys\n"
            "import jax_mapping_torch.demo, jax_mapping_torch.bridge.launch\n"
            "import jax_mapping_torch.bridge.voxel_mapper\n"
            "import jax_mapping_torch.tenancy.megabatch\n"
            "print(sorted(k for k in sys.modules if k.split('.')[0] in "
            "('jax', 'jax_mapping')))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=str(REPO), env=env, timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "[]"


def test_supervisor_restarts_a_killed_mapper():
    """A mapper killed mid-mission stops beating; the supervisor declares
    it dead and restarts it through `Stack.restart_mapper`: a new node
    with the next restart epoch, each chain anchored at the brain's live
    pose, which the mission goes on fusing into."""
    cfg = stack_config(tiny_config)
    st, _ = _stack(cfg, 5)
    old = st.mapper
    st.kill_node("jax_mapper")
    for _ in range(30):
        st.run_steps(1)
        if st.mapper is not old:
            break
    new = st.mapper
    assert new is not old and new.restart_epoch == 1
    assert st.supervisor.n_restarts("jax_mapper") == 1
    assert new in st.executor.nodes and st.planner.mapper is new
    fused = new.n_scans_fused
    st.run_steps(3)
    assert new.n_scans_fused > fused
    assert int((new.merged_grid() <= cfg.grid.free_threshold).sum()) > 0


def test_device_trace_writes_a_torch_profiler_trace(tmp_path):
    from jax_mapping_torch.utils import device_trace
    with device_trace(str(tmp_path / "tr")) as d:
        torch.ones(64).cumsum(0)
    assert d == str(tmp_path / "tr")
    trace = tmp_path / "tr" / "device_trace.pt.trace.json"
    assert "cumsum" in trace.read_text()
