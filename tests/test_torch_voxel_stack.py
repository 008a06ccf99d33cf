"""The depth-camera stack of the port against the JAX package's: the voxel
mapper node, the planner's voxel overlay and the mapper's frontier basis.

One JAX reference run (a fresh `JAX_PLATFORMS=cpu` subprocess,
`tests/torch_jaxref.py`) launches the JAX `launch_sim_stack` with
`depth_cam=True` and the planner on, at tiny_config(2) with noise-free
wheels, a faster cruise, an 8-keyframe ring and a small loop-search disc
(so the ring thins and loops close within the drive), on
plank_course(96, 0.05, n_planks=4, seed=3), and explores for `STEPS`
steps. It records every `/scan`, `/odom` and `/depth` message in delivery
order with the mapper, voxel-mapper and planner ticks between them, the
voxel node's counters and grid after each of its ticks, the planner's
overlay counters, and every `/frontiers` assignment.

The port's `MapperNode`, `VoxelMapperNode` and `PlannerNode`, on the CPU,
are fed the same messages in the same order (teacher-forced, as
tests/test_torch_stack.py feeds the mapper) and held to the reference:
images fused and dropped, keyframes stored, thinned and re-fused, the
voxel revision and the overlay's cache hits and misses exactly; the voxel
grid after every tick, re-fuses included, within ROADMAP C's voxel
tolerance (at most 1e-4 of the voxels apart, each on a decision boundary
of an image fused that tick); every frontier assignment, made on the
overlaid basis, exactly.

Then the port's counterparts of the JAX package's voxel-node tests
(tests/test_voxel_bridge.py without its HTTP cases,
tests/test_voxel_slam_coupling.py, tests/test_planner.py's overlay
cases), and voxel and keyframe sidecars read across the packages.
"""

import dataclasses
import os
import textwrap
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from jax_mapping_torch.bridge import voxel_mapper as VM
from jax_mapping_torch.bridge.bus import Bus
from jax_mapping_torch.bridge.launch import launch_sim_stack
from jax_mapping_torch.bridge.mapper import MapperNode
from jax_mapping_torch.bridge.messages import (DepthImage, Header, LaserScan,
                                               Odometry, Pose2D, Twist)
from jax_mapping_torch.bridge.planner import PlannerNode
from jax_mapping_torch.config import tiny_config
from jax_mapping_torch.io import checkpoint as CK
from jax_mapping_torch.ops import frontier as F
from jax_mapping_torch.ops import planner as P
from jax_mapping_torch.ops import voxel as V
from jax_mapping_torch.recovery import RecoveryManager
from jax_mapping_torch.resilience.health import FleetHealth
from jax_mapping_torch.sim import world as W
from jax_mapping_torch.utils import global_metrics as M
from tests.test_torch_voxel_kernel import voxel_boundary
from tests.torch_jaxref import run_reference
from tests.torch_threads import one_intra_op_thread  # noqa: F401

STEPS = 136
#: The voxel grid is compared after every GRID_EVERY-th voxel tick and
#: after every tick that re-fused.
GRID_EVERY = 4

#: Shared by the reference script and the port's side.
SETUP = '''
def voxel_stack_config(tiny_config):
    import dataclasses
    cfg = tiny_config(2)
    return cfg.replace(
        robot=dataclasses.replace(cfg.robot, speed_noise_frac=0.0,
                                  cruise_speed_units=500),
        loop=dataclasses.replace(cfg.loop, min_chain_size=3,
                                 search_radius_m=0.3, loop_window_m=1.0,
                                 response_coarse=0.2, response_fine=0.3),
        voxel=dataclasses.replace(cfg.voxel, keyframe_cap=8))


def overlay_scene(cfg, np):
    """A 2D map: a free 2 m x 2 m room around the origin, walled but for
    its east side, past which space is unknown; and a voxel wall in the
    planner's height band across the room at x = 0.5 m that the 2D map
    does not have, between the robot and the only frontier: (log-odds
    (n, n), voxel grid (Z, Y, X), robot poses (1, 3))."""
    n, res = cfg.grid.size_cells, cfg.grid.resolution_m
    ox, oy = cfg.grid.origin_m
    lo = np.full((n, n), 2.0, np.float32)
    cols = (np.arange(n) + 0.5) * res + ox
    rows = (np.arange(n) + 0.5) * res + oy
    band_y = (np.abs(rows) < 1.0)[:, None]
    lo[band_y & (cols[None, :] > -1.0) & (cols[None, :] < 1.0)] = -2.0
    lo[band_y & (cols[None, :] >= 1.0)] = 0.0
    vox, pc = cfg.voxel, cfg.planner
    vg = np.zeros((vox.size_z_cells, vox.size_y_cells, vox.size_x_cells),
                  np.float32)
    zs = (np.arange(vox.size_z_cells) + 0.5) * vox.resolution_m \\
        + vox.origin_m[2]
    band = np.nonzero((zs >= pc.voxel_z_min_m) & (zs <= pc.voxel_z_max_m))[0]
    x0 = int(round((0.5 - vox.origin_m[0]) / vox.resolution_m))
    vg[band[0], :, x0:x0 + 2] = 3.0
    return lo, vg, np.array([[-0.5, 0.0, 0.0]], np.float32)
'''
exec(SETUP)
CFG = voxel_stack_config(tiny_config)

REFERENCE = '''
import os
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_cpu_multi_thread_eigen=false")
''' + SETUP + f'''
import jax.numpy as jnp
from jax_mapping.bridge.launch import launch_sim_stack
from jax_mapping.bridge.qos import qos_sensor_data
from jax_mapping.bridge.voxel_mapper import VoxelMapperNode
from jax_mapping.bridge.bus import Bus
from jax_mapping.config import tiny_config
from jax_mapping.io import checkpoint as CK
from jax_mapping.ops import frontier as F
from jax_mapping.ops import planner as P
from jax_mapping.sim import world as W
from jax_mapping.utils import global_metrics as M

cfg = voxel_stack_config(tiny_config)
world = W.plank_course(96, cfg.grid.resolution_m, n_planks=4, seed=3)

# The stamps come from a simulated clock (ROS's sim time): every read in
# a sim step gives that step's time, one control period after the last.
# With the wall clock, the mapper's odometry rates (pose delta over stamp
# delta) would round differently on a loaded CPU.
import types
from jax_mapping.bridge import brain as _brain, sim_node as _sim_node
_clock = [1000.0]
for _mod in (_brain, _sim_node):
    _mod.time = types.SimpleNamespace(monotonic=lambda: _clock[0])
st = launch_sim_stack(cfg, world, n_robots=2, seed=0, depth_cam=True)
_sim_step = st.sim.step


def _step_on_the_clock():
    _clock[0] += 1.0 / cfg.robot.control_rate_hz
    _sim_step()


st.sim.step = _step_on_the_clock
vm, pl, m = st.voxel_mapper, st.planner, st.mapper
OUT["init_mapper_poses"] = np.stack([np.asarray(s.pose) for s in m.states])
events, scans, odoms, depths, fronts = [], [], [], [], []
vcounts, grids, ocounts, grid_ticks = [], [], [], []


def on_msg(kind, store, i, msg):
    events.append((kind, i, len(store)))
    store.append(msg)


for i in range(2):
    st.bus.subscribe(f"robot{{i}}/scan", qos_sensor_data,
                     callback=lambda x, i=i: on_msg(0, scans, i, x))
    st.bus.subscribe(f"robot{{i}}/odom",
                     callback=lambda x, i=i: on_msg(1, odoms, i, x))
    st.bus.subscribe(f"robot{{i}}/depth", qos_sensor_data,
                     callback=lambda x, i=i: on_msg(3, depths, i, x))
st.bus.subscribe("/frontiers",
                 callback=lambda f: fronts.append(np.asarray(f.assignment)))
thins0 = M.counters.get("voxel_mapper.keyframe_thins")


def wrap(obj, kind, after):
    orig = obj.tick

    def tick():
        events.append((kind, -1, -1))
        orig()
        after()
    obj.tick = tick


def after_voxel():
    refused = bool(vcounts) and vm.n_refuses > vcounts[-1][4]
    vcounts.append([vm.n_images_fused, vm.n_images_dropped_unpaired,
                    vm.n_keyframes_stored,
                    M.counters.get("voxel_mapper.keyframe_thins") - thins0,
                    vm.n_refuses, vm.map_revision,
                    len(vm._keyframes[0]), len(vm._keyframes[1]),
                    m.n_loops_closed])
    if len(vcounts) % {GRID_EVERY} == 0 or refused:
        grid_ticks.append(len(vcounts) - 1)
        grids.append(np.asarray(vm.voxel_grid()))


def after_overlay():
    ocounts.append([pl.n_overlay_rebuilds, pl.n_overlay_reuses])


wrap(m, 2, after_overlay)
wrap(vm, 4, after_voxel)
wrap(pl, 5, after_overlay)
st.brain.start_exploring()
st.run_steps({STEPS})
OUT["events"] = np.array(events, np.int64)
OUT["scan_stamp"] = np.array([s.header.stamp for s in scans])
OUT["scan_ranges"] = np.stack([np.asarray(s.ranges, np.float32)
                               for s in scans])
OUT["odom_stamp"] = np.array([o.header.stamp for o in odoms])
OUT["odom_pose"] = np.array([[o.pose.x, o.pose.y, o.pose.theta]
                             for o in odoms])
OUT["odom_twist"] = np.array([[o.twist.linear_x, o.twist.angular_z]
                              for o in odoms])
OUT["depth_stamp"] = np.array([d.header.stamp for d in depths])
OUT["depth"] = np.stack([np.asarray(d.depth, np.float32) for d in depths])
OUT["fronts"] = np.stack(fronts)
OUT["vcounts"] = np.array(vcounts, np.int64)
OUT["grids"] = np.stack(grids)
OUT["grid_ticks"] = np.array(grid_ticks, np.int64)
OUT["ocounts"] = np.array(ocounts, np.int64)

# The sidecars of this run, for the port to read; the port's, read here.
CK.save_voxel_sidecar(JAX_CKPT, vm.snapshot_grid(),
                      config_json=cfg.to_json())
CK.save_keyframe_sidecar(JAX_CKPT, vm.snapshot_keyframes(),
                         config_json=cfg.to_json())
kf = vm.snapshot_keyframes()
for k, v in kf.items():
    OUT["kf." + k] = v
OUT["port_voxel"] = np.asarray(CK.load_voxel_sidecar(
    PORT_CKPT, vm.snapshot_grid(), running_config_json=cfg.to_json()))
pk = CK.load_keyframe_sidecar(PORT_CKPT, running_config_json=cfg.to_json())
vm2 = VoxelMapperNode(cfg, Bus(), n_robots=2)
vm2.restore_keyframes(pk)
for k, v in vm2.snapshot_keyframes().items():
    OUT["port_kf." + k] = v

# The overlay scene: the overlaid grid and the frontiers on it and on
# the bare map.
lo, vg, poses = overlay_scene(cfg, np)
over = P.overlay_voxel_obstacles(cfg.planner, cfg.grid, cfg.voxel,
                                 jnp.asarray(lo), jnp.asarray(vg))
OUT["overlay"] = np.asarray(over)
for name, g in (("bare", lo), ("over", over)):
    fr = F.compute_frontiers(cfg.frontier, cfg.grid, jnp.asarray(g),
                             jnp.asarray(poses))
    for k in ("costs", "assignment", "targets", "sizes"):
        OUT[name + "." + k] = np.asarray(getattr(fr, k))
'''


def _port_sidecar(path: str):
    """A standalone port voxel node, one image fused and one keyframe
    ring set by hand, written as `path`'s voxel and keyframe sidecars."""
    cam = CFG.depthcam
    vm = VM.VoxelMapperNode(CFG, Bus(), n_robots=2, device="cpu")
    d = torch.full((1, cam.height_px, cam.width_px), 0.7)
    vm.grid = V.fuse_depths(CFG.voxel, cam, vm.grid, d,
                            torch.tensor([[0.1, -0.2, 0.4]]))
    rng = np.random.default_rng(5)
    kf = {"depths": rng.uniform(0, 1, (3, cam.height_px, cam.width_px))
          .astype(np.float32),
          "rels": rng.normal(size=(3, 3)).astype(np.float32),
          "node_idx": np.array([4, 9, 2], np.int32),
          "thins": np.array([0, 1, 0], np.int32),
          "robot": np.array([0, 0, 1], np.int32)}
    vm.restore_keyframes(kf)
    CK.save_voxel_sidecar(path, vm.snapshot_grid(),
                          config_json=CFG.to_json())
    CK.save_keyframe_sidecar(path, vm.snapshot_keyframes(),
                             config_json=CFG.to_json())
    return vm.snapshot_grid().numpy(), kf


@pytest.fixture(scope="module")
def ckpts(tmp_path_factory):
    d = tmp_path_factory.mktemp("voxelckpt")
    port_path, jax_path = str(d / "port.npz"), str(d / "jax.npz")
    grid, kf = _port_sidecar(port_path)
    return SimpleNamespace(port=port_path, jax=jax_path, port_grid=grid,
                           port_kf=kf)


@pytest.fixture(scope="module")
def ref(ckpts, tmp_path_factory):
    src = (f"JAX_CKPT = {ckpts.jax!r}\nPORT_CKPT = {ckpts.port!r}\n"
           + REFERENCE)
    return run_reference(src, tmp_path_factory.mktemp("vstack") / "r.npz",
                         timeout=1200)


def teacher_forced(ref) -> SimpleNamespace:
    """The port's mapper, voxel mapper and planner fed the reference's
    messages, ticked where the reference ticked."""
    cfg = CFG
    bus = Bus()
    health = FleetHealth(cfg.resilience, 2)
    m = MapperNode(cfg, bus, n_robots=2, health=health,
                   recovery=RecoveryManager(cfg.recovery, 2, robot=cfg.robot),
                   device="cpu")
    for i, s in enumerate(m.states):
        m.states[i] = s._replace(
            pose=torch.as_tensor(ref["init_mapper_poses"][i]))
    vm = VM.VoxelMapperNode(cfg, bus, n_robots=2, mapper=m)
    pl = PlannerNode(cfg, bus, mapper=m, voxel_mapper=vm, health=health)
    m.frontier_grid_provider = pl._planning_grid
    m.frontier_grid_key_provider = pl.overlay_key
    fronts, vcounts, grids, ocounts, fused = [], [], [], [], []
    bus.subscribe("/frontiers",
                  callback=lambda f: fronts.append(np.asarray(f.assignment)))
    # Feed the health registry as the brain does (test_torch_stack.py).
    brain_tick_no = [0]
    for i in range(2):
        bus.subscribe(f"robot{i}/scan", callback=lambda _m, i=i:
                      m._health.note_scan(i, brain_tick_no[0]))
    bus.subscribe("robot0/odom", callback=lambda _m:
                  m._health.note_tick(brain_tick_no[0]))
    bus.subscribe("robot1/odom", callback=lambda _m:
                  brain_tick_no.__setitem__(0, brain_tick_no[0] + 1))
    to_device = vm._to_device

    def recorded(depths, poses):
        fused[-1].append((np.stack(depths), np.stack(poses)))
        return to_device(depths, poses)
    vm._to_device = recorded
    thins0 = M.counters.get("voxel_mapper.keyframe_thins")
    grid_ticks = set(ref["grid_ticks"].tolist())
    pubs, sc = {}, cfg.scan

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
        elif kind == 3:
            publish(f"robot{i}/depth", DepthImage(
                header=Header(stamp=float(ref["depth_stamp"][j]),
                              frame_id=f"robot{i}/base_camera"),
                depth=ref["depth"][j].copy()))
        elif kind == 2:
            m.tick()
            ocounts.append([pl.n_overlay_rebuilds, pl.n_overlay_reuses])
        elif kind == 4:
            fused.append([])
            vm.tick()
            vcounts.append([
                vm.n_images_fused, vm.n_images_dropped_unpaired,
                vm.n_keyframes_stored,
                M.counters.get("voxel_mapper.keyframe_thins") - thins0,
                vm.n_refuses, vm.map_revision, len(vm._keyframes[0]),
                len(vm._keyframes[1]), m.n_loops_closed])
            if len(vcounts) - 1 in grid_ticks:
                grids.append(vm.voxel_grid().numpy().copy())
        elif kind == 5:
            pl.tick()
            ocounts.append([pl.n_overlay_rebuilds, pl.n_overlay_reuses])
    return SimpleNamespace(mapper=m, voxel=vm, planner=pl,
                           fronts=np.stack(fronts),
                           vcounts=np.array(vcounts, np.int64),
                           grids=np.stack(grids), fused=fused,
                           ocounts=np.array(ocounts, np.int64))


@pytest.fixture(scope="module")
def replay(ref):
    return teacher_forced(ref)


# ------------------------------------------------------- the teacher-forced

def test_voxel_counters_equal_jax_every_tick(ref, replay):
    """Images fused and dropped, keyframes stored, thinned and re-fused,
    the voxel revision, the ring lengths and the 2D closures that trigger
    re-fuses, after every voxel tick; and the drive reached what it is
    for: a thinned ring and closures with their re-fuses."""
    np.testing.assert_array_equal(replay.vcounts, ref["vcounts"])
    last = ref["vcounts"][-1]
    assert last[0] >= 2 * STEPS - 4                   # images fused
    assert last[3] >= 1                               # ring thinned
    assert last[4] >= 1 and last[8] >= 1              # re-fuses, closures
    assert last[5] == last[4]                         # revision per re-fuse


def test_voxel_grid_within_tolerance_every_tick(ref, replay):
    """The voxel grid after every GRID_EVERY-th tick and after every
    re-fuse: at most 1e-4 of the voxels apart, and each voxel that came
    apart since the last comparison on a decision boundary of an image
    fused since then, re-fused keyframes included (ROADMAP C: the
    interpret-mode voxel kernel's boundary flips)."""
    vox, cam = CFG.voxel, CFG.depthcam
    want, ticks = ref["grids"], ref["grid_ticks"]
    assert replay.grids.shape == want.shape
    prev = np.zeros(want.shape[1:], bool)
    last = -1
    for k, t in enumerate(ticks):
        off = replay.grids[k] != want[k]
        assert off.sum() <= 1e-4 * off.size, (t, int(off.sum()))
        rows = np.argwhere(off & ~prev)
        if len(rows):
            depths, poses = [], []
            for calls in replay.fused[last + 1:t + 1]:
                for d, p in calls:
                    depths += list(d)
                    poses += [pp.astype(np.float64) for pp in p]
            on = voxel_boundary(vox, cam, depths, poses,
                                [(0, 0)] * len(poses), rows)
            assert all(on), (t, rows[~np.asarray(on)][:5].tolist())
        prev, last = off, t
    refused = np.diff(ref["vcounts"][:, 4], prepend=0) > 0
    assert refused.any() and set(np.nonzero(refused)[0]) <= set(ticks)
    assert (np.abs(want[-1]) > 0).sum() > 1000


def test_frontier_assignment_on_the_overlaid_basis(ref, replay):
    """Every `/frontiers` assignment, made on the planner's overlaid
    planning grid, equals the reference's."""
    np.testing.assert_array_equal(replay.fronts, ref["fronts"])
    assert (ref["fronts"] >= 0).any()


def test_overlay_cache_hits_and_misses_equal_jax(ref, replay):
    """The overlay's rebuilds and reuses after every mapper and planner
    tick: the publish and the planner share one overlay per revision
    pair."""
    np.testing.assert_array_equal(replay.ocounts, ref["ocounts"])
    assert ref["ocounts"][-1][0] > 0


def test_planning_grid_cache_keys():
    """The overlay cache: a second call under the same (map, voxel)
    revisions reuses the overlay, a fusion in either rebuilds it; with
    the mapper's revisions untracked it keys on the grids' identity."""
    cfg = tiny_config()
    bus = Bus()
    m = MapperNode(cfg, bus, n_robots=1, device="cpu")
    vm = VM.VoxelMapperNode(cfg, bus, n_robots=1, mapper=m)
    pl = PlannerNode(cfg, bus, mapper=m, voxel_mapper=vm)
    a = pl._planning_grid()
    assert pl._planning_grid() is a
    assert (pl.n_overlay_rebuilds, pl.n_overlay_reuses) == (1, 1)
    assert pl.overlay_key() == vm.serving_revision() == 0
    vm.n_images_fused += 1                     # a fusion's revision
    pl._planning_grid()
    assert (pl.n_overlay_rebuilds, pl.n_overlay_reuses) == (2, 1)
    m.map_revision += 1
    pl._planning_grid(m.merged_grid(), m.map_revision)
    assert (pl.n_overlay_rebuilds, pl.n_overlay_reuses) == (3, 1)
    m._serving_enabled = False                 # the same grids: reused
    pl._planning_grid()
    pl._planning_grid()
    assert (pl.n_overlay_rebuilds, pl.n_overlay_reuses) == (3, 3)
    m.shared_grid = m.shared_grid.clone()      # a new grid: rebuilt
    pl._planning_grid()
    assert (pl.n_overlay_rebuilds, pl.n_overlay_reuses) == (4, 3)


def test_mapper_poses_follow_the_reference(replay):
    """The mapper under the voxel stack closed loops and kept its chains:
    its graphs carry the closures the voxel node re-fused on."""
    m = replay.mapper
    assert m.n_loops_closed == replay.voxel._loops_seen > 0
    assert replay.voxel.n_refuses >= 1


# ------------------------------------------------------------ the overlay

def test_overlay_and_frontiers_on_a_wall_only_the_3d_map_sees(ref):
    """overlay_voxel_obstacles' grid equals JAX's exactly on a voxel wall
    across the free corridor that the 2D map does not have; the frontier
    costs and assignment on the overlaid basis and on the bare map equal
    JAX's, and the wall raises the cost of what lies behind it."""
    lo, vg, poses = overlay_scene(CFG, np)
    over = P.overlay_voxel_obstacles(CFG.planner, CFG.grid, CFG.voxel,
                                     torch.as_tensor(lo),
                                     torch.as_tensor(vg))
    np.testing.assert_array_equal(over.numpy(), ref["overlay"])
    assert bool((over.numpy() != lo).any())
    out = {}
    for name, g in (("bare", torch.as_tensor(lo)), ("over", over)):
        fr = F.compute_frontiers(CFG.frontier, CFG.grid, g,
                                 torch.as_tensor(poses))
        for k in ("costs", "assignment", "sizes"):
            np.testing.assert_array_equal(getattr(fr, k).numpy(),
                                          ref[f"{name}.{k}"], err_msg=k)
        np.testing.assert_allclose(fr.targets.numpy(),
                                   ref[f"{name}.targets"], atol=1e-5)
        out[name] = fr
    live = out["bare"].sizes > 0
    assert bool(live.any()) and int(out["bare"].assignment[0]) >= 0
    assert bool((out["bare"].costs[:, live] < 1e9).all())
    assert bool((out["over"].costs[:, live] >= 1e9).all())
    assert int(out["over"].assignment[0]) == -1


def test_frontier_basis_reads_the_overlay():
    """With the overlay wired, the grid the mapper's frontier pass reads
    is blocked where a 3D obstacle stands, while the 2D map is not (JAX
    tests/test_planner.py::test_frontier_assignment_sees_voxel_obstacles)."""
    cfg = tiny_config()
    st = launch_sim_stack(cfg, W.empty_arena(96, cfg.grid.resolution_m),
                          n_robots=1, seed=10, depth_cam=True, device="cpu")
    try:
        assert st.mapper.frontier_grid_provider is not None
        vox, pc = cfg.voxel, cfg.planner
        vg = np.zeros((vox.size_z_cells, vox.size_y_cells,
                       vox.size_x_cells), np.float32)
        zs = (np.arange(vox.size_z_cells) + 0.5) * vox.resolution_m \
            + vox.origin_m[2]
        band = np.nonzero((zs >= pc.voxel_z_min_m)
                          & (zs <= pc.voxel_z_max_m))[0]
        vg[band[0], 30, 30] = 3.0
        st.voxel_mapper.restore_grid(vg)
        lo = st.mapper.frontier_grid_provider().numpy()
        res = cfg.grid.resolution_m
        r0 = round((vox.origin_m[1] - cfg.grid.origin_m[1]) / res)
        c0 = round((vox.origin_m[0] - cfg.grid.origin_m[0]) / res)
        assert lo[r0 + 30, c0 + 30] >= cfg.grid.occ_threshold
        assert float(st.mapper.merged_grid()[r0 + 30, c0 + 30]) \
            < cfg.grid.occ_threshold
        basis, key = st.mapper._frontier_basis(st.mapper.merged_grid(), 0)
        assert key == ("overlay", st.voxel_mapper.serving_revision())
        assert torch.equal(basis, st.mapper.frontier_grid_provider())
    finally:
        st.shutdown()


def test_planner_overlay_disabled_on_mismatched_resolution(capsys):
    cfg = tiny_config()
    cfg = cfg.replace(voxel=dataclasses.replace(cfg.voxel,
                                                resolution_m=0.1))
    bus = Bus()
    m = MapperNode(cfg, bus, n_robots=1, device="cpu")
    vm = VM.VoxelMapperNode(cfg, bus, n_robots=1, mapper=m)
    pl = PlannerNode(cfg, bus, mapper=m, voxel_mapper=vm)
    assert pl.voxel_mapper is None and pl.overlay_key() is None
    assert "DISABLED" in capsys.readouterr().out
    assert pl._planning_grid() is m.merged_grid()


# ------------------------------------------------- the node's own contract

def _one_image(vm, stamp=1.1, value=0.8, shape=None):
    cam = vm.cfg.depthcam
    bus = vm._bus_pubs
    bus["odom"].publish(Odometry(header=Header(stamp=1.0),
                                 pose=Pose2D(0, 0, 0)))
    bus["depth"].publish(DepthImage(
        header=Header(stamp=stamp),
        depth=np.full(shape or (cam.height_px, cam.width_px), value,
                      np.float32)))


def _standalone(cfg=None):
    cfg = cfg or tiny_config()
    bus = Bus()
    vm = VM.VoxelMapperNode(cfg, bus, n_robots=1, device="cpu")
    vm._bus_pubs = {"odom": bus.publisher("odom"),
                    "depth": bus.publisher("depth")}
    return vm


def test_standalone_voxel_mapper_fuses_at_odometry():
    """mapper=None maps in the odom frame: the image fuses, no keyframe,
    no re-fuse."""
    vm = _standalone()
    _one_image(vm)
    vm.tick()
    assert vm.n_images_fused == 1 and vm.serving_revision() == 1
    assert vm.n_keyframes_stored == 0 and vm.n_refuses == 0
    assert bool((vm.voxel_grid() != 0).any())


def test_voxel_mapper_rejects_shape_drift():
    """A depth image whose shape disagrees with DepthCamConfig is counted
    out, not mis-projected."""
    vm = _standalone()
    before = M.counters.get("voxel_mapper.images_bad_shape")
    _one_image(vm, shape=(7, 9))
    vm.tick()
    assert vm.n_images_fused == 0
    assert M.counters.get("voxel_mapper.images_bad_shape") == before + 1


def test_unpaired_images_are_dropped_and_counted():
    vm = _standalone()
    cam = vm.cfg.depthcam
    vm._bus_pubs["depth"].publish(DepthImage(
        header=Header(stamp=1.0),
        depth=np.ones((cam.height_px, cam.width_px), np.float32)))
    vm.tick()
    assert vm.n_images_dropped_unpaired == 1 and vm.n_images_fused == 0


def test_exports_are_writable_copies():
    """height_map and obstacle_slice are writable host copies: a consumer
    masking one in place changes neither the node nor the next export."""
    vm = _standalone()
    _one_image(vm)
    vm.tick()
    hm = vm.height_map()
    blocked = vm.obstacle_slice(0.05, 0.45)
    vox = vm.cfg.voxel
    assert hm.shape == blocked.shape == (vox.size_y_cells, vox.size_x_cells)
    assert hm.flags.writeable and blocked.flags.writeable
    before = hm.copy()
    hm[:] = -1.0
    np.testing.assert_array_equal(vm.height_map(), before)
    img = vm.height_map_image()
    assert img.dtype == np.uint8 and img.shape == hm.shape
    rev, tile = vm.serving_snapshot()
    assert rev == vm.serving_revision()
    np.testing.assert_array_equal(np.flipud(tile), img)


def test_restore_during_an_inflight_fuse_wins(monkeypatch):
    """A restore_grid landing while tick() fuses outside the lock is not
    overwritten by the grid fused from the pre-restore state: the fused
    result is dropped and counted."""
    vm = _standalone()
    _one_image(vm, value=1.0)
    vox = vm.cfg.voxel
    restored = np.full((vox.size_z_cells, vox.size_y_cells,
                        vox.size_x_cells), 0.625, np.float32)
    real = V.fuse_depths

    def racing(*args):
        out = real(*args)
        vm.restore_grid(restored)
        return out
    monkeypatch.setattr(VM.V, "fuse_depths", racing)
    before = M.counters.get("voxel_mapper.fuse_dropped_stale")
    vm.tick()
    assert M.counters.get("voxel_mapper.fuse_dropped_stale") == before + 1
    np.testing.assert_array_equal(vm.voxel_grid().numpy(), restored)
    assert vm.n_images_fused == 0 and vm.map_revision == 1


def test_restore_grid_guards_the_shape_and_clears_the_ring():
    vm = _standalone()
    with pytest.raises(ValueError, match="voxel checkpoint shape"):
        vm.restore_grid(np.zeros((2, 3, 4), np.float32))
    vm._keyframes[0].append(object())
    vm.restore_grid(vm.snapshot_grid())
    assert vm._keyframes == [[]] and vm.map_revision == 1


def test_publish_points_caps_the_export():
    vm = _standalone()
    _one_image(vm)
    vm.tick()
    got = []
    vm.bus.subscribe("/voxel_points", callback=got.append)
    vm.max_points = 10
    vm.publish_points()
    full = V.occupied_voxel_centers(vm.cfg.voxel, vm.voxel_grid())
    assert len(full) > 10 and got[-1].points.shape == (10, 3)
    vm.max_points = 65536
    vm.publish_points()
    np.testing.assert_array_equal(got[-1].points, full)


def test_corrected_pose_math():
    """The map->odom correction applied to a later odometry sample equals
    the estimate composed with the odom-frame motion since the basis."""
    est = np.array([2.0, 1.0, 0.7], np.float32)
    odom_then = np.array([1.5, 0.5, 0.2], np.float32)
    fwd = np.array([0.3, 0.0, 0.0], np.float32)
    odom_now = VM._se2_compose(odom_then, fwd)
    vm = _standalone()
    got = vm._corrected_pose((0, est, odom_then, 0, est, 0), odom_now)
    np.testing.assert_allclose(got, VM._se2_compose(est, fwd), atol=1e-6)
    np.testing.assert_array_equal(vm._corrected_pose(None, odom_now),
                                  odom_now)


def _ring_cfg(cap=8):
    """An 8-slot pose ring and a key scan every step: the graph thins
    within a short straight drive."""
    cfg = tiny_config()
    return cfg.replace(
        loop=dataclasses.replace(cfg.loop, max_poses=cap, max_edges=64),
        matcher=dataclasses.replace(cfg.matcher, min_travel_m=0.01,
                                    min_heading_rad=3.0))


def _drive_straight_step(cfg, pubs, step):
    t = 0.1 * step
    odom_pub, scan_pub, depth_pub = pubs
    odom_pub.publish(Odometry(header=Header(stamp=t, frame_id="odom"),
                              pose=Pose2D(0.02 * step, 0.0, 0.0),
                              twist=Twist()))
    scan_pub.publish(LaserScan(
        header=Header(stamp=t, frame_id="base_laser"),
        angle_increment=cfg.scan.angle_increment_rad,
        ranges=np.full(cfg.scan.n_beams, 1.0, np.float32)))
    if depth_pub is not None:
        cam = cfg.depthcam
        depth_pub.publish(DepthImage(
            header=Header(stamp=t, frame_id="base_camera"),
            depth=np.full((cam.height_px, cam.width_px), 0.6, np.float32)))


def test_thin_replica_tracks_the_real_graph():
    """_ThinSim reproduces the mapper graph's node count after every key
    add, through repeated thinning."""
    cap = 8
    cfg = _ring_cfg(cap)
    bus = Bus()
    m = MapperNode(cfg, bus, n_robots=1, device="cpu")
    pubs = (bus.publisher("odom"), bus.publisher("scan"), None)
    sim = VM._ThinSim(cap)
    for step in range(1, 25):
        _drive_straight_step(cfg, pubs, step)
        m.tick()
        st = m.states[0]
        sim.thins_at(int(st.n_keyscans))
        assert sim.n == int(st.graph.n_poses), step
    assert int(m.states[0].n_keyscans) > cap and sim.t >= 1
    assert sim.thins_at(0) == 0                 # a fresh chain resets


def test_keyframes_survive_graph_thinning():
    """Keyframes captured before a graph thin re-anchor to the surviving
    even node and rebuild the 3D map on re-fuse: none dangles."""
    cap = 8
    cfg = _ring_cfg(cap)
    bus = Bus()
    m = MapperNode(cfg, bus, n_robots=1, device="cpu")
    vm = VM.VoxelMapperNode(cfg, bus, n_robots=1, mapper=m)
    pubs = (bus.publisher("odom"), bus.publisher("scan"),
            bus.publisher("depth"))
    before_thin = 0
    for step in range(1, 25):
        _drive_straight_step(cfg, pubs, step)
        m.tick()
        vm.tick()
        if int(m.states[0].n_keyscans) == cap:
            before_thin = sum(len(x) for x in vm._keyframes)
    assert int(m.states[0].n_keyscans) > cap and before_thin > 0
    n_kf = sum(len(x) for x in vm._keyframes)
    vm._refuse_from_keyframes()
    assert vm.n_refuses == 1 and vm.map_revision == 1
    assert sum(len(x) for x in vm._keyframes) == n_kf
    assert int((vm.voxel_grid() > 0).sum()) > 0


def test_checkpoint_without_keyframe_sidecar_restores_an_empty_ring(
        tmp_path):
    """A checkpoint saved without a keyframe sidecar (as before the ring
    was saved) resumes the voxel grid with an empty ring."""
    cfg = tiny_config()
    path = str(tmp_path / "old.npz")
    vm = _standalone(cfg)
    _one_image(vm)
    vm.tick()
    CK.save_voxel_sidecar(path, vm.snapshot_grid(),
                          config_json=cfg.to_json())
    assert CK.load_keyframe_sidecar(path) is None
    fresh = _standalone(cfg)
    fresh._keyframes[0].append(object())
    fresh.restore_grid(CK.load_voxel_sidecar(
        path, fresh.snapshot_grid(), running_config_json=cfg.to_json()))
    assert torch.equal(fresh.voxel_grid(), vm.voxel_grid())
    assert sum(len(r) for r in fresh._keyframes) == 0


def test_validate_keyframes_refuses_drift():
    vm = _standalone()
    cam = vm.cfg.depthcam
    good = {"depths": np.zeros((1, cam.height_px, cam.width_px),
                               np.float32),
            "rels": np.zeros((1, 3), np.float32),
            "node_idx": np.zeros(1, np.int32),
            "thins": np.zeros(1, np.int32), "robot": np.zeros(1, np.int32)}
    vm.validate_keyframes(good)
    for k, v, says in (("depths", np.zeros((1, 3, 3), np.float32), "shape"),
                       ("robot", np.zeros(2, np.int32), "disagree"),
                       ("robot", np.array([4], np.int32), "outside")):
        with pytest.raises(ValueError, match=says):
            vm.validate_keyframes({**good, k: v})


# ------------------------------------------- sidecars across the packages

def test_jax_voxel_sidecars_load_in_port(ref, ckpts):
    """The JAX run's voxel grid and keyframe ring, written by the JAX
    package, load in the port bit for bit and restore into a voxel
    node."""
    vm = VM.VoxelMapperNode(CFG, Bus(), n_robots=2, device="cpu")
    g = CK.load_voxel_sidecar(ckpts.jax, vm.snapshot_grid(),
                              running_config_json=CFG.to_json())
    np.testing.assert_array_equal(g.numpy(), ref["grids"][-1])
    kf = CK.load_keyframe_sidecar(ckpts.jax,
                                  running_config_json=CFG.to_json())
    vm.restore_grid(g)
    vm.restore_keyframes(kf)
    got = vm.snapshot_keyframes()
    for k in got:
        np.testing.assert_array_equal(got[k], ref["kf." + k], err_msg=k)
    assert len(got["robot"]) > 0


def test_port_voxel_sidecars_load_in_jax(ref, ckpts):
    np.testing.assert_array_equal(ref["port_voxel"], ckpts.port_grid)
    for k, v in ckpts.port_kf.items():
        np.testing.assert_array_equal(ref["port_kf." + k], v, err_msg=k)


def test_auto_checkpoint_writes_the_voxel_sidecars(tmp_path):
    """The stack's auto-checkpoint writes the voxel and keyframe sidecars
    beside the states; a mapper restart keeps the voxel node and its map
    and rewires it, and the planner's overlay, to the new mapper."""
    cfg = tiny_config(2)
    world = W.plank_course(96, cfg.grid.resolution_m, n_planks=4, seed=3)
    st = launch_sim_stack(cfg, world, n_robots=2, seed=0, depth_cam=True,
                          device="cpu", checkpoint_dir=str(tmp_path))
    try:
        st.brain.start_exploring()
        st.run_steps(12)
        st.save_auto_checkpoint()
        path = st.auto_checkpoint_path
        vm = st.voxel_mapper
        g = CK.load_voxel_sidecar(path, vm.snapshot_grid(),
                                  running_config_json=cfg.to_json())
        assert torch.equal(g, vm.voxel_grid())
        kf = CK.load_keyframe_sidecar(path,
                                      running_config_json=cfg.to_json())
        for k, v in vm.snapshot_keyframes().items():
            np.testing.assert_array_equal(kf[k], v)
        grid = vm.voxel_grid()
        st.restart_mapper()
        assert st.voxel_mapper is vm and vm.mapper is st.mapper
        assert vm.voxel_grid() is grid
        assert st.mapper.frontier_grid_provider == st.planner._planning_grid
        fused = vm.n_images_fused
        st.run_steps(3)
        assert vm.n_images_fused > fused
    finally:
        st.shutdown()


def test_demo_depth_cam_save_final_and_resume(tmp_path, capsys):
    """--depth-cam with --voxel-out and --save-final writes the height
    map and both sidecars; --resume restores the voxel grid."""
    import json
    from jax_mapping_torch import demo
    from jax_mapping_torch.bridge import png
    ckpt, img = str(tmp_path / "run.npz"), str(tmp_path / "v.png")
    args = ["--device", "cpu", "--robots", "1", "--world", "arena",
            "--world-cells", "96", "--depth-cam"]
    assert demo.main(args + ["--steps", "12", "--voxel-out", img,
                             "--save-final", ckpt]) == 0
    raw = capsys.readouterr().out
    first = json.loads(raw[raw.index("{\n"):])
    assert first["voxels_free"] > 0 and first["depth_images_fused"] >= 10
    assert os.path.exists(CK.voxel_sidecar_path(ckpt))
    assert os.path.exists(CK.keyframe_sidecar_path(ckpt))
    hm = png.decode_gray(open(img, "rb").read())
    assert hm.shape == (tiny_config().voxel.size_y_cells,
                        tiny_config().voxel.size_x_cells)
    assert demo.main(args + ["--steps", "2", "--resume", ckpt]) == 0
    out = capsys.readouterr()
    second = json.loads(out.out[out.out.index("{\n"):])
    assert "resumed 3D voxel map" in out.err
    assert second["voxels_free"] >= first["voxels_free"] * 0.9
