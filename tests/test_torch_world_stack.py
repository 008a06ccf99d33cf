"""The port's windowed `MapperNode` against the JAX package's.

One JAX reference run (a fresh `JAX_PLATFORMS=cpu` subprocess,
`tests/torch_jaxref.py`) builds the JAX `MapperNode` at tiny_config(2) with
`world.windowed` on a 768-cell logical lattice (12 tiles of 64 cells), a
4-tile window, a 1-tile margin and a host budget of 4 tiles over a spill
file. Two robots start at their true poses and are scripted, noise-free,
12 m east through a plank course and 9 m back, with scans raycast by the
JAX package's simulated lidar: six recentres, evictions to the host and
the disk tier, rehydrations from both, loop closures on the way back. The
reference records every `/scan` and `/odom` it delivered and, at every
tick, the pose-like leaves just after the recentre, the window origin,
the mapper's poses, keys and closures, the map->odom correction TFs, the
revision lattice and every `/pose` and `/frontiers` message.

The port's windowed `MapperNode`, on the CPU, is fed the same messages
(teacher-forced) and held to the reference:

* exactly: the store's schedule and status, the window origin, the
  revision lattice, the map revision, the state generations, the key and
  closure counts at every tick, and the frontier assignments, sizes and
  revisions of every publish;
* within the stack tolerance of `test_torch_stack.py` (1e-3 m, 1e-3 rad):
  the leaves after each recentre, the window-frame estimates, the world-
  frame `/pose` payloads and the correction TFs, at every tick (measured
  on the CPU: 4.4e-6 m, and 8.6e-6 m for the TFs);
* the frontier targets within 1e-5 m (measured: 9.5e-7 m): cluster means,
  they carry the estimates' float32 rounding;
* the grid within the window tolerances of ROADMAP C (cells off by more
  than 2e-6: at most 1e-4 of them; measured: one).

The estimates of the two packages differ by float32 ulps (ROADMAP C), and
the closed loop of matcher and pose graph carries the difference along.
Driven 3 m further west, this drive reaches a matcher near-tie at which
robot 1's heading candidate flips, and the two packages part by a few
centimetres from there on; the drive ends before it.
"""

import json
import tempfile
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax_mapping_torch.config as C
from jax_mapping_torch.bridge.bus import Bus
from jax_mapping_torch.bridge.mapper import MapperNode
from jax_mapping_torch.bridge.messages import (Header, LaserScan, Odometry,
                                               Pose2D, Twist)
from tests.torch_jaxref import run_reference
from tests.torch_threads import one_intra_op_thread  # noqa: F401

#: Shared by the reference script and the port's side.
SETUP = '''
import json
import tempfile

HOST_BUDGET = 4


def world_config(C):
    import dataclasses
    cfg = C.tiny_config(2)
    return cfg.replace(
        grid=dataclasses.replace(cfg.grid, size_cells=768),
        world=C.WorldConfig(windowed=True, window_tiles=4, margin_tiles=1,
                            host_tile_budget=HOST_BUDGET))


def course():
    """(T, 2, 3) scripted world-frame poses: 12 m east and 9 m back in
    0.3 m steps along a gentle weave in heading, robot 1 trailing on the other
    side of the lane's centre line. Each step follows the mapper's RK2
    midpoint motion model, so noise-free odometry is what a
    differential-drive robot would report."""
    steps = [0.3] * 40 + [-0.3] * 30
    p = np.zeros((len(steps) + 1, 2, 3))
    p[0] = [[0.0, 0.25, 0.0], [-0.5, -0.25, 0.0]]
    for k, d in enumerate(steps):
        for i, sign in enumerate((1.0, -1.0)):
            th = sign * 0.05 * np.sin((k + 1) / 3.0)
            mid = 0.5 * (p[k, i, 2] + th)
            p[k + 1, i] = [p[k, i, 0] + d * np.cos(mid),
                           p[k, i, 1] + d * np.sin(mid), th]
    return p.astype(np.float32)


def drive(m, tf, bus, Header, LaserScan, Odometry, Pose2D, Twist, poses,
          ranges, as_pose):
    """Start `m`'s robots at the course's first poses, feed it each tick's
    odometry and scans, tick it, and record what the parity checks read."""
    for i, s in enumerate(m.states):
        m.states[i] = s._replace(pose=as_pose(poses[0, i]))
    fronts, pose_msgs = [], []
    bus.subscribe("/frontiers", callback=lambda f: fronts.append(
        (len(rec["origins"]), f)))
    bus.subscribe("/pose", callback=lambda p: pose_msgs.append(
        (len(rec["origins"]), p)))
    rec = {"origins": [], "est": [], "tfs": [], "tile_rev": [], "rev": [],
           "graph": [], "leaves": [], "basis": [], "gen": []}
    shift = m._maybe_shift_window

    def shift_and_record():
        """Every pose-like leaf, read just after the tick's recentre."""
        shift()
        rec["leaves"].append(np.stack([np.concatenate(
            [np.asarray(s.pose), np.asarray(s.last_key_pose),
             np.asarray(s.graph.poses).ravel()]) for s in m.states]))
        rec["basis"].append([np.full(3, np.nan) if c is None
                             else np.asarray(c[0], np.float64)
                             for c in m._correction])
        rec["gen"].append(list(m._state_gen))

    m._maybe_shift_window = shift_and_record
    pubs, sc = {}, m.cfg.scan

    def pub(topic, msg):
        pubs.setdefault(topic, bus.publisher(topic)).publish(msg)

    for k in range(len(poses)):
        stamp = 0.5 * (k + 1)
        for i in range(2):
            pub(f"robot{i}/odom", Odometry(
                header=Header(stamp=stamp, frame_id=f"robot{i}/odom"),
                child_frame_id=f"robot{i}/base_link",
                pose=Pose2D(*(float(v) for v in poses[k, i])),
                twist=Twist(linear_x=0.6, angular_z=0.0)))
            pub(f"robot{i}/scan", LaserScan(
                header=Header(stamp=stamp, frame_id=f"robot{i}/base_laser"),
                angle_min=sc.angle_min_rad,
                angle_increment=sc.angle_increment_rad,
                range_min=sc.range_min_m, range_max=sc.range_max_m,
                ranges=ranges[k, i, :sc.n_beams].copy()))
        m.tick()
        rec["origins"].append(m.world.origin_tile)
        rec["est"].append(np.stack([np.asarray(s.pose) for s in m.states]))
        tfs = []
        for i in range(2):
            t = tf.lookup("map", f"robot{i}/odom")
            tfs.append([t.x, t.y, t.theta])
        rec["tfs"].append(tfs)
        rec["tile_rev"].append(np.array(m._tile_rev))
        rec["rev"].append(m.map_revision)
        rec["graph"].append([m.n_loops_closed]
                            + [int(s.graph.n_poses) for s in m.states])
    out = {k: np.array(v) for k, v in rec.items()}
    out["front_tick"] = np.array([t for t, _ in fronts])
    out["front_assign"] = np.stack([np.asarray(f.assignment)
                                    for _, f in fronts])
    out["front_rev"] = np.array([f.map_revision for _, f in fronts])
    out["front_targets"] = json.dumps(
        [np.asarray(f.targets_xy, np.float64).tolist() for _, f in fronts])
    out["front_sizes"] = json.dumps(
        [np.asarray(f.sizes).tolist() for _, f in fronts])
    out["pose_tick"] = np.array([t for t, _ in pose_msgs])
    out["pose_xyt"] = np.array([[[d["x"], d["y"], d["theta"]] for d in p]
                                for _, p in pose_msgs])
    out["pose_cov"] = np.array([[d["cov"] is not None for d in p]
                                for _, p in pose_msgs])
    status = {k: v for k, v in m.world_status().items() if k != "spill"}
    out["status"] = json.dumps(status)
    out["spill"] = json.dumps(m.world.status()["spill"])
    out["schedule"] = json.dumps(m.world.schedule)
    out["grid"] = np.asarray(m.shared_grid)
    out["counts"] = np.array([m.n_scans_fused, m.n_loops_closed,
                              m.map_revision])
    return out
'''
_ns: dict = {"np": np}
exec(SETUP, _ns)

REFERENCE = '''
import os
# One XLA thread: the suite's parallel workers share the cores.
os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                           + " --xla_cpu_multi_thread_eigen=false")
''' + SETUP + '''
import jax.numpy as jnp

import jax_mapping.config as C
from jax_mapping.bridge.bus import Bus
from jax_mapping.bridge.mapper import MapperNode
from jax_mapping.bridge.messages import (Header, LaserScan, Odometry, Pose2D,
                                         Twist)
from jax_mapping.sim import lidar
from jax_mapping.sim import world as W

cfg = world_config(C)
world = W.plank_course(700, cfg.grid.resolution_m, n_planks=160, seed=5)
world[350 - 12:350 + 12, 2:-2] = False        # the route's lane, |y| < 0.6 m
poses = course()
res = cfg.grid.resolution_m
n_samples = int(cfg.scan.range_max_m / (res * 0.5))
ranges = np.asarray(lidar.simulate_scans(
    cfg.scan, jnp.asarray(world), res, n_samples,
    jnp.asarray(poses.reshape(-1, 3)))).reshape(len(poses), 2, -1)
bus = Bus()
spill = tempfile.TemporaryDirectory()
m = MapperNode(cfg, bus, n_robots=2, spill_dir=spill.name)
OUT.update(drive(m, m.tf, bus, Header, LaserScan, Odometry, Pose2D, Twist,
                 poses, ranges, jnp.asarray))
OUT["ranges"] = ranges
m.destroy()
spill.cleanup()
'''


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(REFERENCE,
                         tmp_path_factory.mktemp("wstack") / "ref.npz")


@pytest.fixture(scope="module")
def port(ref):
    """The port's windowed MapperNode fed the reference's messages."""
    cfg = _ns["world_config"](C)
    bus = Bus()
    with tempfile.TemporaryDirectory() as spill:
        m = MapperNode(cfg, bus, n_robots=2, device="cpu", spill_dir=spill)
        try:
            out = _ns["drive"](m, m.tf, bus, Header, LaserScan, Odometry,
                               Pose2D, Twist, _ns["course"](), ref["ranges"],
                               torch.as_tensor)
        finally:
            m.destroy()
    return SimpleNamespace(**out)


def test_drive_exercises_both_tiers(ref):
    """The reference drive recentres three times each way and evicts to,
    and rehydrates from, both the host and the disk tier."""
    status = json.loads(str(ref["status"]))
    assert status["shifts"] >= 6 and status["evictions"] > 0
    assert status["rehydrated_host"] > 0 and status["rehydrated_disk"] > 0
    assert status["lost_tiles"] == 0
    assert len(set(map(tuple, ref["origins"]))) >= 4
    assert ref["counts"][1] > 0                   # loop closures


def test_schedule_and_status_match_jax(ref, port):
    assert json.loads(port.schedule) == json.loads(str(ref["schedule"]))
    assert json.loads(port.status) == json.loads(str(ref["status"]))
    assert json.loads(port.spill) == json.loads(str(ref["spill"]))
    np.testing.assert_array_equal(port.counts, ref["counts"])


def test_origin_and_revisions_every_tick_match_jax(ref, port):
    np.testing.assert_array_equal(port.origins, ref["origins"])
    np.testing.assert_array_equal(port.rev, ref["rev"])
    np.testing.assert_array_equal(port.tile_rev, ref["tile_rev"])


def test_leaves_right_after_each_recentre(ref, port):
    """Pose, last key pose, every graph pose row and the correction basis,
    read between the tick's recentre and its step: the recentre moves
    each of them as the JAX node's does."""
    np.testing.assert_array_equal(port.gen, ref["gen"])
    assert port.gen[-1][0] >= 6
    np.testing.assert_allclose(port.leaves, ref["leaves"], rtol=0,
                               atol=1e-3)
    np.testing.assert_array_equal(np.isnan(port.basis),
                                  np.isnan(ref["basis"]))
    np.testing.assert_allclose(port.basis, ref["basis"], rtol=0, atol=1e-3)


def test_keys_and_closures_every_tick(ref, port):
    np.testing.assert_array_equal(port.graph, ref["graph"])


def test_window_estimates_every_tick(ref, port):
    assert port.est.shape == ref["est"].shape
    err = np.abs(port.est - ref["est"])
    assert err[..., :2].max() <= 1e-3, err[..., :2].max()
    assert err[..., 2].max() <= 1e-3


def test_pose_topic_is_world_frame_and_matches_jax(ref, port):
    np.testing.assert_array_equal(port.pose_tick, ref["pose_tick"])
    np.testing.assert_array_equal(port.pose_cov, ref["pose_cov"])
    err = np.abs(port.pose_xyt - ref["pose_xyt"])
    assert err[..., :2].max() <= 1e-3 and err[..., 2].max() <= 1e-3
    # World frame: each tick's /pose is the window-frame estimate plus the
    # offset of the window's origin (64-cell tiles of 0.05 m, origin tile
    # (4, 4) at offset 0).
    off = (port.origins[port.pose_tick] - 4) * 3.2
    np.testing.assert_allclose(
        port.pose_xyt[..., :2],
        port.est[port.pose_tick][..., :2] + off[:, None, ::-1],
        rtol=0, atol=1e-5)
    assert np.abs(off).max() >= 6.4


def test_correction_tfs_every_tick(ref, port):
    err = np.abs(port.tfs - ref["tfs"])
    assert err[..., :2].max() <= 1e-3 and err[..., 2].max() <= 1e-3


def test_frontier_publishes_match_jax(ref, port):
    np.testing.assert_array_equal(port.front_tick, ref["front_tick"])
    np.testing.assert_array_equal(port.front_rev, ref["front_rev"])
    np.testing.assert_array_equal(port.front_assign, ref["front_assign"])
    assert json.loads(port.front_sizes) == json.loads(str(ref["front_sizes"]))
    got = json.loads(port.front_targets)
    want = json.loads(str(ref["front_targets"]))
    assert [len(t) for t in got] == [len(t) for t in want]
    assert sum(len(t) for t in want) > len(want)
    for g, w in zip(got, want):
        if w:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-5)


def test_grid_matches_jax(ref, port):
    got, want = port.grid, ref["grid"]
    assert got.shape == want.shape == (256, 256)
    off = np.abs(got - want) > 2e-6
    assert off.sum() <= 1e-4 * got.size, int(off.sum())
    assert (np.abs(got) > 0).sum() > 1000
