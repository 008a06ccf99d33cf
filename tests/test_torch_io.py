"""Trace record/replay and map priors in the port (`io/trace.py`,
`io/rosmap.py`, the demo's `--record`, `--replay` and `--map-prior`),
against the JAX package's.

Mirrors `tests/test_io.py`'s trace tests and `tests/test_rosmap.py` on
the port's modules, and carries files across the two packages: one JAX
reference run (a fresh `JAX_PLATFORMS=cpu` subprocess) records a
tiny_config(2) stack for 40 steps with its `TraceRecorder`, replays that
bag and a bag the port's demo recorded through its own mapper as the
JAX demo's `--replay` does, and writes and reads ROS maps beside the
port's. The port's `--replay` of the JAX bag must give the JAX replay's
counters exactly, and its grid and poses within the teacher-forced
`MapperNode`'s tolerance (cells off by more than 2e-6: at most 1e-4 of
them; poses to 1e-6 m, ROADMAP C).
"""

import dataclasses
import json
import time

import numpy as np
import pytest
import torch

from jax_mapping_torch import demo
from jax_mapping_torch.bridge.bus import Bus
from jax_mapping_torch.bridge.mapper import MapperNode
from jax_mapping_torch.config import tiny_config
from jax_mapping_torch.io import TraceRecorder, TraceReplayer, rosmap
from tests.torch_jaxref import ONE_XLA_THREAD, run_reference
from tests.torch_threads import one_intra_op_thread  # noqa: F401

REC_STEPS = 40

_REF = '''
from jax_mapping.bridge.bus import Bus
from jax_mapping.bridge.launch import launch_sim_stack
from jax_mapping.bridge.mapper import MapperNode
from jax_mapping.config import tiny_config
from jax_mapping.io import rosmap
from jax_mapping.io.trace import TraceRecorder, TraceReplayer
from jax_mapping.ops import grid as G
from jax_mapping.sim import world as W

cfg = tiny_config(2)
world = W.plank_course(96, cfg.grid.resolution_m, n_planks=4, seed=3)
st = launch_sim_stack(cfg, world, n_robots=2, seed=0)
rec = TraceRecorder(st.bus, ["robot0/scan", "robot0/odom", "robot1/scan",
                             "robot1/odom"])
st.brain.start_exploring()
st.run_steps(STEPS)
rec.stop()
OUT["jax_bag.n"] = rec.save(JAX_BAG, config_json=cfg.to_json())
st.shutdown()


def replay(path):
    """The JAX demo's _replay_main loop, without its CLI."""
    bus = Bus()
    mapper = MapperNode(cfg, bus, n_robots=2)
    pubs, n = {}, 0
    for _stamp, topic, msg in TraceReplayer(path).messages():
        if topic not in pubs:
            pubs[topic] = bus.publisher(topic)
        pubs[topic].publish(msg)
        n += 1
        if n % 40 == 0:
            mapper.tick()
    for _ in range(4):
        mapper.tick()
    occ = np.asarray(G.to_occupancy(cfg.grid, mapper.merged_grid()))
    return mapper, np.array([n, int((occ == 0).sum()),
                             int((occ == 100).sum()), mapper.n_scans_fused,
                             mapper.n_scans_dropped_unpaired])


m, OUT["jax_bag.counts"] = replay(JAX_BAG)
OUT["jax_bag.grid"] = np.asarray(m.merged_grid())
OUT["jax_bag.poses"] = np.stack([np.asarray(s.pose) for s in m.states])
_m, OUT["port_bag.counts"] = replay(PORT_BAG)
rep = TraceReplayer(PORT_BAG)
OUT["port_bag.topics"] = np.array([r["topic"] for r in rep.index])
OUT["port_bag.config_ok"] = np.asarray(rep.config_json == cfg.to_json())

# Maps across the packages: one written here, the port's read here.
occ = np.random.default_rng(5).choice(np.array([-1, 0, 100], np.int8),
                                      size=(40, 56))
rosmap.save_map(JAX_MAP, occ, 0.05, (-1.4, -1.0))
OUT["map.jax_occ"] = occ
port_occ, res, origin = rosmap.load_map(PORT_MAP + ".yaml")
OUT["map.port_read"] = port_occ
OUT["map.port_meta"] = np.array([res, *origin])
'''


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The port's bag and map first, then the reference (which records
    its own bag and map and reads the port's)."""
    d = tmp_path_factory.mktemp("io")
    port_bag = str(d / "port_bag.npz")
    assert demo.main(["--device", "cpu", "--steps", "20", "--robots", "2",
                      "--record", port_bag]) == 0
    port_occ = np.random.default_rng(6).choice(
        np.array([-1, 0, 100], np.int8), size=(24, 32))
    rosmap.save_map(str(d / "port_map"), port_occ, 0.1, (2.0, -3.5))
    paths = {"JAX_BAG": str(d / "jax_bag.npz"), "PORT_BAG": port_bag,
             "JAX_MAP": str(d / "jax_map"), "PORT_MAP": str(d / "port_map")}
    src = ONE_XLA_THREAD + "".join(f"{k} = {v!r}\n"
                                for k, v in paths.items()) \
        + f"STEPS = {REC_STEPS}\n" + _REF
    ref = run_reference(src, d / "ref.npz")
    return {"dir": d, "ref": ref, "port_occ": port_occ, **paths}


def _replay_summary(capsys, argv) -> dict:
    capsys.readouterr()
    assert demo.main(["--device", "cpu"] + argv) == 0
    out = capsys.readouterr().out
    return json.loads(out[out.index("{"):])


# ---------------------------------------------------------------------------
# Bags across the packages
# ---------------------------------------------------------------------------

def test_port_replays_a_jax_bag_with_jax_counters(files, capsys):
    """`--replay` of the JAX stack's bag: the same messages replayed,
    scans fused and dropped, free and occupied cells as the JAX replay."""
    s = _replay_summary(capsys, ["--robots", "2", "--replay",
                                 files["JAX_BAG"]])
    n, free, occ, fused, dropped = files["ref"]["jax_bag.counts"].tolist()
    assert s["replayed"] == n == int(files["ref"]["jax_bag.n"])
    assert (s["cells_free"], s["cells_occupied"]) == (free, occ)
    assert (s["scans_fused"], s["scans_dropped_unpaired"]) == \
        (fused, dropped)
    assert fused >= REC_STEPS and occ > 0


def test_port_replay_grid_and_poses_match_jax(files):
    """The demo's replay loop (`demo.replay_bag`, which `--replay` runs):
    grid and poses as the JAX replay's, to the teacher-forced
    MapperNode's tolerance."""
    m, voxel, n = demo.replay_bag(TraceReplayer(files["JAX_BAG"]),
                                  tiny_config(2), 2, "cpu")
    assert voxel is None and n == int(files["ref"]["jax_bag.n"])
    ref = files["ref"]
    got = m.merged_grid().numpy()
    off = np.abs(got - ref["jax_bag.grid"]) > 2e-6
    assert off.sum() <= 1e-4 * got.size, int(off.sum())
    poses = np.stack([s.pose.numpy() for s in m.states])
    np.testing.assert_allclose(poses, ref["jax_bag.poses"], rtol=0,
                               atol=1e-6)


def test_jax_replays_a_port_bag(files, capsys):
    """The port's bag reads in the JAX package: every topic, the
    recording config, and the same replay counters as the port's."""
    ref = files["ref"]
    topics = set(ref["port_bag.topics"].tolist())
    assert topics == {"robot0/scan", "robot0/odom", "robot1/scan",
                      "robot1/odom"}
    assert bool(ref["port_bag.config_ok"])
    s = _replay_summary(capsys, ["--robots", "2", "--replay",
                                 files["PORT_BAG"]])
    n, free, occ, fused, dropped = ref["port_bag.counts"].tolist()
    assert (s["replayed"], s["scans_fused"],
            s["scans_dropped_unpaired"]) == (n, fused, dropped)
    assert (s["cells_free"], s["cells_occupied"]) == (free, occ)
    assert n == len(TraceReplayer(files["PORT_BAG"])) and fused > 0


def test_replay_refusals(files, capsys):
    """The namespace-cover check, the config check and the clash list,
    each with rc 2 and the JAX demo's message."""
    capsys.readouterr()
    bag = files["JAX_BAG"]
    assert demo.main(["--device", "cpu", "--robots", "3", "--replay",
                      bag]) == 2
    assert "do not cover" in capsys.readouterr().err
    c2 = tiny_config(2)
    other = c2.replace(matcher=dataclasses.replace(c2.matcher,
                                                   min_response=0.2))
    path = files["dir"] / "other.json"
    path.write_text(other.to_json())
    assert demo.main(["--device", "cpu", "--robots", "2", "--replay", bag,
                      "--config", str(path)]) == 2
    assert "different config" in capsys.readouterr().err
    for flag in (["--record", "x"], ["--resume", "x"], ["--depth-cam"]):
        assert demo.main(["--device", "cpu", "--robots", "2", "--replay",
                          bag] + flag) == 2
        assert "cannot be combined with " + flag[0] in \
            capsys.readouterr().err
    assert demo.main(["--device", "cpu", "--robots", "2", "--replay", bag,
                      "--voxel-out", "v.png"]) == 2
    assert "no depth topics" in capsys.readouterr().err


def test_depth_bag_rebuilds_the_voxel_map(tmp_path, capsys):
    """A bag recorded with --depth-cam carries each robot's depth topic,
    and its replay runs a VoxelMapperNode beside the mapper."""
    bag = str(tmp_path / "depth.npz")
    assert demo.main(["--device", "cpu", "--steps", "6", "--robots", "2",
                      "--depth-cam", "--record", bag]) == 0
    topics = {r["topic"] for r in TraceReplayer(bag).index}
    assert {"robot0/depth", "robot1/depth"} <= topics
    png = tmp_path / "v.png"
    s = _replay_summary(capsys, ["--robots", "2", "--replay", bag,
                                 "--voxel-out", str(png)])
    assert s["depth_images_fused"] > 0 and s["voxels_occupied"] > 0
    assert png.read_bytes().startswith(b"\x89PNG")


# ---------------------------------------------------------------------------
# The trace format (tests/test_io.py)
# ---------------------------------------------------------------------------

def test_trace_record_replay_golden(tmp_path):
    """A live run's /scan + /odom replayed into a fresh mapper rebuilds
    the live map (test_io.py:181)."""
    from jax_mapping_torch.bridge.launch import launch_sim_stack
    from jax_mapping_torch.sim import world as W
    cfg = tiny_config(1)
    world = W.plank_course(96, cfg.grid.resolution_m, n_planks=3, seed=9)
    stack = launch_sim_stack(cfg, world, n_robots=1, device="cpu")
    try:
        rec = TraceRecorder(stack.bus, ["scan", "odom"])
        stack.brain.start_exploring()
        stack.run_steps(20)
        live_grid = stack.mapper.merged_grid().numpy()
        path = str(tmp_path / "run.trace.npz")
        n = rec.save(path)
        assert n > 20
    finally:
        stack.shutdown()
    bus = Bus()
    mapper = MapperNode(cfg, bus, n_robots=1, device="cpu")
    player = TraceReplayer(path)
    assert len(player) == n
    assert player.replay(bus, speed=None) == n
    mapper.tick()
    rep_occ = int((mapper.merged_grid() > 0.5).sum())
    live_occ = int((live_grid > 0.5).sum())
    assert rep_occ > 0
    assert abs(live_occ - rep_occ) < max(60, 0.35 * live_occ)


def test_trace_replay_realtime_timing(tmp_path):
    """speed=K respects relative stamps (test_io.py:217)."""
    from jax_mapping_torch.bridge.messages import Header, LaserScan
    bus = Bus()
    rec = TraceRecorder(bus, ["scan"])
    pub = bus.publisher("scan")
    for i in range(4):
        pub.publish(LaserScan(header=Header(stamp=i * 0.1),
                              ranges=np.arange(5, dtype=np.float32)))
    path = str(tmp_path / "t.trace.npz")
    rec.save(path)
    out = Bus()
    sub = out.subscribe("scan", callback=lambda m: None)
    t0 = time.monotonic()
    TraceReplayer(path).replay(out, speed=2.0)
    assert 0.10 < time.monotonic() - t0 < 1.0
    assert sub.n_received == 4


def test_trace_message_fidelity(tmp_path):
    """Every allowlisted type survives the round trip field for field
    (test_io.py:239)."""
    from jax_mapping_torch.bridge.messages import (
        DepthImage, Header, LaserScan, MapMetaData, OccupancyGrid,
        Odometry, Pose2D, Twist)
    bus = Bus()
    rec = TraceRecorder(bus, ["a", "b", "c", "d"])
    scan = LaserScan(header=Header(stamp=1.5, frame_id="laser"),
                     angle_increment=0.2,
                     ranges=np.array([1.0, 2.0, 0.0], np.float32))
    odom = Odometry(header=Header(stamp=1.6, frame_id="odom"),
                    pose=Pose2D(1.0, -2.0, 0.3),
                    twist=Twist(linear_x=0.1, angular_z=-0.5))
    grid = OccupancyGrid(header=Header(stamp=1.7, frame_id="map"),
                         info=MapMetaData(resolution=0.05, width=2, height=1,
                                          origin=Pose2D(-1, -1, 0)),
                         data=np.array([0, 100], np.int8))
    depth = DepthImage(header=Header(stamp=1.8, frame_id="cam"),
                       depth=np.arange(6, dtype=np.float32).reshape(2, 3))
    for topic, msg in zip("abcd", (scan, odom, grid, depth)):
        bus.publisher(topic).publish(msg)
    path = str(tmp_path / "f.trace.npz")
    rec.save(path)
    msgs = {t: m for _, t, m in TraceReplayer(path).messages()}
    assert msgs["a"].header.frame_id == "laser"
    np.testing.assert_array_equal(msgs["a"].ranges, scan.ranges)
    assert msgs["a"].angle_increment == pytest.approx(0.2)
    assert msgs["b"].pose.theta == pytest.approx(0.3)
    assert msgs["b"].twist.angular_z == pytest.approx(-0.5)
    assert msgs["c"].info.origin.x == pytest.approx(-1)
    np.testing.assert_array_equal(msgs["c"].data, grid.data)
    np.testing.assert_array_equal(msgs["d"].depth, depth.depth)


def test_trace_refuses_unlisted_types(tmp_path):
    """No pickle: a message type outside the allowlist is refused."""
    from jax_mapping_torch.bridge.messages import Heartbeat
    bus = Bus()
    rec = TraceRecorder(bus, ["hb"])
    bus.publisher("hb").publish(Heartbeat())
    with pytest.raises(TypeError, match="cannot record Heartbeat"):
        rec.save(str(tmp_path / "x.npz"))


# ---------------------------------------------------------------------------
# ROS maps (tests/test_rosmap.py)
# ---------------------------------------------------------------------------

def test_maps_read_across_the_packages(files):
    """A map the JAX package wrote reads in the port, and the port's in
    the JAX package, bit for bit with their metadata."""
    occ, res, origin = rosmap.load_map(files["JAX_MAP"] + ".yaml")
    assert (res, origin) == (0.05, (-1.4, -1.0))
    assert occ.dtype == np.int8
    assert np.array_equal(occ, files["ref"]["map.jax_occ"])
    assert np.array_equal(files["ref"]["map.port_read"], files["port_occ"])
    assert files["ref"]["map.port_meta"].tolist() == [0.1, 2.0, -3.5]


def test_pgm_format_pinned(tmp_path):
    """P5 header, 255 maxval, trinary pixels, grid row 0 at the image
    bottom (test_rosmap.py:37)."""
    occ = np.full((4, 3), -1, np.int8)
    occ[0, 0] = 100
    occ[3, 2] = 0
    pgm, _ = rosmap.save_map(str(tmp_path / "m"), occ, 0.05, (0.0, 0.0))
    raw = open(pgm, "rb").read()
    assert raw.startswith(b"P5\n3 4\n255\n")
    px = np.frombuffer(raw[len(b"P5\n3 4\n255\n"):], np.uint8).reshape(4, 3)
    assert px[3, 0] == 0 and px[0, 2] == 254 and px[1, 1] == 205


def test_load_foreign_negate_and_thresholds(tmp_path):
    px = np.array([[0, 128, 255]], np.uint8)
    with open(tmp_path / "f.pgm", "wb") as f:
        f.write(b"P5\n3 1\n255\n" + px.tobytes())
    (tmp_path / "f.yaml").write_text(
        "image: f.pgm\nresolution: 0.1\norigin: [0.0, 0.0, 0.0]\n"
        "negate: 1\noccupied_thresh: 0.9\nfree_thresh: 0.1\n")
    occ, _res, _origin = rosmap.load_map(str(tmp_path / "f.yaml"))
    assert occ[0, 0] == 0 and occ[0, 1] == -1 and occ[0, 2] == 100


def test_embed_offsets_and_clip():
    g = tiny_config().grid
    occ = np.full((10, 10), 0, np.int8)
    occ[5, 5] = 100
    ox, oy = g.origin_m
    out = rosmap.embed_in_grid(occ, g.resolution_m, (ox + 1.0, oy + 1.0), g)
    k = round(1.0 / g.resolution_m)
    assert out[k + 5, k + 5] == 100 and out[k, k] == 0 and out[0, 0] == -1
    with pytest.raises(ValueError):
        rosmap.embed_in_grid(occ, g.resolution_m * 2, (0, 0), g)


def test_load_rejects_rotated_origin(tmp_path):
    px = np.full((2, 2), 254, np.uint8)
    with open(tmp_path / "r.pgm", "wb") as f:
        f.write(b"P5\n2 2\n255\n" + px.tobytes())
    (tmp_path / "r.yaml").write_text(
        "image: r.pgm\nresolution: 0.05\norigin: [0.0, 0.0, 1.57]\n"
        "negate: 0\n")
    with pytest.raises(ValueError, match="yaw"):
        rosmap.load_map(str(tmp_path / "r.yaml"))


def test_logodds_prior_values():
    lo = rosmap.logodds_prior(np.array([[-1, 0, 100]], np.int8))
    assert lo[0, 0] == 0.0 and lo[0, 1] == -2.0 and lo[0, 2] == 2.0


def test_seed_mapper_installs_the_prior(tmp_path):
    """seed_mapper: load, embed, log-odds prior, `seed_map_prior`; the
    mapper's shared grid is the prior, and a wrong shape is refused."""
    cfg = tiny_config(1)
    occ = np.full((32, 32), 0, np.int8)
    occ[0, :] = 100
    _pgm, yaml = rosmap.save_map(str(tmp_path / "prior"), occ, 0.05,
                                 (-0.8, -0.8))
    m = MapperNode(cfg, Bus(), n_robots=1, device="cpu")
    assert rosmap.seed_mapper(m, yaml, cfg.grid) == 32
    grid = m.merged_grid().numpy()
    assert (grid == 2.0).sum() == 32 and (grid == -2.0).sum() == 32 * 31
    assert m.map_prior() is not None
    with pytest.raises(ValueError):
        m.seed_map_prior(np.zeros((8, 8), np.float32))


def test_demo_map_prior_cli(tmp_path, capsys):
    """--map-prior seeds the demo's mapper and says so; with --resume, or
    on a map it cannot read, the demo refuses with rc 2
    (test_rosmap.py:287, :307)."""
    occ = np.full((32, 32), 0, np.int8)
    occ[0, :] = 100
    _pgm, yaml = rosmap.save_map(str(tmp_path / "prior"), occ, 0.05,
                                 (-0.8, -0.8))
    base = ["--device", "cpu", "--world", "arena", "--world-cells", "96"]
    capsys.readouterr()
    assert demo.main(base + ["--steps", "2", "--map-prior", yaml,
                             "--localization"]) == 0
    assert "seeded map prior" in capsys.readouterr().out
    assert demo.main(base + ["--steps", "1", "--map-prior", yaml,
                             "--resume", "nope.npz"]) == 2
    assert "pick one" in capsys.readouterr().err
    assert demo.main(base + ["--steps", "1", "--map-prior",
                             str(tmp_path / "nope.yaml")]) == 2
    assert "cannot seed --map-prior" in capsys.readouterr().err


def test_localization_on_a_prior_keeps_the_map(tmp_path):
    """--localization on a seeded prior: the robots track poses and the
    shared grid stays the prior (the use a map_server import serves)."""
    from jax_mapping_torch.bridge.launch import launch_sim_stack
    from jax_mapping_torch.sim import world as W
    cfg = tiny_config(1).replace(mode="localization")
    world = W.empty_arena(96, cfg.grid.resolution_m)
    occ = np.full((96, 96), 0, np.int8)
    occ[:2, :] = occ[-2:, :] = occ[:, :2] = occ[:, -2:] = 100
    g = cfg.grid
    n = g.size_cells
    origin = (g.origin_m[0] + (n - 96) // 2 * g.resolution_m,
              g.origin_m[1] + (n - 96) // 2 * g.resolution_m)
    _pgm, yaml = rosmap.save_map(str(tmp_path / "arena"), occ,
                                 g.resolution_m, origin)
    st = launch_sim_stack(cfg, world, n_robots=1, device="cpu")
    try:
        rosmap.seed_mapper(st.mapper, yaml, cfg.grid)
        prior = st.mapper.merged_grid().clone()
        st.brain.start_exploring()
        st.run_steps(10)
        assert torch.equal(st.mapper.merged_grid(), prior)
        assert np.isfinite(st.mapper.states[0].pose.numpy()).all()
    finally:
        st.shutdown()
