"""The hardware and ROS 2 edges of the port (`native/`, `bridge/ld06_node`,
`ld06_transport`, `teleop`, `joydev`, `rclpy_adapter`, `ros_launch`),
held to the JAX package's own tests.

The JAX package's tests of these modules (`tests/test_native.py`,
`test_ld06_transport.py`, `test_teleop.py`, `test_joydev.py`,
`test_rclpy_adapter.py`, and `test_dds_proof.py`'s topic surface) run
here on the port: each file's source is compiled with its
`jax_mapping.` imports pointed at `jax_mapping_torch.` and the edits of
`PORT_EDITS` (a stack launches with `--device cpu` / `device="cpu"`; a
JAX array becomes a tensor), and its tests are collected under a
`<file>__` prefix. The files are read, never imported, and nothing of
them is copied into the repo. The rclpy stub is the JAX package's own
(`stub_ros`, imported from tests/test_rclpy_adapter.py); `tiny_cfg` is
the port's.

Then the port's own checks: the C++ parser decodes the same bytes to the
same arrays as the JAX package's, the library builds into the port's own
`native/build/`, and `ros_launch.main` without `--device cpu` and
without a card raises instead of falling back.
"""

import types

import numpy as np
import pytest
import torch

from tests.test_rclpy_adapter import stub_ros  # noqa: F401
from tests.torch_jaxref import REPO, run_reference

#: Per file: the JAX tests that do not apply to the port, and the edits
#: that point the rest at the CPU (the port runs on the card unless
#: asked) or at torch.
PORT_EDITS = {
    "test_native": {
        "skip_tests": (),
        "edits": [
            ("import jax.numpy as jnp", "import torch as jnp"),
            ("jnp.asarray(world)", "jnp.as_tensor(world)"),
        ],
    },
    "test_ld06_transport": {"skip_tests": (), "edits": []},
    "test_teleop": {"skip_tests": (), "edits": [
        ("ThymioBrain(tiny_cfg, bus, driver)",
         'ThymioBrain(tiny_cfg, bus, driver, device="cpu")')]},
    "test_joydev": {"skip_tests": (), "edits": [
        ("ThymioBrain(tiny_cfg, bus, driver)",
         'ThymioBrain(tiny_cfg, bus, driver, device="cpu")')]},
    "test_rclpy_adapter": {
        "skip_tests": (),
        "edits": [
            ('ros_launch.main(["--world"', 'ros_launch.main(["--device", '
             '"cpu", "--world"'),
            ('ros_launch.main(["--live-hardware"',
             'ros_launch.main(["--device", "cpu", "--live-hardware"'),
            ("launch_sim_stack(tiny_cfg, world, n_robots=1)",
             'launch_sim_stack(tiny_cfg, world, n_robots=1, device="cpu")'),
            ("launch_sim_stack(tiny_cfg, world, n_robots=2)",
             'launch_sim_stack(tiny_cfg, world, n_robots=2, device="cpu")'),
            ("mapper = MapperNode(tiny_cfg, bus, n_robots=1)",
             'mapper = MapperNode(tiny_cfg, bus, n_robots=1, device="cpu")'),
            ("vm = VoxelMapperNode(tiny_cfg, bus, n_robots=1)",
             'vm = VoxelMapperNode(tiny_cfg, bus, n_robots=1, device="cpu")'),
            ("import jax.numpy as jnp", "import torch as jnp"),
            ("world = jnp.asarray(W.empty_arena(",
             "world = jnp.as_tensor(W.empty_arena("),
            ("jnp.asarray([[x, 0.0, 0.0]])", "jnp.tensor([[x, 0.0, 0.0]])"),
        ],
    },
    # Only the adapter's topic surface: the kit's compose file launches
    # the JAX package's entry point.
    "test_dds_proof": {
        "skip_tests": ("test_kit_files_present_and_executable",
                       "test_compose_parses_and_wires_the_stack",
                       "test_probe_fails_loudly"),
        "edits": [],
    },
}


def _port_source(name: str) -> str:
    src = (REPO / "tests" / f"{name}.py").read_text()
    src = src.replace("from jax_mapping import ", "from jax_mapping_torch "
                      "import ").replace("jax_mapping.", "jax_mapping_torch.")
    for old, new in PORT_EDITS[name]["edits"]:
        assert old in src, (name, old)
        src = src.replace(old, new)
    assert "import jax" not in src.replace("import jax_mapping_torch", ""), \
        name
    return src


def _collect(name: str) -> dict:
    """{collected name: test function or fixture} of one JAX test file
    compiled against the port."""
    mod = types.ModuleType(f"tests._port_{name}")
    mod.__file__ = str(REPO / "tests" / f"{name}.py")
    exec(compile(_port_source(name), f"<port of tests/{name}.py>", "exec"),
         mod.__dict__)
    out = {}
    for key, obj in vars(mod).items():
        if key.startswith("test_"):
            if key not in PORT_EDITS[name]["skip_tests"]:
                out[f"test_{name[5:]}__{key[5:]}"] = obj
    return out


for _name in PORT_EDITS:
    globals().update(_collect(_name))


@pytest.fixture(scope="module")
def tiny_cfg():
    from jax_mapping_torch.config import tiny_config
    return tiny_config()


# ------------------------------------------------------------ the port's own

def test_parser_decodes_like_the_jax_package(tmp_path):
    """The same wire bytes (resyncs, a CRC-corrupted packet, low
    confidences, two rotations) decode to the same ranges, intensities
    and counters in both packages' parsers."""
    rng = np.random.default_rng(5)
    ranges = rng.uniform(0.05, 11.0, (3, 360)).astype(np.float32)
    ranges[1, ::17] = 0.0
    conf = rng.integers(0, 255, (3, 360)).astype(np.int32)
    np.save(tmp_path / "ranges.npy", ranges)
    np.save(tmp_path / "conf.npy", conf)
    script = f"""
        from jax_mapping.native import Ld06Parser, encode_packets
        ranges = np.load({str(tmp_path / 'ranges.npy')!r})
        conf = np.load({str(tmp_path / 'conf.npy')!r})
        wire = bytearray(b"\\x00\\x54garbage")
        for i in range(3):
            wire += encode_packets(ranges[i], conf[i], timestamp_ms=40 * i)
        wire[200] ^= 0x40
        OUT["wire"] = np.frombuffer(bytes(wire), np.uint8)
        p = Ld06Parser(n_beams=360)
        p.feed(bytes(wire))
        k = 0
        while True:
            s = p.take_scan()
            if s is None:
                break
            OUT[f"r{{k}}"], OUT[f"i{{k}}"] = s
            k += 1
        OUT["stats"] = np.array(sorted(p.stats().items()), dtype=object
                                ).astype(str)
    """
    ref = run_reference(script, tmp_path / "ld06.npz", timeout=300)
    from jax_mapping_torch.native import Ld06Parser, encode_packets
    wire = bytearray(b"\x00\x54garbage")
    for i in range(3):
        wire += encode_packets(ranges[i], conf[i], timestamp_ms=40 * i)
    wire[200] ^= 0x40
    assert bytes(wire) == ref["wire"].tobytes()
    p = Ld06Parser(n_beams=360)
    p.feed(bytes(wire))
    k = 0
    while True:
        s = p.take_scan()
        if s is None:
            break
        np.testing.assert_array_equal(s[0], ref[f"r{k}"])
        np.testing.assert_array_equal(s[1], ref[f"i{k}"])
        k += 1
    assert k >= 1 and f"r{k}" not in ref
    assert np.array(sorted(p.stats().items()), dtype=object).astype(
        str).tolist() == ref["stats"].tolist()
    assert p.stats()["crc_errors"] == 1


def test_library_builds_into_the_ports_tree():
    from jax_mapping_torch.native import ld06
    assert ld06.native_available()
    assert ld06._SO.startswith(str(REPO / "jax_mapping_torch" / "native"))
    assert ld06._lib._name == ld06._SO


def test_ros_launch_without_a_card_raises(monkeypatch, stub_ros):
    """Without `--device cpu` the stack goes to the card; with none, the
    launch raises rather than fall back to the CPU."""
    from jax_mapping_torch import ros_launch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ros_launch.main(["--world", "arena", "--world-cells", "96",
                         "--duration-s", "0.05"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ros_launch.main(["--live-hardware", "--duration-s", "0.05"])


def test_ros_launch_exits_2_without_rclpy(capsys):
    from jax_mapping_torch import ros_launch
    from jax_mapping_torch.bridge.rclpy_adapter import rclpy_available
    assert not rclpy_available()
    assert ros_launch.main(["--device", "cpu"]) == 2
    assert "rclpy is not importable" in capsys.readouterr().err


def test_rviz_config_is_the_ports_copy():
    from jax_mapping_torch import ros_launch
    path = ros_launch.rviz_config_path()
    assert path == str(REPO / "jax_mapping_torch" / "configs"
                       / "jax_mapping.rviz")
    assert open(path).read() == (REPO / "jax_mapping" / "configs"
                                 / "jax_mapping.rviz").read_text()


def test_adapter_converts_tensor_payloads(tiny_cfg, stub_ros):
    """A payload the port carries as a tensor converts like its numpy
    twin: a LaserScan's ranges and a frontier array's targets."""
    from jax_mapping_torch.bridge.bus import Bus
    from jax_mapping_torch.bridge.messages import FrontierArray, Header, \
        LaserScan
    from jax_mapping_torch.bridge.rclpy_adapter import RclpyAdapter
    bus = Bus()
    ad = RclpyAdapter(bus, tiny_cfg)
    r = torch.linspace(0.1, 3.0, 8)
    got = ad.scan_to_ros(LaserScan(header=Header(stamp=1.0), ranges=r))
    want = ad.scan_to_ros(LaserScan(header=Header(stamp=1.0),
                                    ranges=r.numpy()))
    assert got.ranges == want.ranges == [float(x) for x in r.numpy()]
    for targets in (torch.tensor([[1.0, 2.0]]), np.array([[1.0, 2.0]],
                                                         np.float32)):
        bus.publisher("/frontiers").publish(FrontierArray(
            header=Header(stamp=1.0), targets_xy=targets,
            sizes=torch.tensor([3]), assignment=torch.tensor([0])))
    a, b = ad.node.pubs["/frontiers_markers"].published[-2:]
    assert len(a.markers) == len(b.markers) == 2
    assert a.markers[1].pose.position.y == b.markers[1].pose.position.y \
        == pytest.approx(2.0)
