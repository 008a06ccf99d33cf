"""The port's HTTP API (`bridge/http_api.py`) against the JAX package's.

The JAX suite's HTTP tests on the port's stack at tiny_config on the CPU:
`test_stack.py`'s endpoints and start/stop contract, `test_bridge.py`'s
save/load round trip and config-drift refusal, `test_resilience.py`'s 503
answers (a wedged brain lock, a dead mapper), `test_rosmap.py`'s
`/save-map` and re-import, `test_voxel_bridge.py`'s four HTTP tests,
`test_planner.py`'s `/goal`, and `test_world.py`'s windowed serving
surface.

Across the packages (one JAX reference run in a fresh `JAX_PLATFORMS=cpu`
subprocess, `tests/torch_jaxref.py`): the JAX package's `DeltaMapClient`
(it imports no JAX) polls the port's server and rebuilds the port's map;
a port `POST /save` loads in JAX bit-equal; a fresh mapper of each package
seeded with the grid of a JAX stack's run serves byte-equal `/tiles`
bodies and `/map-image` PNGs; and with obs disabled the same stack script
run by each package (each in a fresh process, since the stage and counter
registries are process-wide) exports the same `/metrics` family names.
"""

import dataclasses
import io
import json
import re
import subprocess
import sys
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from jax_mapping_torch.bridge import png as png_codec
from jax_mapping_torch.bridge.bus import Bus
from jax_mapping_torch.bridge.http_api import MapApiServer
from jax_mapping_torch.bridge.launch import launch_sim_stack
from jax_mapping_torch.bridge.mapper import MapperNode
from jax_mapping_torch.config import tiny_config
from jax_mapping_torch.io import rosmap
from jax_mapping_torch.ops import grid as G
from jax_mapping_torch.serving.client import DeltaMapClient
from jax_mapping_torch.sim import world as W
from tests.torch_jaxref import REPO, clean_cpu_env, run_reference
from tests.torch_threads import one_intra_op_thread  # noqa: F401

T = 10          # urlopen timeout, seconds


def _get(url):
    return urllib.request.urlopen(url, timeout=T)


def _post(url):
    return urllib.request.urlopen(
        urllib.request.Request(url, method="POST"), timeout=T)


def _base(st) -> str:
    return f"http://127.0.0.1:{st.api.port}"


@pytest.fixture(scope="module")
def stack():
    cfg = tiny_config(2)
    world = W.plank_course(96, cfg.grid.resolution_m, n_planks=4, seed=3)
    st = launch_sim_stack(cfg, world, n_robots=2, http_port=0,
                          realtime=False, device="cpu")
    st.brain.start_exploring()
    st.run_steps(15)
    yield st
    st.shutdown()


# ------------------------------------------------------ test_stack.py

def test_stack_http_endpoints(stack):
    stack.mapper.publish_map()
    base = _base(stack)
    with _get(f"{base}/status") as r:
        st = json.loads(r.read())
    assert st["connected"] and st["n_robots"] == 2
    assert st["n_scans_fused"] == stack.mapper.n_scans_fused > 0

    with _get(f"{base}/map-image") as r:
        body = r.read()
        assert r.headers["Content-Type"] == "image/png"
    img = png_codec.decode_gray(body)
    assert img.shape == (stack.cfg.grid.size_cells,) * 2
    assert set(np.unique(img)) <= {0, 127, 255}

    hits0 = stack.api.n_png_cache_hits
    with _get(f"{base}/map-image") as r:
        assert r.read() == body
    assert stack.api.n_png_cache_hits == hits0 + 1

    with _get(f"{base}/frontiers") as r:
        fr = json.loads(r.read())
    assert len(fr["assignment"]) == 2

    with _get(f"{base}/metrics") as r:
        text = r.read().decode()
    assert "jax_mapping_brain_ticks_total" in text

    for route, code in (("/nope", 404), ("/trace", 404), ("/load", 405),
                        ("/voxel-image", 404)):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(base + route)
        assert ei.value.code == code, route


def test_stack_start_stop_contract(stack):
    base = _base(stack)
    with _get(f"{base}/stop") as r:
        assert json.loads(r.read())["status"] == "exploration stopped"
    assert not stack.brain.is_exploring
    assert np.all(stack.driver.targets() == 0)
    stack.run_steps(3)
    assert np.all(stack.driver.targets() == 0)
    with _get(f"{base}/start") as r:
        assert json.loads(r.read())["status"] == "exploration started"
    assert stack.brain.is_exploring


# ------------------------------------------------------ test_bridge.py

def test_http_save_load_roundtrip(tmp_path):
    """/save, then /load over a wiped state, restores the live grid; GET
    must not mutate."""
    from jax_mapping_torch.models import slam as S
    cfg = tiny_config()
    world = W.plank_course(96, cfg.grid.resolution_m, n_planks=4, seed=3)
    st = launch_sim_stack(cfg, world, n_robots=1, http_port=0, seed=3,
                          device="cpu")
    try:
        st.api.checkpoint_dir = str(tmp_path)
        st.brain.start_exploring()
        st.run_steps(15)
        grid_before = st.mapper.states[0].grid.clone()
        assert grid_before.abs().sum() > 0
        url = _base(st)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(url + "/save")
        assert ei.value.code == 405
        assert json.loads(_post(url + "/save").read())["status"] == "saved"
        st.mapper.states[0] = S.init_state(cfg, device="cpu")
        assert st.mapper.states[0].grid.abs().sum() == 0
        body = json.loads(_post(url + "/load").read())
        assert body["status"] == "loaded"
        assert torch.equal(st.mapper.states[0].grid, grid_before)
    finally:
        st.shutdown()


def test_http_load_refuses_config_drift(tmp_path):
    from jax_mapping_torch.io.checkpoint import save_checkpoint
    from jax_mapping_torch.models import slam as S
    cfg = tiny_config()
    other = dataclasses.replace(
        cfg, matcher=dataclasses.replace(cfg.matcher, min_response=0.42))
    save_checkpoint(str(tmp_path / "drift.npz"),
                    [S.init_state(cfg, device="cpu")],
                    config_json=other.to_json())
    world = W.plank_course(96, cfg.grid.resolution_m, n_planks=2, seed=1)
    st = launch_sim_stack(cfg, world, n_robots=1, http_port=0,
                          device="cpu")
    try:
        st.api.checkpoint_dir = str(tmp_path)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(_base(st) + "/load?name=drift")
        assert ei.value.code == 409
        assert "config" in json.loads(ei.value.read())["error"]
    finally:
        st.shutdown()


# -------------------------------------------------- test_resilience.py

def test_http_status_503_when_brain_lock_wedged():
    cfg = tiny_config()
    world = W.plank_course(96, cfg.grid.resolution_m, n_planks=3, seed=3)
    st = launch_sim_stack(cfg, world, n_robots=1, http_port=0,
                          device="cpu")
    try:
        st.run_steps(3)
        st.api.lock_timeout_s = 0.1
        url = _base(st) + "/status"
        assert json.load(_get(url))["connected"]
        st.brain._state_lock.acquire()
        try:
            with pytest.raises(urllib.error.HTTPError) as ei:
                _get(url)
            assert ei.value.code == 503
            assert json.load(ei.value)["state"] == "degraded"
        finally:
            st.brain._state_lock.release()
        assert json.load(_get(url))["connected"]
        assert st.api.n_degraded_responses == 1
    finally:
        st.shutdown()


def test_http_mutations_503_while_mapper_dead(tmp_path):
    """Between the supervisor's dead declaration and the restart, /save
    answers 503 degraded; after the restart (which rebinds the API onto
    the new mapper) it works again, and /tiles serves the new epoch."""
    cfg = tiny_config()
    world = W.plank_course(96, cfg.grid.resolution_m, n_planks=3, seed=3)
    st = launch_sim_stack(cfg, world, n_robots=1, http_port=0,
                          checkpoint_dir=str(tmp_path), device="cpu")
    try:
        st.api.checkpoint_dir = str(tmp_path)
        st.run_steps(5)
        client = DeltaMapClient(_base(st))
        client.poll()
        st.kill_node("jax_mapper")
        missed = st.cfg.resilience.supervisor_missed_beats
        st.run_steps(missed + 1)
        assert not st.supervisor.is_alive("jax_mapper")
        url = _base(st) + "/save"
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(url)
        assert ei.value.code == 503
        assert json.load(ei.value)["state"] == "degraded"
        status = json.load(_get(_base(st) + "/status"))
        assert status["supervisor"]["dead"] == ["jax_mapper"]
        st.run_steps(30)
        assert st.supervisor.is_alive("jax_mapper")
        assert json.load(_post(url))["status"] == "saved"
        assert st.api.mapper is st.mapper
        assert st.api.serving.mapper is st.mapper
        client.poll()
        assert client.epoch == st.mapper.restart_epoch == 1
        assert client.n_epoch_resyncs == 1
        assert np.array_equal(
            client.image(0),
            G.to_gray(st.cfg.grid, st.mapper.merged_grid()).numpy())
    finally:
        st.shutdown()


# ------------------------------------------------------ test_rosmap.py

def _rosmap_stack(tmp_path, seed=0):
    cfg = tiny_config()
    cfg = dataclasses.replace(
        cfg, planner=dataclasses.replace(cfg.planner, enabled=False))
    world = W.empty_arena(96, cfg.grid.resolution_m)
    st = launch_sim_stack(cfg, world, n_robots=1, http_port=0, seed=seed,
                          device="cpu")
    st.api.checkpoint_dir = str(tmp_path)
    return st


def test_http_save_map_and_reimport(tmp_path):
    """POST /save-map -> the artifact loads back to exactly the occupancy
    the live /map exports; GET is refused; a fresh mapper seeded with the
    import holds the same walls and free space."""
    from jax_mapping_torch.bridge.messages import occupancy_from_logodds
    st = _rosmap_stack(tmp_path)
    try:
        st.brain.start_exploring()
        st.run_steps(30)
        url = _base(st) + "/save-map?name=arena"
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(url)
        assert ei.value.code == 405
        body = json.loads(_post(url).read())
        assert body["status"] == "saved"
        occ, res, origin = rosmap.load_map(body["yaml"])
        g = st.cfg.grid
        assert res == g.resolution_m and origin == g.origin_m
        live = occupancy_from_logodds(
            st.mapper.merged_grid().numpy(), g.occ_threshold,
            g.free_threshold, g.resolution_m, g.origin_m)
        live_occ = np.asarray(live.data, np.int8).reshape(
            live.info.height, live.info.width)
        assert (occ == live_occ).all()
        assert (occ == 100).sum() > 0
    finally:
        st.shutdown()

    st2 = _rosmap_stack(tmp_path, seed=1)
    try:
        occ2 = rosmap.embed_in_grid(occ, res, origin, st2.cfg.grid)
        st2.mapper.seed_map_prior(rosmap.logodds_prior(occ2))
        g = st2.cfg.grid
        seeded = occupancy_from_logodds(
            st2.mapper.merged_grid().numpy(), g.occ_threshold,
            g.free_threshold, g.resolution_m, g.origin_m)
        s_occ = np.asarray(seeded.data, np.int8).reshape(
            seeded.info.height, seeded.info.width)
        assert ((s_occ == 100) == (occ == 100)).all()
        assert ((s_occ == 0) == (occ == 0)).all()
    finally:
        st2.shutdown()


# ------------------------------------------------ test_voxel_bridge.py

@pytest.fixture(scope="module")
def depth_stack():
    cfg = tiny_config(2)
    world = W.plank_course(96, cfg.grid.resolution_m, n_planks=4, seed=3)
    st = launch_sim_stack(cfg, world, n_robots=2, http_port=0, seed=3,
                          depth_cam=True, device="cpu")
    st.brain.start_exploring()
    st.run_steps(12)
    yield st
    st.shutdown()


def test_http_voxel_image(depth_stack):
    url = _base(depth_stack) + "/voxel-image"
    with _get(url) as r:
        body = r.read()
        etag = r.headers["ETag"]
    assert body[:8] == b"\x89PNG\r\n\x1a\n"
    img = png_codec.decode_gray(body)
    v = depth_stack.cfg.voxel
    assert img.shape == (v.size_y_cells, v.size_x_cells)
    assert np.array_equal(img, depth_stack.voxel_mapper.height_map_image())
    req = urllib.request.Request(url, headers={"If-None-Match": etag})
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=T)
    assert ei.value.code == 304


def test_http_voxel_image_404_without_depth_cam(stack):
    with pytest.raises(urllib.error.HTTPError) as ei:
        _get(_base(stack) + "/voxel-image")
    assert ei.value.code == 404


def test_http_save_load_voxel_sidecar(tmp_path):
    cfg = tiny_config()
    world = W.plank_course(96, cfg.grid.resolution_m, n_planks=4, seed=3)
    st = launch_sim_stack(cfg, world, n_robots=1, http_port=0, seed=3,
                          depth_cam=True, device="cpu")
    try:
        st.api.checkpoint_dir = str(tmp_path)
        st.brain.start_exploring()
        st.run_steps(12)
        url = _base(st)
        body = json.loads(_post(url + "/save").read())
        assert "voxel_path" in body and "keyframe_path" in body
        g_before = st.voxel_mapper.voxel_grid().clone()
        assert g_before.abs().sum() > 0
        st.voxel_mapper.restore_grid(
            torch.zeros_like(st.voxel_mapper.voxel_grid()))
        body = json.loads(_post(url + "/load").read())
        assert "voxel_path" in body
        assert torch.equal(st.voxel_mapper.voxel_grid(), g_before)
    finally:
        st.shutdown()


def test_http_rejects_reserved_voxel_name(stack, tmp_path):
    stack.api.checkpoint_dir = str(tmp_path)
    for name in ("x.voxel", "x.voxelkf", "x.prior", "x.world"):
        with pytest.raises(urllib.error.HTTPError) as ei:
            _post(_base(stack) + f"/save?name={name}")
        assert ei.value.code == 400
    assert list(tmp_path.iterdir()) == []


# ------------------------------------------------------ test_planner.py

def test_http_goal_endpoint():
    cfg = tiny_config()
    world = W.empty_arena(96, cfg.grid.resolution_m)
    st = launch_sim_stack(cfg, world, n_robots=2, http_port=0, seed=24,
                          device="cpu")
    try:
        base = _base(st)
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(f"{base}/goal?x=1&y=2")
        assert ei.value.code == 405
        with _post(f"{base}/goal?x=0.5&y=0.25") as r:
            assert json.loads(r.read())["robot"] == 0
        with _post(f"{base}/goal?x=-0.5&y=0.1&robot=1") as r:
            assert json.loads(r.read())["robot"] == 1
        goals = st.brain.status()["goals"]
        assert goals[0] == {"x": 0.5, "y": 0.25}
        assert goals[1] == {"x": -0.5, "y": 0.1}
        for bad in ("/goal?x=abc&y=2", "/goal?y=2", "/goal?x=1&y=2&robot=7",
                    "/goal?x=nan&y=2", "/goal?x=1&y=inf", "/goal?x=99&y=0"):
            with pytest.raises(urllib.error.HTTPError) as ei:
                _post(base + bad)
            assert ei.value.code == 400, bad
        with _post(f"{base}/goal/cancel?robot=1") as r:
            assert json.loads(r.read())["status"] == "goal cancelled"
        assert st.brain.status()["goals"][1] is None
        assert st.brain.status()["goals"][0] is not None
        with _post(f"{base}/goal/cancel?robot=1") as r:
            assert json.loads(r.read())["status"] == "no goal set"
        with pytest.raises(urllib.error.HTTPError) as ei:
            _get(f"{base}/goal/cancel")
        assert ei.value.code == 405
    finally:
        st.shutdown()


# -------------------------------------------------------- test_world.py

def test_windowed_serving_and_http_surface():
    """A windowed mapper's `/tiles` serves typed evicted markers the
    client prunes on, the ETag grows a `-w{epoch}` suffix across an
    eviction flip, `/status` carries the world section and `/metrics`
    the jax_mapping_world_* families."""
    from tests.test_torch_world import _odom, _ranges, _scan, _wcfg
    cfg = _wcfg()
    bus = Bus()
    mapper = MapperNode(cfg, bus, n_robots=1, device="cpu")
    api = MapApiServer(bus, mapper=mapper, port=0)
    try:
        store = api.serving.map_store
        scan_pub = bus.publisher("scan")
        odom_pub = bus.publisher("odom")
        ranges = _ranges(cfg)[:cfg.scan.n_beams]
        for i, x in enumerate([0.0, 0.2]):
            stamp = 0.5 * (i + 1)
            odom_pub.publish(_odom(stamp, x, 0.0, 0.0))
            scan_pub.publish(_scan(stamp, cfg, ranges=ranges))
            mapper.tick()
        store.refresh()
        rev0, entries0, meta0 = store.tiles_since(-1)
        assert meta0["size_cells"] == 768
        assert not any(e.get("evicted") for e in entries0)
        client = DeltaMapClient("http://unused")
        client.apply({"revision": rev0, "since": -1, "tiles": entries0,
                      "tile_cells": 64, "levels": meta0["levels"]})
        assert client.image().shape == (768, 768)
        assert int((client.image() != 127).sum()) > 0
        res = api.handle("/tiles?since=-1")
        assert res[0] == 200
        etag0 = res[3]["ETag"]
        assert "-w" not in etag0

        t = 1.0
        for x in [1.6, 2.4, 3.2, 4.0, 4.8]:
            t += 0.5
            odom_pub.publish(_odom(t, x, 0.0, 0.0))
            scan_pub.publish(_scan(t, cfg))
            mapper.tick()
        assert mapper.world.n_shifts >= 1
        assert mapper.world.status()["away_tiles"] > 0
        store.refresh()
        rev1, entries1, meta1 = store.tiles_since(rev0)
        markers = [e for e in entries1 if e.get("evicted")]
        assert markers and meta1["evicted_tiles"] > 0
        assert all("png" not in e for e in markers)
        before = client.n_tiles_pruned
        client.apply({"revision": rev1, "since": rev0, "tiles": entries1,
                      "tile_cells": 64, "levels": meta1["levels"]})
        assert client.n_tiles_pruned == before + len(markers)
        for e in markers:
            ty, tx = e["ty"], e["tx"]
            assert (client.image()[ty * 64:(ty + 1) * 64,
                                   tx * 64:(tx + 1) * 64] == 127).all()
        assert store.stats()["n_tiles_evicted"] > 0
        assert store.stats()["evicted_epoch"] > 0
        etag1 = api.handle("/tiles?since=-1")[3]["ETag"]
        assert f"-w{store.evicted_epoch}" in etag1 and etag1 != etag0
        # The served mosaic is the store's composition of the window.
        mosaic, evicted = mapper.world.compose_serving(
            G.to_gray(cfg.grid, mapper.merged_grid()).numpy())
        full = json.loads(api.handle("/tiles?since=-1&level=0")[2])
        client2 = DeltaMapClient("http://unused")
        client2.apply(full)
        assert np.array_equal(client2.image(0), mosaic)
        assert sorted((e["ty"], e["tx"]) for e in full["tiles"]
                      if e.get("evicted")) == \
            sorted(map(tuple, np.argwhere(evicted).tolist()))

        body = json.loads(api.handle("/status")[2])
        assert body["world"]["windowed"] is True
        assert body["world"]["shifts"] >= 1
        text = api.handle("/metrics")[2].decode()
        for fam in ("jax_mapping_world_shifts_total",
                    "jax_mapping_world_evictions_total",
                    "jax_mapping_world_device_window_bytes",
                    "jax_mapping_world_governor_rung",
                    "jax_mapping_world_away_tiles"):
            assert f"# TYPE {fam} " in text
    finally:
        api.shutdown()
        mapper.destroy()


# ------------------------------------------------------- across packages

#: One stack drive, run by either package in a fresh process: the
#: /metrics family names after a short mission and a poll of each route.
FAMILY_SCRIPT = '''
import json, re, sys, urllib.request
pkg = sys.argv[1]
import importlib
L = importlib.import_module(pkg + ".bridge.launch")
C = importlib.import_module(pkg + ".config")
W = importlib.import_module(pkg + ".sim.world")
cfg = C.tiny_config(2)
world = W.plank_course(96, cfg.grid.resolution_m, n_planks=4, seed=3)
kw = {"device": "cpu"} if pkg == "jax_mapping_torch" else {}
st = L.launch_sim_stack(cfg, world, n_robots=2, http_port=0, seed=0, **kw)
st.brain.start_exploring()
st.run_steps(8)
st.mapper.publish_map()
base = "http://127.0.0.1:%d" % st.api.port
for r in ("/tiles", "/map-image", "/status", "/frontiers"):
    urllib.request.urlopen(base + r, timeout=10).read()
text = urllib.request.urlopen(base + "/metrics", timeout=10).read().decode()
st.shutdown()
print(json.dumps(sorted(set(re.findall(r"^# TYPE (\\S+) (\\S+)", text,
                                       re.M)))))
'''


def _families(*pkgs: str) -> dict:
    """pkg -> the family (name, type) set FAMILY_SCRIPT prints, the
    packages' processes run side by side."""
    env = clean_cpu_env()
    env["OMP_NUM_THREADS"] = "1"
    procs = {pkg: subprocess.Popen(
        [sys.executable, "-c", FAMILY_SCRIPT, pkg], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=str(REPO))
        for pkg in pkgs}
    out = {}
    for pkg, p in procs.items():
        stdout, stderr = p.communicate(timeout=300)
        assert p.returncode == 0, stderr[-3000:]
        out[pkg] = {tuple(f) for f in
                    json.loads(stdout.strip().splitlines()[-1])}
    return out


def _saved_port_checkpoint(st, path) -> list:
    """The port's /save of `st` as `xpkg.npz` under `path`, and the same
    states through `checkpoint_bytes` as `bytes.npz`; returns the leaves."""
    st.api.checkpoint_dir = str(path)
    body = json.loads(_post(_base(st) + "/save?name=xpkg").read())
    assert body["status"] == "saved"
    from jax_mapping_torch.io.checkpoint import (_flatten, _to_numpy,
                                                 checkpoint_bytes)
    states = st.mapper.snapshot_states()
    (path / "bytes.npz").write_bytes(
        checkpoint_bytes(states, config_json=st.cfg.to_json()))
    return [(k, _to_numpy(v)) for k, v in _flatten(states)]


@pytest.fixture(scope="module")
def xref(stack, tmp_path_factory):
    """The port's /save of the module stack and its `checkpoint_bytes`,
    then the JAX reference: its load of both files, its own
    `checkpoint_bytes` of the states it loaded from the save, a JAX
    stack's grid, and the /tiles body and /map-image PNG of a fresh JAX
    mapper seeded with that grid."""
    d = tmp_path_factory.mktemp("xpkg")
    leaves = _saved_port_checkpoint(stack, d)
    script = f'''
import json
from jax_mapping.bridge.bus import Bus
from jax_mapping.bridge.http_api import MapApiServer
from jax_mapping.bridge.launch import launch_sim_stack
from jax_mapping.bridge.mapper import MapperNode
from jax_mapping.config import tiny_config
from jax_mapping.io.checkpoint import checkpoint_bytes, load_checkpoint
from jax_mapping.models import slam as S
from jax_mapping.sim import world as W
import jax

cfg = tiny_config(2)
states, cfg_json = load_checkpoint({str(d / "xpkg.npz")!r},
                                   [S.init_state(cfg)] * 2)
leaves = jax.tree_util.tree_flatten_with_path(states)[0]
for k, (path, leaf) in enumerate(leaves):
    OUT["ckpt_%03d" % k] = np.asarray(leaf)
OUT["ckpt_cfg"] = np.frombuffer(cfg_json.encode(), np.uint8)
OUT["jax_bytes"] = np.frombuffer(checkpoint_bytes(states, cfg_json), np.uint8)
got, got_cfg = load_checkpoint({str(d / "bytes.npz")!r},
                               [S.init_state(cfg)] * 2)
for k, (path, leaf) in enumerate(jax.tree_util.tree_flatten_with_path(got)[0]):
    OUT["cb_%03d" % k] = np.asarray(leaf)
OUT["cb_cfg"] = np.frombuffer(got_cfg.encode(), np.uint8)

world = W.plank_course(96, cfg.grid.resolution_m, n_planks=4, seed=5)
st = launch_sim_stack(cfg, world, n_robots=2, seed=1)
st.brain.start_exploring()
st.run_steps(15)
grid = np.asarray(st.mapper.merged_grid())
st.shutdown()
OUT["grid"] = grid

bus = Bus()
m = MapperNode(cfg, bus, n_robots=2)
api = MapApiServer(bus, mapper=m, port=0)
m.seed_map_prior(grid)
m.publish_map()
OUT["tiles"] = np.frombuffer(api.handle("/tiles?since=-1")[2], np.uint8)
OUT["map_image"] = np.frombuffer(api.handle("/map-image")[2], np.uint8)
api.shutdown()
'''
    ref = run_reference(script, d / "ref.npz")
    ref["port_bytes"] = (d / "bytes.npz").read_bytes()
    return leaves, ref, stack.cfg.to_json()


def test_jax_client_rebuilds_the_port_server_map(stack):
    from jax_mapping.serving.client import DeltaMapClient as JaxClient
    client = JaxClient(_base(stack))
    client.poll()
    stack.run_steps(5)
    client.poll()
    client.poll()
    want = G.to_gray(stack.cfg.grid, stack.mapper.merged_grid()).numpy()
    assert np.array_equal(client.image(0), want)
    for lvl in (1, 2):
        want = G.downsample_gray(torch.as_tensor(want)).numpy()
        assert np.array_equal(client.image(lvl), want)


def test_port_save_loads_in_jax_bit_equal(xref):
    leaves, ref, cfg_json = xref
    got = {k: v for k, v in ref.items() if k.startswith("ckpt_0")}
    assert len(got) == len(leaves)
    for k, (key, arr) in enumerate(leaves):
        want = got["ckpt_%03d" % k]
        assert want.dtype == arr.dtype and want.shape == arr.shape, key
        assert np.array_equal(want, arr), key
    assert bytes(ref["ckpt_cfg"]).decode() == cfg_json


def test_tiles_and_map_image_byte_equal_on_jax_grid(xref):
    _leaves, ref, _cfg = xref
    cfg = tiny_config(2)
    bus = Bus()
    m = MapperNode(cfg, bus, n_robots=2, device="cpu")
    api = MapApiServer(bus, mapper=m, port=0)
    try:
        m.seed_map_prior(ref["grid"])
        m.publish_map()
        tiles = api.handle("/tiles?since=-1")
        assert tiles[0] == 200
        assert tiles[2] == bytes(ref["tiles"])
        assert len(json.loads(tiles[2])["tiles"]) == 16 + 4 + 1
        img = api.handle("/map-image")
        assert img[0] == 200 and img[2] == bytes(ref["map_image"])
    finally:
        api.shutdown()
        m.destroy()


def test_metrics_family_names_equal_jax():
    fams = _families("jax_mapping", "jax_mapping_torch")
    assert fams["jax_mapping_torch"] == fams["jax_mapping"]
    names = {n for n, _t in fams["jax_mapping"]}
    assert {"jax_mapping_serving_grid_revision",
            "jax_mapping_checkpoint_fallback_total",
            "jax_mapping_stage_serving_snapshot_seconds"} <= names


def test_fallback_counters_count_the_slot_used(tmp_path):
    """`fallback_counts()` counts each generation the fallback load
    resumes from, and /metrics renders every slot."""
    from jax_mapping_torch.io import checkpoint as CK
    p = str(tmp_path / "a.npz")
    CK.save_checkpoint(p, {"x": np.arange(3)})
    CK.save_checkpoint(p, {"x": np.arange(3) + 1})
    before = CK.fallback_counts()
    CK.load_checkpoint_with_fallback(p, {"x": np.zeros(3, np.int64)})
    with open(p, "wb") as f:
        f.write(b"torn")
    state, _c, used = CK.load_checkpoint_with_fallback(
        p, {"x": np.zeros(3, np.int64)})
    assert used == CK.previous_checkpoint_path(p)
    assert state["x"].tolist() == [0, 1, 2]
    after = CK.fallback_counts()
    assert after["primary"] == before["primary"] + 1
    assert after["prev"] == before["prev"] + 1
    assert after["generation"] == before["generation"]
    api = MapApiServer(Bus(), port=0)
    try:
        text = api.handle("/metrics")[2].decode()
    finally:
        api.shutdown()
    for slot in ("primary", "prev", "generation"):
        assert re.search(r'^jax_mapping_checkpoint_fallback_total'
                         rf'{{slot="{slot}"}} {after[slot]}$', text, re.M)


def test_checkpoint_bytes_load_in_jax_format(xref):
    """The port's `checkpoint_bytes` of the module stack's states equals
    the JAX package's `checkpoint_bytes` of the same states (JAX loaded
    them from the port's /save) member by member: the keys in order,
    every array's dtype, shape and values, and the meta record. JAX's
    `load_checkpoint` reads the port's bytes back to those leaves."""
    from jax_mapping_torch.io.checkpoint import _META_KEY
    leaves, ref, cfg_json = xref
    members = {}
    for who, raw in (("port", ref["port_bytes"]),
                     ("jax", bytes(ref["jax_bytes"]))):
        with np.load(io.BytesIO(raw)) as z:
            members[who] = (list(z.files), {k: z[k] for k in z.files})
    (port_names, port), (jax_names, jx) = members["port"], members["jax"]
    assert port_names == jax_names
    meta = json.loads(bytes(port[_META_KEY]).decode())
    assert meta == json.loads(bytes(jx[_META_KEY]).decode())
    assert meta["config"] == cfg_json and "crc32" not in meta
    assert meta["keys"] == [key for key, _arr in leaves]
    for key in meta["keys"]:
        a, b = port[key], jx[key]
        assert a.dtype == b.dtype and a.shape == b.shape, key
        assert np.array_equal(a, b), key
    got = {k: v for k, v in ref.items() if k.startswith("cb_0")}
    assert len(got) == len(leaves)
    for k, (key, arr) in enumerate(leaves):
        assert np.array_equal(got["cb_%03d" % k], arr), key
    assert bytes(ref["cb_cfg"]).decode() == cfg_json
