"""The port's serving subsystem against the JAX package's.

One JAX reference run (a fresh `JAX_PLATFORMS=cpu` subprocess,
`tests/torch_jaxref.py`) computes `grid.tile_hashes` (uint8, float bit
patterns, int8, rectangular, 256-cell tiles, edges that do not divide),
`grid.to_gray` (values at and one ulp past the thresholds) and
`grid.downsample_gray` on seeded arrays, and drives its `TileStore` through
seeded edit sequences (the occupancy gray, a continuous height map with
the block-max pyramid, and a windowed provider with evicted masks, with a
dirty hint that misses every change once). The port must give the same
hashes, images and byte-equal `tiles_since` manifests and `stats()`.

Then every test of the JAX package's `tests/test_serving.py` but its slow
benchmark gate, on the port's stack on the CPU: delta reconstruction bit
for bit, the pyramid, ETag/304, long-poll, SSE, metrics, thread-safe
counters, the concurrent hammer with no stale tile, serving disabled
staying dark, voxel tiles, typed evicted markers, the load generator, and
the race watch over a live serving stack. Last, the snapshot the tile store
reads stays the revision it was taken at through every path that changes
the map (the mapper never writes into a grid it handed out).
"""

import dataclasses
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from jax_mapping_torch.bridge.launch import launch_sim_stack
from jax_mapping_torch.config import ServingConfig, tiny_config
from jax_mapping_torch.ops import grid as G
from jax_mapping_torch.serving.client import DeltaMapClient
from jax_mapping_torch.serving.events import EventChannel
from jax_mapping_torch.serving.tiles import (MapServing, TileStore,
                                             _downsample_max_u8)
from jax_mapping_torch.sim import world as W
from tests.torch_jaxref import run_reference
from tests.torch_threads import one_intra_op_thread  # noqa: F401

#: Seeded inputs, shared by the reference script and the port's side.
SETUP = '''
import json


def hash_cases():
    rng = np.random.default_rng(0)
    f = rng.normal(0.0, 2.0, (256, 256)).astype(np.float32)
    f[0, :6] = [0.0, -0.0, 1e-45, -1e-45, np.inf, -np.inf]
    f[1, 0] = np.nan
    return {
        "u8": (rng.integers(0, 256, (256, 256)).astype(np.uint8), 64),
        "u8_tile256": (rng.integers(0, 256, (512, 512)).astype(np.uint8),
                       256),
        "f32_bits": (f, 64),
        "rect": (rng.integers(0, 256, (128, 256)).astype(np.uint8), 64),
        "i8": (rng.choice(np.array([-1, 0, 100], np.int8), (192, 320)), 64),
        "uneven_rows": (np.zeros((100, 128), np.uint8), 64),
        "uneven_cols": (np.zeros((128, 96), np.uint8), 64),
    }


def gray_cases(g):
    rng = np.random.default_rng(1)
    lo = rng.uniform(-3.0, 3.0, (256, 256)).astype(np.float32)
    occ, free = np.float32(g.occ_threshold), np.float32(g.free_threshold)
    lo[0, :4] = [occ, free, 0.0, -0.0]
    lo[1, :4] = [np.nextafter(occ, np.float32(9)),
                 np.nextafter(occ, np.float32(-9)),
                 np.nextafter(free, np.float32(9)),
                 np.nextafter(free, np.float32(-9))]
    sparse = np.where(rng.random((128, 128)) < 0.9, np.float32(0.0),
                      lo[:128, :128]).astype(np.float32)
    return {"uniform": lo, "sparse": sparse}


def down_cases():
    rng = np.random.default_rng(2)
    return {"tri": rng.choice(np.array([0, 127, 255], np.uint8), (256, 256)),
            "any": rng.integers(0, 256, (128, 64)).astype(np.uint8)}


STORE_KINDS = ("grid", "voxel", "evicted")


def store_steps(kind):
    """[(revision, image, hint, evicted mask or None)]: a seeded edit
    sequence on a 256^2 surface of 64-cell tiles."""
    rng = np.random.default_rng(3 + STORE_KINDS.index(kind))
    n, t = 256, 64
    img = np.full((n, n), 0 if kind == "voxel" else 127, np.uint8)
    rev, steps = 0, []
    for k in range(7):
        img = img.copy()
        touched = np.zeros((4, 4), bool)
        for _ in range(int(rng.integers(0, 4))):
            r0, c0 = (int(v) for v in rng.integers(0, n - 24, 2))
            h, w = (int(v) for v in rng.integers(1, 24, 2))
            val = int(rng.integers(0, 256)) if kind == "voxel" \\
                else int(rng.choice([0, 127, 255]))
            img[r0:r0 + h, c0:c0 + w] = val
            touched[r0 // t:(r0 + h - 1) // t + 1,
                    c0 // t:(c0 + w - 1) // t + 1] = True
        hint = np.zeros((4, 4), bool) if k == 4 else touched
        rev += int(rng.integers(1, 4))
        if kind == "evicted":
            ev = rng.random((4, 4)) < 0.25
            shown = img.copy()
            for ty, tx in np.argwhere(ev):
                shown[ty * t:(ty + 1) * t, tx * t:(tx + 1) * t] = 127
            steps.append((rev, shown, hint, ev))
        else:
            steps.append((rev, img, hint, None))
    return steps


def run_store(TileStore, ServingConfig, down, kind, wrap):
    """JSON of [(full snapshot, delta since the last revision, its level-1
    slice, stats)] after each refresh of the sequence."""
    steps = store_steps(kind)
    cur = [0]

    def snap():
        rev, img, hint, ev = steps[cur[0]]
        return (rev, wrap(img), hint) if ev is None else \\
            (rev, wrap(img), hint, ev)
    store = TileStore(ServingConfig(tile_cells=64, pyramid_levels=3), kind,
                      lambda: steps[cur[0]][0], snap,
                      downsample_fn=down if kind == "voxel" else None,
                      meta={"resolution_m": 0.05, "origin_m": [-6.4, -6.4]})
    out, prev = [], -1
    for i in range(len(steps)):
        cur[0] = i
        store.refresh()
        full = store.tiles_since(-1)
        out.append([full, store.tiles_since(prev),
                    store.tiles_since(prev, level=1), store.stats()])
        prev = full[0]
    return json.dumps(out, sort_keys=True)
'''
exec(SETUP)

REFERENCE = '''
import jax.numpy as jnp
from jax_mapping.config import ServingConfig, tiny_config
from jax_mapping.ops import grid as G
from jax_mapping.serving.tiles import TileStore, _downsample_max_u8
''' + SETUP + '''
for name, (arr, t) in hash_cases().items():
    try:
        OUT["hash_" + name] = np.asarray(G.tile_hashes(jnp.asarray(arr), t))
    except ValueError:
        OUT["raises_" + name] = np.array(1)
g = tiny_config().grid
for name, lo in gray_cases(g).items():
    OUT["gray_" + name] = np.asarray(G.to_gray(g, jnp.asarray(lo)))
for name, img in down_cases().items():
    OUT["down_" + name] = np.asarray(G.downsample_gray(jnp.asarray(img)))
for kind in STORE_KINDS:
    OUT["store_" + kind] = np.frombuffer(run_store(
        TileStore, ServingConfig, _downsample_max_u8, kind,
        lambda a: a).encode(), np.uint8)
'''


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    return run_reference(REFERENCE,
                         tmp_path_factory.mktemp("ref") / "serving.npz")


# ------------------------------------------------- against the JAX package

@pytest.mark.parametrize("name", list(hash_cases()))
def test_tile_hashes_equal_jax(ref, name):
    arr, t = hash_cases()[name]
    assert ("raises_" + name in ref) == name.startswith("uneven")
    if "raises_" + name in ref:
        with pytest.raises(ValueError, match="not divisible"):
            G.tile_hashes(torch.as_tensor(arr), t)
        return
    got = G.tile_hashes(torch.as_tensor(arr), t).numpy()
    want = ref["hash_" + name]
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("rows", [1, 2])
@pytest.mark.parametrize("name", [n for n in hash_cases()
                                  if not n.startswith("uneven")])
def test_tile_hashes_in_chunks_equal_jax(ref, name, rows, monkeypatch):
    """Hashed `rows` tile rows a chunk (the last one shorter where the
    rows do not divide), the hashes are still JAX's."""
    arr, t = hash_cases()[name]
    monkeypatch.setattr(G, "_HASH_CHUNK_CELLS", rows * t * arr.shape[1])
    got = G.tile_hashes(torch.as_tensor(arr), t).numpy()
    np.testing.assert_array_equal(got, ref["hash_" + name].astype(np.int64))


@pytest.mark.parametrize("name", ["uniform", "sparse"])
def test_to_gray_equals_jax(ref, name):
    g = tiny_config().grid
    got = G.to_gray(g, torch.as_tensor(gray_cases(g)[name]))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), ref["gray_" + name])


@pytest.mark.parametrize("name", ["tri", "any"])
def test_downsample_gray_equals_jax(ref, name):
    got = G.downsample_gray(torch.as_tensor(down_cases()[name]))
    np.testing.assert_array_equal(got.numpy(), ref["down_" + name])


@pytest.mark.parametrize("kind", STORE_KINDS)
def test_tile_store_manifests_equal_jax(ref, kind):
    """Byte-equal manifests (PNG bytes, stamps, meta, evicted markers)
    and stats after every refresh; the grid store gets tensors, the
    others numpy images."""
    wrap = torch.as_tensor if kind == "grid" else (lambda a: a)
    got = run_store(TileStore, ServingConfig, _downsample_max_u8, kind,
                    wrap)
    assert got == bytes(ref["store_" + kind]).decode()
    assert json.loads(got)[-1][-1]["n_hint_missed"] > 0


# ------------------------------------------------------------------ units

def test_tile_hashes_change_iff_content_changes():
    img = np.full((256, 256), 127, np.uint8)
    h0 = G.tile_hashes(torch.as_tensor(img), 64).numpy()
    assert h0.shape == (4, 4, 2)
    img2 = img.copy()
    img2[70, 130] = 0                     # tile (1, 2)
    h1 = G.tile_hashes(torch.as_tensor(img2), 64).numpy()
    changed = np.argwhere(np.any(h0 != h1, axis=-1))
    assert changed.tolist() == [[1, 2]]


def test_tile_hashes_float_is_bit_exact():
    """Float grids hash their bit patterns: a sub-epsilon log-odds change
    still changes the hash."""
    lo = np.zeros((128, 128), np.float32)
    h0 = G.tile_hashes(torch.as_tensor(lo), 64).numpy()
    lo2 = lo.copy()
    lo2[3, 3] = 1e-7
    h1 = G.tile_hashes(torch.as_tensor(lo2), 64).numpy()
    assert np.any(h0 != h1)


def test_downsample_gray_priority():
    """Occupied (0) beats free (255) beats unknown (127) per block."""
    img = np.full((4, 4), 127, np.uint8)
    img[0, 0] = 0
    img[0, 2] = 255
    out = G.downsample_gray(torch.as_tensor(img)).numpy()
    assert out.tolist() == [[0, 255], [127, 127]]
    img[0, 1] = 255
    assert G.downsample_gray(torch.as_tensor(img)).numpy()[0, 0] == 0


def test_tile_store_delta_and_pyramid():
    cfg = ServingConfig(tile_cells=64, pyramid_levels=3)
    state = {"rev": 0, "img": np.full((256, 256), 127, np.uint8)}
    store = TileStore(cfg, "grid", lambda: state["rev"],
                      lambda: (state["rev"], state["img"], None))
    store.refresh()
    rev, entries, meta = store.tiles_since(-1)
    assert rev == 0 and len(entries) == 16 + 4 + 1
    assert [lv["size_cells"] for lv in meta["levels"]] == [256, 128, 64]

    state["img"] = state["img"].copy()
    state["img"][10:20, 70:80] = 0         # level-0 tile (0, 1)
    state["rev"] = 7
    store.refresh()
    rev, entries, _ = store.tiles_since(0)
    assert rev == 7
    assert [(e["level"], e["ty"], e["tx"]) for e in entries] == \
        [(0, 0, 1), (1, 0, 0), (2, 0, 0)]
    assert all(e["revision"] == 7 for e in entries)

    state["rev"] = 9                       # same content: hash dedupe
    store.refresh()
    _, entries, _ = store.tiles_since(7)
    assert entries == []
    assert store.stats()["n_tiles_clean_skipped"] > 0


def test_tile_store_rejects_rectangular_image():
    store = TileStore(ServingConfig(tile_cells=64), "grid", lambda: 0,
                      lambda: (0, np.zeros((128, 256), np.uint8), None))
    with pytest.raises(ValueError, match="square"):
        store.refresh()


def test_voxel_store_gated_on_square_geometry():
    from jax_mapping_torch.config import VoxelConfig
    cfg = ServingConfig(tile_cells=64)
    assert MapServing._voxel_servable(
        cfg, VoxelConfig(size_x_cells=128, size_y_cells=128))
    assert not MapServing._voxel_servable(
        cfg, VoxelConfig(size_x_cells=256, size_y_cells=128))
    assert not MapServing._voxel_servable(
        cfg, VoxelConfig(size_x_cells=96, size_y_cells=96))


def test_event_channel_drop_counter_survives_disconnect():
    ch = EventChannel(depth=1)
    sub = ch.subscribe()
    for rev in range(4):
        ch.emit({"revision": rev})
    assert ch.n_dropped_total() == 3
    ch.unsubscribe(sub)
    assert ch.n_dropped_total() == 3


def test_event_channel_drop_to_latest():
    ch = EventChannel(depth=2)
    sub = ch.subscribe()
    for rev in range(5):
        ch.emit({"revision": rev})
    assert sub.pending() == 2
    assert sub.n_dropped == 3
    assert sub.next(0.1)["revision"] == 3
    assert sub.next(0.1)["revision"] == 4
    assert sub.next(0.05) is None
    ch.unsubscribe(sub)
    assert ch.n_clients() == 0


def test_tile_store_typed_evicted_markers_and_client_prune():
    """A windowed provider's 4th snapshot element turns level-0 tiles into
    byteless markers (cached bytes dropped), the client prunes them to
    unknown, and re-entry re-encodes normally."""
    cfg = ServingConfig(tile_cells=64, pyramid_levels=1)
    img = np.full((256, 256), 127, np.uint8)
    img[:64, :64] = 0
    state = {"rev": 0, "img": img, "ev": np.zeros((4, 4), bool)}
    store = TileStore(cfg, "grid", lambda: state["rev"],
                      lambda: (state["rev"], state["img"], None,
                               state["ev"]))
    store.refresh()
    rev0, entries0, meta0 = store.tiles_since(-1)
    assert not any(e.get("evicted") for e in entries0)
    assert meta0.get("evicted_tiles", 0) == 0
    client = DeltaMapClient("http://unused")
    client.apply({"revision": rev0, "since": -1, "tiles": entries0,
                  "tile_cells": 64, "levels": meta0["levels"]})
    assert (client.image()[:64, :64] == 0).all()

    img2 = img.copy()
    img2[:64, :64] = 127
    ev2 = np.zeros((4, 4), bool)
    ev2[0, 0] = True
    state.update(rev=5, img=img2, ev=ev2)
    store.refresh()
    rev1, entries1, meta1 = store.tiles_since(rev0)
    markers = [e for e in entries1 if e.get("evicted")]
    assert markers == [{"level": 0, "ty": 0, "tx": 0, "revision": 5,
                        "evicted": True}]
    assert meta1["evicted_tiles"] == 1
    assert store.evicted_epoch == 1
    assert store.stats()["n_tiles_evicted"] == 1
    _, full, _ = store.tiles_since(-1)
    slot = [e for e in full
            if e["level"] == 0 and (e["ty"], e["tx"]) == (0, 0)]
    assert all(e.get("evicted") for e in slot) and slot

    before = client.n_tiles_pruned
    client.apply({"revision": rev1, "since": rev0, "tiles": entries1,
                  "tile_cells": 64, "levels": meta1["levels"]})
    assert client.n_tiles_pruned == before + 1
    assert (client.image()[:64, :64] == 127).all()

    img3 = img2.copy()
    img3[:64, :64] = 0
    state.update(rev=9, img=img3, ev=np.zeros((4, 4), bool))
    store.refresh()
    assert store.evicted_epoch == 2
    assert store.stats()["n_tiles_evicted"] == 0
    rev2, entries2, meta2 = store.tiles_since(rev1)
    assert not any(e.get("evicted") for e in entries2)
    assert any((e["ty"], e["tx"]) == (0, 0) and "png" in e
               for e in entries2 if e["level"] == 0)
    client.apply({"revision": rev2, "since": rev1, "tiles": entries2,
                  "tile_cells": 64, "levels": meta2["levels"]})
    assert (client.image()[:64, :64] == 0).all()


# ------------------------------------------------------------------ stack

@pytest.fixture(scope="module")
def stack():
    cfg = tiny_config()
    world = W.plank_course(96, cfg.grid.resolution_m, n_planks=4, seed=3)
    st = launch_sim_stack(cfg, world, n_robots=2, http_port=0,
                          realtime=False, device="cpu")
    st.brain.start_exploring()
    st.run_steps(20)
    st.mapper.publish_map()
    yield st
    st.shutdown()


def _base(st) -> str:
    return f"http://127.0.0.1:{st.api.port}"


def _expected_gray(st):
    return G.to_gray(st.cfg.grid, st.mapper.merged_grid()).numpy()


def test_delta_reconstruction_bit_equality(stack):
    """Initial snapshot + applied tile deltas == the mapper's live grid,
    bit for bit; the dirty hint never missed."""
    client = DeltaMapClient(_base(stack))
    client.poll()
    assert client.revision >= 0 and client.n_tiles_applied > 0
    for _ in range(4):
        stack.run_steps(10)
        client.poll()
    stack.run_steps(5)
    client.poll()
    assert np.array_equal(client.image(0), _expected_gray(stack))
    assert stack.api.serving.map_store.stats()["n_hint_missed"] == 0


def test_pyramid_levels_consistent(stack):
    client = DeltaMapClient(_base(stack))
    client.poll()
    lvl1 = G.downsample_gray(torch.as_tensor(client.image(0))).numpy()
    assert np.array_equal(client.image(1), lvl1)
    lvl2 = G.downsample_gray(torch.as_tensor(lvl1)).numpy()
    assert np.array_equal(client.image(2), lvl2)


def test_tiles_etag_304_and_client_dedupe(stack):
    client = DeltaMapClient(_base(stack))
    client.poll()
    before = client.bytes_received
    body = client.poll()
    assert body.get("not_modified") is True
    assert client.n_not_modified == 1
    assert client.bytes_received == before


def test_map_image_etag_304(stack):
    stack.mapper.publish_map()
    base = _base(stack)
    with urllib.request.urlopen(f"{base}/map-image", timeout=5) as r:
        etag = r.headers["ETag"]
        assert len(r.read()) > 0
    req = urllib.request.Request(f"{base}/map-image",
                                 headers={"If-None-Match": etag})
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(req, timeout=5)
    assert ei.value.code == 304
    assert ei.value.read() == b""
    req = urllib.request.Request(f"{base}/map-image",
                                 headers={"If-None-Match": 'W/"map-0"'})
    with urllib.request.urlopen(req, timeout=5) as r:
        assert len(r.read()) > 0


def test_map_events_long_poll(stack):
    base = _base(stack)
    rev = stack.mapper.serving_revision()
    with urllib.request.urlopen(
            f"{base}/map-events?mode=poll&since=-1", timeout=5) as r:
        body = json.loads(r.read())
    assert body["revision"] == rev and not body["timed_out"]
    out = {}

    def waiter():
        with urllib.request.urlopen(
                f"{base}/map-events?mode=poll&since={rev}&wait_s=5",
                timeout=10) as r:
            out.update(json.loads(r.read()))

    t = threading.Thread(target=waiter)
    t.start()
    time.sleep(0.2)
    stack.run_steps(5)
    t.join(timeout=10)
    assert not t.is_alive()
    assert out["revision"] > rev and not out["timed_out"]


def test_map_events_sse_stream(stack):
    base = _base(stack)
    since = stack.mapper.serving_revision()
    revisions = []

    def reader():
        req = urllib.request.Request(
            f"{base}/map-events?since={since}&timeout_s=4")
        with urllib.request.urlopen(req, timeout=10) as r:
            for line in r:
                if line.startswith(b"data:"):
                    revisions.append(
                        json.loads(line[5:].decode())["revision"])
                if len(revisions) >= 2:
                    break

    t = threading.Thread(target=reader)
    t.start()
    for _ in range(4):
        time.sleep(0.1)
        stack.run_steps(5)
    t.join(timeout=10)
    assert not t.is_alive()
    assert len(revisions) >= 2
    assert revisions == sorted(revisions)
    assert all(r > since for r in revisions)


def test_metrics_routes_and_latency_histogram(stack):
    base = _base(stack)
    urllib.request.urlopen(f"{base}/status", timeout=5).read()
    with urllib.request.urlopen(f"{base}/metrics", timeout=5) as r:
        text = r.read().decode()
    assert 'jax_mapping_http_requests_by_route_total{route="/status"}' \
        in text
    assert 'jax_mapping_http_request_seconds_bucket{le="+Inf"}' in text
    assert "jax_mapping_http_request_seconds_count" in text
    assert "jax_mapping_serving_grid_revision" in text
    assert "jax_mapping_serving_events_total" in text
    inf = count = None
    for line in text.splitlines():
        if line.startswith('jax_mapping_http_request_seconds_bucket'
                           '{le="+Inf"}'):
            inf = int(line.split()[-1])
        if line.startswith("jax_mapping_http_request_seconds_count"):
            count = int(line.split()[-1])
    assert inf == count and count > 0


def test_request_counters_thread_safe(stack):
    """500 requests across 10 threads count exactly 500."""
    base = _base(stack)
    before = stack.api.route_requests.get("/frontiers", 0)

    def worker():
        for _ in range(50):
            urllib.request.urlopen(f"{base}/frontiers", timeout=10).read()

    threads = [threading.Thread(target=worker) for _ in range(10)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert stack.api.route_requests.get("/frontiers", 0) == before + 500


def test_concurrent_hammer_no_stale_tiles(stack):
    """8 threads mixing /map-image, /tiles?since= and /map-events while
    the stack explores: every delta client's revision stays monotonic
    with no stale tile (DeltaMapClient raises otherwise), event queues
    stay bounded, and polling keeps a cache hit-rate > 0."""
    base = _base(stack)
    stop = threading.Event()
    errors = []

    def delta_worker():
        try:
            client = DeltaMapClient(base)
            while not stop.is_set():
                client.poll()
                stop.wait(0.03)
        except Exception as e:             # noqa: BLE001
            errors.append(f"delta: {type(e).__name__}: {e}")

    def png_worker():
        try:
            while not stop.is_set():
                with urllib.request.urlopen(f"{base}/map-image",
                                            timeout=10) as r:
                    r.read()
                stop.wait(0.03)
        except Exception as e:             # noqa: BLE001
            errors.append(f"png: {type(e).__name__}: {e}")

    def events_worker():
        try:
            while not stop.is_set():
                with urllib.request.urlopen(
                        f"{base}/map-events?mode=poll&since=-1&wait_s=1",
                        timeout=10) as r:
                    json.loads(r.read())
                # Paced like the other workers: since=-1 answers at once,
                # and an unpaced loop starves the stepping thread of the
                # interpreter lock.
                stop.wait(0.03)
        except Exception as e:             # noqa: BLE001
            errors.append(f"events: {type(e).__name__}: {e}")

    threads = [threading.Thread(target=delta_worker) for _ in range(3)] \
        + [threading.Thread(target=png_worker) for _ in range(3)] \
        + [threading.Thread(target=events_worker) for _ in range(2)]
    for t in threads:
        t.start()
    for _ in range(10):
        stack.run_steps(5)
        stack.mapper.publish_map()
        time.sleep(0.05)
    stop.set()
    for t in threads:
        t.join(timeout=30)
    assert not [t for t in threads if t.is_alive()]
    assert errors == []
    depth = stack.cfg.serving.event_queue_depth
    ch = stack.api.serving.events
    assert all(s.pending() <= depth for s in list(ch._subs))
    assert stack.api.png_cache_hits.get("map", 0) > 0
    assert stack.api.serving.map_store.stats()["n_hint_missed"] == 0


def test_racewatch_clean_on_live_stack_with_serving(stack):
    """The JAX package's lockset race watch (it imports no JAX) over the
    port's live serving stack: the mapper, the grid tile store and the
    event channel, hammered from the tile poller, SSE and long-poll
    threads, converge on their declared locks with no report."""
    from jax_mapping.analysis.protection import groups_by_class
    from jax_mapping.analysis.racewatch import RaceWatch

    by = groups_by_class()
    base = _base(stack)
    watch = RaceWatch()
    try:
        watch.watch_object(stack.mapper, by["MapperNode"][0],
                           name="mapper")
        watch.watch_object(stack.api.serving.map_store,
                           by["TileStore"][0], name="grid-store")
        watch.watch_object(stack.api.serving.events,
                           by["EventChannel"][0], name="events")
        stop = threading.Event()
        errors = []

        def tile_poller():
            client = DeltaMapClient(base)
            while not stop.is_set():
                try:
                    client.poll()
                except Exception as e:           # noqa: BLE001
                    errors.append(f"poll: {e}")
                stop.wait(0.03)

        def sse_reader():
            try:
                req = urllib.request.Request(
                    f"{base}/map-events?since=-1&timeout_s=3")
                with urllib.request.urlopen(req, timeout=10) as r:
                    for line in r:
                        if stop.is_set():
                            break
                        if line.startswith(b"data:"):
                            json.loads(line[5:].decode())
            except Exception as e:               # noqa: BLE001
                errors.append(f"sse: {e}")

        def long_poller():
            while not stop.is_set():
                try:
                    urllib.request.urlopen(
                        f"{base}/map-events?mode=poll&since=-1&wait_s=0.2",
                        timeout=5).read()
                except Exception:                # noqa: BLE001
                    pass
                stop.wait(0.03)

        threads = [threading.Thread(target=tile_poller),
                   threading.Thread(target=sse_reader),
                   threading.Thread(target=long_poller)]
        for t in threads:
            t.start()
        stack.run_steps(12)
        stop.set()
        for t in threads:
            t.join(timeout=15)
        assert not any(t.is_alive() for t in threads)
    finally:
        watch.unwatch_all()

    assert not errors, errors
    reports = watch.reports()
    assert reports == [], "\n".join(r.message for r in reports)
    states = watch.field_states()
    tiles = states["TileStore._tiles@grid-store"]
    assert tiles.state in ("shared", "shared-modified")
    assert tiles.candidate and \
        "TileStore._lock@grid-store" in tiles.candidate
    grid = states["MapperNode.shared_grid@mapper"]
    assert grid.state == "shared-modified"
    assert grid.candidate == \
        frozenset({"MapperNode._state_lock@mapper"})


# ------------------------------------------------------ disabled / voxel

def test_serving_disabled_is_bit_identical_and_dark():
    """ServingConfig(enabled=False): /tiles and /map-events answer 404,
    no revision tracking runs, and the map is bit-identical to a
    serving-enabled run of the same seed."""
    base_cfg = tiny_config()
    world = W.empty_arena(96, base_cfg.grid.resolution_m)
    cfg_off = dataclasses.replace(
        base_cfg,
        serving=dataclasses.replace(base_cfg.serving, enabled=False))
    grids = {}
    for key, cfg in (("on", base_cfg), ("off", cfg_off)):
        st = launch_sim_stack(cfg, world, n_robots=1, http_port=0,
                              realtime=False, seed=11, device="cpu")
        try:
            st.brain.start_exploring()
            st.run_steps(25)
            grids[key] = st.mapper.merged_grid().numpy().copy()
            if key == "off":
                assert st.api.serving is None
                assert st.mapper.map_revision == 0
                for route in ("/tiles", "/map-events?mode=poll",
                              "/voxel-tiles"):
                    with pytest.raises(urllib.error.HTTPError) as ei:
                        urllib.request.urlopen(_base(st) + route, timeout=5)
                    assert ei.value.code == 404
            else:
                assert st.mapper.map_revision > 0
        finally:
            st.shutdown()
    assert np.array_equal(grids["on"], grids["off"])


def test_voxel_height_tiles_ride_the_same_store():
    cfg = tiny_config()
    world = W.plank_course(96, cfg.grid.resolution_m, n_planks=4, seed=5)
    st = launch_sim_stack(cfg, world, n_robots=1, http_port=0,
                          realtime=False, depth_cam=True, device="cpu")
    try:
        st.brain.start_exploring()
        st.run_steps(15)
        client = DeltaMapClient(_base(st), route="/voxel-tiles")
        client.poll()
        st.run_steps(10)
        client.poll()
        client.poll()
        _rev, expect = st.voxel_mapper.serving_snapshot()
        assert np.array_equal(client.image(0), expect)
        assert client.meta["map"] == "voxel-height"
        assert st.api.serving.voxel_store.stats()["n_tiles_encoded"] > 0
    finally:
        st.shutdown()


def test_loadgen_smoke():
    """The load generator on the tiny config for a few seconds: both
    client kinds run clean, and the delta path carries fewer bytes than
    whole-PNG polling."""
    from jax_mapping_torch.serving.loadgen import run_serving_benchmark
    r = run_serving_benchmark(cfg=tiny_config(), n_clients=4,
                              duration_s=2.5, warmup_steps=20,
                              world_cells=80, n_planks=4, n_robots=1,
                              device="cpu")
    assert r["whole_png_polling"]["errors"] == []
    assert r["tiled_delta"]["errors"] == []
    assert r["whole_png_polling"]["polls"] > 0
    assert r["tiled_delta"]["polls"] > 0
    assert r["bytes_reduction_factor"] is not None
    assert r["bytes_reduction_factor"] > 1.0
    assert r["png_cache_hit_rate"] > 0


# ------------------------------------------------ the snapshot's lifetime

def _closure_config():
    """tiny_config(2) with the closure settings that close a loop on
    plank_course(96) in ~60 steps (tests/test_torch_voxel_stack.py), and
    decay every 7 ticks."""
    from jax_mapping_torch.config import DecayConfig
    cfg = tiny_config(2)
    return cfg.replace(
        robot=dataclasses.replace(cfg.robot, speed_noise_frac=0.0,
                                  cruise_speed_units=500),
        loop=dataclasses.replace(cfg.loop, min_chain_size=3,
                                 search_radius_m=0.3, loop_window_m=1.0,
                                 response_coarse=0.2, response_fine=0.3),
        decay=DecayConfig(enabled=True, every_n_ticks=7, factor=0.9,
                          evidence_cap=1.5))


class _SnapshotWatch:
    """Snapshots the mapper's serving grid before each step and checks,
    after it, that the snapshot's bytes did not move."""

    def __init__(self, mapper):
        self.mapper, self.held, self.moved = mapper, [], 0

    def take(self):
        rev, grid, _hint = self.mapper.serving_snapshot()
        self.held.append((rev, grid, grid.clone(),
                          G.tile_hashes(grid, 64).clone()))

    def check(self):
        for _rev, grid, copy, h in self.held:
            if not (torch.equal(grid, copy)
                    and torch.equal(G.tile_hashes(grid, 64), h)):
                self.moved += 1
        self.held = self.held[-4:]


def test_serving_snapshot_never_moves():
    """The tile store reads the grid `serving_snapshot` hands it after the
    state lock is released, on another thread. The mapper never writes
    into such a grid: a snapshot taken before a step keeps its bytes
    through single-scan steps, K5 bursts, a loop-closure re-fuse, decay
    passes, /load's restore and a prior's seeding."""
    cfg = _closure_config()
    world = W.plank_course(96, cfg.grid.resolution_m, n_planks=4, seed=3)
    st = launch_sim_stack(cfg, world, n_robots=2, device="cpu")
    try:
        m = st.mapper
        watch = _SnapshotWatch(m)
        st.brain.start_exploring()
        windows = m.n_windows_fused
        for k in range(70):
            watch.take()
            if k % 10 == 9:                # a burst: one K5 window each
                for _ in range(4):
                    st.sim.step()
                    st.brain.update_loop()
            st.run_steps(1)
            watch.check()
            if m.n_loops_closed and k >= 30:
                break
        assert m.n_loops_closed > 0, "no loop closed: no ring re-fuse ran"
        assert m.n_windows_fused > windows and m.n_decay_passes > 0
        watch.take()
        m.restore_states(m.snapshot_states())
        watch.check()
        watch.take()
        m.seed_map_prior(np.zeros((cfg.grid.size_cells,) * 2, np.float32))
        watch.check()
        assert watch.moved == 0
    finally:
        st.shutdown()


def test_windowed_serving_snapshot_never_moves(tmp_path):
    """A windowed mapper's snapshot keeps its bytes through a window
    shift (eviction to the host and disk tiers) and the walk back
    (rehydration)."""
    from jax_mapping_torch.bridge.bus import Bus
    from jax_mapping_torch.bridge.mapper import MapperNode
    from tests.test_torch_world import _odom, _ranges, _scan, _wcfg
    cfg = _wcfg(host_tile_budget=2)
    bus = Bus()
    m = MapperNode(cfg, bus, n_robots=1, device="cpu",
                   spill_dir=str(tmp_path))
    try:
        watch = _SnapshotWatch(m)
        scan_pub, odom_pub = bus.publisher("scan"), bus.publisher("odom")
        ranges = _ranges(cfg)[:cfg.scan.n_beams]
        t = 0.0
        for x in [0.0, 1.6, 3.2, 4.8, 6.4, 8.0, 6.4, 4.8, 3.2, 1.6, 0.0,
                  0.0]:
            t += 0.5
            watch.take()
            odom_pub.publish(_odom(t, x, 0.0, 0.0))
            scan_pub.publish(_scan(t, cfg, ranges=ranges))
            m.tick()
            watch.check()
        ws = m.world.status()
        assert m.world.n_shifts >= 2
        assert ws["rehydrated_host"] + ws["rehydrated_disk"] > 0
        assert watch.moved == 0
    finally:
        m.destroy()
