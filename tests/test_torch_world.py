"""The port's bounded-memory world store against its oracle and the JAX
package's store.

Ports of the JAX package's `tests/test_world.py` store and mapper tests,
on the CPU at tiny_config with a 768-cell logical lattice (12 serving
tiles of 64 cells) and a 4-tile window:

* the window equals a big-grid oracle (K1's plain deltas at the global
  patch origin, clip-added) bit for bit after every step of an east-and-
  back walk, through host and disk eviction, re-entry and a decay pass;
* a disk hit reads unknown until the next poll, a corrupt spill degrades
  to unknown with a flight event, a torn spill tail truncates;
* the governor's ladder, refused admission, the pressure shed, rung-2
  coarsening, same-seed schedules, serving composition and both
  checkpoint payloads;
* the windowed mapper's shift translates its pose leaves, and
  `windowed=False` builds no store;
* a threaded evict-vs-serve drive under the JAX package's RaceWatch, whose
  `WorldStore` / `MemoryGovernor` protection groups attach to the port's
  classes unchanged, reports nothing.

The parity test runs one shared drive text through both packages' stores
(the JAX side in a fresh `JAX_PLATFORMS=cpu` subprocess,
`tests/torch_jaxref.py`): schedules, origins and offsets are equal, and
the windows agree within the jitted-`classify_patch` tolerance of ROADMAP
C (at most 1e-4 of cells differ, each on a decision boundary of the
sensor model).
"""

import dataclasses
import json
import threading

import numpy as np
import pytest
import torch

from jax_mapping_torch.config import WorldConfig, tiny_config
from jax_mapping_torch.ops import grid as G
from jax_mapping_torch.ops import sensor_kernel as SK
from jax_mapping_torch.world.store import WorldStore, window_slam_config
from tests.test_torch_sensor_model import boundary_cells
from tests.torch_jaxref import run_reference
from tests.torch_threads import one_intra_op_thread  # noqa: F401

DEV = dict(device="cpu")       # for the grids


def _wcfg(**world_kw):
    """Windowed tiny config: a 768-cell logical lattice (12 tiles), a
    4-tile (256-cell) window, a 1-tile margin (recentres at |x| > 3.2 m)."""
    cfg = tiny_config()
    kw = dict(windowed=True, window_tiles=4, margin_tiles=1,
              host_tile_budget=64)
    kw.update(world_kw)
    return cfg.replace(grid=dataclasses.replace(cfg.grid, size_cells=768),
                       world=WorldConfig(**kw))


def _ranges(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.5, 2.5, cfg.scan.padded_beams).astype(np.float32)


def _oracle_fuse(cfg, big, ranges, pose_world):
    """The big-grid fusion a windowed run's live region must equal: K1's
    deltas at the global patch origin, clip-added."""
    pose = torch.as_tensor(np.asarray(pose_world, np.float32))
    og = G.patch_origin(cfg.grid, pose[:2])
    delta = SK.scan_deltas(cfg.grid, cfg.scan,
                           torch.as_tensor(ranges).reshape(1, -1),
                           pose.reshape(1, 3), og.reshape(1, 2))[0]
    r, c = int(og[0]), int(og[1])
    p = cfg.grid.patch_cells
    out = big.clone()
    out[r:r + p, c:c + p] = torch.clamp(out[r:r + p, c:c + p] + delta,
                                        cfg.grid.logodds_min,
                                        cfg.grid.logodds_max)
    return out


def _window_region(store, big):
    t = store.tile_cells
    r0, c0 = store.origin_tile
    w = store.window_cells
    return big[r0 * t:r0 * t + w, c0 * t:c0 * t + w]


#: One drive for both packages (run here with the port's names, and in
#: the JAX reference with the JAX package's): walk one robot along y = 0
#: fusing a scan a pose, polling and recentring as the mapper does.
#: Returns the store and each step's (window, origin, offset).
DRIVE = '''
def drive(WorldStore, G, dev, cfg, xs, ranges, spill_dir=None,
          decay_at=(), pressure_at=(), oracle=None):
    store = WorldStore(cfg, spill_dir=spill_dir)
    win = G.empty_grid(store.cfg.grid, **dev)
    big = G.empty_grid(cfg.grid, **dev) if oracle else None
    steps = []
    for i, x in enumerate(xs):
        pose_w = np.array([x, 0.0, 0.0], np.float32)
        win, _ = store.poll_prefetch(win)
        off = store.offset_xy()
        dr, dc = store.desired_shift(
            [pose_w - np.array([off[0], off[1], 0.0], np.float32)])
        if (dr, dc) != (0, 0):
            win = store.shift(win, dr, dc)
            win, _ = store.poll_prefetch(win)
        win = store.fuse_scan_global(win, ranges, pose_w)
        if oracle:
            big = oracle(cfg, big, ranges, pose_w)
        if i in decay_at:
            d = cfg.decay
            win = G.decay_grid(win, d.factor, d.evidence_cap)
            store.note_decay_pass()
            if oracle:
                big = G.decay_grid(big, d.factor, d.evidence_cap)
        if i in pressure_at:
            store.hold_pressure(f"drive@{i}", 0.5)
        steps.append((np.asarray(win), store.origin_tile,
                      store.offset_xy(), big))
    return store, steps
'''
_ns: dict = {"np": np}
exec(DRIVE, _ns)


def _drive(cfg, xs, spill_dir=None, decay_at=(), pressure_at=(),
           check_each=True):
    """The shared drive on the port, the oracle beside it; with
    `check_each`, the window equals the oracle's region after every
    step. Returns (store, window, big)."""
    store, steps = _ns["drive"](
        WorldStore, G, DEV, cfg, xs, _ranges(cfg), spill_dir=spill_dir,
        decay_at=decay_at, pressure_at=pressure_at, oracle=_oracle_fuse)
    t = store.tile_cells
    w = store.window_cells
    if check_each:
        for i, (win, (r0, c0), _off, big) in enumerate(steps):
            np.testing.assert_array_equal(
                win, big[r0 * t:r0 * t + w, c0 * t:c0 * t + w].numpy(),
                err_msg=f"window diverged from the oracle at step {i}")
    return store, torch.as_tensor(steps[-1][0]), steps[-1][3]


#: East and back: two eastward recentres evict what the robot mapped
#: near the origin, the return leg rehydrates it.
_WALK = [0.0, 1.6, 3.3, 6.6, 9.9, 6.6, 3.3, 0.0]


# --------------------------------------------------- config derivation

def test_window_slam_config_geometry_validation():
    cfg = _wcfg()
    out = window_slam_config(cfg)
    assert out.grid.size_cells == 4 * 64
    assert out.grid.patch_cells == cfg.grid.patch_cells
    assert out.scan == cfg.scan
    assert out.serving == cfg.serving
    bad = cfg.replace(grid=dataclasses.replace(cfg.grid, size_cells=800))
    with pytest.raises(ValueError, match="not divisible"):
        window_slam_config(bad)
    with pytest.raises(ValueError, match="exceeds the logical"):
        window_slam_config(_wcfg(window_tiles=16))
    with pytest.raises(ValueError, match="must be even"):
        window_slam_config(_wcfg(window_tiles=3))
    with pytest.raises(ValueError, match="no interior"):
        window_slam_config(_wcfg(margin_tiles=2))


def test_offset_starts_at_exact_zero_and_advances_by_tiles():
    store = WorldStore(_wcfg())
    assert store.origin_tile == (4, 4)
    np.testing.assert_array_equal(store.offset_xy(), np.zeros(2, np.float32))
    win = G.empty_grid(store.cfg.grid, "cpu")
    out = store.shift(win, 1, 2)
    assert out is not win and not win.any()       # a new tensor
    assert store.origin_tile == (5, 6)
    np.testing.assert_allclose(store.offset_xy(), [6.4, 3.2])
    np.testing.assert_array_equal(store.shift_delta_m(1, 2),
                                  store.offset_xy())
    assert store.n_shifts == 1


# ------------------------------------------------- oracle bit-identity

def test_host_eviction_roundtrip_bit_identical_to_oracle():
    """East and back with a roomy host budget: through two evicting
    shifts, a decay pass and the host rehydration, the window equals the
    oracle after every step (evicted tiles replay the missed pass)."""
    store, _win, _big = _drive(_wcfg(), _WALK, decay_at=(4,))
    assert store.n_shifts >= 3
    assert store.n_evictions > 0
    assert store.n_rehydrated_host > 0
    assert store.n_lost == 0 and store.n_corrupt_spills == 0
    assert store.decay_epoch == 1
    np.testing.assert_array_equal(store.offset_xy(), np.zeros(2, np.float32))


def test_disk_spill_roundtrip_bit_identical_to_oracle(tmp_path):
    """A one-tile host budget pushes evicted content to disk (lossless
    with retention_coarsen=1); the return leg rehydrates through the
    prefetch path and still equals the oracle."""
    cfg = _wcfg(host_tile_budget=1, retention_coarsen=1)
    store, _win, _big = _drive(cfg, _WALK, spill_dir=str(tmp_path))
    assert store.n_rehydrated_disk > 0
    assert store.governor.n_spills > 0
    assert store.n_corrupt_spills == 0
    assert store.spill.n_corrupt_reads == 0
    store.close()


def _fused_then_away(cfg, spill_dir=None):
    """A store with one scan fused at the origin and the whole window
    shifted away; returns (store, window, oracle big grid)."""
    store = WorldStore(cfg, spill_dir=spill_dir)
    win = G.empty_grid(store.cfg.grid, "cpu")
    big = G.empty_grid(cfg.grid, "cpu")
    ranges = _ranges(cfg)
    pose = np.zeros(3, np.float32)
    win = store.fuse_scan_global(win, ranges, pose)
    big = _oracle_fuse(cfg, big, ranges, pose)
    return store, store.shift(win, 0, 4), big


def test_disk_rehydration_is_one_tick_unknown_degrade(tmp_path):
    """A disk hit is not scattered at shift time: the tile reads unknown
    until the next poll joins the prefetch."""
    cfg = _wcfg(host_tile_budget=1, retention_coarsen=1)
    store, win, big = _fused_then_away(cfg, str(tmp_path))
    assert store.host_tiles() == 1
    spilled = store.spill.tiles()
    assert len(spilled) == 3
    win = store.shift(win, 0, -4)
    assert store.status()["pending_prefetch"] > 0
    t = store.tile_cells
    for (r, c) in spilled:
        sr, sc = r - store.origin_tile[0], c - store.origin_tile[1]
        assert not win[sr * t:(sr + 1) * t, sc * t:(sc + 1) * t].any()
    before = win.clone()
    out, n = store.poll_prefetch(win)
    assert torch.equal(win, before)               # the input is a value
    win = out
    assert n == len(spilled)
    torch.testing.assert_close(win, _window_region(store, big), rtol=0,
                               atol=0)
    assert store.status()["pending_prefetch"] == 0
    assert store.n_rehydrated_disk == n
    store.close()


# ----------------------------------------------- integrity and degrade

def test_corrupt_spill_degrades_to_unknown_with_flight_event(tmp_path):
    from jax_mapping_torch.obs.recorder import flight_recorder
    cfg = _wcfg(host_tile_budget=1, retention_coarsen=1)
    store, win, big = _fused_then_away(cfg, str(tmp_path))
    hit = store.corrupt_spill(1)
    assert len(hit) == 1
    mark = flight_recorder.mark()
    win = store.shift(win, 0, -4)
    win, _n_ok = store.poll_prefetch(win)        # never raises
    assert store.n_corrupt_spills == 1
    assert store.n_lost >= 1
    evs = [e for e in flight_recorder.events_since(mark)
           if e["kind"] == "world_spill_corrupt"]
    assert len(evs) == 1 and tuple(evs[0]["tile"]) == hit[0]
    assert store.status()["away_tiles"] == 0
    t = store.tile_cells
    oracle = _window_region(store, big).clone()
    r, c = hit[0]
    sr, sc = r - store.origin_tile[0], c - store.origin_tile[1]
    assert not win[sr * t:(sr + 1) * t, sc * t:(sc + 1) * t].any()
    oracle[sr * t:(sr + 1) * t, sc * t:(sc + 1) * t] = 0.0
    assert torch.equal(win, oracle)
    store.close()


def test_spillstore_torn_tail_truncates_newest_gen_wins(tmp_path):
    from jax_mapping_torch.world.spill import SpillStore
    s = SpillStore(str(tmp_path))
    a1 = np.full((8, 8), 1.0, np.float32)
    a2 = np.full((8, 8), 2.0, np.float32)
    b = np.full((8, 8), 3.0, np.float32)
    s.put((1, 2), 1, a1, 0)
    s.put((1, 2), 2, a2, 0)
    s.put((3, 4), 1, b, 0)
    np.testing.assert_array_equal(s.get((1, 2)).data, a2)
    assert s.get((9, 9)) is None
    size_before = s.nbytes()
    s.close()
    with open(s.path, "ab") as f:
        f.write(b"\x40\x00\x00\x00partial")
    s2 = SpillStore(str(tmp_path))
    assert s2.n_truncated_bytes > 0
    np.testing.assert_array_equal(s2.get((1, 2)).data, a2)
    np.testing.assert_array_equal(s2.get((3, 4)).data, b)
    s2.compact()
    assert s2.nbytes() < size_before
    np.testing.assert_array_equal(s2.get((1, 2)).data, a2)
    assert s2.corrupt_tiles(1) == [(1, 2)]
    assert s2.get((1, 2)) is None
    assert s2.n_corrupt_reads == 1
    np.testing.assert_array_equal(s2.get((3, 4)).data, b)
    s2.close()


# -------------------------------------------------- the governor ladder

def test_governor_watermark_ladder_and_worst_of_holds():
    from jax_mapping_torch.world.governor import MemoryGovernor
    gov = MemoryGovernor(WorldConfig(host_tile_budget=100))
    assert gov.observe(50) == 0
    assert gov.observe(80) == 1
    assert gov.observe(93) == 2
    assert gov.observe(100) == 3
    assert gov.observe(10) == 0
    assert gov.n_rung_changes == 4
    gov.hold_pressure("a", 0.5)
    assert gov.effective_budget() == 50
    gov.hold_pressure("b", 0.75)
    assert gov.effective_budget() == 25
    assert gov.pressure() == 0.75
    gov.release_pressure("b")
    assert gov.effective_budget() == 50
    gov.release_pressure("a")
    assert gov.effective_budget() == 100
    st = gov.status()
    assert st["rung_name"] == "normal" and st["pressure_holds"] == 0
    assert st["effective_budget_tiles"] == 100


def test_refused_admission_reenters_as_unknown():
    """Rung 3 without a disk tier drops the tile (flight event, counters);
    re-entry clears the away marker: resident again AS UNKNOWN."""
    from jax_mapping_torch.obs.recorder import flight_recorder
    cfg = _wcfg(host_tile_budget=1)
    store = WorldStore(cfg)
    win = G.empty_grid(store.cfg.grid, "cpu")
    win = store.fuse_scan_global(win, _ranges(cfg), np.zeros(3, np.float32))
    mark = flight_recorder.mark()
    win = store.shift(win, 0, 4)
    assert store.governor.n_refused > 0
    assert store.n_lost == store.governor.n_refused
    assert store.host_tiles() == 0
    evs = [e for e in flight_recorder.events_since(mark)
           if e["kind"] == "world_admission_refused"]
    assert len(evs) == store.governor.n_refused
    assert store.status()["away_tiles"] > 0
    epoch = store.eviction_epoch
    win = store.shift(win, 0, -4)
    assert store.status()["away_tiles"] == 0
    assert store.eviction_epoch > epoch
    assert not win.any()
    assert any(ev[0] == "reenter_unknown" for ev in store.schedule)


def test_pressure_hold_sheds_immediately_drop_without_spill():
    cfg = _wcfg(host_tile_budget=4)
    store, _win, _big = _fused_then_away(cfg)
    n_host = store.host_tiles()
    assert n_host >= 2
    lost_before = store.n_lost
    store.hold_pressure("chaos@1", 0.7)           # effective budget -> 1
    assert store.host_tiles() == 1
    assert store.governor.n_drops == n_host - 1
    assert store.n_lost - lost_before == n_host - 1
    store.release_pressure("chaos@1")
    assert store.governor.effective_budget() == 4
    assert any(ev[0] == "pressure" for ev in store.schedule)
    assert any(ev[0] == "pressure_clear" for ev in store.schedule)


def test_rung2_coarsens_spilled_retention(tmp_path):
    """Above the critical watermark the spill coarsens by
    `retention_coarsen`; rehydration upsamples back to the tile."""
    cfg = _wcfg(host_tile_budget=1)              # default coarsen = 2
    store, win, _big = _fused_then_away(cfg, str(tmp_path))
    assert store.governor.n_coarsened > 0
    win = store.shift(win, 0, -4)
    win, n = store.poll_prefetch(win)
    assert n > 0 and store.n_rehydrated_disk == n
    assert win.any()
    assert tuple(win.shape) == (256, 256)
    store.close()


# --------------------------------------------------------- determinism

def test_same_seed_drives_produce_bit_identical_schedules(tmp_path):
    cfg = _wcfg(host_tile_budget=1, retention_coarsen=1)
    a, win_a, _ = _drive(cfg, _WALK, spill_dir=str(tmp_path / "a"),
                         decay_at=(4,), pressure_at=(3,), check_each=False)
    b, win_b, _ = _drive(cfg, _WALK, spill_dir=str(tmp_path / "b"),
                         decay_at=(4,), pressure_at=(3,), check_each=False)
    assert a.schedule == b.schedule
    assert a.n_schedule_events == b.n_schedule_events
    assert a.origin_tile == b.origin_tile
    assert a.status()["evictions"] == b.status()["evictions"]
    assert torch.equal(win_a, win_b)
    kinds = {ev[0] for ev in a.schedule}
    assert {"shift", "evict", "spill", "prefetch", "rehydrate",
            "pressure"} <= kinds
    a.close()
    b.close()


# ----------------------------------------------- serving composition

def test_compose_serving_masks_away_tiles():
    store, _win, _big = _fused_then_away(_wcfg(host_tile_budget=64))
    gray = np.full((store.window_cells, store.window_cells), 200, np.uint8)
    mosaic, mask = store.compose_serving(gray)
    assert mosaic.shape == (768, 768) and mask.shape == (12, 12)
    r0, c0 = store.origin_tile
    t = store.tile_cells
    w = store.window_cells
    assert (mosaic[r0 * t:r0 * t + w, c0 * t:c0 * t + w] == 200).all()
    outside = mosaic.copy()
    outside[r0 * t:r0 * t + w, c0 * t:c0 * t + w] = 127
    assert (outside == 127).all()
    away = {tuple(t_) for t_ in np.argwhere(mask)}
    assert away and away == store._away


# ------------------------------------------------ checkpoint payloads

def test_checkpoint_payload_roundtrip_embedded_host():
    cfg = _wcfg()
    store, _win, big = _drive(cfg, [0.0, 1.6, 3.3], check_each=False)
    payload = store.checkpoint_payload()
    assert "host_meta" in payload and "host_tiles" in payload
    fresh = WorldStore(cfg)
    fresh.restore_payload(payload)
    assert fresh.origin_tile == store.origin_tile
    assert fresh._away == store._away
    assert fresh.decay_epoch == store.decay_epoch
    assert fresh.eviction_epoch == store.eviction_epoch
    win2 = G.empty_grid(fresh.cfg.grid, "cpu")
    win2 = fresh.shift(win2, 0, 4 - fresh.origin_tile[1])
    assert torch.equal(win2[:, :2 * 64],
                       _window_region(fresh, big)[:, :2 * 64])
    assert fresh.n_rehydrated_host > 0


def test_checkpoint_payload_spill_backed_flushes_host(tmp_path):
    cfg = _wcfg(host_tile_budget=1, retention_coarsen=1)
    store, _win, big = _drive(cfg, [0.0, 1.6, 3.3], spill_dir=str(tmp_path),
                              check_each=False)
    payload = store.checkpoint_payload()
    assert "host_meta" not in payload
    assert store.host_tiles() == 0
    store.close()
    fresh = WorldStore(cfg, spill_dir=str(tmp_path))
    fresh.restore_payload(payload)
    assert fresh.origin_tile == store.origin_tile
    win2 = G.empty_grid(fresh.cfg.grid, "cpu")
    win2 = fresh.shift(win2, 0, 4 - fresh.origin_tile[1])
    win2, n = fresh.poll_prefetch(win2)
    assert n > 0
    assert torch.equal(win2[:, :2 * 64],
                       _window_region(fresh, big)[:, :2 * 64])
    fresh.close()


# -------------------------------------------- evict vs serve vs status

def test_racewatch_evict_vs_serve_vs_status():
    """One tick thread shifting, evicting, rehydrating and holding
    pressure against three threads composing serving mosaics, reading
    status and taking checkpoint payloads: the port's RaceWatch, with
    its protection groups for `WorldStore` and `MemoryGovernor`
    attached to the port's objects, reports nothing, and the cross-thread
    `_gen` converges on the store's lock."""
    from jax_mapping_torch.analysis.protection import groups_by_class
    from jax_mapping_torch.analysis.racewatch import RaceWatch
    cfg = _wcfg(host_tile_budget=64)
    store = WorldStore(cfg)
    win = G.empty_grid(store.cfg.grid, "cpu")
    win = store.fuse_scan_global(win, _ranges(cfg), np.zeros(3, np.float32))
    errs = []
    watch = RaceWatch()
    try:
        watch.watch_object(store, groups_by_class()["WorldStore"][0],
                           name="world")
        watch.watch_object(store.governor,
                           groups_by_class()["MemoryGovernor"][0],
                           name="gov")

        def tick(g=win):
            try:
                for _ in range(25):
                    g = store.shift(g, 0, 2)
                    store.note_decay_pass()
                    store.hold_pressure("gate", 0.3)
                    g = store.shift(g, 0, -2)
                    g, _ = store.poll_prefetch(g)
                    store.release_pressure("gate")
            except Exception as e:            # noqa: BLE001
                errs.append(e)

        def serve():
            gray = np.full((store.window_cells, store.window_cells), 127,
                           np.uint8)
            try:
                for _ in range(120):
                    store.compose_serving(gray)
                    store.status()
                    store.host_tiles()
                    store.checkpoint_payload()
            except Exception as e:            # noqa: BLE001
                errs.append(e)

        threads = [threading.Thread(target=tick)] + \
            [threading.Thread(target=serve) for _ in range(3)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        assert not any(t.is_alive() for t in threads)
    finally:
        watch.unwatch_all()
    assert errs == []
    assert watch.reports() == [], \
        "\n".join(r.message for r in watch.reports())
    gen = watch.field_states()["WorldStore._gen@world"]
    assert gen.state == "shared-modified"
    assert "WorldStore._lock@world" in gen.candidate


# ------------------------------------------------ mapper integration

def _scan(stamp, cfg, ranges=None):
    from jax_mapping_torch.bridge.messages import Header, LaserScan
    r = np.zeros(cfg.scan.n_beams, np.float32) if ranges is None else ranges
    return LaserScan(header=Header(stamp=stamp, frame_id="base_laser"),
                     angle_increment=cfg.scan.angle_increment_rad, ranges=r)


def _odom(stamp, x, y, theta):
    from jax_mapping_torch.bridge.messages import (Header, Odometry, Pose2D,
                                                   Twist)
    return Odometry(header=Header(stamp=stamp, frame_id="odom"),
                    pose=Pose2D(x, y, theta),
                    twist=Twist(linear_x=0.0, angular_z=0.0))


def test_windowed_mapper_shift_translates_pose_leaves():
    """The mapper runs window-frame machinery; a margin-band crossing
    shifts the window and translates every pose-like leaf, so window pose
    + offset == world pose through the shift (zero-range scans: pure
    odometry, which is the world-frame truth)."""
    from jax_mapping_torch.bridge.bus import Bus
    from jax_mapping_torch.bridge.mapper import MapperNode
    from jax_mapping_torch.obs.recorder import flight_recorder
    cfg = _wcfg()
    bus = Bus()
    mapper = MapperNode(cfg, bus, n_robots=1, device="cpu")
    try:
        assert mapper.world is not None
        assert mapper.cfg.grid.size_cells == 256
        assert mapper.full_cfg.grid.size_cells == 768
        scan_pub = bus.publisher("scan")
        odom_pub = bus.publisher("odom")
        mark = flight_recorder.mark()
        t = 0.0
        for x in [0.0, 0.8, 1.6, 2.4, 3.2, 4.0, 4.8]:
            t += 0.5
            odom_pub.publish(_odom(t, x, 0.0, 0.0))
            scan_pub.publish(_scan(t, cfg))
            mapper.tick()
        assert mapper.world.n_shifts >= 1
        ws = mapper.world_status()
        assert ws["windowed"] and ws["origin_tile"] != [4, 4]
        off = mapper.world.offset_xy()
        assert float(off[0]) > 0.0 and float(off[1]) == 0.0
        pose = mapper.states[0].pose.numpy()
        assert pose[0] + off[0] == pytest.approx(4.8, abs=1e-3)
        assert abs(pose[0]) < 6.4
        evs = [e for e in flight_recorder.events_since(mark)
               if e["kind"] == "window_shift"]
        assert evs and evs[0]["dr"] == 0 and evs[0]["dc"] > 0
        assert ws["offset_m"] == [float(off[0]), float(off[1])]
        # The graph's node and the correction basis moved with the frame.
        _gen, gposes, valid, n, _k = mapper.graph_snapshot(0)
        assert n >= 1
        assert gposes[0, 0] == pytest.approx(0.0, abs=1e-3)
    finally:
        mapper.destroy()


def test_windowed_off_builds_no_store_and_is_knob_inert():
    """`windowed=False` builds no store, and the other world knobs are
    inert: identical input gives identical grids."""
    from jax_mapping_torch.bridge.bus import Bus
    from jax_mapping_torch.bridge.mapper import MapperNode
    base = tiny_config()
    grids = []
    for knobs in (WorldConfig(),
                  WorldConfig(windowed=False, window_tiles=6,
                              margin_tiles=2, host_tile_budget=7)):
        cfg = base.replace(world=knobs)
        bus = Bus()
        mapper = MapperNode(cfg, bus, n_robots=1, device="cpu")
        assert mapper.world is None
        assert mapper.world_status() is None
        assert mapper.cfg.grid.size_cells == base.grid.size_cells
        scan_pub = bus.publisher("scan")
        odom_pub = bus.publisher("odom")
        ranges = _ranges(cfg)[:cfg.scan.n_beams]
        for i, x in enumerate([0.0, 0.3, 0.6]):
            st = 0.5 * (i + 1)
            odom_pub.publish(_odom(st, x, 0.0, 0.0))
            scan_pub.publish(_scan(st, cfg, ranges=ranges))
            mapper.tick()
        grids.append(mapper.shared_grid.clone())
        mapper.destroy()
    assert torch.equal(grids[0], grids[1])


def test_windowed_mapper_refuses_map_prior():
    from jax_mapping_torch.bridge.bus import Bus
    from jax_mapping_torch.bridge.mapper import MapperNode
    mapper = MapperNode(_wcfg(), Bus(), n_robots=1, device="cpu")
    with pytest.raises(ValueError, match="windowed mode"):
        mapper.seed_map_prior(np.zeros((256, 256), np.float32))
    mapper.destroy()


# ------------------------------------------------- parity with the JAX store

PARITY_DRIVES = {
    "host": dict(world=dict(), decay_at=(4,), pressure_at=()),
    "disk": dict(world=dict(host_tile_budget=1, retention_coarsen=1),
                 decay_at=(4,), pressure_at=(3,)),
}

REFERENCE = DRIVE + '''
import dataclasses, json, tempfile
from jax_mapping.config import WorldConfig, tiny_config
from jax_mapping.ops import grid as G
from jax_mapping.world.store import WorldStore
WALK = %(walk)r
for name, spec in %(drives)r.items():
    base = tiny_config()
    kw = dict(windowed=True, window_tiles=4, margin_tiles=1,
              host_tile_budget=64)
    kw.update(spec["world"])
    cfg = base.replace(grid=dataclasses.replace(base.grid, size_cells=768),
                       world=WorldConfig(**kw))
    ranges = np.random.default_rng(0).uniform(
        0.5, 2.5, cfg.scan.padded_beams).astype(np.float32)
    store, steps = drive(WorldStore, G, {}, cfg, WALK, ranges,
                         spill_dir=tempfile.mkdtemp(),
                         decay_at=spec["decay_at"],
                         pressure_at=spec["pressure_at"])
    OUT[name + ".schedule"] = np.array(json.dumps(store.schedule))
    OUT[name + ".windows"] = np.stack([s[0] for s in steps])
    OUT[name + ".origins"] = np.array([s[1] for s in steps])
    OUT[name + ".offsets"] = np.stack([s[2] for s in steps])
    OUT[name + ".status"] = np.array(json.dumps(
        {k: v for k, v in store.status().items() if k != "spill"}))
'''


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    drives = {k: dict(v, decay_at=tuple(v["decay_at"]),
                      pressure_at=tuple(v["pressure_at"]))
              for k, v in PARITY_DRIVES.items()}
    return run_reference(REFERENCE % dict(walk=_WALK, drives=drives),
                         tmp_path_factory.mktemp("world") / "ref.npz")


@pytest.mark.parametrize("name", list(PARITY_DRIVES))
def test_store_drive_matches_jax(ref, name, tmp_path):
    """The walk through both packages' stores: schedules, origins,
    offsets and status counters exactly equal; each step's window within
    the jitted-classify tolerance (<= 1e-4 of cells differ, each on a
    decision boundary of some fused scan)."""
    spec = PARITY_DRIVES[name]
    cfg = _wcfg(**spec["world"])
    ranges = _ranges(cfg)
    store, steps = _ns["drive"](
        WorldStore, G, DEV, cfg, _WALK, ranges, spill_dir=str(tmp_path),
        decay_at=spec["decay_at"], pressure_at=spec["pressure_at"])
    assert json.loads(json.dumps(store.schedule)) == \
        json.loads(str(ref[name + ".schedule"]))
    np.testing.assert_array_equal([s[1] for s in steps],
                                  ref[name + ".origins"])
    np.testing.assert_array_equal(np.stack([s[2] for s in steps]),
                                  ref[name + ".offsets"])
    status = {k: v for k, v in store.status().items() if k != "spill"}
    assert json.loads(json.dumps(status)) == \
        json.loads(str(ref[name + ".status"]))
    t = store.tile_cells
    poses = np.array([[x, 0.0, 0.0] for x in _WALK], np.float32)
    for i, (win, (r0, c0), _off, _big) in enumerate(steps):
        want = ref[name + ".windows"][i]
        diff = np.argwhere(win != want)
        assert len(diff) <= 1e-4 * win.size, (i, len(diff))
        if len(diff):
            cells = diff + np.array([r0 * t, c0 * t])
            fused = np.arange(len(_WALK)) <= i
            assert boundary_cells(cfg, np.tile(ranges, (len(_WALK), 1)),
                                  poses, fused, cells).all(), i
    store.close()


# ------------------------------------- host-side parity with the JAX store
#
# The JAX package's store does its bookkeeping (bands, recentring, frame
# math, decay catch-up, the admission ladder, coarsening, the spill file)
# in numpy and imports no JAX at module level, so both packages' stores
# run here in one process on the same inputs.

def _jax_wcfg(**world_kw):
    import jax_mapping.config as JC
    cfg = JC.tiny_config()
    kw = dict(windowed=True, window_tiles=4, margin_tiles=1,
              host_tile_budget=64)
    kw.update(world_kw)
    return cfg.replace(grid=dataclasses.replace(cfg.grid, size_cells=768),
                       world=JC.WorldConfig(**kw))


def _jax_store(spill_dir=None, **world_kw):
    from jax_mapping.world.store import WorldStore as JaxStore
    return JaxStore(_jax_wcfg(**world_kw), spill_dir=spill_dir)


SHIFTS = [(0, 1), (0, -1), (1, 0), (-1, 0), (1, 1), (-2, 1), (0, 4),
          (3, -5)]


@pytest.mark.parametrize("dr,dc", SHIFTS)
def test_bands_match_jax(dr, dc):
    """The leaving and entering tiles of a shift, in the same order."""
    assert WorldStore(_wcfg())._bands(dr, dc) == _jax_store()._bands(dr, dc)


@pytest.mark.parametrize("dr,dc", SHIFTS)
def test_shift_window_is_a_roll_with_the_entering_band_zeroed(dr, dc):
    """`shift_window` against its definition in numpy, and the input left
    as it was."""
    from jax_mapping_torch.world.store import shift_window
    rng = np.random.default_rng(abs(dr) * 10 + abs(dc))
    g = rng.standard_normal((256, 256)).astype(np.float32)
    t = 64
    got = shift_window(torch.as_tensor(g), dr * t, dc * t).numpy()
    want = np.roll(g, (-dr * t, -dc * t), axis=(0, 1))
    rows, cols = np.arange(256), np.arange(256)
    keep = ((rows >= max(0, -dr * t)) & (rows < 256 - max(0, dr * t)))[
        :, None] & ((cols >= max(0, -dc * t))
                    & (cols < 256 - max(0, dc * t)))[None, :]
    np.testing.assert_array_equal(got, np.where(keep, want, 0.0))
    assert not np.shares_memory(got, g)


FLEETS = {
    "centre": [(0.0, 0.0)],
    "east": [(3.5, 0.0)],
    "west": [(-3.5, 0.5)],
    "north": [(0.0, 3.4)],
    "south": [(1.0, -3.3)],
    "spread": [(3.3, 0.0), (-1.0, 1.0), (2.0, -2.0)],
}


@pytest.mark.parametrize("fleet", list(FLEETS))
@pytest.mark.parametrize("origin", [(4, 4), (0, 8), (8, 0)])
def test_desired_shift_matches_jax(fleet, origin):
    """The recentring decision (margin band, fleet centroid, clamp to the
    lattice) from any origin, in the window frame."""
    ours, theirs = WorldStore(_wcfg()), _jax_store()
    ours.origin_tile = theirs.origin_tile = origin
    poses = [np.array([x, y, 0.0], np.float32) for x, y in FLEETS[fleet]]
    assert ours.desired_shift(poses) == theirs.desired_shift(poses)


@pytest.mark.parametrize("origin", [(4, 4), (5, 7), (0, 0), (8, 3)])
def test_frame_math_matches_jax(origin):
    ours, theirs = WorldStore(_wcfg()), _jax_store()
    ours.origin_tile = theirs.origin_tile = origin
    np.testing.assert_array_equal(ours.offset_xy(), theirs.offset_xy())
    for dr, dc in SHIFTS:
        np.testing.assert_array_equal(ours.shift_delta_m(dr, dc),
                                      theirs.shift_delta_m(dr, dc))


@pytest.mark.parametrize("missed", [0, 1, 3, 7])
def test_decay_catch_up_matches_jax(missed):
    """A tile's missed decay passes, one float32 clip(x*f) a pass."""
    ours, theirs = WorldStore(_wcfg()), _jax_store()
    for s in (ours, theirs):
        s.decay_epoch = missed
    arr = np.random.default_rng(missed).uniform(
        -3.5, 3.5, (64, 64)).astype(np.float32)
    got = ours._catch_up(arr, 0, 1)
    np.testing.assert_array_equal(got, theirs._catch_up(arr, 0, 1))
    if missed:
        d = tiny_config().decay
        want = G.decay_grid(torch.as_tensor(arr), d.factor, d.evidence_cap)
        for _ in range(missed - 1):
            want = G.decay_grid(want, d.factor, d.evidence_cap)
        np.testing.assert_array_equal(got, want.numpy())


@pytest.mark.parametrize("k", [2, 4])
def test_coarsen_and_upsample_match_jax(k):
    from jax_mapping.world import store as JW
    from jax_mapping_torch.world import store as PW
    arr = np.random.default_rng(k).uniform(-3, 3, (64, 64)).astype(
        np.float32)
    c = PW._coarsen(arr, k)
    np.testing.assert_array_equal(c, JW._coarsen(arr, k))
    np.testing.assert_array_equal(PW._upsample(c, k, 64),
                                  JW._upsample(c, k, 64))


LADDERS = {
    "budget4_no_disk": (dict(host_tile_budget=4), False),
    "budget4_disk": (dict(host_tile_budget=4), True),
    "budget1_disk": (dict(host_tile_budget=1), True),
    "budget16_disk_pressure": (dict(host_tile_budget=16), True),
}


@pytest.mark.parametrize("name", list(LADDERS))
def test_admission_ladder_matches_jax(name, tmp_path):
    """Thirty evictions (a third of them never-observed tiles) through
    both stores' governor ladders, a pressure hold and its release:
    schedules, host tiers, governor and spill status equal, and every
    spilled tile reads back equal."""
    kw, disk = LADDERS[name]
    ours = WorldStore(_wcfg(**kw), spill_dir=str(tmp_path / "p")
                      if disk else None)
    theirs = _jax_store(spill_dir=str(tmp_path / "j") if disk else None,
                        **kw)
    rng = np.random.default_rng(len(name))
    for k in range(30):
        tile = (int(rng.integers(0, 12)), int(rng.integers(0, 12)))
        arr = (rng.uniform(-2, 2, (64, 64)).astype(np.float32)
               if k % 3 else np.zeros((64, 64), np.float32))
        ours._admit(tile, arr)
        theirs._admit(tile, arr.copy())
        if k == 20 and name.endswith("pressure"):
            ours.hold_pressure("squeeze", 0.6)
            theirs.hold_pressure("squeeze", 0.6)
    ours.release_pressure("squeeze")
    theirs.release_pressure("squeeze")
    assert ours.schedule == theirs.schedule
    assert list(ours._host) == list(theirs._host)
    assert ours._away == theirs._away
    assert ours.governor.status() == theirs.governor.status()
    assert (ours.n_lost, ours.eviction_epoch) == (theirs.n_lost,
                                                   theirs.eviction_epoch)
    if disk:
        assert ours.spill.tiles() == theirs.spill.tiles()
        for tile in ours.spill.tiles():
            a, b = ours.spill.get(tile), theirs.spill.get(tile)
            assert (a.gen, a.coarse) == (b.gen, b.coarse)
            np.testing.assert_array_equal(a.data, b.data)
        ours.close()
        theirs.close()


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_spill_file_reads_across_packages(writer, tmp_path):
    """A spill file one package wrote (several generations, a coarse
    tile) is the other's: same index, same tiles."""
    from jax_mapping.world.spill import SpillStore as JaxSpill
    from jax_mapping_torch.world.spill import SpillStore
    W_, R_ = (SpillStore, JaxSpill) if writer == "port" else \
        (JaxSpill, SpillStore)
    w = W_(str(tmp_path))
    rng = np.random.default_rng(3)
    tiles = {}
    for gen in range(1, 7):
        tile = (gen % 3, 5)
        tiles[tile] = rng.uniform(-1, 1, (8, 8)).astype(np.float32)
        w.put(tile, gen, tiles[tile], decay_epoch=gen // 2,
              coarse=2 if gen == 6 else 1)
    w.close()
    r = R_(str(tmp_path))
    assert r.tiles() == sorted(tiles)
    for tile, arr in tiles.items():
        rec = r.get(tile)
        np.testing.assert_array_equal(rec.data, arr)
    assert r.get((0, 5)).coarse == 2
    r.close()


# ------------------------------------ the windowed mapper's world frame
#
# One robot driven east on noise-free odometry with scans raycast in an
# arena, past the margin band: the window shifts, and every boundary the
# mapper publishes through (the `/pose` and `/frontiers` topics, the
# correction TF, `/map`, `graph_snapshot`, `depth_anchor`) is in the world
# frame, i.e. the window frame plus `world.offset_xy()`.

_ARENA = (300, 0.05)          # a 15 m walled arena, centred on the origin


def _drive_windowed(xs, cfg=None, start=None):
    """A windowed tiny MapperNode on the CPU, one scan a tick at each x of
    `xs` (y = 0, heading 0); returns (mapper, bus, topics seen)."""
    from jax_mapping_torch.bridge.bus import Bus
    from jax_mapping_torch.bridge.mapper import MapperNode
    from jax_mapping_torch.sim import lidar
    from jax_mapping_torch.sim import world as W
    cfg = cfg or _wcfg()
    bus = Bus()
    seen = {"/pose": [], "/frontiers": [], "/map": []}
    for topic, box in seen.items():
        bus.subscribe(topic, callback=box.append)
    m = MapperNode(cfg, bus, n_robots=1, device="cpu")
    world = torch.as_tensor(W.empty_arena(*_ARENA))
    res = cfg.grid.resolution_m
    n_samples = int(cfg.scan.range_max_m / (res * 0.5))
    scan_pub, odom_pub = bus.publisher("scan"), bus.publisher("odom")
    for k, x in enumerate(xs):
        pose = torch.tensor([[x, 0.0, 0.0]])
        r = lidar.simulate_scans(cfg.scan, world, res, n_samples, pose)[0]
        stamp = 0.5 * (k + 1)
        odom_pub.publish(_odom(stamp, x, 0.0, 0.0))
        scan_pub.publish(_scan(stamp, cfg, r[:cfg.scan.n_beams].numpy()))
        m.tick()
    return m, bus, seen


@pytest.fixture(scope="module")
def shifted():
    """The drive past one shift east: (mapper, topics, world x)."""
    xs = [0.25 * k for k in range(17)]            # 0 .. 4 m
    m, _bus, seen = _drive_windowed(xs)
    assert m.world.n_shifts >= 1 and m.world.offset_xy()[0] > 0
    yield m, seen, xs[-1]
    m.destroy()


def test_pose_topic_and_correction_tf_are_world_frame(shifted):
    m, seen, x = shifted
    off = m.world.offset_xy()
    window = m.states[0].pose.numpy()
    last = seen["/pose"][-1][0]
    assert last["x"] == pytest.approx(float(window[0] + off[0]), abs=1e-6)
    assert last["x"] == pytest.approx(x, abs=0.05)
    # Exact odometry: the map -> odom correction is near the identity in
    # the world frame (the window frame would put it an offset away).
    corr = m.tf.lookup("map", "odom")
    assert abs(corr.x) < 0.05 and abs(corr.y) < 0.05


def test_frontier_targets_are_world_frame(shifted):
    """The published targets are the window-frame full recompute's,
    plus the offset."""
    from jax_mapping_torch.ops import frontier as F
    m, seen, _x = shifted
    fr = F.compute_frontiers(m.cfg.frontier, m.cfg.grid, m.shared_grid,
                             torch.stack([st.pose for st in m.states]))
    want = fr.targets.numpy() + m.world.offset_xy()[None, :]
    got = seen["/frontiers"][-1].targets_xy
    assert len(got) == len(want) and len(got) > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_map_origin_rides_the_window(shifted):
    m, seen, _x = shifted
    m.publish_map()
    msg = seen["/map"][-1]
    off = m.world.offset_xy()
    assert (msg.info.width, msg.info.height) == (256, 256)
    assert msg.info.origin.x == pytest.approx(m.cfg.grid.origin_m[0]
                                              + off[0])
    assert msg.info.origin.y == pytest.approx(m.cfg.grid.origin_m[1]
                                              + off[1])


def test_graph_snapshot_and_depth_anchor_are_world_frame(shifted):
    m, _seen, x = shifted
    _gen, poses, valid, n, _k = m.graph_snapshot(0)
    assert valid[:n].all() and poses[n - 1, 0] == pytest.approx(x, abs=0.05)
    anchor = m.depth_anchor(0)
    assert anchor is not None
    _g, est, _odo, node, node_pose, _nk = anchor
    assert est[0] == pytest.approx(x, abs=0.05) and node == n - 1
    np.testing.assert_allclose(node_pose, poses[n - 1], rtol=0, atol=1e-6)


def test_region_revision_reads_the_logical_lattice(shifted):
    """Window cells map onto the logical tile at the window's origin."""
    m, _seen, _x = shifted
    r0, c0 = m.world.origin_tile
    for wr, wc in ((0, 0), (1, 2), (3, 3)):
        assert m.region_revision(wr * 64, wc * 64, 64) == \
            int(m._tile_rev[r0 + wr, c0 + wc])


def test_initialpose_is_asserted_in_world_frame():
    from jax_mapping_torch.bridge.messages import Pose2D
    m, bus, _seen = _drive_windowed([0.25 * k for k in range(17)])
    try:
        off = m.world.offset_xy()
        bus.publisher("/initialpose").publish(Pose2D(5.0, 1.0, 0.5))
        np.testing.assert_allclose(
            m.states[0].pose.numpy(),
            [5.0 - off[0], 1.0 - off[1], 0.5], rtol=0, atol=1e-6)
    finally:
        m.destroy()


def test_decay_passes_reach_the_store():
    """The mapper's decay passes advance the store's decay epoch, which
    evicted tiles catch up on."""
    from jax_mapping_torch.config import DecayConfig
    cfg = _wcfg().replace(decay=DecayConfig(enabled=True, every_n_ticks=2,
                                            factor=0.9, evidence_cap=1.5))
    m, _bus, _seen = _drive_windowed([0.25 * k for k in range(8)], cfg)
    try:
        assert m.n_decay_passes == 4
        assert m.world.decay_epoch == m.n_decay_passes
    finally:
        m.destroy()
