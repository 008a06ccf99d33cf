"""The port's checkpoints (`io/checkpoint.py`) against the JAX package's.

Ports of the JAX package's `tests/test_io.py` checkpoint tests (exact
round trip, resume equals continuous, shape drift, truncation, CRC bit rot,
the `.prev` fallback, no rotation of a corrupt primary) and its keyframe-
and world-sidecar guards, on the CPU at tiny_config. Beyond them:

* a checkpoint written by the JAX package's `save_checkpoint` loads in the
  port, and one the port wrote loads in the JAX package, leaf for leaf
  (the JAX side in a fresh `JAX_PLATFORMS=cpu` subprocess,
  `tests/torch_jaxref.py`; the port's states through `interop`);
* numbered generations are retained and garbage-collected;
* a windowed `launch_sim_stack` with `checkpoint_dir` auto-checkpoints its
  states and `.world` manifest, and after a `kill_node` the supervisor's
  `restart_mapper` resumes the window at the checkpointed origin with
  each chain at the brain's pose in the window frame;
* the demo's `--save-final` and `--resume` round-trip a windowed mission.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from jax_mapping_torch import interop
from jax_mapping_torch.config import WorldConfig, tiny_config
from jax_mapping_torch.io import (
    CheckpointCorrupt, load_checkpoint, load_checkpoint_with_fallback,
    previous_checkpoint_path, save_checkpoint,
)
from jax_mapping_torch.io.checkpoint import _flatten, generation_paths
from jax_mapping_torch.models import slam as S
from jax_mapping_torch.sim import lidar
from jax_mapping_torch.sim import world as W
from tests.torch_jaxref import run_reference
from tests.torch_threads import one_intra_op_thread  # noqa: F401


def _run_slam(cfg, world, n, state=None):
    res = cfg.grid.resolution_m
    n_samples = int(cfg.scan.range_max_m / (res * 0.5))
    st = S.init_state(cfg, device="cpu") if state is None else state
    w = torch.as_tensor(world)
    for _ in range(n):
        scan = lidar.simulate_scans(cfg.scan, w, res, n_samples,
                                    st.pose[None])[0]
        st, _ = S.slam_step(cfg, st, scan, 60.0, 100.0, 0.1)
    return st


def _world(cfg):
    return W.plank_course(96, cfg.grid.resolution_m, seed=5)


def _leaves_equal(a, b):
    fa, fb = _flatten(a), _flatten(b)
    assert [k for k, _ in fa] == [k for k, _ in fb]
    for (k, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype, k
        assert torch.equal(x, y), k


def test_checkpoint_roundtrip_exact(tmp_path):
    cfg = tiny_config()
    st = _run_slam(cfg, _world(cfg), 8)
    path = str(tmp_path / "slam.ckpt.npz")
    save_checkpoint(path, st, config_json=cfg.to_json())
    restored, cfg_json = load_checkpoint(path, S.init_state(cfg,
                                                            device="cpu"))
    assert cfg_json == cfg.to_json()
    assert type(restored) is type(st)
    _leaves_equal(st, restored)


def test_checkpoint_resume_equals_continuous(tmp_path):
    """restart-from-checkpoint == never-restarted, bit for bit."""
    cfg = tiny_config()
    world = _world(cfg)
    st10 = _run_slam(cfg, world, 10)
    st15_direct = _run_slam(cfg, world, 5, state=st10)
    path = str(tmp_path / "mid.ckpt.npz")
    save_checkpoint(path, st10)
    restored, _ = load_checkpoint(path, S.init_state(cfg, device="cpu"))
    st15_resumed = _run_slam(cfg, world, 5, state=restored)
    assert torch.equal(st15_direct.grid, st15_resumed.grid)
    assert torch.equal(st15_direct.pose, st15_resumed.pose)


def test_checkpoint_shape_drift_detected(tmp_path):
    cfg = tiny_config()
    path = str(tmp_path / "drift.ckpt.npz")
    save_checkpoint(path, S.init_state(cfg, device="cpu"))
    bigger = cfg.replace(grid=dataclasses.replace(cfg.grid, size_cells=512))
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(path, S.init_state(bigger, device="cpu"))


def test_checkpoint_truncation_raises_checkpoint_corrupt(tmp_path):
    cfg = tiny_config()
    path = str(tmp_path / "trunc.ckpt.npz")
    save_checkpoint(path, S.init_state(cfg, device="cpu"))
    with open(path, "rb+") as f:
        f.truncate(os.path.getsize(path) // 2)
    with pytest.raises(CheckpointCorrupt):
        load_checkpoint(path, S.init_state(cfg, device="cpu"))
    assert issubclass(CheckpointCorrupt, ValueError)


def test_checkpoint_crc_detects_bit_rot(tmp_path):
    """A valid zip whose leaf bytes changed fails the per-leaf CRC32."""
    from jax_mapping_torch.io.checkpoint import _META_KEY
    cfg = tiny_config()
    path = str(tmp_path / "rot.ckpt.npz")
    save_checkpoint(path, S.init_state(cfg, device="cpu"))
    with np.load(path) as z:
        arrays = {k: z[k] for k in z.files}
    key = next(k for k in arrays if k != _META_KEY
               and arrays[k].size > 0 and arrays[k].dtype == np.float32)
    arrays[key] = arrays[key].copy()
    arrays[key].flat[0] += 1.0
    with open(path, "wb") as f:
        np.savez_compressed(f, **arrays)
    with pytest.raises(CheckpointCorrupt, match="CRC32"):
        load_checkpoint(path, S.init_state(cfg, device="cpu"))


def test_checkpoint_fallback_rotates_to_last_good(tmp_path):
    cfg = tiny_config()
    world = _world(cfg)
    st_a = _run_slam(cfg, world, 4)
    st_b = _run_slam(cfg, world, 4, state=st_a)
    path = str(tmp_path / "gen.ckpt.npz")
    save_checkpoint(path, st_a)
    save_checkpoint(path, st_b)             # rotates A to .prev
    prev = previous_checkpoint_path(path)
    assert os.path.exists(prev)
    tmpl = S.init_state(cfg, device="cpu")
    got, _, used = load_checkpoint_with_fallback(path, tmpl)
    assert used == path and torch.equal(got.grid, st_b.grid)
    with open(path, "rb+") as f:
        f.truncate(os.path.getsize(path) // 3)
    got, _, used = load_checkpoint_with_fallback(path, tmpl)
    assert used == prev and torch.equal(got.grid, st_a.grid)
    with open(prev, "rb+") as f:
        f.truncate(8)
    with pytest.raises(CheckpointCorrupt):
        load_checkpoint_with_fallback(path, tmpl)


def test_save_does_not_rotate_corrupt_primary_over_last_good(tmp_path):
    cfg = tiny_config()
    world = _world(cfg)
    st_a = _run_slam(cfg, world, 4)
    st_b = _run_slam(cfg, world, 4, state=st_a)
    st_c = _run_slam(cfg, world, 4, state=st_b)
    path = str(tmp_path / "rot.ckpt.npz")
    save_checkpoint(path, st_a)
    save_checkpoint(path, st_b)              # .prev = A
    with open(path, "rb+") as f:             # the primary (B) rots
        f.truncate(os.path.getsize(path) // 3)
    save_checkpoint(path, st_c)              # must NOT move B over A
    tmpl = S.init_state(cfg, device="cpu")
    got, _ = load_checkpoint(previous_checkpoint_path(path), tmpl)
    assert torch.equal(got.grid, st_a.grid)
    got, _, used = load_checkpoint_with_fallback(path, tmpl)
    assert used == path and torch.equal(got.grid, st_c.grid)


def test_retained_generations_rotate_and_gc(tmp_path):
    """retain_generations=4: current + .prev + two numbered generations,
    the oldest collected; the fallback walks them newest first."""
    path = str(tmp_path / "deep.npz")
    for k in range(6):
        save_checkpoint(path, {"v": np.full(3, k, np.int32)},
                        retain_generations=4)
    gens = generation_paths(path)
    assert len(gens) == 2
    tmpl = {"v": np.zeros(3, np.int32)}
    for p in (path, previous_checkpoint_path(path)):
        os.unlink(p)
    got, _, used = load_checkpoint_with_fallback(path, tmpl)
    assert used == gens[-1] and int(got["v"][0]) == 3
    with pytest.raises(ValueError, match="fallback floor"):
        save_checkpoint(path, tmpl, retain_generations=1)


def test_keyframe_sidecar_guards(tmp_path):
    from jax_mapping_torch.io.checkpoint import (keyframe_sidecar_path,
                                                 load_keyframe_sidecar,
                                                 save_keyframe_sidecar)
    base = str(tmp_path / "ck.npz")
    kf = {"depths": np.zeros((2, 4, 5), np.float32),
          "rels": np.zeros((2, 3), np.float32),
          "node_idx": np.zeros(2, np.int32),
          "thins": np.zeros(2, np.int32),
          "robot": np.zeros(2, np.int32)}
    save_checkpoint(keyframe_sidecar_path(base), {"grid": np.ones(3)})
    with pytest.raises(ValueError, match="refusing to overwrite"):
        save_keyframe_sidecar(base, kf)
    os.remove(keyframe_sidecar_path(base))
    save_keyframe_sidecar(base, kf)
    got = load_keyframe_sidecar(base)
    np.testing.assert_array_equal(got["depths"], kf["depths"])
    save_checkpoint(keyframe_sidecar_path(base), {"grid": np.ones(3)})
    with pytest.raises(ValueError, match="not a voxel keyframe"):
        load_keyframe_sidecar(base)
    bad = dict(kf, robot=np.zeros(3, np.int32))
    os.remove(keyframe_sidecar_path(base))
    save_keyframe_sidecar(base, bad)
    with pytest.raises(ValueError, match="disagree on length"):
        load_keyframe_sidecar(base)


def test_world_sidecar_roundtrip_and_guards(tmp_path):
    """Exact round trip, refuse-to-clobber, wrong-kind refusal, a loud
    CRC / truncation failure, config-drift refusal, None on absence, a
    sentinel-checked clear."""
    from jax_mapping_torch.io.checkpoint import (clear_world_sidecar,
                                                 load_world_sidecar,
                                                 save_world_sidecar,
                                                 world_sidecar_path)
    cfg = tiny_config()
    base = str(tmp_path / "ck.npz")
    payload = {"origin_tile": np.asarray([2, 5], np.int64),
               "epochs": np.asarray([3, 17, 4], np.int64),
               "away": np.asarray([[0, 1], [7, 9]], np.int64)}
    assert load_world_sidecar(base) is None
    save_checkpoint(world_sidecar_path(base), {"grid": np.ones(3)})
    with pytest.raises(ValueError, match="refusing to overwrite"):
        save_world_sidecar(base, payload)
    with pytest.raises(ValueError, match="not a world sidecar"):
        load_world_sidecar(base)
    assert clear_world_sidecar(base) is False
    assert os.path.exists(world_sidecar_path(base))
    os.remove(world_sidecar_path(base))
    with pytest.raises(ValueError, match="missing keys"):
        save_world_sidecar(base, {"origin_tile": payload["origin_tile"]})
    wp = save_world_sidecar(base, payload, config_json=cfg.to_json())
    got = load_world_sidecar(base, running_config_json=cfg.to_json())
    for k in payload:
        np.testing.assert_array_equal(got[k], payload[k])
    drifted = cfg.replace(grid=dataclasses.replace(
        cfg.grid, size_cells=cfg.grid.size_cells * 2))
    with pytest.raises(ValueError, match="differs from the running"):
        load_world_sidecar(base, running_config_json=drifted.to_json())
    raw = open(wp, "rb").read()
    with open(wp, "wb") as f:
        f.write(raw[:len(raw) // 2])
    with pytest.raises(CheckpointCorrupt):
        load_world_sidecar(base)
    with pytest.raises(ValueError, match="refusing to overwrite"):
        save_world_sidecar(base, payload)
    os.remove(wp)
    save_world_sidecar(base, payload)
    assert clear_world_sidecar(base) is True
    assert load_world_sidecar(base) is None


# ------------------------------------------------ across the two packages

CROSS = '''
import jax
import jax.numpy as jnp
from jax_mapping.config import tiny_config
from jax_mapping.io.checkpoint import (_path_str, load_checkpoint,
                                       save_checkpoint)
from jax_mapping.models import slam as S
from jax_mapping.sim import lidar
from jax_mapping.sim import world as W
cfg = tiny_config()
world = W.plank_course(96, cfg.grid.resolution_m, seed=5)
res = cfg.grid.resolution_m
n_samples = int(cfg.scan.range_max_m / (res * 0.5))
sts = []
st = S.init_state(cfg)
for n in (6, 4):
    for _ in range(n):
        scan = lidar.simulate_scans(cfg.scan, jnp.asarray(world), res,
                                    n_samples, st.pose[None])[0]
        st, _ = S.slam_step(cfg, st, scan, jnp.float32(60.0),
                            jnp.float32(100.0), jnp.float32(0.1))
    sts.append(st)
save_checkpoint(%(jax_path)r, sts, config_json=cfg.to_json())
for kp, leaf in jax.tree_util.tree_flatten_with_path(sts)[0]:
    OUT["jax." + _path_str(kp)] = np.asarray(leaf)
got, cfg_json = load_checkpoint(%(port_path)r,
                                [S.init_state(cfg) for _ in range(2)])
for kp, leaf in jax.tree_util.tree_flatten_with_path(got)[0]:
    OUT["port." + _path_str(kp)] = np.asarray(leaf)
OUT["port_config"] = np.array(cfg_json)
# The sidecars, both ways.
from jax_mapping.io.checkpoint import (load_prior_sidecar,
                                       load_world_sidecar,
                                       save_prior_sidecar,
                                       save_world_sidecar)
from jax_mapping.ops import grid as G
for k, v in load_world_sidecar(%(port_path)r,
                               running_config_json=cfg.to_json()).items():
    OUT["port_world." + k] = np.asarray(v)
OUT["port_prior"] = np.asarray(load_prior_sidecar(
    %(port_path)r, G.empty_grid(cfg.grid),
    running_config_json=cfg.to_json()))
save_world_sidecar(%(jax_path)r, WORLD, config_json=cfg.to_json())
save_prior_sidecar(%(jax_path)r, np.asarray(sts[1].grid) * 0.5,
                   config_json=cfg.to_json())
'''

#: A world payload with a host tier embedded, for both packages.
WORLD = {"origin_tile": np.asarray([3, 5], np.int64),
         "epochs": np.asarray([2, 11, 7], np.int64),
         "away": np.asarray([[0, 1], [2, 9]], np.int64),
         "host_meta": np.asarray([[2, 9, 11, 1]], np.int64),
         "host_tiles": np.arange(64 * 64, dtype=np.float32).reshape(
             1, 64, 64) / 4096.0}



@pytest.fixture(scope="module")
def cross(tmp_path_factory):
    """The port's two-state snapshot written for the JAX side to read,
    and the JAX side's snapshot (written there) with its leaves."""
    d = tmp_path_factory.mktemp("cross")
    cfg = tiny_config()
    world = _world(cfg)
    st_a = _run_slam(cfg, world, 5)
    sts = [st_a, _run_slam(cfg, world, 3, state=st_a)]
    port_path, jax_path = str(d / "port.npz"), str(d / "jax.npz")
    save_checkpoint(port_path, sts, config_json=cfg.to_json())
    from jax_mapping_torch.io.checkpoint import (save_prior_sidecar,
                                                 save_world_sidecar)
    save_world_sidecar(port_path, WORLD, config_json=cfg.to_json())
    save_prior_sidecar(port_path, sts[0].grid * 2.0,
                       config_json=cfg.to_json())
    world_src = "WORLD = {" + ", ".join(
        f"{k!r}: np.array({v.tolist()!r}, {str(v.dtype)!r})"
        for k, v in WORLD.items()) + "}\n"
    ref = run_reference(world_src + CROSS % dict(jax_path=jax_path,
                                                 port_path=port_path),
                        d / "ref.npz")
    return sts, jax_path, ref


def _numpy_leaves(states) -> dict:
    """The states' leaves by checkpoint key, through interop."""
    return {k: v for k, v in _flatten(
        [interop.slam_state_to_numpy(s) for s in states])}


def test_jax_checkpoint_loads_in_port(cross):
    _sts, jax_path, ref = cross
    cfg = tiny_config()
    got, cfg_json = load_checkpoint(
        jax_path, [S.init_state(cfg, device="cpu") for _ in range(2)])
    from jax_mapping_torch.config import configs_equivalent
    assert configs_equivalent(cfg_json, cfg.to_json())
    leaves = _numpy_leaves(got)
    want = {k[4:]: v for k, v in ref.items() if k.startswith("jax.")}
    assert sorted(leaves) == sorted(want)
    for k, v in want.items():
        assert leaves[k].dtype == v.dtype, k
        np.testing.assert_array_equal(leaves[k], v, err_msg=k)
    # The JAX run really mapped something.
    assert (leaves["1.grid"] > 0).any() and int(leaves["1.n_keyscans"]) > 0


def test_port_checkpoint_loads_in_jax(cross):
    sts, _jax_path, ref = cross
    leaves = _numpy_leaves(sts)
    got = {k[5:]: v for k, v in ref.items() if k.startswith("port.")}
    assert sorted(leaves) == sorted(got)
    for k, v in leaves.items():
        assert got[k].dtype == v.dtype, k
        np.testing.assert_array_equal(got[k], v, err_msg=k)
    assert str(ref["port_config"]) == tiny_config().to_json()


def test_jax_sidecars_load_in_port(cross):
    """The world manifest and the map prior the JAX package wrote."""
    from jax_mapping_torch.io.checkpoint import (load_prior_sidecar,
                                                 load_world_sidecar)
    from jax_mapping_torch.ops import grid as G
    sts, jax_path, _ref = cross
    cfg = tiny_config()
    got = load_world_sidecar(jax_path, running_config_json=cfg.to_json())
    assert sorted(got) == sorted(WORLD)
    for k, v in WORLD.items():
        np.testing.assert_array_equal(got[k], v)
        assert got[k].dtype == v.dtype
    prior = load_prior_sidecar(jax_path, G.empty_grid(cfg.grid, "cpu"),
                               running_config_json=cfg.to_json())
    assert prior.dtype == torch.float32 and prior.shape == (256, 256)
    assert bool((prior != 0).any())


def test_port_sidecars_load_in_jax(cross):
    sts, _jax_path, ref = cross
    for k, v in WORLD.items():
        np.testing.assert_array_equal(ref["port_world." + k], v)
        assert ref["port_world." + k].dtype == v.dtype
    np.testing.assert_array_equal(ref["port_prior"],
                                  (sts[0].grid * 2.0).numpy())


# ------------------------------------------------ guards and helpers

EQUIVALENT = {
    "same": (lambda c: c, True),
    "mode": (lambda c: c.replace(mode="localization"), True),
    "obs": (lambda c: c.replace(obs=dataclasses.replace(c.obs,
                                                        enabled=True)),
            True),
    "grid": (lambda c: c.replace(grid=dataclasses.replace(
        c.grid, size_cells=512)), False),
    "world": (lambda c: c.replace(world=WorldConfig(windowed=True)),
              False),
}


@pytest.mark.parametrize("case", list(EQUIVALENT))
def test_configs_equivalent(case):
    """Operating mode and telemetry are not drift; shapes are. The JAX
    package's `configs_equivalent` agrees on its own JSON."""
    import jax_mapping.config as JC
    from jax_mapping_torch.config import configs_equivalent
    edit, want = EQUIVALENT[case]
    base = tiny_config()
    assert configs_equivalent(base.to_json(), edit(base).to_json()) is want
    jbase = JC.SlamConfig.from_json(base.to_json())
    jother = JC.SlamConfig.from_json(edit(base).to_json())
    assert JC.configs_equivalent(jbase.to_json(), jother.to_json()) is want
    # Across packages: the JAX JSON of the same config is not drift.
    assert configs_equivalent(jbase.to_json(), base.to_json())


@pytest.mark.parametrize("other", [None, "not json", "{\"grid\": 3}"])
def test_configs_equivalent_refuses_missing_or_broken(other):
    from jax_mapping_torch.config import configs_equivalent
    assert configs_equivalent(tiny_config().to_json(), other) is False


def test_prior_sidecar_roundtrip_and_guards(tmp_path):
    from jax_mapping_torch.io.checkpoint import (clear_prior_sidecar,
                                                 load_prior_sidecar,
                                                 prior_sidecar_path,
                                                 save_prior_sidecar)
    from jax_mapping_torch.ops import grid as G
    cfg = tiny_config()
    base = str(tmp_path / "ck.npz")
    tmpl = G.empty_grid(cfg.grid, "cpu")
    assert load_prior_sidecar(base, tmpl) is None
    prior = torch.linspace(-2, 2, 256 * 256).reshape(256, 256)
    save_prior_sidecar(base, prior, config_json=cfg.to_json())
    got = load_prior_sidecar(base, tmpl, running_config_json=cfg.to_json())
    assert torch.equal(got, prior)
    drifted = cfg.replace(mode="localization",
                          grid=dataclasses.replace(cfg.grid,
                                                   size_cells=512))
    with pytest.raises(ValueError, match="differs from the running"):
        load_prior_sidecar(base, tmpl,
                           running_config_json=drifted.to_json())
    assert clear_prior_sidecar(base) is True
    save_checkpoint(prior_sidecar_path(base), {"grid": np.ones(3)})
    with pytest.raises(ValueError, match="refusing to overwrite"):
        save_prior_sidecar(base, prior)
    with pytest.raises(ValueError, match="not a prior sidecar"):
        load_prior_sidecar(base, tmpl)
    assert clear_prior_sidecar(base) is False


def test_voxel_sidecar_roundtrip_and_guards(tmp_path):
    from jax_mapping_torch.io.checkpoint import (load_voxel_sidecar,
                                                 save_voxel_sidecar,
                                                 voxel_sidecar_path)
    base = str(tmp_path / "ck.npz")
    tmpl = torch.zeros((4, 8, 8))
    assert load_voxel_sidecar(base, tmpl) is None
    grid = torch.arange(4 * 8 * 8, dtype=torch.float32).reshape(4, 8, 8)
    save_voxel_sidecar(base, grid)
    assert torch.equal(load_voxel_sidecar(base, tmpl), grid)
    with pytest.raises(ValueError, match="shape"):
        load_voxel_sidecar(base, torch.zeros((4, 8, 9)))
    os.remove(voxel_sidecar_path(base))
    save_checkpoint(voxel_sidecar_path(base), {"grid": np.ones(3)})
    with pytest.raises(ValueError, match="refusing to overwrite"):
        save_voxel_sidecar(base, grid)
    with pytest.raises(ValueError, match="not a voxel sidecar"):
        load_voxel_sidecar(base, tmpl)


@pytest.mark.parametrize("template,match", [
    ({"a": np.zeros(3), "b": np.zeros(2)}, "leaves, template has"),
    ({"c": np.zeros(3)}, "missing leaf 'c'")])
def test_load_checkpoint_names_the_drift(tmp_path, template, match):
    path = str(tmp_path / "x.npz")
    save_checkpoint(path, {"a": np.zeros(3)})
    with pytest.raises(ValueError, match=match):
        load_checkpoint(path, template)


# ------------------------------------------------ the windowed stack

def _windowed_cfg(n_robots=2):
    cfg = tiny_config(n_robots)
    return cfg.replace(
        grid=dataclasses.replace(cfg.grid, size_cells=768),
        world=WorldConfig(windowed=True, window_tiles=4, margin_tiles=1,
                          host_tile_budget=64),
        planner=dataclasses.replace(cfg.planner, enabled=False),
        robot=dataclasses.replace(cfg.robot, speed_noise_frac=0.0))


def _teleport(st, x):
    """Put the fleet at world x (truth, the brain and the mapper's
    chains), inside the window's margin band, so the next mapper tick
    shifts the window."""
    poses = st.sim.sim_state.poses.clone()
    poses[:, 0] += x
    st.sim.sim_state = st.sim.sim_state._replace(poses=poses)
    st.brain.poses = st.sim.truth_poses().copy()
    for i, s in enumerate(st.mapper.states):
        st.mapper.states[i] = s._replace(
            pose=torch.as_tensor(st.brain.poses[i]),
            last_key_pose=torch.as_tensor(st.brain.poses[i]))


def test_windowed_stack_auto_checkpoint_and_restart(tmp_path):
    """A windowed stack with `checkpoint_dir`: the supervisor's cadence
    writes the states and the `.world` manifest of a shifted window; a
    killed mapper is restarted from that checkpoint with the window at
    the checkpointed origin and each chain at the brain's pose in the
    window frame (window pose + offset == the brain's world pose)."""
    from jax_mapping_torch.bridge.launch import launch_sim_stack
    from jax_mapping_torch.io.checkpoint import load_world_sidecar
    from jax_mapping_torch.obs.recorder import flight_recorder
    cfg = _windowed_cfg()
    every = cfg.resilience.checkpoint_every_steps
    st = launch_sim_stack(cfg, W.empty_arena(240, 0.05), n_robots=2,
                          seed=0, device="cpu",
                          checkpoint_dir=str(tmp_path))
    assert st.world_spill_dir == str(tmp_path / "world_spill")
    _teleport(st, 3.6)
    st.brain.start_exploring()
    st.run_steps(every)
    assert st.mapper.world.n_shifts >= 1
    origin = st.mapper.world.origin_tile
    assert origin != (4, 4)
    path = st.auto_checkpoint_path
    assert os.path.exists(path) and st.supervisor.n_checkpoints == 1
    manifest = load_world_sidecar(path, running_config_json=cfg.to_json())
    assert tuple(manifest["origin_tile"]) == origin
    saved_grid = st.mapper.merged_grid().clone()

    old = st.mapper
    mark = flight_recorder.mark()
    st.kill_node("jax_mapper")
    for _ in range(30):
        st.run_steps(1)
        if st.mapper is not old:
            break
    new = st.mapper
    assert new is not old and new.restart_epoch == 1
    evs = [e for e in flight_recorder.events_since(mark)
           if e["kind"] == "restart_epoch"]
    assert evs and evs[-1]["resumed_from_checkpoint"] is True
    assert new.world.origin_tile == origin
    # The resumed map is the checkpoint's (the node fused nothing since
    # the restart: its first tick is the next step).
    assert torch.equal(new.merged_grid(), saved_grid)
    off = new.world.offset_xy()
    for i in range(2):
        pose = new.states[i].pose.numpy()
        np.testing.assert_allclose(pose[:2] + off, st.brain.poses[i][:2],
                                   rtol=0, atol=1e-5)
    st.run_steps(3)
    assert new.n_scans_fused > 0
    st.shutdown()
    new.destroy()


def test_windowed_stack_restart_degrades_without_manifest(tmp_path):
    """A checkpoint whose `.world` manifest is gone resumes the states at
    the boot origin with a `world_sidecar_degraded` flight event."""
    from jax_mapping_torch.bridge.launch import launch_sim_stack
    from jax_mapping_torch.io.checkpoint import world_sidecar_path
    from jax_mapping_torch.obs.recorder import flight_recorder
    cfg = _windowed_cfg()
    st = launch_sim_stack(cfg, W.empty_arena(240, 0.05), n_robots=2,
                          seed=0, device="cpu",
                          checkpoint_dir=str(tmp_path))
    st.brain.start_exploring()
    st.run_steps(2)
    st.save_auto_checkpoint()
    with open(world_sidecar_path(st.auto_checkpoint_path), "wb") as f:
        f.write(b"rot")
    mark = flight_recorder.mark()
    st.restart_mapper()
    evs = [e["kind"] for e in flight_recorder.events_since(mark)]
    assert "world_sidecar_degraded" in evs
    assert st.mapper.world.origin_tile == (4, 4)
    st.shutdown()
    st.mapper.destroy()


def test_auto_checkpoint_rotates_the_manifest_in_lockstep(tmp_path):
    """Two auto-checkpoints with a shift between: the `.prev` states keep
    the manifest saved with them, so a rotted primary resumes the `.prev`
    states at the `.prev` origin."""
    from jax_mapping_torch.bridge.launch import launch_sim_stack
    from jax_mapping_torch.io.checkpoint import (load_world_sidecar,
                                                 world_sidecar_path)
    cfg = _windowed_cfg()
    st = launch_sim_stack(cfg, W.empty_arena(240, 0.05), n_robots=2,
                          seed=0, device="cpu", checkpoint_dir=str(tmp_path))
    st.brain.start_exploring()
    st.run_steps(1)
    st.save_auto_checkpoint()
    first = st.mapper.world.origin_tile
    _teleport(st, 3.6)
    st.run_steps(2)
    assert st.mapper.world.origin_tile != first
    st.save_auto_checkpoint()
    path = st.auto_checkpoint_path
    prev = previous_checkpoint_path(path)
    assert tuple(load_world_sidecar(prev)["origin_tile"]) == first
    assert tuple(load_world_sidecar(path)["origin_tile"]) == \
        st.mapper.world.origin_tile
    with open(path, "rb+") as f:
        f.truncate(os.path.getsize(path) // 3)
    assert os.path.exists(world_sidecar_path(prev))
    st.restart_mapper()
    assert st.mapper.world.origin_tile == first
    st.shutdown()
    st.mapper.destroy()


def test_demo_resume_refuses_config_drift(tmp_path, capsys):
    from jax_mapping_torch import demo
    cfg_path = tmp_path / "other.json"
    other = tiny_config(2)
    other = other.replace(loop=dataclasses.replace(other.loop,
                                                   gn_iters=7))
    cfg_path.write_text(other.to_json())
    ck = str(tmp_path / "tiny.npz")
    assert demo.main(["--device", "cpu", "--robots", "2", "--steps", "2",
                      "--save-final", ck]) == 0
    assert demo.main(["--device", "cpu", "--robots", "2", "--steps", "1",
                      "--config", str(cfg_path), "--resume", ck]) == 2
    assert "config differs" in capsys.readouterr().err


def test_demo_windowed_save_final_and_resume(tmp_path, capsys):
    from jax_mapping_torch import demo
    cfg_path = tmp_path / "windowed.json"
    cfg_path.write_text(_windowed_cfg().to_json())
    ck = str(tmp_path / "final.npz")
    base = ["--device", "cpu", "--robots", "2", "--steps", "6",
            "--config", str(cfg_path)]
    assert demo.main(base + ["--save-final", ck]) == 0
    assert os.path.exists(ck)
    from jax_mapping_torch.io.checkpoint import world_sidecar_path
    assert os.path.exists(world_sidecar_path(ck))
    assert demo.main(base + ["--resume", ck]) == 0
    assert "resumed 2 robot state(s)" in capsys.readouterr().err
    # A checkpoint of another shape refuses politely.
    assert demo.main(["--device", "cpu", "--robots", "2", "--steps", "1",
                      "--resume", ck]) == 2
