"""The port's multi-rank mesh (`jax_mapping_torch/parallel/`) against the
JAX package's `parallel/` on a 2 x 2 mesh.

The JAX reference runs once, in a subprocess with 4 virtual CPU devices
(`torch_jaxref.run_reference(..., n_devices=4)`): its slab fuse and
closure repair on seeded scans and rings, and its sharded step from
`init_sharded_state` for each scenario of `torch_parallel_ranks`, with
each step's per-robot wheel draws (the normals its keys give) and the
auction it runs. The port runs once, as 4 gloo ranks of one intra-op
thread each (`parallel.dryrun.spawn` of `torch_parallel_ranks.fleet`),
from the same states and draws, and also runs the dry run.

Tolerances, those of the chip smoke's card-against-CPU parity: truth
poses within 1e-6 m, estimates within 1e-4 m, at most 1e-4 of the grid
cells apart; assignments, loop and thinning counts exact; the 'space'
replicas of every robot bit-equal.
"""

import dataclasses
import json
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from tests import torch_jaxref as JR
from tests import torch_parallel_ranks as PR
from tests.torch_threads import one_intra_op_thread  # noqa: F401

from jax_mapping_torch import interop
from jax_mapping_torch.parallel import distributed as D
from jax_mapping_torch.parallel import dryrun as DR
from jax_mapping_torch.parallel import fleet_sharded as FS
from jax_mapping_torch.parallel import mesh as MESH

TRUTH_M = 1e-6
EST_M = 1e-4
CELLS = 1e-4

_REF = '''
import dataclasses
import jax, jax.numpy as jnp
from jax.sharding import PartitionSpec as P
from jax_mapping.config import tiny_config
from jax_mapping.ops import frontier as F, grid as G
from jax_mapping.parallel import fleet_sharded as FS, mesh as MESH
from jax_mapping.sim import lidar, world as W

NF, NS = 2, 2
mesh = MESH.make_mesh(n_fleet=NF, n_space=NS)
base = tiny_config()
base = dataclasses.replace(base, fleet=dataclasses.replace(base.fleet,
                                                           n_robots=8))
R = 8
g, s = base.grid, base.scan
rows = g.size_cells // NS


def shmap(fn, in_specs):
    return jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=in_specs,
                                 out_specs=P("space", None),
                                 check_vma=False))


# The slab fuse (tests/test_parallel.py's scans).
rng = np.random.default_rng(3)
poses = np.stack([rng.uniform(-0.8, 0.8, R), rng.uniform(-0.8, 0.8, R),
                  rng.uniform(-3, 3, R)], 1).astype(np.float32)
world = jnp.asarray(W.empty_arena(96, g.resolution_m))
scans = lidar.simulate_scans(s, world, g.resolution_m, 128,
                             jnp.asarray(poses))


def fuse_only(grid, scans_l, poses_l):
    row0 = jax.lax.axis_index("space") * rows
    d = jax.lax.psum(FS._slab_delta(base, scans_l, poses_l, row0, rows),
                     "fleet")
    return jnp.clip(grid + d, g.logodds_min, g.logodds_max)


OUT["fuse.scans"], OUT["fuse.poses"] = np.asarray(scans), poses
OUT["fuse.want"] = np.asarray(shmap(fuse_only, (P("space", None),
                                                P("fleet", None),
                                                P("fleet", None)))(
    G.empty_grid(g), scans, jnp.asarray(poses)))
OUT["fuse.single"] = np.asarray(G.merge_delta(
    g, G.empty_grid(g), G.scan_deltas_full(g, s, scans, jnp.asarray(poses))))

# The closure repair (tests/test_parallel.py's rings).
cap = 8
rng = np.random.default_rng(11)
rposes = rng.uniform(-0.1, 0.1, (R, cap, 3)).astype(np.float32)
rposes[:, :, 2] = rng.uniform(-3, 3, (R, cap))
valid = rng.random((R, cap)) < 0.7
rings = lidar.simulate_scans(s, world, g.resolution_m, 128,
                             jnp.asarray(rposes.reshape(R * cap, 3))
                             ).reshape(R, cap, -1)


def repair_only(rings_l, poses_l, valid_l):
    Rl = rings_l.shape[0]
    row0 = jax.lax.axis_index("space") * rows
    d = FS._slab_delta(base, rings_l.reshape(Rl * cap, -1),
                       poses_l.reshape(Rl * cap, 3), row0, rows,
                       mask=valid_l.reshape(Rl * cap))
    return jnp.clip(jax.lax.psum(d, "fleet"), g.logodds_min, g.logodds_max)


OUT["repair.rings"], OUT["repair.poses"] = np.asarray(rings), rposes
OUT["repair.valid"] = valid
OUT["repair.want"] = np.asarray(shmap(
    repair_only, (P("fleet"), P("fleet"), P("fleet")))(
        rings, jnp.asarray(rposes), jnp.asarray(valid)))
OUT["repair.local"] = np.asarray(G.fuse_scans_masked(
    g, s, G.empty_grid(g), rings.reshape(R * cap, -1),
    jnp.asarray(rposes.reshape(R * cap, 3)),
    jnp.asarray(valid.reshape(R * cap))))


def put(prefix, st):
    for k, v in st._asdict().items():
        if k == "graphs":
            for gk, gv in v._asdict().items():
                OUT[prefix + "graphs." + gk] = np.asarray(gv)
        elif k != "keys":
            OUT[prefix + k] = np.asarray(v)


draw = jax.jit(jax.vmap(
    lambda k: jax.random.normal(jax.random.split(k)[1], (2,))))


def auction(cfg, st):
    """The sharded step's auction, from the same gathered masks."""
    free, _occ, unk = F.coarsen(cfg.frontier, cfg.grid, st.grid)
    Rl = R // NF
    costs = jnp.concatenate([F.compute_frontiers_from_masks(
        cfg.frontier, cfg.grid, free, unk,
        st.est_poses[f * Rl:(f + 1) * Rl]).costs for f in range(NF)])
    return np.asarray(F.assign_frontiers(costs))


for name, (steps, cells, seed) in RUNS.items():
    cfg = CONFIGS[name]
    world = jnp.asarray(W.empty_arena(cells, cfg.grid.resolution_m))
    st = FS.init_sharded_state(cfg, mesh, seed=seed)
    step = FS.make_fleet_step(cfg, mesh, cfg.grid.resolution_m)
    put(name + ".s0.", st)
    for t in range(steps):
        OUT[f"{name}.normals{t}"] = np.asarray(draw(st.keys))
        OUT[f"{name}.assignment{t}"] = auction(cfg, st)
        st, m = step(st, world)
        put(f"{name}.s{t + 1}.", st)
        for k, v in m.items():
            OUT[f"{name}.m{t}.{k}"] = np.asarray(v)
'''


def _configs_src() -> str:
    """The scenarios' configs and step counts, rebuilt in the reference
    from the port's field values (the two config trees have the same
    fields)."""
    lines = ["from jax_mapping import config as _C",
             "RUNS = " + repr(PR.STEP_RUNS), "CONFIGS = {}"]
    for name in PR.STEP_RUNS:
        c = PR.fleet_config(name)
        lines.append(f"CONFIGS[{name!r}] = _C.SlamConfig.from_json("
                     f"{c.to_json()!r})")
    return "\n".join(lines) + "\n"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("parallel")
    ref = JR.run_reference(JR.ONE_XLA_THREAD + _configs_src() + _REF,
                           d / "ref.npz",
                           n_devices=4)
    DR.spawn("tests.torch_parallel_ranks:fleet", 4,
             [str(d / "ref.npz"), str(d)], timeout_s=900)
    out = {}
    with np.load(d / "global.npz") as z:
        out["global"] = {k: z[k] for k in z.files}
    out["ranks"] = []
    for r in range(4):
        with np.load(d / f"rank{r}.npz") as z:
            out["ranks"].append({k: z[k] for k in z.files})
    out["ref"] = ref
    return out


# ---------------------------------------------------------------------------
# Mesh and bring-up, no process group
# ---------------------------------------------------------------------------

def test_factor_devices():
    assert MESH.factor_devices(8) == (4, 2)
    assert MESH.factor_devices(7) == (7, 1)
    assert MESH.factor_devices(16) == (4, 4)
    assert MESH.factor_devices(1) == (1, 1)


def test_dist_config_from_env():
    cfg = D.DistConfig.from_env(env={})
    assert cfg.num_processes == 1 and cfg.coordinator_address is None
    cfg = D.DistConfig.from_env(env={
        "JAX_MAPPING_COORDINATOR": "10.0.0.1:1234",
        "JAX_MAPPING_NUM_PROCESSES": "4",
        "JAX_MAPPING_PROCESS_ID": "2"})
    assert cfg.coordinator_address == "10.0.0.1:1234"
    assert cfg.num_processes == 4 and cfg.process_id == 2
    # torch's launcher names as the fallback.
    cfg = D.DistConfig.from_env(env={"MASTER_ADDR": "h", "MASTER_PORT": "1",
                                     "WORLD_SIZE": "2", "RANK": "1"})
    assert cfg.coordinator_address == "h:1"
    assert cfg.num_processes == 2 and cfg.process_id == 1
    # The framework's names win over torch's.
    cfg = D.DistConfig.from_env(env={"JAX_MAPPING_NUM_PROCESSES": "3",
                                     "WORLD_SIZE": "2"})
    assert cfg.num_processes == 3


def test_initialize_single_process_noop():
    assert D.initialize(D.DistConfig()) is False
    assert not torch.distributed.is_initialized()


def test_initialize_half_configured_raises():
    with pytest.raises(ValueError, match="coordinator"):
        D.initialize(D.DistConfig(num_processes=4, coordinator_address=None))


def test_hybrid_layout_is_host_major():
    """2 simulated hosts x 2 ranks, and 2 x 4: each 'space' row is one
    host's consecutive ranks, 'fleet' crosses hosts."""
    lay = D.hybrid_layout(2, 2, 2).numpy()
    assert lay.tolist() == [[0, 1], [2, 3]]
    lay = D.hybrid_layout(2, 2, 4).numpy()
    assert lay.shape == (4, 2)
    for row in lay:
        assert row[1] - row[0] == 1 and row[0] // 4 == row[1] // 4
    with pytest.raises(ValueError, match="divisible"):
        D.hybrid_layout(2, 3, 4)


def test_make_mesh_single_process_brings_up_its_group():
    """No environment: make_mesh brings up a world-size-1 gloo group over
    a local store and gives the 1 x 1 mesh (a fresh process, so no group
    leaks into the test worker)."""
    code = ("from jax_mapping_torch.parallel import mesh as M\n"
            "m = M.make_mesh(device_type='cpu')\n"
            "print(tuple(m.mesh.shape), m.mesh_dim_names, "
            "M.axis_index(m, 'fleet'), M.axis_index(m, 'space'))\n"
            "try:\n    M.make_mesh(2, 1, device_type='cpu')\n"
            "except ValueError as e:\n    print('refused', e)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, env=JR.clean_cpu_env(),
                       cwd=str(JR.REPO))
    assert r.returncode == 0, r.stderr[-2000:]
    lines = r.stdout.strip().splitlines()
    assert lines[0] == "(1, 1) ('fleet', 'space') 0 0"
    assert lines[1].startswith("refused mesh 2x1 != 1")


def _stub_mesh(n_fleet, n_space):
    """A mesh's shape without a process group, for the checks that run
    before any collective."""
    return types.SimpleNamespace(
        size=lambda i: (n_fleet, n_space)[i],
        get_coordinate=lambda: [0, 0], device_type="cpu")


def test_step_refuses_indivisible_before_any_collective():
    c = PR.fleet_config("steps")
    with pytest.raises(ValueError, match="n_robots=8 not divisible"):
        FS.make_fleet_step(c, _stub_mesh(3, 1), c.grid.resolution_m)
    with pytest.raises(ValueError, match="frontier downsample"):
        FS.make_fleet_step(c, _stub_mesh(1, 256), c.grid.resolution_m)
    bad = dataclasses.replace(c, mode="slam")
    with pytest.raises(ValueError, match="mode"):
        FS.make_fleet_step(bad, _stub_mesh(1, 1), c.grid.resolution_m)


def test_sharded_state_from_numpy_cuts_each_shard():
    """Every coordinate's shard of a global view: robots by fleet index,
    grid rows by space index, t replicated; the four shards tile the
    global view."""
    rng = np.random.default_rng(0)
    R, N, cap = 8, 16, 4
    tree = types.SimpleNamespace(
        true_poses=rng.random((R, 3), np.float32),
        wheel_speeds=rng.random((R, 2), np.float32),
        est_poses=rng.random((R, 3), np.float32),
        grid=rng.random((N, N), np.float32),
        exploring=rng.random(R) < 0.5,
        last_key_poses=rng.random((R, 3), np.float32),
        scan_rings=rng.random((R, cap, 5), np.float32),
        n_loops=np.arange(R, dtype=np.int32), t=np.int32(7),
        keys=np.zeros((R, 2), np.uint32),
        graphs=types.SimpleNamespace(
            poses=rng.random((R, cap, 3), np.float32),
            pose_valid=rng.random((R, cap)) < 0.5,
            n_poses=np.arange(R, dtype=np.int32),
            edge_ij=np.zeros((R, 6, 2), np.int32),
            edge_meas=rng.random((R, 6, 3), np.float32),
            edge_weight=rng.random((R, 6, 3), np.float32),
            edge_valid=rng.random((R, 6)) < 0.5,
            n_edges=np.arange(R, dtype=np.int32)))
    for f in range(2):
        for s in range(2):
            sh = interop.sharded_state_from_numpy(tree, (f, s), (2, 2),
                                                  "cpu")
            assert np.array_equal(sh.grid.numpy(),
                                  tree.grid[s * 8:(s + 1) * 8])
            assert np.array_equal(sh.est_poses.numpy(),
                                  tree.est_poses[f * 4:(f + 1) * 4])
            assert np.array_equal(sh.graphs.edge_valid.numpy(),
                                  tree.graphs.edge_valid[f * 4:(f + 1) * 4])
            assert np.array_equal(sh.exploring.numpy(),
                                  tree.exploring[f * 4:(f + 1) * 4])
            assert int(sh.t) == 7 and sh.t.dim() == 0


# ---------------------------------------------------------------------------
# The 4-rank job against JAX's 2 x 2 mesh
# ---------------------------------------------------------------------------

def test_mesh_layout_and_factoring(runs):
    gl = runs["global"]
    assert gl["mesh.coords"].tolist() == [[0, 1, 2, 3]]
    for r, rk in enumerate(runs["ranks"]):
        assert rk["coord"].tolist() == [r // 2, r % 2]       # row-major
    assert gl["mesh.default"].tolist() == [2, 2]
    assert gl["mesh.fleet4"].tolist() == [4, 1]
    assert bool(gl["mesh.refused"])


def test_hybrid_mesh_two_simulated_hosts(runs):
    """hybrid_fleet_mesh over 4 ranks as 2 hosts x 2: host-major, 'space'
    inside a host; and initialize() inside the running group returns True
    without bringing up another."""
    gl = runs["global"]
    assert bool(gl["initialize.again"])
    assert gl["hybrid.ranks"].tolist() == [[0, 1], [2, 3]]
    assert gl["hybrid.names"].tolist() == ["fleet", "space"]


def _cells_apart(a, b, atol=1e-5) -> float:
    return float((np.abs(a - b) > atol).mean())


def test_slab_fuse_matches_jax(runs):
    """_slab_delta + the 'fleet' sum + one clip at 2 x 2, against JAX's
    shard_map of the same and its single-device merge
    (tests/test_parallel.py:57-90), within 1e-5 but for the documented
    sensor-model boundary cells."""
    got = runs["global"]["fuse.got"]
    ref = runs["ref"]
    for want in (ref["fuse.want"], ref["fuse.single"]):
        assert got.shape == want.shape
        assert _cells_apart(got, want) <= CELLS
    assert (got > 0).sum() > 30


def test_repair_matches_jax_and_local_refusion(runs):
    """The closure repair (rings, 30% of the slots masked) against JAX's
    sharded repair within 1e-5, and against the local re-fusion as JAX's
    test holds its own: occupancy equal, raw log-odds apart on < 1% of the
    cells (the clamp order)."""
    got = runs["global"]["repair.got"]
    ref = runs["ref"]
    assert _cells_apart(got, ref["repair.want"]) <= CELLS
    from jax_mapping_torch.config import tiny_config
    from jax_mapping_torch.ops import grid as G
    g = tiny_config().grid
    occ_got = G.to_occupancy(g, torch.as_tensor(got)).numpy()
    occ_local = G.to_occupancy(g, torch.as_tensor(ref["repair.local"])
                               ).numpy()
    assert (occ_got != occ_local).mean() <= CELLS
    assert _cells_apart(got, ref["repair.local"]) < 0.01


def _hold_to_jax(runs, name: str):
    ref, gl = runs["ref"], runs["global"]
    steps = PR.STEP_RUNS[name][0]
    for t in range(steps):
        p = f"{name}.s{t + 1}."
        np.testing.assert_allclose(gl[p + "true_poses"],
                                   ref[p + "true_poses"], rtol=0,
                                   atol=TRUTH_M, err_msg=f"{p} truth")
        np.testing.assert_allclose(gl[p + "est_poses"],
                                   ref[p + "est_poses"], rtol=0,
                                   atol=EST_M, err_msg=f"{p} estimates")
        assert _cells_apart(gl[p + "grid"], ref[p + "grid"]) <= CELLS, p
        assert np.array_equal(gl[f"{name}.assignment{t}"],
                              ref[f"{name}.assignment{t}"]), p
        for k in ("n_poses", "n_edges"):
            assert np.array_equal(gl[p + "graphs." + k],
                                  ref[p + "graphs." + k]), (p, k)
        assert np.array_equal(gl[p + "n_loops"], ref[p + "n_loops"]), p
        assert int(gl[p + "t"]) == t + 1
        for k in ("n_loops", "n_thins", "n_clusters"):
            assert int(gl[f"{name}.m{t}.{k}"]) == \
                int(ref[f"{name}.m{t}.{k}"]), (name, t, k)
        np.testing.assert_allclose(gl[f"{name}.m{t}.mean_pose_err_m"],
                                   ref[f"{name}.m{t}.mean_pose_err_m"],
                                   rtol=0, atol=EST_M)


def test_sharded_steps_match_jax(runs):
    """6 steps of tiny_config with 8 robots in the 4.8 m arena, from
    JAX's initial state, with JAX's wheel draws."""
    _hold_to_jax(runs, "steps")
    gl = runs["global"]
    assert (gl["steps.s6.grid"] > 0.5).sum() > 30        # walls fused


def test_trajectory_closes_and_thins_as_jax(runs):
    """The dry run's trajectory gates, 10 steps: the rings fill and thin
    and loops close, on the same steps in both packages."""
    _hold_to_jax(runs, "traj")
    gl = runs["global"]
    steps = PR.STEP_RUNS["traj"][0]
    assert sum(int(gl[f"traj.m{t}.n_thins"]) for t in range(steps)) >= 1
    assert int(gl[f"traj.m{steps - 1}.n_loops"]) >= 1


def test_localization_variant(runs):
    """mode=localization (test_localization_mode.py:219): the grid never
    changes, no graph grows, and the steps match JAX's."""
    _hold_to_jax(runs, "loc")
    gl = runs["global"]
    assert np.array_equal(gl["loc.s3.grid"], runs["ref"]["loc.s0.grid"])
    assert int(gl["loc.s3.graphs.n_poses"].sum()) == 0


def test_planned_goals_variant(runs):
    """planned_goals (test_planned_goals.py:122): K3's waypoints from the
    gathered masks steer the robots as JAX's do."""
    _hold_to_jax(runs, "pg")
    assert (runs["global"]["pg.s3.grid"] > 0.5).sum() > 30


@pytest.mark.parametrize("name", list(PR.STEP_RUNS))
def test_space_replicas_bit_equal(runs, name):
    """Ranks (f, 0) and (f, 1) hold the same robots and must agree to the
    last bit in every robot leaf (else they would branch apart)."""
    rk = runs["ranks"]
    for f in range(2):
        a, b = rk[2 * f], rk[2 * f + 1]
        keys = [k for k in a if k.startswith(name + ".")
                and not k.endswith(".grid")]
        assert keys
        for k in keys:
            assert np.array_equal(a[k], b[k]), k


def test_dryrun_on_four_ranks(runs):
    """`parallel.dryrun` on the 2 x 2 mesh: the trajectory thins and
    closes, planned steering runs, the voxel fuse leaves evidence through
    the region route."""
    out = json.loads(str(runs["global"]["dryrun"]))
    assert out["ranks"] == 4 and out["mesh"] == [2, 2]
    assert out["thins"] >= 1 and out["loops_closed"] >= 1
    assert out["mean_pose_err_m"] < 1.0
    assert out["planned_steps"] == 2
    assert out["voxels_updated"] > 0 and out["voxel_region_route"]


def test_dryrun_refuses_ranks_on_the_card():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal without a card")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DR.dryrun(1)
