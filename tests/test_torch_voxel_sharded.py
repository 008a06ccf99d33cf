"""The port's Y-slab voxel fuse (`parallel/voxel_sharded.py`) against the
JAX package's on a 2 x 2 mesh (`tests/test_voxel_sharded.py`'s cases).

The JAX reference runs once in a subprocess with 4 virtual CPU devices:
eight depth images rendered in the 4.8 m arena, fused on its 2 x 2 mesh
into an empty grid, into a grid saturated by 12 patch-path fuses, and
with a camera pitched up 0.1 rad; beside each, its patch path
(`voxel.fuse_depths`) and its engine predicate (`region_supported` of a
slab). The port fuses the same images on 4 gloo ranks
(`torch_parallel_ranks.voxel`). On a level camera the port takes the
region route (K7's plain version here) where the JAX CPU reference
takes `classify_region`: the two float programs can flip a voxel on a
model boundary, so at most 1e-4 of the voxels may be apart by more than
1e-5 (ROADMAP C's voxel tolerance).
"""

import dataclasses
import math
import types

import numpy as np
import pytest
import torch

from tests import torch_jaxref as JR
from tests import torch_parallel_ranks as PR
from tests.torch_threads import one_intra_op_thread  # noqa: F401

from jax_mapping_torch.config import tiny_config
from jax_mapping_torch.ops import voxel as V
from jax_mapping_torch.parallel import dryrun as DR
from jax_mapping_torch.parallel import voxel_sharded as VS

VOXELS = 1e-4
CASES = ("empty", "saturated", "pitched")

_REF = '''
import math
import jax, jax.numpy as jnp
from jax_mapping import config as C
from jax_mapping.ops import voxel as V
from jax_mapping.ops import voxel_kernel as VKK
from jax_mapping.parallel import mesh as MESH, voxel_sharded as VS
from jax_mapping.sim import depthcam as DC, world as W

mesh = MESH.make_mesh(n_fleet=2, n_space=2)
for case, js in CONFIGS.items():
    cfg = C.SlamConfig.from_json(js)
    res = cfg.voxel.resolution_m
    n = 8
    world = jnp.asarray(np.asarray(W.empty_arena(96, res)))
    poses = np.stack([
        np.concatenate([np.linspace(-0.8, 0.8, n // 2)] * 2),
        np.concatenate([np.zeros(n // 2), np.full(n // 2, 0.5)]),
        np.linspace(0, 2 * math.pi, n, endpoint=False)],
        axis=1).astype(np.float32)
    depths = DC.render_depths(cfg.depthcam, world, res, 96,
                              jnp.asarray(poses))
    base = V.empty_voxel_grid(cfg.voxel)
    if case == "saturated":
        for _ in range(12):
            base = V.fuse_depths(cfg.voxel, cfg.depthcam, base, depths,
                                 jnp.asarray(poses))
    step = VS.make_voxel_fuse_step(cfg.voxel, cfg.depthcam, mesh)
    OUT[case + ".depths"] = np.asarray(depths)
    OUT[case + ".poses"] = poses
    OUT[case + ".base"] = np.asarray(base)
    OUT[case + ".want"] = np.asarray(step(
        jax.device_put(base, VS.voxel_sharding(mesh)), depths,
        jnp.asarray(poses)))
    OUT[case + ".patch"] = np.asarray(V.fuse_depths(
        cfg.voxel, cfg.depthcam, base, depths, jnp.asarray(poses)))
    OUT[case + ".region_supported"] = np.asarray(VKK.region_supported(
        cfg.voxel, cfg.depthcam, cfg.voxel.size_y_cells // 2,
        cfg.voxel.size_x_cells))
'''


def _configs_src() -> str:
    return "CONFIGS = " + repr({c: PR.voxel_config(c).to_json()
                                for c in CASES}) + "\n"


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    d = tmp_path_factory.mktemp("voxel_sharded")
    ref = JR.run_reference(JR.ONE_XLA_THREAD + _configs_src() + _REF,
                           d / "ref.npz",
                           n_devices=4)
    DR.spawn("tests.torch_parallel_ranks:voxel", 4,
             [str(d / "ref.npz"), str(d)], timeout_s=600)
    with np.load(d / "global.npz") as z:
        glob = {k: z[k] for k in z.files}
    ranks = []
    for r in range(4):
        with np.load(d / f"rank{r}.npz") as z:
            ranks.append({k: z[k] for k in z.files})
    return {"ref": ref, "global": glob, "ranks": ranks}


def _apart(a, b) -> float:
    return float((np.abs(a - b) > 1e-5).mean())


@pytest.mark.parametrize("case", ["empty", "pitched"])
def test_sharded_matches_jax_and_patch_path(runs, case):
    """The 2 x 2 fuse into an empty grid against JAX's 2 x 2 fuse and the
    patch path of both packages (test_voxel_sharded.py:41)."""
    got = runs["global"][case + ".got"]
    ref = runs["ref"]
    assert got.shape == ref[case + ".want"].shape
    assert _apart(got, ref[case + ".want"]) <= VOXELS
    assert _apart(got, ref[case + ".patch"]) <= VOXELS
    cfg = PR.voxel_config(case)
    mine = V.fuse_depths(cfg.voxel, cfg.depthcam,
                         torch.as_tensor(ref[case + ".base"]),
                         torch.as_tensor(ref[case + ".depths"]),
                         torch.as_tensor(ref[case + ".poses"])).numpy()
    assert _apart(got, mine) <= VOXELS
    assert (got > 0).sum() > 0 and (got < 0).sum() > 0


def test_sharded_parity_holds_at_saturation(runs):
    """Both paths clip once a call, so mixed-sign updates on a saturated
    grid agree (test_voxel_sharded.py:61)."""
    ref = runs["ref"]
    cfg = tiny_config()
    base = ref["saturated.base"]
    assert base.max() == cfg.voxel.logodds_max
    assert base.min() == cfg.voxel.logodds_min
    got = runs["global"]["saturated.got"]
    assert _apart(got, ref["saturated.want"]) <= VOXELS
    assert _apart(got, ref["saturated.patch"]) <= VOXELS


def test_sharded_grid_layout(runs):
    """Each rank owns a contiguous Y slab of every Z layer
    (test_voxel_sharded.py:85)."""
    v = tiny_config().voxel
    want = [v.size_z_cells, v.size_y_cells // 2, v.size_x_cells]
    for rk in runs["ranks"]:
        assert rk["init_shape"].tolist() == want
        for case in CASES:
            assert rk[case + ".slab_shape"].tolist() == want


def test_engine_follows_region_supported(runs):
    """The engine is JAX's static choice: the region route (K7) where
    `region_supported` holds for the slab, the classify_region sum where
    it does not (the pitched camera)."""
    for case in CASES:
        want = bool(runs["ref"][case + ".region_supported"])
        assert bool(runs["global"][case + ".region"]) == want, case
    assert bool(runs["global"]["empty.region"])
    assert not bool(runs["global"]["pitched.region"])


def _stub_mesh(n_fleet, n_space):
    return types.SimpleNamespace(
        size=lambda i: (n_fleet, n_space)[i],
        get_coordinate=lambda: [0, 0], device_type="cpu")


def test_sharded_rejects_indivisible():
    """Y not divisible by 'space', and a batch not divisible by 'fleet',
    raise before any collective (test_voxel_sharded.py:98)."""
    cfg = tiny_config()
    bad = dataclasses.replace(cfg.voxel, size_y_cells=100)
    with pytest.raises(ValueError, match="divisible"):
        VS.init_sharded_voxel_grid(bad, _stub_mesh(1, 8))
    with pytest.raises(ValueError, match="divisible"):
        VS.make_voxel_fuse_step(bad, cfg.depthcam, _stub_mesh(1, 8))
    fuse = VS.make_voxel_fuse_step(cfg.voxel, cfg.depthcam, _stub_mesh(2, 1))
    H, W = cfg.depthcam.height_px, cfg.depthcam.width_px
    with pytest.raises(ValueError, match="batch 3 not divisible"):
        fuse(VS.init_sharded_voxel_grid(cfg.voxel, _stub_mesh(2, 1)),
             torch.zeros((3, H, W)), torch.zeros((3, 3)))


def test_one_rank_region_route_equals_the_patch_path():
    """A 1 x 1 mesh's step is `region_delta` over the whole grid: on the
    level camera it equals the port's own patch path (the kernel
    engine's float program) within the clip-order tolerance."""
    cfg = tiny_config()
    from jax_mapping_torch.sim import depthcam as DC
    from jax_mapping_torch.sim import world as W
    world = torch.as_tensor(W.empty_arena(96, cfg.voxel.resolution_m))
    poses = torch.tensor([[0.1 * i - 0.3, 0.05 * i, 0.8 * i]
                          for i in range(6)], dtype=torch.float32)
    depths = DC.render_depths(cfg.depthcam, world, cfg.voxel.resolution_m,
                              96, poses)
    # The step's local sum, without the 'fleet' all_reduce (a no-op on
    # one rank, and a stub mesh has no process group).
    from jax_mapping_torch.ops import voxel_kernel as VKK
    assert VS.uses_region_kernel(cfg.voxel, cfg.depthcam, _stub_mesh(1, 1))
    delta = VKK.region_delta(cfg.voxel, cfg.depthcam, depths, poses, 0,
                             cfg.voxel.size_y_cells, cfg.voxel.size_x_cells)
    got = torch.clamp(delta, cfg.voxel.logodds_min, cfg.voxel.logodds_max)
    want = V.fuse_depths(cfg.voxel, cfg.depthcam,
                         V.empty_voxel_grid(cfg.voxel, "cpu"), depths, poses)
    assert _apart(got.numpy(), want.numpy()) <= VOXELS
    assert math.isfinite(float(got.sum())) and (got > 0).any()
