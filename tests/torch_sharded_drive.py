"""The sharded step and the Y-slab voxel fuse on a 1 x 1 card mesh against
a 1 x 1 CPU mesh, shared by chip_smoke.py's `sharded_parity` phase and
tests/test_torch_cuda.py.

Both meshes live over the one process group that `parallel.mesh.make_mesh`
brings up at world size 1 (`cpu:gloo,cuda:nccl`). The step runs from one
state with the same wheel normals on both; the tolerances are those of
the stack parity: truth poses to 1e-6 m, estimates to 1e-4 m, assignments
and loop counts equal, at most 1e-4 of the grid cells (or voxels) more
than 1e-5 apart. Plain PyTorch; no pytest and no JAX.
"""

import numpy as np
import torch

from jax_mapping_torch.config import tiny_config
from jax_mapping_torch.ops import _cuda
from jax_mapping_torch.parallel import dryrun as DR
from jax_mapping_torch.parallel import fleet_sharded as FS
from jax_mapping_torch.parallel import mesh as MESH
from jax_mapping_torch.parallel import voxel_sharded as VS
from jax_mapping_torch.sim import depthcam as D
from jax_mapping_torch.sim import world as W

ROBOTS = 8
#: name -> ticks: tiny_config(8) in a 4.8 m arena, and the dry run's
#: trajectory (closures and thinning) in its 2.4 m arena.
TICKS = {"tiny": 6, "trajectory": 10}
TRUTH_M, EST_M, CELLS_SHARE, APART = 1e-6, 1e-4, 1e-4, 1e-5


def meshes() -> dict:
    return {"cuda": MESH.make_mesh(1, 1),
            "cpu": MESH.make_mesh(1, 1, device_type="cpu")}


def run_config(name: str):
    """(cfg, arena cells, ticks) of the named run."""
    cfg = tiny_config(ROBOTS)
    if name == "trajectory":
        return (DR.trajectory_config(cfg), DR.TRAJECTORY_ARENA_CELLS,
                TICKS[name])
    return cfg, 96, TICKS[name]


def _to(state, dev):
    return FS.ShardedFleetState(*(
        x.to(dev) if torch.is_tensor(x) else type(x)(*(y.to(dev) for y in x))
        for x in state))


def step_card_and_cpu(name: str, seed: int = 0) -> dict:
    """The named run on both meshes, then the comparison: truth_m, est_m,
    cells_apart_max_share, assignments_equal, loops_equal (loops and
    thinnings every tick), the run's closures and thinnings on each mesh,
    and the card's kernel launches (`launches`)."""
    cfg, cells, ticks = run_config(name)
    res = cfg.grid.resolution_m
    ms = meshes()
    st0 = FS.init_sharded_state(cfg, ms["cpu"])
    gen = torch.Generator().manual_seed(seed)
    normals = [torch.randn((ROBOTS, 2), generator=gen) for _ in range(ticks)]
    rec, launches = {}, {}
    for label, mesh in ms.items():
        dev = FS.mesh_device(mesh)
        st = _to(st0, dev)
        step = FS.make_fleet_step(cfg, mesh, res)
        world = torch.as_tensor(W.empty_arena(cells, res), device=dev)
        before = dict(_cuda.LAUNCHES)
        r = {"truth": [], "est": [], "grid": [], "assign": [], "loops": [],
             "thins": []}
        for t in range(ticks):
            st, met = step(st, world, normals[t].to(dev))
            r["truth"].append(st.true_poses.cpu().numpy())
            r["est"].append(st.est_poses.cpu().numpy())
            r["grid"].append(st.grid.cpu().numpy())
            r["assign"].append(met["assignment"].cpu().numpy())
            r["loops"].append(int(met["n_loops"]))
            r["thins"].append(int(met["n_thins"]))
        rec[label] = r
        launches[label] = {k: v - before.get(k, 0)
                           for k, v in _cuda.LAUNCHES.items()}
    a, b = rec["cuda"], rec["cpu"]
    return {
        "ticks": ticks,
        "truth_m": float(np.abs(np.stack(a["truth"])
                                - np.stack(b["truth"])).max()),
        "est_m": float(np.abs(np.stack(a["est"]) - np.stack(b["est"])).max()),
        "cells_apart_max_share": max(
            float((np.abs(x - y) > APART).mean())
            for x, y in zip(a["grid"], b["grid"])),
        "assignments_equal": all(np.array_equal(x, y) for x, y in
                                 zip(a["assign"], b["assign"])),
        "assigned": int(sum((x >= 0).sum() for x in b["assign"])),
        "loops": {"cuda": a["loops"][-1], "cpu": b["loops"][-1]},
        "thins": {"cuda": sum(a["thins"]), "cpu": sum(b["thins"])},
        "loops_equal": a["loops"] == b["loops"] and a["thins"] == b["thins"],
        "launches": launches["cuda"]}


def step_failures(name: str, o: dict) -> list:
    """What of `step_card_and_cpu(name)`'s result breaks the tolerances."""
    bad = [k for k, ok in (
        ("truth", o["truth_m"] <= TRUTH_M), ("estimates", o["est_m"] <= EST_M),
        ("assignments", o["assignments_equal"]), ("loops", o["loops_equal"]),
        ("grid cells", o["cells_apart_max_share"] <= CELLS_SHARE)) if not ok]
    if name == "trajectory" and o["loops"]["cpu"] < 1:
        bad.append("the trajectory closed no loop")
    return bad


def voxel_fuse_card_and_cpu() -> dict:
    """One Y-slab fuse of 8 tiny images on both meshes: voxels apart, the
    voxel count, the CPU grid's occupied voxels, whether both meshes took
    the region route, and the card's K7 launches."""
    cfg = tiny_config(ROBOTS)
    vox, cam = cfg.voxel, cfg.depthcam
    res = vox.resolution_m
    poses = torch.stack([torch.linspace(-0.8, 0.8, ROBOTS),
                         torch.zeros(ROBOTS),
                         torch.linspace(0.0, 6.0, ROBOTS)], 1)
    depths = D.render_depths(cam, torch.as_tensor(W.empty_arena(96, res)),
                             res, 96, poses)
    out, region, k7 = {}, True, 0
    for label, mesh in meshes().items():
        dev = FS.mesh_device(mesh)
        region &= VS.uses_region_kernel(vox, cam, mesh)
        before = _cuda.LAUNCHES["voxel_summed"]
        fuse = VS.make_voxel_fuse_step(vox, cam, mesh)
        out[label] = fuse(VS.init_sharded_voxel_grid(vox, mesh),
                          depths.to(dev), poses.to(dev)).cpu()
        if label == "cuda":
            k7 = _cuda.LAUNCHES["voxel_summed"] - before
    return {"voxels_apart": int(((out["cuda"] - out["cpu"]).abs()
                                 > APART).sum()),
            "voxels": out["cpu"].numel(),
            "occupied": int((out["cpu"] > vox.occ_threshold).sum()),
            "region_route": region, "k7_launches": k7}


def voxel_failures(v: dict) -> list:
    return [k for k, ok in (
        ("voxels apart", v["voxels_apart"] <= CELLS_SHARE * v["voxels"]),
        ("nothing occupied", v["occupied"] > 0),
        ("left the region route", v["region_route"]),
        ("K7 not launched", v["k7_launches"] > 0)) if not ok]
