"""The port's side of the multi-rank tests: functions that every rank of a
gloo job runs (`jax_mapping_torch.parallel.dryrun.spawn`), one job per
test module.

Each takes argv = [reference .npz, output directory]. The reference holds
the JAX package's inputs and outputs (its scans, rings, depth images and
initial states, in the global view); every rank cuts its shard out of
them, runs the port's sharded code, and writes `rank<r>.npz` with its own
shard's leaves. Rank 0 also writes `global.npz` with the gathered global
views. Imports no JAX: the ranks are port processes.
"""

from __future__ import annotations

import dataclasses
import json
import os
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist

from jax_mapping_torch import interop
from jax_mapping_torch.config import tiny_config
from jax_mapping_torch.ops import posegraph as PG
from jax_mapping_torch.parallel import distributed as D
from jax_mapping_torch.parallel import dryrun as DR
from jax_mapping_torch.parallel import fleet_sharded as FS
from jax_mapping_torch.parallel import mesh as MESH
from jax_mapping_torch.parallel import voxel_sharded as VS
from jax_mapping_torch.sim import world as W

#: The mesh of both jobs and of their JAX references.
MESH_SHAPE = (2, 2)

#: Sharded-step scenarios: name -> (steps, world cells, the seed of the
#: JAX initial state's per-robot keys). With seed 8 the JAX draws close a
#: loop at step 6 of the trajectory (seeds 0-2 close none in 16 steps).
STEP_RUNS = {"steps": (6, 96, 0), "traj": (10, DR.TRAJECTORY_ARENA_CELLS, 8),
             "loc": (3, 96, 0), "pg": (3, 96, 0)}

_GRAPH = PG.PoseGraph._fields


def fleet_config(name: str):
    """The config of a sharded-step scenario (both packages build it from
    the same fields)."""
    c = tiny_config()
    c = dataclasses.replace(c, fleet=dataclasses.replace(c.fleet,
                                                         n_robots=8))
    if name == "traj":
        return DR.trajectory_config(c)
    if name == "loc":
        return dataclasses.replace(c, mode="localization")
    if name == "pg":
        return dataclasses.replace(c, frontier=dataclasses.replace(
            c.frontier, planned_goals=True))
    return c


def _tree(ref: dict, prefix: str) -> SimpleNamespace:
    """The attribute tree `sharded_state_from_numpy` reads."""
    top = SimpleNamespace(**{k[len(prefix):]: v for k, v in ref.items()
                             if k.startswith(prefix)
                             and "." not in k[len(prefix):]})
    top.graphs = SimpleNamespace(**{f: ref[f"{prefix}graphs.{f}"]
                                    for f in _GRAPH})
    return top


def _flat(prefix: str, st) -> dict:
    """A ShardedFleetState's leaves as numpy arrays under `prefix`."""
    def n(v):
        return v.detach().cpu().numpy() if torch.is_tensor(v) \
            else np.asarray(v)

    out = {f"{prefix}{k}": n(v) for k, v in st._asdict().items()
           if k != "graphs"}
    out.update({f"{prefix}graphs.{k}": n(v)
                for k, v in st.graphs._asdict().items()})
    return out


def fleet(argv) -> None:
    """The fleet job: mesh shapes, the hybrid mesh, the slab fuse and the
    closure repair on the reference's inputs, the sharded-step scenarios
    from the reference's initial states with its wheel draws, and the dry
    run."""
    ref_path, out_dir = argv
    with np.load(ref_path) as z:
        ref = {k: z[k] for k in z.files}
    rank = dist.get_rank()
    glob, mine = {}, {}
    mesh = MESH.make_mesh(*MESH_SHAPE, device_type="cpu")
    f = MESH.axis_index(mesh, "fleet")
    s = MESH.axis_index(mesh, "space")
    glob["mesh.coords"] = np.asarray(
        [[int(v) for v in mesh.mesh.flatten()]])
    mine["coord"] = np.asarray([f, s])
    # make_mesh's factoring and its refusal, over the same 4 ranks.
    glob["mesh.default"] = np.asarray(MESH.make_mesh(device_type="cpu")
                                      .mesh.shape)
    glob["mesh.fleet4"] = np.asarray(MESH.make_mesh(n_fleet=4,
                                                    device_type="cpu")
                                     .mesh.shape)
    try:
        MESH.make_mesh(3, 3, device_type="cpu")
        glob["mesh.refused"] = np.asarray(False)
    except ValueError:
        glob["mesh.refused"] = np.asarray(True)
    # initialize() inside a running group: idempotent, no second group.
    glob["initialize.again"] = np.asarray(D.initialize(
        D.DistConfig("127.0.0.1:1", 4, rank)))
    hyb = D.hybrid_fleet_mesh(n_hosts=2, space_per_host=2, local_ranks=2,
                              device_type="cpu")
    glob["hybrid.ranks"] = hyb.mesh.numpy()
    glob["hybrid.names"] = np.asarray(list(hyb.mesh_dim_names))

    cfg = fleet_config("steps")
    g = cfg.grid
    R = cfg.fleet.n_robots
    Rl = R // MESH_SHAPE[0]
    rows = g.size_cells // MESH_SHAPE[1]
    row0 = s * rows

    def mine_rows(a):
        return torch.as_tensor(np.asarray(a)[f * Rl:(f + 1) * Rl])

    # The slab fuse: deltas of the local robots, summed over 'fleet',
    # clipped once, gathered along 'space'.
    d = FS._slab_delta(cfg, mine_rows(ref["fuse.scans"]),
                       mine_rows(ref["fuse.poses"]), row0, rows)
    d = MESH.all_sum(d.contiguous(), mesh, "fleet")
    got = torch.clamp(d, g.logodds_min, g.logodds_max)
    glob["fuse.got"] = MESH.gather_rows(got, mesh, "space").numpy()

    # The closure repair from the local robots' rings.
    rings, poses, valid = (mine_rows(ref[k]) for k in
                           ("repair.rings", "repair.poses", "repair.valid"))
    cap = rings.shape[1]
    d = FS._slab_delta(cfg, rings.reshape(Rl * cap, -1),
                       poses.reshape(Rl * cap, 3), row0, rows,
                       mask=valid.reshape(Rl * cap))
    d = MESH.all_sum(d.contiguous(), mesh, "fleet")
    glob["repair.got"] = MESH.gather_rows(
        torch.clamp(d, g.logodds_min, g.logodds_max), mesh, "space").numpy()

    # The sharded-step scenarios.
    for name, (steps, cells, _seed) in STEP_RUNS.items():
        c = fleet_config(name)
        world = torch.as_tensor(W.empty_arena(cells, c.grid.resolution_m))
        st = interop.sharded_state_from_numpy(
            _tree(ref, f"{name}.s0."), (f, s), MESH_SHAPE, "cpu")
        step = FS.make_fleet_step(c, mesh, c.grid.resolution_m)
        for t in range(steps):
            st, met = step(st, world, torch.as_tensor(
                ref[f"{name}.normals{t}"]))
            gl = interop.sharded_state_to_numpy(st, mesh)
            glob.update(_flat(f"{name}.s{t + 1}.", gl))
            glob[f"{name}.assignment{t}"] = MESH.gather_rows(
                met["assignment"], mesh, "fleet").numpy()
            for k, v in met.items():
                if k != "assignment":
                    glob[f"{name}.m{t}.{k}"] = v.numpy()
        mine.update(_flat(f"{name}.", st))

    out = DR.run(mesh, 16, 0, verbose=False)
    glob["dryrun"] = np.asarray(json.dumps(out))

    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **mine)
    if rank == 0:
        np.savez(os.path.join(out_dir, "global.npz"), **glob)


def voxel(argv) -> None:
    """The voxel job: each reference case fused on the 2 x 2 mesh (the
    reference's depth images and base grids), the slabs' shapes, and the
    engine each mesh takes."""
    ref_path, out_dir = argv
    with np.load(ref_path) as z:
        ref = {k: z[k] for k in z.files}
    rank = dist.get_rank()
    mesh = MESH.make_mesh(*MESH_SHAPE, device_type="cpu")
    s = MESH.axis_index(mesh, "space")
    glob, mine = {}, {}
    for case in ("empty", "saturated", "pitched"):
        cfg = voxel_config(case)
        vox = cfg.voxel
        rows = VS.slab_rows(vox, mesh)
        base = torch.as_tensor(ref[f"{case}.base"])[:, s * rows:(s + 1)
                                                     * rows].contiguous()
        fuse = VS.make_voxel_fuse_step(vox, cfg.depthcam, mesh)
        out = fuse(base, torch.as_tensor(ref[f"{case}.depths"]),
                   torch.as_tensor(ref[f"{case}.poses"]))
        mine[f"{case}.slab_shape"] = np.asarray(out.shape)
        glob[f"{case}.got"] = MESH.gather_rows(
            out.transpose(0, 1).contiguous(), mesh, "space"
        ).transpose(0, 1).numpy()
        glob[f"{case}.region"] = np.asarray(
            VS.uses_region_kernel(vox, cfg.depthcam, mesh))
    mine["init_shape"] = np.asarray(
        VS.init_sharded_voxel_grid(tiny_config().voxel, mesh).shape)
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **mine)
    if rank == 0:
        np.savez(os.path.join(out_dir, "global.npz"), **glob)


def voxel_config(case: str):
    """The config of a voxel case: tiny_config, with a camera pitched up
    0.1 rad for "pitched" (outside the region route)."""
    c = tiny_config()
    if case == "pitched":
        return dataclasses.replace(c, depthcam=dataclasses.replace(
            c.depthcam, mount_pitch_rad=0.1))
    return c
