"""Multi-rank dry run of the sharded fleet step and the Y-slab voxel fuse.

The port's counterpart of the JAX package's `dryrun_multichip`:

    python -m jax_mapping_torch.parallel.dryrun --ranks 4 --device cpu
    python -m jax_mapping_torch.parallel.dryrun            # one card

With `--device cpu` it spawns N gloo ranks, each a process of its own on
one intra-op thread; on the card it runs one NCCL rank (a 1 x 1 mesh) in
this process. The ranks form a ('fleet', 'space') mesh factored as
square-ish as possible (`mesh.factor_devices`) and run, at tiny_config
with a fleet of 8 robots (at least 2 a fleet rank):

  * a 16-step trajectory whose gates make every branch fire: a key scan
    every step (0.005 m / 0.005 rad gates), an 8-slot ring that fills and
    thins, and closures from robots that cross a 2.4 m arena and turn
    back (`trajectory_config`) — at 12 steps or more the mesh must show
    at least one thinning and one closure. The JAX dry run's own gates
    (a 1.2 m arena at the default motor limit and LiDAR stop distance)
    leave its robots turning in place within the stop distance of the
    walls, and close no loop;
  * two steps with planned steering (`FrontierConfig.planned_goals`);
  * one sharded voxel fuse of 2 x n_fleet rendered depth images, which
    must leave evidence in the grid.

Any failure raises (a spawned rank's failure ends the others and raises
here). Rank 0 prints the JAX dry run's summary lines. `spawn` is the
launcher the tests use for their own multi-rank jobs.
"""

from __future__ import annotations

import argparse
import dataclasses
import datetime
import importlib
import json
import os
import subprocess
import sys
import tempfile
import time
from typing import Optional, Sequence

import torch

#: The repository root (the directory that holds the package).
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def spawn(target: str, n_ranks: int, argv: Sequence[str] = (),
          timeout_s: float = 600.0) -> str:
    """Run `target` ("module:function", called as function(list of str))
    on `n_ranks` gloo CPU ranks, each a process of its own with one
    intra-op thread, joined through a file store. Waits for all of them;
    if one fails or the time runs out, ends the others and raises with
    the failing rank's output. Returns rank 0's standard output."""
    with tempfile.TemporaryDirectory() as d:
        env = dict(os.environ, OMP_NUM_THREADS="1")
        env["PYTHONPATH"] = os.pathsep.join(
            [_ROOT] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                       if p])
        logs, procs = [], []
        for r in range(n_ranks):
            out = open(os.path.join(d, f"rank{r}.log"), "w+")
            logs.append(out)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "jax_mapping_torch.parallel.dryrun",
                 "--rank-main", target, "--rank", str(r), "--ranks",
                 str(n_ranks), "--init-file", os.path.join(d, "store"),
                 "--", *argv],
                stdout=out, stderr=subprocess.STDOUT, env=env, cwd=_ROOT))
        deadline = time.monotonic() + timeout_s
        failed: Optional[int] = None
        try:
            while any(p.poll() is None for p in procs):
                bad = [r for r, p in enumerate(procs)
                       if p.poll() not in (None, 0)]
                if bad:
                    failed = bad[0]
                    break
                if time.monotonic() > deadline:
                    break
                time.sleep(0.05)
            else:
                bad = [r for r, p in enumerate(procs) if p.returncode]
                failed = bad[0] if bad else None
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        texts = []
        for out in logs:
            out.seek(0)
            texts.append(out.read())
            out.close()
        if failed is None and any(p.returncode for p in procs):
            raise RuntimeError(
                f"{target} on {n_ranks} ranks timed out after "
                f"{timeout_s:.0f} s:\n{texts[0][-4000:]}")
        if failed is not None:
            raise RuntimeError(
                f"{target} failed on rank {failed} of {n_ranks} (rc "
                f"{procs[failed].returncode}):\n{texts[failed][-6000:]}")
        return texts[0]


def _rank_main(target: str, rank: int, n_ranks: int, init_file: str,
               argv: list) -> None:
    """One spawned rank: join the gloo group, run the target, leave."""
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", init_method=f"file://{init_file}", rank=rank,
        world_size=n_ranks, timeout=datetime.timedelta(seconds=300))
    try:
        mod, fn = target.split(":")
        getattr(importlib.import_module(mod), fn)(argv)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _tiny(n_robots: int):
    from jax_mapping_torch.config import tiny_config
    c = tiny_config()
    return dataclasses.replace(
        c, fleet=dataclasses.replace(c.fleet, n_robots=n_robots))


def fleet_size(n_fleet: int) -> int:
    """Robots of the dry run's fleet: 8, or 2 a fleet rank, rounded up to
    a multiple of the fleet axis."""
    return n_fleet * max(2, -(-8 // n_fleet))


#: The trajectory's arena: 48 cells (2.4 m) at tiny_config's 0.05 m.
TRAJECTORY_ARENA_CELLS = 48


def trajectory_config(cfg):
    """The dry run's trajectory gates: a key scan every step, an 8-slot
    ring, a 0.25 m search disc (those of the JAX dry run), and robots
    fast enough to leave that disc and come back within 16 steps: cruise
    2000 units under a 3000-unit motor limit (9 cm a step at most), the
    LiDAR's stop and warn distances at 0.15 m and 0.1 m."""
    return dataclasses.replace(
        cfg,
        robot=dataclasses.replace(cfg.robot, cruise_speed_units=2000,
                                  motor_limit_units=3000,
                                  lidar_stop_dist_m=0.15,
                                  lidar_warn_dist_m=0.1),
        matcher=dataclasses.replace(cfg.matcher, min_travel_m=0.005,
                                    min_heading_rad=0.005),
        loop=dataclasses.replace(cfg.loop, max_poses=8, max_edges=64,
                                 min_chain_size=4, search_radius_m=0.25))


def run(mesh, steps: int = 16, seed: int = 0, verbose: bool = True) -> dict:
    """The dry run on this rank's shard of `mesh` (every rank calls it);
    returns the summary, the same on every rank."""
    from jax_mapping_torch.parallel import fleet_sharded as FS
    from jax_mapping_torch.parallel import voxel_sharded as VS
    from jax_mapping_torch.parallel.mesh import axis_size, gather_rows
    from jax_mapping_torch.sim import depthcam as DC
    from jax_mapping_torch.sim import world as W

    n_fleet = axis_size(mesh, "fleet")
    n = n_fleet * axis_size(mesh, "space")
    dev = FS.mesh_device(mesh)
    say = print if verbose else (lambda *a, **k: None)
    cfg = _tiny(fleet_size(n_fleet))
    R = cfg.fleet.n_robots
    res = cfg.grid.resolution_m
    # The wheel noise: the fleet's (R, 2) normals from one seeded stream,
    # the same numbers on every rank.
    gen = torch.Generator().manual_seed(seed)

    def normals():
        return torch.randn((R, 2), generator=gen)

    traj = trajectory_config(cfg)
    world2 = torch.as_tensor(W.empty_arena(TRAJECTORY_ARENA_CELLS, res),
                             device=dev)
    state = FS.init_sharded_state(traj, mesh)
    step = FS.make_fleet_step(traj, mesh, res)
    n_thins = 0
    for _ in range(steps):
        state, metrics = step(state, world2, normals())
        n_thins += int(metrics["n_thins"])
    err = float(metrics["mean_pose_err_m"])
    n_loops = int(metrics["n_loops"])
    chains = gather_rows(state.graphs.n_poses, mesh, "fleet")
    finite = bool(torch.isfinite(state.grid).all())
    _check(int(state.t) == steps, f"trajectory stopped at t={int(state.t)}")
    _check(finite, "sharded grid went non-finite during the trajectory")
    _check(err == err and err < 1.0, f"pose error diverged: {err}")
    _check(int(chains.min()) >= 1, "key-scan gate never fired on some robot")
    if steps >= 12:
        _check(n_thins >= 1, "thinning never fired despite ring saturation")
        _check(n_loops >= 1, "no loop closure fired across the mesh")
    say(f"dryrun({n}): trajectory t={steps} ok, loops_closed={n_loops}, "
        f"thins={n_thins}, chain={int(chains.min())}..{int(chains.max())}, "
        f"mean_pose_err={err:.4f} m", flush=True)

    world = torch.as_tensor(W.empty_arena(96, res), device=dev)
    pg = dataclasses.replace(cfg, frontier=dataclasses.replace(
        cfg.frontier, planned_goals=True))
    state3 = FS.init_sharded_state(pg, mesh)
    step3 = FS.make_fleet_step(pg, mesh, res)
    for _ in range(2):
        state3, metrics3 = step3(state3, world, normals())
    _check(bool(torch.isfinite(state3.grid).all()),
           "sharded grid went non-finite under planned steering")
    _check(float(metrics3["mean_pose_err_m"]) < 1.0,
           "pose error diverged under planned steering")
    say(f"dryrun({n}): planned-steering mesh ok (t={int(state3.t)})",
        flush=True)

    nv = n_fleet * 2
    poses = torch.stack([torch.linspace(-0.5, 0.5, nv), torch.zeros(nv),
                         torch.linspace(0.0, 6.0, nv)], 1).to(dev)
    depths = DC.render_depths(cfg.depthcam, world, res, 64, poses)
    vgrid = VS.init_sharded_voxel_grid(cfg.voxel, mesh)
    vgrid = VS.make_voxel_fuse_step(cfg.voxel, cfg.depthcam, mesh)(
        vgrid, depths, poses)
    full = gather_rows(vgrid.transpose(0, 1).contiguous(), mesh, "space")
    _check(bool(torch.isfinite(full).all()),
           "sharded voxel grid went non-finite")
    n_evidence = int((full.abs() > 0).sum())
    _check(n_evidence > 0, "voxel fusion produced no evidence")
    say(f"dryrun({n}): voxel mesh ok, {n_evidence} voxels updated",
        flush=True)
    return {"ranks": n, "mesh": [n_fleet, n // n_fleet], "steps": steps,
            "loops_closed": n_loops, "thins": n_thins,
            "chain_min": int(chains.min()), "chain_max": int(chains.max()),
            "mean_pose_err_m": err, "planned_steps": int(state3.t),
            "voxels_updated": n_evidence,
            "voxel_region_route": VS.uses_region_kernel(
                cfg.voxel, cfg.depthcam, mesh)}


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"dryrun: {what}")


def _spawned_run(argv: list) -> None:
    """A spawned rank's dry run: argv = [steps, seed, summary path]."""
    import torch.distributed as dist
    from jax_mapping_torch.parallel import mesh as MESH
    steps, seed, path = int(argv[0]), int(argv[1]), argv[2]
    rank = dist.get_rank()
    mesh = MESH.make_mesh(device_type="cpu")
    out = run(mesh, steps, seed, verbose=rank == 0)
    if rank == 0:
        with open(path, "w") as f:
            json.dump(out, f)


def dryrun(n_ranks: int = 1, device: Optional[str] = None, steps: int = 16,
           seed: int = 0) -> dict:
    """The dry run over `n_ranks` gloo CPU ranks (device "cpu"), or over
    one NCCL rank on the card (device None or "cuda"). Returns the
    summary."""
    from jax_mapping_torch._util import resolve_device
    dev = resolve_device(device)
    if dev.type != "cpu":
        if n_ranks != 1:
            raise ValueError(f"{n_ranks} ranks on the card: the dry run "
                             "runs one NCCL rank there; more ranks run "
                             "as gloo processes with --device cpu")
        from jax_mapping_torch.parallel import mesh as MESH
        return run(MESH.make_mesh(1, 1, device_type=dev.type), steps, seed)
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "summary.json")
        print(spawn("jax_mapping_torch.parallel.dryrun:_spawned_run",
                    n_ranks, [str(steps), str(seed), path]),
              end="", flush=True)
        with open(path) as f:
            return json.load(f)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m jax_mapping_torch.parallel.dryrun",
        description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=1)
    ap.add_argument("--device", default=None,
                    help="cpu: gloo ranks on the CPU (default: the card)")
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--rank-main", default=None, help=argparse.SUPPRESS)
    ap.add_argument("--rank", type=int, default=0, help=argparse.SUPPRESS)
    ap.add_argument("--init-file", default=None, help=argparse.SUPPRESS)
    ap.add_argument("rest", nargs="*", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank_main:
        _rank_main(args.rank_main, args.rank, args.ranks, args.init_file,
                   args.rest)
        return 0
    print(json.dumps(dryrun(args.ranks, args.device, args.steps, args.seed)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
