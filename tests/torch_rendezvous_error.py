"""The rendezvous phase (chip_smoke.py `phase_rendezvous`) in both packages
on the CPU: how far each one's recovered fleet transform is from the true
one.

    JAX_PLATFORMS=cpu python -m tests.torch_rendezvous_error [--seed S]

The default SlamConfig. Fleet A is 4 robots on 0.4 m circles 3.5 m from
two walls of rooms_world(4096, 0.05, seed=1) at 0.1 m/s (the mapper
drive), each tick a 16-scan window (`slam_step_window`) per robot on one
shared grid, until every robot has the merger's `min_keyscans` graph
poses. Fleet B is A's robots 0 and 1 in a frame that (2.0, -1.5, 0.3)
about their mean start maps onto A's: poses, graphs and rings through its
inverse, a grid re-fused in B's frame. `RendezvousMerger.poll` runs on
stand-in mappers (tests/torch_kernel_inputs.py) until it merges.

The inputs are the smoke's: the true poses by rk2 from the commanded
wheel speeds, scans from the port's `sim.lidar` at them, measured wheel
speeds with 2% noise from a torch generator seeded with S + 7 (the smoke
passes its seed S). The JAX package runs the same inputs in a clean
subprocess (tests/torch_jaxref.py); each side runs closed loop. The
script prints one JSON line: each side's transform, its error in metres
and radians, its polls and ticks, and how far the two transforms are
apart.
"""

from __future__ import annotations

import argparse
import inspect
import json
import math
import tempfile
import textwrap
import time
from pathlib import Path

import numpy as np
import torch

from jax_mapping_torch.config import SlamConfig
from jax_mapping_torch.models import slam as S
from jax_mapping_torch.ops import grid as G
from jax_mapping_torch.ops.odometry import rk2_step, twist_to_wheel_units
from jax_mapping_torch.scenarios import rendezvous as RV
from jax_mapping_torch.sim import lidar
from jax_mapping_torch.sim import world as W

try:
    from tests.torch_jaxref import run_reference
    from tests.torch_kernel_inputs import StandInMapper
except ImportError:                       # run from inside tests/
    from torch_jaxref import run_reference
    from torch_kernel_inputs import StandInMapper

#: B's frame -> A's, about the mean start of A's robots 0 and 1 (the
#: smoke's RENDEZVOUS_T).
RENDEZVOUS_T = (2.0, -1.5, 0.3)
ROBOTS = 4
MAX_TICKS = 8
POLLS = 4


def drive_inputs(seed: int) -> dict:
    """The smoke's drive of fleet A for MAX_TICKS ticks: start poses (R,
    3), scans (T, R, W, beams) and measured wheels (T, R, W, 2)."""
    cfg = SlamConfig()
    n, res = cfg.grid.size_cells, cfg.grid.resolution_m
    world = torch.as_tensor(W.rooms_world(n, res, seed=1))
    walls = [int(n * f) for f in (0.33, 0.66)]
    centres = []
    for wx in walls:
        for wy in walls:
            for s in (1, -1):
                fx = (wx + (2 if s > 0 else 0) - n / 2) * res
                fy = (wy + (2 if s > 0 else 0) - n / 2) * res
                centres.append((fx + 3.5 * s, fy + 3.5 * s))
    c = torch.tensor(centres[:ROBOTS], dtype=torch.float32)
    truth = torch.stack([c[:, 0] + 0.4, c[:, 1],
                         torch.full((ROBOTS,), math.pi / 2)], 1)
    start = truth.clone()
    wl, wr = twist_to_wheel_units(cfg.robot, 0.1, 0.1 / 0.4)
    cmd = torch.tensor([wl, wr], dtype=torch.float32)
    gen = torch.Generator().manual_seed(seed + 7)
    ns = int(cfg.scan.range_max_m / (res * 0.5))
    WN = cfg.fleet.batch_scans
    dt = torch.tensor(0.1)
    scans, wheels = [], []
    for _ in range(MAX_TICKS):
        poses = []
        for _ in range(WN):
            truth = rk2_step(cfg.robot, truth, cmd[0], cmd[1], dt)
            poses.append(truth)
        p = torch.stack(poses, 1)
        scans.append(lidar.simulate_scans(
            cfg.scan, world, res, ns, p.reshape(-1, 3)).reshape(
                ROBOTS, WN, -1))
        noise = torch.randn((ROBOTS, WN, 2), generator=gen)
        wheels.append(cmd * (1.0 + 0.02 * noise))
    return {"start": start.numpy(), "scans": torch.stack(scans).numpy(),
            "wheels": torch.stack(wheels).numpy()}


def true_transform(start: np.ndarray) -> np.ndarray:
    s = start[:2, :2].mean(axis=0)
    return np.asarray([s[0] + RENDEZVOUS_T[0], s[1] + RENDEZVOUS_T[1],
                       RENDEZVOUS_T[2]], np.float32)


def reference(inputs_path, out_path) -> dict:
    """JAX's fleet A, fleet B and merger on the inputs."""
    return run_reference(textwrap.dedent(f"""
        import inspect, math
        sys.path.insert(0, "tests")
        import jax.numpy as jnp
        from jax_mapping.config import SlamConfig
        from jax_mapping.models import slam as S
        from jax_mapping.ops import grid as G
        from jax_mapping.scenarios import rendezvous as RV
        from torch_kernel_inputs import StandInMapper
        z = np.load({str(inputs_path)!r})
        cfg = SlamConfig()
        T = z["T"]
        states = [S.init_state(cfg, pose0=jnp.asarray(z["start"][r]))
                  for r in range({ROBOTS})]
        shared = states[0].grid
        min_keys = inspect.signature(RV.RendezvousMerger).parameters[
            "min_keyscans"].default
        ticks = 0
        while min(int(s.graph.n_poses) for s in states) < min_keys:
            for r in range({ROBOTS}):
                states[r], _ = S.slam_step_window(
                    cfg, states[r]._replace(grid=shared),
                    jnp.asarray(z["scans"][ticks, r]),
                    jnp.asarray(z["wheels"][ticks, r]), jnp.float32(0.1))
                shared = states[r].grid
            ticks += 1
        cap = cfg.loop.max_poses
        states_a = [s._replace(grid=shared) for s in states]
        t_inv = RV.se2_from_pair(np.zeros(3, np.float32), T)
        moved = [RV.transform_state(st, t_inv) for st in states_a[:2]]
        grid_b = G.empty_grid(cfg.grid)
        for st in moved:
            grid_b = G.fuse_scans_masked(cfg.grid, cfg.scan, grid_b,
                                         st.scan_ring, st.graph.poses[:cap],
                                         st.graph.pose_valid[:cap])
        states_b = [st._replace(grid=grid_b) for st in moved]
        merger = RV.RendezvousMerger(cfg, StandInMapper(states_a, cap),
                                     StandInMapper(states_b, cap))
        polls = 0
        for _ in range({POLLS}):
            polls += 1
            if merger.poll():
                break
        OUT["merged"] = np.array(bool(merger.merged))
        OUT["transform"] = np.asarray(
            merger.transform if merger.merged else np.full(3, np.nan),
            np.float32)
        OUT["polls"], OUT["ticks"] = np.array(polls), np.array(ticks)
        OUT["est"] = np.stack([np.asarray(s.pose) for s in states_a])
    """), out_path, timeout=1800)


def port_run(inputs: dict, T: np.ndarray) -> dict:
    """The port's fleet A, fleet B and merger on the inputs, on the CPU."""
    cfg = SlamConfig()
    states = [S.init_state(cfg, torch.from_numpy(inputs["start"][r]),
                           device="cpu") for r in range(ROBOTS)]
    shared = states[0].grid
    min_keys = inspect.signature(RV.RendezvousMerger).parameters[
        "min_keyscans"].default
    ticks = 0
    while min(int(s.graph.n_poses) for s in states) < min_keys:
        for r in range(ROBOTS):
            states[r], _ = S.slam_step_window(
                cfg, states[r]._replace(grid=shared),
                torch.from_numpy(inputs["scans"][ticks, r]),
                torch.from_numpy(inputs["wheels"][ticks, r]), 0.1)
            shared = states[r].grid
        ticks += 1
    cap = cfg.loop.max_poses
    states_a = [s._replace(grid=shared) for s in states]
    t_inv = RV.se2_from_pair(np.zeros(3, np.float32), T)
    moved = [RV.transform_state(st, t_inv) for st in states_a[:2]]
    grid_b = G.empty_grid(cfg.grid, "cpu")
    for st in moved:
        grid_b = G.fuse_scans_masked(cfg.grid, cfg.scan, grid_b,
                                     st.scan_ring, st.graph.poses[:cap],
                                     st.graph.pose_valid[:cap])
    states_b = [st._replace(grid=grid_b) for st in moved]
    merger = RV.RendezvousMerger(cfg, StandInMapper(states_a, cap),
                                 StandInMapper(states_b, cap))
    polls = 0
    for _ in range(POLLS):
        polls += 1
        if merger.poll():
            break
    return {"merged": bool(merger.merged),
            "transform": np.asarray(merger.transform if merger.merged
                                    else np.full(3, np.nan), np.float32),
            "polls": polls, "ticks": ticks,
            "est": np.stack([s.pose.numpy() for s in states_a])}


def error(transform: np.ndarray, T: np.ndarray) -> tuple:
    d = np.asarray(transform, np.float64) - np.asarray(T, np.float64)
    return float(np.hypot(d[0], d[1])), abs(math.remainder(float(d[2]),
                                                           2 * math.pi))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    inputs = drive_inputs(args.seed)
    T = true_transform(inputs["start"])
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "inputs.npz"
        np.savez(path, T=T, **inputs)
        ref = reference(path, Path(tmp) / "rendezvous.npz")
    t1 = time.perf_counter()
    port = port_run(inputs, T)
    t2 = time.perf_counter()
    jm, jr = error(ref["transform"], T)
    pm, pr = error(port["transform"], T)
    apart = np.asarray(port["transform"], np.float64) - ref["transform"]
    print(json.dumps({
        "config": "SlamConfig()", "robots_a": ROBOTS, "robots_b": 2,
        "seed": args.seed, "transform_true": T.tolist(),
        "jax": {"merged": bool(ref["merged"]),
                "transform": ref["transform"].tolist(),
                "err_m": jm, "err_rad": jr, "polls": int(ref["polls"]),
                "ticks": int(ref["ticks"])},
        "port": {"merged": port["merged"],
                 "transform": port["transform"].tolist(),
                 "err_m": pm, "err_rad": pr, "polls": port["polls"],
                 "ticks": port["ticks"]},
        "transforms_apart_m": float(np.hypot(apart[0], apart[1])),
        "transforms_apart_rad": abs(math.remainder(float(apart[2]),
                                                   2 * math.pi)),
        "fleet_a_estimates_apart_m": float(np.linalg.norm(
            port["est"][:, :2] - ref["est"][:, :2], axis=-1).max()),
        "seconds": {"jax": t1 - t0, "port": t2 - t1}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
