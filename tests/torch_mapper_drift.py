"""The mapper phase's drive (chip_smoke.py `phase_mapper`) in both packages
on the CPU: how far each one's SLAM poses drift from the true poses.

    JAX_PLATFORMS=cpu python -m tests.torch_mapper_drift [--robots R]
        [--ticks T] [--seed S]

The default SlamConfig, R robots (8 in the chip smoke) on 0.4 m circles
3.5 m from two walls of rooms_world(4096, 0.05, seed=1) at 0.1 m/s; a
tick is, per robot, one 16-scan window (`slam_step_window`) and two single
scans (`slam_step`), every robot's step taking the grid the previous one
returned. The JAX package drives it in a clean subprocess
(tests/torch_jaxref.py): true poses by rk2 from the commanded wheel
speeds, scans from its `sim.lidar` at the true poses, measured wheel
speeds with 2% noise from numpy's generator seeded with S. The port then
runs its own SLAM steps on the same scans and wheel speeds. Each side runs
closed loop, so the two estimates may part. The script prints one JSON
line: each side's distance from the true position per robot at the end
and its largest over all ticks, and the signed difference of the two
distances (port minus JAX) per robot at the end and at its extremes over
all ticks and robots.
"""

from __future__ import annotations

import argparse
import json
import tempfile
import textwrap
import time
from pathlib import Path

import numpy as np
import torch

from jax_mapping_torch.config import SlamConfig
from jax_mapping_torch.models import slam as S

try:
    from tests.torch_jaxref import run_reference
except ImportError:                       # run from inside tests/
    from torch_jaxref import run_reference


def reference(robots: int, ticks: int, seed: int, out_path) -> dict:
    """JAX's drive: inputs, true poses and its estimates, per tick."""
    return run_reference(textwrap.dedent(f"""
        import jax, jax.numpy as jnp
        from jax_mapping.config import SlamConfig
        from jax_mapping.models import slam as S
        from jax_mapping.ops.odometry import rk2_step, twist_to_wheel_units
        from jax_mapping.sim import lidar
        from jax_mapping.sim import world as W
        cfg = SlamConfig()
        R, T = {robots}, {ticks}
        n, res = cfg.grid.size_cells, cfg.grid.resolution_m
        world = jnp.asarray(W.rooms_world(n, res, seed=1))
        walls = [int(n * f) for f in (0.33, 0.66)]
        centres = []
        for wx in walls:
            for wy in walls:
                for s in (1, -1):
                    fx = (wx + (2 if s > 0 else 0) - n / 2) * res
                    fy = (wy + (2 if s > 0 else 0) - n / 2) * res
                    centres.append((fx + 3.5 * s, fy + 3.5 * s))
        WN = cfg.fleet.batch_scans
        wl, wr = twist_to_wheel_units(cfg.robot, 0.1, 0.1 / 0.4)
        truth = [jnp.asarray([c[0] + 0.4, c[1], np.pi / 2], jnp.float32)
                 for c in centres[:R]]
        OUT["truth0"] = np.stack([np.asarray(p) for p in truth])
        sts = [S.init_state(cfg, truth[r]) for r in range(R)]
        shared = sts[0].grid
        rng = np.random.default_rng({seed})
        nsamp = int(cfg.scan.range_max_m / (res * 0.5))
        dt = jnp.float32(0.1)
        scans_all = np.zeros((T, R, WN + 2, cfg.scan.padded_beams),
                             np.float32)
        wheels_all = np.zeros((T, R, WN + 2, 2), np.float32)
        truth_all = np.zeros((T, R, 3), np.float32)
        est_all = np.zeros((T, R, 3), np.float32)
        for t in range(T):
            for r in range(R):
                tp = []
                for i in range(WN + 2):
                    truth[r] = rk2_step(cfg.robot, truth[r], jnp.float32(wl),
                                        jnp.float32(wr), dt)
                    tp.append(truth[r])
                    wheels_all[t, r, i] = np.array([wl, wr]) * (
                        1.0 + 0.02 * rng.standard_normal(2))
                scans = lidar.simulate_scans(cfg.scan, world, res, nsamp,
                                             jnp.stack(tp))
                wh = jnp.asarray(wheels_all[t, r])
                st, _ = S.slam_step_window(
                    cfg, sts[r]._replace(grid=shared), scans[:WN], wh[:WN],
                    dt)
                for j in range(WN, WN + 2):
                    st, _ = S.slam_step(cfg, st, scans[j], wh[j, 0],
                                        wh[j, 1], dt)
                sts[r], shared = st, st.grid
                scans_all[t, r] = np.asarray(scans)
                truth_all[t, r] = np.asarray(truth[r])
                est_all[t, r] = np.asarray(st.pose)
        OUT["scans"], OUT["wheels"] = scans_all, wheels_all
        OUT["truth"], OUT["est"] = truth_all, est_all
    """), out_path, timeout=1800)


def port_drive(ref: dict) -> np.ndarray:
    """The port's estimates (T, R, 3) on the reference's inputs, on the
    CPU, with the same shared-grid order."""
    cfg = SlamConfig()
    WN = cfg.fleet.batch_scans
    T, R = ref["truth"].shape[:2]
    sts = [S.init_state(cfg, torch.from_numpy(ref["truth0"][r]),
                        device="cpu") for r in range(R)]
    shared = sts[0].grid
    est = np.zeros((T, R, 3), np.float32)
    for t in range(T):
        for r in range(R):
            scans = torch.from_numpy(ref["scans"][t, r])
            wh = torch.from_numpy(ref["wheels"][t, r])
            st, _ = S.slam_step_window(cfg, sts[r]._replace(grid=shared),
                                       scans[:WN], wh[:WN], 0.1)
            for j in range(WN, WN + 2):
                st, _ = S.slam_step(cfg, st, scans[j], wh[j, 0], wh[j, 1],
                                    0.1)
            sts[r], shared = st, st.grid
            est[t, r] = st.pose.numpy()
    return est


def drift(est: np.ndarray, truth: np.ndarray) -> np.ndarray:
    """(T, R) distance of the estimated from the true position."""
    return np.linalg.norm(est[..., :2] - truth[..., :2], axis=-1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--robots", type=int, default=8)
    ap.add_argument("--ticks", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        ref = reference(args.robots, args.ticks, args.seed,
                        Path(tmp) / "mapper_drift.npz")
    t1 = time.perf_counter()
    est = port_drive(ref)
    t2 = time.perf_counter()
    d_jax, d_port = drift(ref["est"], ref["truth"]), drift(est, ref["truth"])
    print(json.dumps({
        "config": "SlamConfig()", "robots": args.robots, "ticks": args.ticks,
        "seed": args.seed, "path_m_per_robot": round(
            args.ticks * (SlamConfig().fleet.batch_scans + 2) * 0.01, 3),
        "jax_drift_m_final": d_jax[-1].tolist(),
        "port_drift_m_final": d_port[-1].tolist(),
        "jax_drift_m_mean_final": float(d_jax[-1].mean()),
        "port_drift_m_mean_final": float(d_port[-1].mean()),
        "jax_drift_m_max": float(d_jax.max()),
        "port_drift_m_max": float(d_port.max()),
        "port_minus_jax_m_final": (d_port[-1] - d_jax[-1]).tolist(),
        "port_minus_jax_m_per_tick_max": float((d_port - d_jax).max()),
        "jax_minus_port_m_per_tick_max": float((d_jax - d_port).max()),
        "estimates_apart_m_final": np.linalg.norm(
            est[-1, :, :2] - ref["est"][-1, :, :2], axis=-1).tolist(),
        "seconds": {"jax": t1 - t0, "port": t2 - t1}}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
