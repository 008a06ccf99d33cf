"""Simulation node: the LD06 driver + physical world, in one box.

Port of the JAX package's `bridge/sim_node.py`. Plays the role of the Pi
half of the reference: a fixed-rate loop that produces
`sensor_msgs/LaserScan` on `{ns}scan` — plus the physics the workshop
floor provided for free. Each tick it:

  1. reads motor targets from the driver (what the brain wrote),
  2. advances the simulated fleet (first-order motor lag + RK2 kinematics,
     `sim.thymio`) on the stack's device,
  3. feeds measured wheel speeds + IR prox back into the driver (uint16
     wire encoding included),
  4. raycasts LD06 scans from ground-truth poses (`sim.lidar`) and
     publishes them Best-Effort (report.pdf §V.A),
  5. with `depth_cam`, renders every robot's depth image
     (`sim.depthcam`) and publishes it on `{ns}depth`.

With scripted world dynamics attached (`attach_world_dynamics`, the
`door_close` / `crowd` FaultPlan kinds through `set_door` / `set_crowd`),
the top of each step asks `WorldDynamics.world_if_changed` for the
composed world, on the host as in the JAX package, and uploads it to the
device in one host-to-device copy only when it changed: a copy from
pinned memory that the step's raycast waits for on the stream, with no
host sync. A quiet scenario makes no copy; an active crowd makes one a
step.

The JAX package draws the wheel noise from a PRNG key carried in the
fleet state; here a `torch.Generator` seeded from `seed` draws the (R, 2)
standard normals on the host each step and `step_fleet` takes them as
`wheel_normals`. The measured wheels, the IR readings, the scans and
the depth images leave the device together, in one copy a step.
"""

from __future__ import annotations

import time
from typing import Optional

import numpy as np
import torch

from jax_mapping_torch._util import resolve_device
from jax_mapping_torch.bridge.brain import robot_ns
from jax_mapping_torch.bridge.bus import Bus
from jax_mapping_torch.bridge.driver import SimulatedThymioDriver
from jax_mapping_torch.bridge.messages import (DepthImage, Header,
                                               LaserScan)
from jax_mapping_torch.bridge.node import Node
from jax_mapping_torch.bridge.qos import qos_sensor_data
from jax_mapping_torch.bridge.tf import TfTree
from jax_mapping_torch.config import SlamConfig
from jax_mapping_torch.sim import depthcam, lidar, thymio


class SimNode(Node):
    """Ground-truth world + sensor emulation behind the driver surface."""

    def __init__(self, cfg: SlamConfig, bus: Bus,
                 driver: SimulatedThymioDriver, world: np.ndarray,
                 world_res_m: float, tf: Optional[TfTree] = None,
                 rate_hz: float = 10.0, seed: int = 0,
                 realtime: bool = True, device=None,
                 depth_cam: bool = False, wall_height_m: float = 0.5):
        super().__init__("sim_node", bus, tf)
        self.cfg = cfg
        self.driver = driver
        self.device = resolve_device(device)
        self.world = torch.as_tensor(np.asarray(world, bool),
                                     device=self.device)
        self.world_res_m = world_res_m
        self.rate_hz = rate_hz
        self.n_samples = int(cfg.scan.range_max_m / (world_res_m * 0.5))
        R = driver.n_robots
        #: The fleet's random draws (spawn radii, wheel noise), on the host.
        self.generator = torch.Generator().manual_seed(seed)
        self.sim_state = thymio.init_fleet(cfg.robot, R, self.device,
                                           generator=self.generator)
        self.scan_pubs = [
            self.create_publisher(f"{robot_ns(i, R)}scan", qos_sensor_data)
            for i in range(R)]
        # The optional simulated depth camera: a depth image per robot a
        # tick for the 3D voxel pipeline, on walls `wall_height_m` tall.
        self.depth_cam = depth_cam
        self.wall_height_m = wall_height_m
        if depth_cam:
            self.depth_n_samples = depthcam.n_samples_for(cfg.depthcam,
                                                          world_res_m)
            self.depth_pubs = [
                self.create_publisher(f"{robot_ns(i, R)}depth",
                                      qos_sensor_data)
                for i in range(R)]
        # Adversarial sensor-fault state (wheel_slip / lidar_miscal /
        # ghost_returns / scan_jam). The identity values keep the healthy
        # hot path byte-identical (_faults_active gates every application).
        self._wheel_slip = np.ones(R, np.float32)
        self._lidar_miscal = np.zeros(R, np.float32)
        self._ghost_frac = np.zeros(R, np.float32)
        self._scan_jam = np.zeros(R, bool)
        #: Last healthy ranges per robot — what a jammed sensor keeps
        #: re-reporting (frozen data, fresh stamps).
        self._jam_cache = [None] * R
        self._fault_seed = seed
        #: Scripted world dynamics (scenarios/dynamics.py), or None — the
        #: static-world stack exactly. Attached once at launch, mutated
        #: through set_door / set_crowd, consumed at the top of step().
        self._world_dyn = None
        self.n_world_updates = 0
        self.n_steps = 0
        if realtime:
            self.create_timer(1.0 / rate_hz, self.step)

    # -- scripted world dynamics (scenarios/; FaultPlan world kinds) ---------

    def attach_world_dynamics(self, dyn) -> None:
        """Arm a WorldDynamics: its base world must be THIS sim's world
        (same shape; the scenario engine owns composition from here on).
        step() uploads the composed bitmap when it changes."""
        if dyn.base.shape != tuple(self.world.shape):
            raise ValueError(
                f"world dynamics base {dyn.base.shape} != sim world "
                f"{tuple(self.world.shape)}")
        self._world_dyn = dyn
        if self.device.type == "cuda":
            # Two pinned staging buffers, allocated here and not on the
            # step's path: an upload fills one while the other's copy may
            # still be queued.
            self._staging = [torch.empty(dyn.base.shape, dtype=torch.bool,
                                         pin_memory=True) for _ in range(2)]
            self._staged = [None, None]

    def set_door(self, name: str, closed: bool) -> None:
        """Close (or re-open) a registered door — the `door_close`
        scenario kind's boundary."""
        if self._world_dyn is None:
            raise RuntimeError(
                "no world dynamics attached (launch the stack with a "
                "scenarios.WorldDynamics to script doors)")
        self._world_dyn.set_door(name, closed)

    def set_crowd(self, cid: int, radius_m) -> None:
        """Activate/clear a moving crowd blob — the `crowd` scenario
        kind's boundary (None radius = gone)."""
        if self._world_dyn is None:
            raise RuntimeError(
                "no world dynamics attached (launch the stack with a "
                "scenarios.WorldDynamics to script crowds)")
        self._world_dyn.set_crowd(cid, radius_m)

    def _upload_world(self, world: np.ndarray) -> None:
        """The composed world to the device in one copy. On the card it
        goes through a pinned staging buffer with `non_blocking`: the copy
        is ordered on the stream before the step's raycast, and the host
        does not wait for it. The buffers alternate; one is refilled only
        once its last copy has run (its event; a step's own reads have
        long waited for it by then)."""
        if self.device.type != "cuda":
            self.world = torch.from_numpy(world).to(self.device)
            return
        i = self.n_world_updates % 2
        done = self._staged[i]
        if done is not None and not done.query():
            done.synchronize()
        buf = self._staging[i]
        buf.numpy()[...] = world
        self.world = buf.to(self.device, non_blocking=True)
        self._staged[i] = torch.cuda.Event()
        self._staged[i].record()

    # -- adversarial sensor-fault boundary -----------------------------------

    def set_wheel_slip(self, robot: int, factor: float) -> None:
        """Bias robot's MEASURED wheel speeds by `factor` (1.0 = healthy):
        odometry integrates motion the robot did not make."""
        self._wheel_slip[robot] = factor

    def set_lidar_miscal(self, robot: int, offset_rad: float) -> None:
        """Rotate robot's lidar mount by `offset_rad` (0 = healthy):
        every beam reports the range of a rotated world angle."""
        self._lidar_miscal[robot] = offset_rad

    def set_ghost_returns(self, robot: int, frac: float) -> None:
        """Replace a seeded `frac` of robot's live beams with spurious
        short ranges (0 = healthy)."""
        self._ghost_frac[robot] = frac

    def set_scan_jam(self, robot: int, jammed: bool) -> None:
        """Freeze robot's scan at the last healthy reading (fresh
        stamps, stale data) until cleared."""
        self._scan_jam[robot] = jammed
        if not jammed:
            self._jam_cache[robot] = None

    def _faults_active(self) -> bool:
        return bool((self._wheel_slip != 1.0).any()
                    or (self._lidar_miscal != 0.0).any()
                    or (self._ghost_frac != 0.0).any()
                    or self._scan_jam.any())

    def truth_poses(self) -> np.ndarray:
        return self.sim_state.poses.cpu().numpy()

    def step(self) -> None:
        """One physics+sensor tick (call directly for faster-than-realtime
        runs; the timer drives it in realtime mode)."""
        cfg = self.cfg
        R = self.driver.n_robots
        if self._world_dyn is not None:
            # Scripted world mutations land BEFORE this step's physics,
            # IR proximity, raycast and depth render (FaultPlan fires on
            # the same step clock): a door closed at step k is solid in
            # step k's scans.
            new_world = self._world_dyn.world_if_changed(self.n_steps)
            if new_world is not None:
                self._upload_world(new_world)
                self.n_world_updates += 1
        targets = torch.as_tensor(self.driver.targets().astype(np.float32),
                                  device=self.device)
        normals = torch.randn((R, 2), generator=self.generator)
        self.sim_state, measured = thymio.step_fleet(
            cfg.robot, self.sim_state, targets, 1.0 / self.rate_hz,
            cfg.robot.speed_noise_frac, wheel_normals=normals)
        prox = lidar.ir_proximity(self.world, self.world_res_m,
                                  self.sim_state.poses)
        faults = self._faults_active()
        scan_poses = self.sim_state.poses
        if faults:
            # lidar_miscal: raycast from heading-offset poses — beam k
            # reports a rotated world angle but keeps its label.
            scan_poses = torch.as_tensor(
                lidar.apply_lidar_miscal(scan_poses.cpu().numpy(),
                                         self._lidar_miscal),
                device=self.device)
        scans = lidar.simulate_scans(cfg.scan, self.world, self.world_res_m,
                                     self.n_samples, scan_poses)
        parts = [measured, prox, scans]
        if self.depth_cam:
            parts.append(depthcam.render_depths(
                cfg.depthcam, self.world, self.world_res_m,
                self.depth_n_samples, self.sim_state.poses,
                self.wall_height_m).reshape(R, -1))
        # Everything the host needs from this step, in one copy.
        host = torch.cat(parts, dim=1).cpu().numpy()
        n_scan = scans.shape[1]
        measured_np, scans_np = host[:, :2], host[:, 7:7 + n_scan]
        prox7 = np.zeros((R, 7), np.int32)
        prox7[:, :5] = np.clip(host[:, 2:7], 0, 4500).astype(np.int32)
        if faults:
            # wheel_slip: odometry bias at the measured-speed boundary
            # (ground truth untouched — sim/thymio.apply_wheel_slip).
            measured_np = thymio.apply_wheel_slip(measured_np,
                                                  self._wheel_slip)
        self.driver.ingest_state(measured_np, prox7)

        if faults:
            scans_np = scans_np.copy()
            for i in range(R):
                if self._scan_jam[i]:
                    # Frozen data, fresh stamps; the cache pins the
                    # reading at jam onset.
                    if self._jam_cache[i] is None:
                        self._jam_cache[i] = scans_np[i].copy()
                    else:
                        scans_np[i] = self._jam_cache[i]
                else:
                    self._jam_cache[i] = scans_np[i].copy()
                if self._ghost_frac[i] > 0.0:
                    # Seeded per (launch seed, step, robot): two
                    # same-seed runs ghost the identical beams.
                    rng = np.random.default_rng(
                        (self._fault_seed, self.n_steps, i))
                    scans_np[i] = lidar.apply_ghost_returns(
                        cfg.scan, scans_np[i], float(self._ghost_frac[i]),
                        rng)
        stamp = time.monotonic()
        for i, pub in enumerate(self.scan_pubs):
            pub.publish(LaserScan(
                header=Header(stamp=stamp,
                              frame_id=f"{robot_ns(i, R)}base_laser"),
                angle_min=cfg.scan.angle_min_rad,
                angle_increment=cfg.scan.angle_increment_rad,
                scan_time=1.0 / self.rate_hz,
                range_min=cfg.scan.range_min_m,
                range_max=cfg.scan.range_max_m,
                ranges=scans_np[i, :cfg.scan.n_beams].copy()))
        if self.depth_cam:
            cam = cfg.depthcam
            depths_np = host[:, 7 + n_scan:].reshape(R, cam.height_px,
                                                     cam.width_px)
            for i, pub in enumerate(self.depth_pubs):
                pub.publish(DepthImage(
                    header=Header(stamp=stamp,
                                  frame_id=f"{robot_ns(i, R)}base_camera"),
                    depth=depths_np[i].copy()))
        self.n_steps += 1
