"""`jax-mapping-ros` for the port: one-command ROS 2 bring-up, the reference's
`ros2 launch thymio_project pc_server.launch.py` equivalent
(`server/thymio_project/launch/pc_server.launch.py:12-34`
starts slam_toolbox + the brain node + RViz; here one process boots the
whole simulated stack, mirrors it onto real DDS through the rclpy adapter,
and prints the RViz command).

Usage (with a ROS 2 Jazzy environment sourced):

    jax-mapping-ros                     # sim stack + /map /scan /pose ...
    jax-mapping-ros --robots 4          # fleet
    jax-mapping-ros --live-hardware     # inbound /scan + /odom feed the
                                        # mapper (a real ldlidar driver
                                        # publishes; nothing is simulated)
    rviz2 -d "$(jax-mapping-ros --print-rviz-config)"

Without rclpy importable this exits 2 with the adapter's explanatory error
(the rest of the framework runs without ROS; see bridge/rclpy_adapter.py).

A copy of the JAX package's `ros_launch.py` with two changes: the stack
runs on `--device` (default `cuda`; `cpu` only when asked: without a card
the stack raises, it never falls back), and there is no backend probe,
since the port never initialises JAX. `python -m
jax_mapping_torch.ros_launch` runs it.
"""

from __future__ import annotations

import argparse
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="jax-mapping-ros",
        description="Bridge the jax_mapping stack onto a live ROS 2 graph.")
    p.add_argument("--robots", type=int, default=1)
    p.add_argument("--world", choices=("arena", "rooms"), default="rooms")
    p.add_argument("--world-cells", type=int, default=256)
    p.add_argument("--http-port", type=int, default=None,
                   help="also serve the map HTTP API on this port")
    p.add_argument("--config", type=str, default=None,
                   help="SlamConfig JSON file (default: tiny sim config)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--duration-s", type=float, default=0.0,
                   help="run this long then exit (0 = until Ctrl-C)")
    p.add_argument("--live-hardware", action="store_true",
                   help="inbound /scan + /odom from real drivers feed the "
                        "mapper; the simulator is not started")
    p.add_argument("--depth-cam", action="store_true",
                   help="run the 3D voxel pipeline too: simulated depth "
                        "cameras feed a shared voxel grid, exported on "
                        "/voxel_points (RViz PointCloud2) and HTTP "
                        "/voxel-image")
    p.add_argument("--joy-device", type=str, default=None, metavar="DEV",
                   help="read a joystick at this evdev node (e.g. "
                        "/dev/input/event3) and publish /cmd_vel teleop "
                        "(joystick.yaml semantics: deadman button 0, "
                        "axes 2/3, autorepeat 20 Hz)")
    p.add_argument("--map-prior", type=str, default=None, metavar="YAML",
                   help="seed the mapper with a ROS map_server map "
                        "(map.yaml + map.pgm) before mapping")
    p.add_argument("--localization", action="store_true",
                   help="freeze the map (SlamConfig.mode=localization): "
                        "scans match for pose tracking only; pair with "
                        "--map-prior")
    p.add_argument("--device", type=str, default="cuda",
                   help="torch device of the stack (default cuda; cpu "
                        "only when asked)")
    p.add_argument("--print-rviz-config", action="store_true",
                   help="print the bundled RViz config path and exit")
    return p


def rviz_config_path() -> str:
    import os
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "configs", "jax_mapping.rviz")


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.print_rviz_config:
        print(rviz_config_path())
        return 0

    from jax_mapping_torch.bridge.rclpy_adapter import (RclpyAdapter,
                                                        rclpy_available)
    if not rclpy_available():
        print("jax-mapping-ros: rclpy is not importable — source a ROS 2 "
              "(Jazzy) environment first; see README 'ROS 2 / RViz'.",
              file=sys.stderr)
        return 2

    from jax_mapping_torch.config import SlamConfig, tiny_config

    n_robots = max(1, args.robots)
    if args.config:
        with open(args.config) as f:
            cfg = SlamConfig.from_json(f.read())
    else:
        cfg = tiny_config(n_robots=n_robots)
    if args.localization:
        cfg = cfg.replace(mode="localization")

    if args.live_hardware:
        # Live mode = the reference's PC-server role alone
        # (pc_server.launch.py: slam + map server; the robot side runs on
        # real hardware): mapper + HTTP API only. No simulator — real
        # /scan and /odom arrive via the inbound adapter on the SAME bus
        # topics the sim would use, so booting the sim would interleave
        # simulated and real sensor data. Outbound excludes scan/odom for
        # the same reason mirrored: this node subscribing /scan while
        # republishing its bus copy back to /scan would echo-loop DDS.
        stack = _launch_live_stack(cfg, http_port=args.http_port,
                                   n_robots=n_robots, device=args.device)
        inbound = ("cmd_vel", "scan", "odom", "initialpose", "goal_pose")
        # No scan/odom echo (see above), but the live mapper still
        # publishes /frontiers and the standalone planner /plan — keep
        # the RViz marker + Path displays fed.
        outbound = ("map", "map_updates", "pose", "frontiers", "plan")
    else:
        from jax_mapping_torch.bridge.launch import launch_sim_stack
        from jax_mapping_torch.sim import world as W
        if args.world == "arena":
            world = W.empty_arena(args.world_cells, cfg.grid.resolution_m)
        else:
            world = W.rooms_world(args.world_cells, cfg.grid.resolution_m,
                                  seed=args.seed)
        stack = launch_sim_stack(cfg, world, n_robots=n_robots,
                                 http_port=args.http_port, realtime=True,
                                 seed=args.seed, depth_cam=args.depth_cam,
                                 device=args.device)
        inbound = ("cmd_vel", "initialpose", "goal_pose")
        outbound = RclpyAdapter.OUTBOUND_DEFAULT

    if args.map_prior:
        from jax_mapping_torch.io import rosmap
        try:
            n_occ = rosmap.seed_mapper(stack.mapper, args.map_prior,
                                       cfg.grid)
        except rosmap.SEED_ERRORS as e:
            print(f"jax-mapping-ros: cannot seed --map-prior "
                  f"{args.map_prior}: {e}", file=sys.stderr)
            stack.shutdown()
            return 2
        print(f"jax-mapping-ros: seeded map prior from {args.map_prior} "
              f"({n_occ} occupied cells)")

    adapter = RclpyAdapter(stack.bus, cfg, tf=stack.tf, inbound=inbound,
                           outbound=outbound, n_robots=n_robots)
    adapter.spin()
    joy = None
    if args.joy_device:
        from jax_mapping_torch.bridge.joydev import attach_joystick
        try:
            joy = attach_joystick(stack.bus, args.joy_device)
            print(f"jax-mapping-ros: joystick at {args.joy_device} -> "
                  "/cmd_vel (hold button 0 to drive)")
        except OSError as e:
            print(f"jax-mapping-ros: cannot open joystick "
                  f"{args.joy_device}: {e}", file=sys.stderr)
    if not args.live_hardware:
        # A pad means MANUAL drive: the brain applies /cmd_vel only while
        # not exploring (brain._manual_targets — the reference's override
        # semantics), so auto-starting exploration would silently discard
        # every pad command. The operator flips modes via HTTP /start.
        if joy is None:
            stack.brain.start_exploring()
        else:
            print("jax-mapping-ros: manual-drive mode (pad attached); "
                  "start autonomous exploration via HTTP /start")
        print("jax-mapping-ros: sim stack up — /map /map_updates /pose "
              "/poses /scan /odom /tf out, /cmd_vel in")
    else:
        print("jax-mapping-ros: live stack up — /map /map_updates /pose "
              "/poses /tf out; /scan /odom /cmd_vel in feed the mapper")
    print(f"  rviz2 -d {rviz_config_path()}")
    try:
        t0 = time.time()
        while args.duration_s <= 0 or time.time() - t0 < args.duration_s:
            time.sleep(0.2)
    except KeyboardInterrupt:
        pass
    finally:
        if joy is not None:
            joy.close()
        adapter.shutdown()
        stack.shutdown()
    return 0


def _launch_live_stack(cfg, http_port=None, n_robots: int = 1,
                       device=None, realtime: bool = True):
    """Mapper + planner + API + TF, fed by real inbound /scan + /odom.

    The planner runs STANDALONE (brain=None): RViz SetGoal publishes
    /goal_pose over DDS, the planner answers with /plan — the operator
    sees the route on the live map and an external follower (Nav2-style)
    can consume it; there is no brain to steer in live mode (the robot
    side runs its own controller on real hardware). The mapper runs on
    `device` (None: the card, raising without one). `realtime=False`
    leaves the executor idle, so a caller ticks `mapper` itself."""
    import dataclasses as _dc

    from jax_mapping_torch.bridge.bus import Bus
    from jax_mapping_torch.bridge.http_api import MapApiServer
    from jax_mapping_torch.bridge.launch import LASER_MOUNT_Z_M
    from jax_mapping_torch.bridge.mapper import MapperNode
    from jax_mapping_torch.bridge.messages import Header, TransformStamped
    from jax_mapping_torch.bridge.node import Executor
    from jax_mapping_torch.bridge.planner import PlannerNode
    from jax_mapping_torch.bridge.tf import TfTree

    bus = Bus(domain_id=cfg.domain_id)
    tf = TfTree()
    tf.set_static_transform(TransformStamped(
        header=Header(frame_id="base_link"), child_frame_id="base_laser",
        z=LASER_MOUNT_Z_M))
    mapper = MapperNode(cfg, bus, tf=tf, n_robots=n_robots, device=device)
    planner = None
    if cfg.planner.enabled:
        planner = PlannerNode(cfg, bus, mapper=mapper, brain=None)
    api = None
    if http_port is not None:
        api = MapApiServer(bus, brain=None, port=http_port,
                           mapper=mapper, planner=planner)
        api.serve_thread()
    executor = Executor([mapper] + ([planner] if planner else []))
    if realtime:
        executor.spin_thread()

    @_dc.dataclass
    class LiveStack:
        bus: object
        tf: object
        mapper: object
        api: object
        executor: object
        planner: object = None

        def shutdown(self):
            if self.api is not None:
                self.api.shutdown()
            self.executor.shutdown()

    return LiveStack(bus=bus, tf=tf, mapper=mapper, api=api,
                     executor=executor, planner=planner)


if __name__ == "__main__":
    sys.exit(main())
