"""End-to-end demo CLI: a simulated fleet explores and maps a world.

Port of the JAX package's `demo.py` (its default path). One command
boots the mission stack (sim world, driver, brain, mapper, planner)
against a generated world, starts exploration, steps the stack
faster-than-realtime, prints a summary JSON and writes the occupancy map
as a grayscale PNG (127 unknown / 255 free / 0 occupied):

    python -m jax_mapping_torch.demo --steps 200 --robots 2 --out map.png

The stack runs on the CUDA card; `--device cpu` runs it on the CPU with
the kernels' plain PyTorch versions. Without a card and without
`--device cpu` the launch raises: the demo never falls back to the CPU
on its own.

`--depth-cam` adds the depth-camera stack (a depth image per robot a
step fused into the shared voxel grid, kernel K6 on the card) and the
voxel counts to the summary; `--voxel-out PNG` writes its height map.

`--save-final CKPT` writes the final SLAM state as a checkpoint (with the
windowed world's `.world` manifest when `world.windowed`, and the voxel
grid and keyframe ring with `--depth-cam`), and `--resume CKPT` starts
from one, re-anchored at the relaunched fleet's spawn poses (the voxel
grid too, when both runs have `--depth-cam`):

    python -m jax_mapping_torch.demo --config windowed.json --save-final f.npz
    python -m jax_mapping_torch.demo --config windowed.json --resume f.npz

`--record BAG` records every robot's /scan and /odom (and /depth with
`--depth-cam`) to a trace in the JAX package's format; `--replay BAG`
maps from such a trace instead of simulating (no sim, no brain: the
reference's rosbag workflow, a mapper tick every 40 messages), and
`--map-prior map.yaml` seeds the mapper with a ROS map_server map before
stepping (localization on a known map, with `--localization`):

    python -m jax_mapping_torch.demo --robots 2 --record run.npz
    python -m jax_mapping_torch.demo --robots 2 --replay run.npz --out m.png

`--http-port PORT` serves the HTTP API (`bridge/http_api.py`) while the
stack steps (0 picks a free port; the summary's `"http"` gives the URL),
and `--serve` keeps it up after the steps until Ctrl-C, for `curl
/status`, `/map-image`, `/tiles`, `/metrics`, `/start`, `/stop`:

    python -m jax_mapping_torch.demo --serve --http-port 5000
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="python -m jax_mapping_torch.demo",
        description="Run the simulated exploration + mapping stack.")
    p.add_argument("--steps", type=int, default=150,
                   help="sensor ticks to run (default 150)")
    p.add_argument("--robots", type=int, default=1,
                   help="fleet size (default 1)")
    p.add_argument("--world", choices=["arena", "rooms"], default="rooms",
                   help="generated world layout")
    p.add_argument("--world-cells", type=int, default=192,
                   help="world edge length in cells")
    p.add_argument("--config", type=str, default=None,
                   help="SlamConfig JSON file, as either package writes it "
                        "(default: tiny_config)")
    p.add_argument("--out", type=str, default=None,
                   help="write final map PNG here")
    p.add_argument("--localization", action="store_true",
                   help="freeze the map (SlamConfig.mode=localization): "
                        "scans match for pose tracking but never fuse")
    p.add_argument("--drop-prob", type=float, default=0.0,
                   help="Best-Effort link loss injection")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", type=str, default="cuda",
                   help="device of the stack (default cuda; cpu runs the "
                        "kernels' plain versions)")
    p.add_argument("--resume", type=str, default=None, metavar="CKPT",
                   help="resume the SLAM state from a checkpoint written "
                        "by --save-final (either package's)")
    p.add_argument("--save-final", type=str, default=None, metavar="CKPT",
                   help="write the final SLAM state as a resumable "
                        "checkpoint")
    p.add_argument("--depth-cam", action="store_true",
                   help="also run the 3D pipeline: a simulated depth camera "
                        "per robot fused into a shared voxel grid; adds "
                        "voxel counts to the summary")
    p.add_argument("--voxel-out", type=str, default=None, metavar="PNG",
                   help="write the final 3D height map as a grayscale PNG "
                        "(requires --depth-cam, or --replay of a bag "
                        "recorded with it)")
    p.add_argument("--record", type=str, default=None, metavar="BAG",
                   help="record /scan + /odom (+ /depth with --depth-cam) "
                        "to a rosbag-style trace during the run")
    p.add_argument("--replay", type=str, default=None, metavar="BAG",
                   help="map from a recorded trace instead of simulating "
                        "(no sim, no brain: scans and odometry come from "
                        "the bag)")
    p.add_argument("--map-prior", type=str, default=None, metavar="YAML",
                   help="seed the mapper with a ROS map_server map "
                        "(map.yaml + map.pgm) before stepping")
    p.add_argument("--http-port", type=int, default=None,
                   help="serve the HTTP API on this port (0 = pick free)")
    p.add_argument("--serve", action="store_true",
                   help="keep serving HTTP after stepping (Ctrl-C to exit)")
    return p


def _occupancy(stack):
    from jax_mapping_torch.ops import grid as G
    return G.to_occupancy(stack.cfg.grid,
                          stack.mapper.merged_grid()).cpu().numpy()


def _write_png(path: str, occ) -> None:
    from jax_mapping_torch.bridge.png import encode_gray
    from jax_mapping_torch.ops.grid import occupancy_to_png_array
    with open(path, "wb") as f:
        f.write(encode_gray(occupancy_to_png_array(occ)))
    print(f"map written to {path}", file=sys.stderr)


def replay_bag(rep, cfg, n_robots: int, device=None, depth: bool = False):
    """Feed a bag's messages (a `TraceReplayer`) to a fresh mapper (and a
    voxel mapper with `depth`) as `--replay` does: a mapper tick every 40
    messages, then 4. Returns (mapper, voxel mapper or None, messages)."""
    from jax_mapping_torch.bridge.bus import Bus
    from jax_mapping_torch.bridge.mapper import MapperNode
    bus = Bus()
    mapper = MapperNode(cfg, bus, n_robots=n_robots, device=device)
    voxel = None
    if depth:
        from jax_mapping_torch.bridge.voxel_mapper import VoxelMapperNode
        voxel = VoxelMapperNode(cfg, bus, n_robots=n_robots, mapper=mapper)
    pubs = {}
    n = 0
    # Publishing interleaves with mapper ticks: the odometry pairing
    # history is bounded, so a bag must not be dumped wholesale ahead of
    # processing.
    for _stamp, topic, msg in rep.messages():
        if topic not in pubs:
            pubs[topic] = bus.publisher(topic)
        pubs[topic].publish(msg)
        n += 1
        if n % 40 == 0:
            mapper.tick()
            if voxel is not None:
                voxel.tick()
    for _ in range(4):
        mapper.tick()
    if voxel is not None:
        voxel.tick()
    return mapper, voxel, n


def _replay_main(args, cfg) -> int:
    """Map from a recorded /scan + /odom trace: no sim, no brain, the
    mapper alone (the reference's rosbag workflow). Bags carrying depth
    topics (recorded with --depth-cam) also rebuild the 3D voxel map."""
    from jax_mapping_torch.bridge.brain import robot_ns
    from jax_mapping_torch.config import configs_equivalent
    from jax_mapping_torch.io.trace import TraceReplayer
    from jax_mapping_torch.ops import grid as G

    rep = TraceReplayer(args.replay)
    # Every expected namespace must appear: a bag recorded with --robots
    # 2 replayed at 4 would leave robots 2-3 silently unfed, and one
    # replayed at 1 would publish to topics nothing subscribes to.
    expected = set()
    for i in range(args.robots):
        ns = robot_ns(i, args.robots)
        expected |= {f"{ns}scan", f"{ns}odom"}
    bag_topics = {rec["topic"] for rec in rep.index}
    if not expected <= bag_topics:
        missing = sorted(expected - bag_topics)
        print(f"error: bag topics {sorted(bag_topics)} do not cover the "
              f"expected {sorted(expected)} (missing {missing}) — was the "
              "bag recorded with a different --robots?", file=sys.stderr)
        return 2
    if rep.config_json is not None and \
            not configs_equivalent(rep.config_json, cfg.to_json()):
        print("error: bag was recorded under a different config; pass the "
              "matching --config (the bag stores the recording config)",
              file=sys.stderr)
        return 2
    has_depth = any(t.endswith("depth") for t in bag_topics)
    if args.voxel_out and not has_depth:
        print("error: --voxel-out given but the bag has no depth topics "
              "(was it recorded without --depth-cam?)", file=sys.stderr)
        return 2

    mapper, voxel, n = replay_bag(rep, cfg, args.robots, args.device,
                                  depth=has_depth)
    occ = G.to_occupancy(cfg.grid, mapper.merged_grid()).cpu().numpy()
    summary = {
        "replayed": n,
        "bag": args.replay,
        "robots": args.robots,
        "device": str(mapper.device),
        "cells_free": int((occ == 0).sum()),
        "cells_occupied": int((occ == 100).sum()),
        "scans_fused": int(mapper.n_scans_fused),
        "scans_dropped_unpaired": int(mapper.n_scans_dropped_unpaired),
    }
    if voxel is not None:
        from jax_mapping_torch.ops import voxel as VX
        occ3 = VX.to_occupancy(cfg.voxel, voxel.voxel_grid())
        summary["voxels_occupied"] = int((occ3 == 100).sum())
        summary["voxels_free"] = int((occ3 == 0).sum())
        summary["depth_images_fused"] = int(voxel.n_images_fused)
    print(json.dumps(summary, indent=2))
    if args.out:
        _write_png(args.out, occ)
    if args.voxel_out and voxel is not None:
        from jax_mapping_torch.bridge.png import encode_gray
        with open(args.voxel_out, "wb") as f:
            f.write(encode_gray(voxel.height_map_image()))
        print(f"voxel height map written to {args.voxel_out}",
              file=sys.stderr)
    return 0


def _recorder(stack, args):
    """A TraceRecorder on every robot's /scan and /odom (and /depth with
    --depth-cam)."""
    from jax_mapping_torch.bridge.brain import robot_ns
    from jax_mapping_torch.io.trace import TraceRecorder
    topics = []
    for i in range(args.robots):
        ns = robot_ns(i, args.robots)
        topics += [f"{ns}scan", f"{ns}odom"]
        if args.depth_cam:
            topics.append(f"{ns}depth")
    return TraceRecorder(stack.bus, topics)


def _seed_prior(stack, cfg, args) -> int:
    """Seed the mapper with the --map-prior map: 0, or 2 with a message
    when --resume is set too or the map cannot be read."""
    if args.resume:
        # The checkpoint's grid would be installed over the prior:
        # refusing beats telling the user the prior is active when it is
        # not.
        print("demo: --map-prior and --resume both set a map; pick one "
              "(a checkpoint already contains its grid)", file=sys.stderr)
        return 2
    from jax_mapping_torch.io import rosmap
    try:
        n_occ = rosmap.seed_mapper(stack.mapper, args.map_prior, cfg.grid)
    except rosmap.SEED_ERRORS as e:
        print(f"demo: cannot seed --map-prior {args.map_prior}: {e}",
              file=sys.stderr)
        return 2
    print(f"demo: seeded map prior from {args.map_prior} "
          f"({n_occ} occupied cells)")
    return 0


def _resume(stack, cfg, path: str) -> int:
    """Install a checkpoint's states (and its prior and world sidecars),
    anchored at the relaunched fleet's spawn poses; 0, or 2 with a
    message on a missing, unreadable or mismatched checkpoint."""
    from jax_mapping_torch.config import configs_equivalent
    from jax_mapping_torch.io.checkpoint import (
        load_checkpoint, load_prior_sidecar, load_voxel_sidecar,
        load_world_sidecar)
    from jax_mapping_torch.ops import grid as G
    mapper = stack.mapper
    try:
        states, ckpt_cfg = load_checkpoint(path,
                                           mapper.checkpoint_template())
    except FileNotFoundError:
        print(f"error: no checkpoint at {path}", file=sys.stderr)
        return 2
    except ValueError as e:
        # Wrong robot count or shape drift raise before the config
        # comparison below can explain it.
        print(f"error: cannot resume from {path}: {e}", file=sys.stderr)
        return 2
    if ckpt_cfg is not None and \
            not configs_equivalent(ckpt_cfg, cfg.to_json()):
        print("error: checkpoint config differs from the running "
              "config; pass the matching --config", file=sys.stderr)
        return 2
    try:
        prior = load_prior_sidecar(
            path, G.empty_grid(mapper.cfg.grid, stack.device),
            running_config_json=cfg.to_json())
        payload = (load_world_sidecar(path,
                                      running_config_json=cfg.to_json())
                   if mapper.world is not None else None)
    except ValueError as e:
        print(f"error: cannot resume a sidecar: {e}", file=sys.stderr)
        return 2
    # The map is inherited, but the robots respawned: anchor the chains
    # at the spawn poses.
    mapper.resume(states, payload, stack.brain.poses, map_prior=prior)
    print(f"resumed {len(states)} robot state(s) from {path}",
          file=sys.stderr)
    voxel = stack.voxel_mapper
    if voxel is not None:
        # The grid only: the keyframe ring anchors to the checkpointed
        # graphs, and the resumed chains start fresh at the spawn poses.
        try:
            vgrid = load_voxel_sidecar(path, voxel.snapshot_grid(),
                                       running_config_json=cfg.to_json())
        except ValueError as e:
            print(f"error: cannot resume 3D map: {e}", file=sys.stderr)
            return 2
        if vgrid is not None:
            voxel.restore_grid(vgrid)
            print("resumed 3D voxel map from the checkpoint sidecar",
                  file=sys.stderr)
    return 0


def _save_final(stack, cfg, path: str) -> None:
    """Write the mapper's states as a checkpoint, with the prior, world,
    voxel and keyframe sidecars it needs (stale prior and world ones from
    an earlier save under this name removed)."""
    from jax_mapping_torch.io.checkpoint import (
        clear_prior_sidecar, clear_world_sidecar, save_checkpoint,
        save_keyframe_sidecar, save_prior_sidecar, save_voxel_sidecar,
        save_world_sidecar)
    mapper = stack.mapper
    save_checkpoint(path, mapper.snapshot_states(),
                    config_json=cfg.to_json())
    print(f"checkpoint written to {path}", file=sys.stderr)
    prior = mapper.map_prior()
    if prior is not None:
        save_prior_sidecar(path, prior, config_json=cfg.to_json())
    else:
        clear_prior_sidecar(path)
    if mapper.world is not None:
        save_world_sidecar(path, mapper.world.checkpoint_payload(),
                           config_json=cfg.to_json())
    else:
        clear_world_sidecar(path)
    voxel = stack.voxel_mapper
    if voxel is not None:
        try:
            vp = save_voxel_sidecar(path, voxel.snapshot_grid(),
                                    config_json=cfg.to_json())
            # The keyframe ring too: a resume re-anchors and ignores it,
            # but a graph-preserving restore repairs closures from it.
            save_keyframe_sidecar(path, voxel.snapshot_keyframes(),
                                  config_json=cfg.to_json())
            print(f"3D voxel checkpoint written to {vp}", file=sys.stderr)
        except ValueError as e:
            print(f"error: 3D checkpoint not written: {e}", file=sys.stderr)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    args.robots = max(1, args.robots)

    from jax_mapping_torch.bridge.launch import launch_sim_stack
    from jax_mapping_torch.config import SlamConfig, tiny_config
    from jax_mapping_torch.sim import world as W

    if args.config:
        with open(args.config) as f:
            cfg = SlamConfig.from_json(f.read())
    else:
        cfg = tiny_config(n_robots=args.robots)
    if args.localization:
        cfg = cfg.replace(mode="localization")

    if args.voxel_out and not args.depth_cam and not args.replay:
        print("error: --voxel-out requires --depth-cam (or --replay of a "
              "bag recorded with it)", file=sys.stderr)
        return 2

    if args.replay:
        clash = [f for f in ("record", "save_final", "resume", "serve",
                             "depth_cam")
                 if getattr(args, f)]
        if clash:
            flags = ", ".join("--" + f.replace("_", "-") for f in clash)
            print(f"error: --replay cannot be combined with {flags}",
                  file=sys.stderr)
            return 2
        return _replay_main(args, cfg)

    if args.world == "arena":
        world = W.empty_arena(args.world_cells, cfg.grid.resolution_m)
    else:
        world = W.rooms_world(args.world_cells, cfg.grid.resolution_m,
                              seed=args.seed)

    port = args.http_port if args.http_port is not None else (
        0 if args.serve else None)
    stack = launch_sim_stack(cfg, world, n_robots=args.robots,
                             http_port=port, drop_prob=args.drop_prob,
                             seed=args.seed, depth_cam=args.depth_cam,
                             device=args.device)
    try:
        recorder = _recorder(stack, args) if args.record else None
        if args.map_prior:
            rc = _seed_prior(stack, cfg, args)
            if rc:
                return rc
        if args.resume:
            rc = _resume(stack, cfg, args.resume)
            if rc:
                return rc
        stack.brain.start_exploring()
        t0 = time.time()
        report_every = max(1, args.steps // 5)
        for step in range(args.steps):
            stack.run_steps(1)
            if (step + 1) % report_every == 0:
                occ = _occupancy(stack)
                print(f"step {step + 1}/{args.steps}: "
                      f"{int((occ == 0).sum())} free / "
                      f"{int((occ == 100).sum())} occupied cells mapped",
                      file=sys.stderr)
        wall = time.time() - t0

        occ = _occupancy(stack)
        summary = {
            "steps": args.steps,
            "robots": args.robots,
            "device": str(stack.device),
            "wall_s": round(wall, 2),
            "steps_per_sec": round(args.steps / max(wall, 1e-9), 1),
            "cells_free": int((occ == 0).sum()),
            "cells_occupied": int((occ == 100).sum()),
            "brain": stack.brain.status(),
        }
        voxel = stack.voxel_mapper
        if voxel is not None:
            from jax_mapping_torch.ops import voxel as VX
            occ3 = VX.to_occupancy(cfg.voxel, voxel.voxel_grid())
            summary["voxels_occupied"] = int((occ3 == 100).sum())
            summary["voxels_free"] = int((occ3 == 0).sum())
            summary["depth_images_fused"] = int(voxel.n_images_fused)
        if stack.api is not None:
            summary["http"] = f"http://127.0.0.1:{stack.api.port}"
        print(json.dumps(summary, indent=2), flush=True)
        if recorder is not None:
            recorder.stop()
            n_rec = recorder.save(args.record, config_json=cfg.to_json())
            print(f"recorded {n_rec} messages to {args.record}",
                  file=sys.stderr)
        if args.out:
            _write_png(args.out, occ)
        if args.voxel_out and voxel is not None:
            from jax_mapping_torch.bridge.png import encode_gray
            with open(args.voxel_out, "wb") as f:
                f.write(encode_gray(voxel.height_map_image()))
            print(f"voxel height map written to {args.voxel_out}",
                  file=sys.stderr)
        if args.save_final:
            _save_final(stack, cfg, args.save_final)
        if args.serve:
            print(f"serving on http://127.0.0.1:{stack.api.port} — Ctrl-C "
                  f"to exit", file=sys.stderr, flush=True)
            try:
                while True:
                    time.sleep(1.0)
            except KeyboardInterrupt:
                pass
        return 0
    finally:
        stack.shutdown()


if __name__ == "__main__":
    sys.exit(main())
