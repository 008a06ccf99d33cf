#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`jax_mapping_torch`) on one GPU.

    python3 chip_smoke.py [--ticks N] [--seed S]
    python3 chip_smoke.py --ab PARENT_TREE

The second form only times kernels K1-K7 of an unpacked parent checkout
against this tree's, in turns (parent, change, change, parent), each turn
a process of its own, and prints one "ab" line: K1, K4 and K5 at the main
paths' batches, K2 at the fleet's 256^2 x 49 sweeps, K3 at each of the
fleet's three levels, K6 at one voxel tick's 8 images, K7 at the bench's
32-image window and at the tick's images over the whole voxel grid, and
the voxel tick's `fuse_depths` and the bench window around them, on fixed
seeded inputs.

Phases, each printed as one JSON line:

  device   the card (nvidia-smi name and power limit), the TF32 flags
  build    nvcc builds of every kernel in jax_mapping_torch/csrc/, with
           ptxas's registers and the SASS instruction count of K1, K4, K5
  fleet    slice 1's main path: `fleet_step` of the default SlamConfig
           (4096^2 grid at 0.05 m, 8 robots, 360-beam scans padded to
           512, 640^2 patches, 1024-pose rings) on plank_course(4096,
           0.05, n_planks=40, seed=0). Launch counts are zeroed just
           before the ticks and read just after; every kernel of the
           fleet path (K1-K3) must have launched, K2 once a tick and K3
           three times (a launch a level), both on the cluster route.
  stages   the same stages called one at a time on the final state, and
           within compute_frontiers the cost fields and K3's launches
  profile  the next ticks, timed alone and then under torch.profiler:
           device busy share, device work per stream, launches per tick,
           the kernels that take the device's time; loop verifications
           are counted per tick
  refuse   the loop-closure re-fuse shape: 8192 ring scans into an empty
           4096^2 grid, with its peak device memory
  mapper   slice 2's main path, the mapper's per-robot SLAM step: the
           default SlamConfig, 8 robots with their own SlamState sharing
           one 4096^2 grid, each driving a 0.4 m circle 3.5 m from two
           walls of rooms_world(4096, 0.05, seed=1); a tick is one
           16-scan window per robot through `slam_step_window` and two
           single scans through `slam_step`. Counts are zeroed before the
           ticks and read after; K1 (both modes) and K5 must have
           launched. Host syncs of one step of each kind, the stages of a
           window step, one profiled tick; then three windows with
           fused_fusion=False, where the window sum goes through K4.
  publish  slice 7: the mapper's frontier publish, an
           IncrementalFrontierPipeline (tile 256) fed after each mapper
           tick (the tiles whose log-odds changed get the tick's
           revision) and republished at once (a skip); then the robots
           moved to their BFS cells' centres (reuse), 1 m east (warm),
           and the re-fuse phase's map (dense dirt, the full refresh).
           Per mode: ms, host syncs, K2/K3 launches, crop spans, and the
           full compute_frontiers ms; every publish must equal the full
           recompute on the card (sizes, assignment; targets to one ulp)
  planner  the planner node's calls on the mapper drive's map:
           plan_to_goal from robot 0's circle to a goal behind the
           vertical wall (the 1024^2 field, 1025 sweeps of K3 on the
           global route, then 256 descent steps), goal_field and
           descend_field alone, host syncs; one replan as the node runs
           it (a field per distinct assigned target, a descent per robot)
  fleet_modes  fleet_step with planned_goals, decay_aware (the map
           decayed x 0.5) and exact_bfs on in turn, 10 ticks each, 8
           robots where the mapper drive starts them, its map as their
           map: tick p50/p90, host syncs, K2/K3 launches by route; K3 a
           tick: planned_goals 6, decay_aware 3, exact_bfs 1 (all 8
           robots' fields under a mask each, counted apart)
  recovery the recovery path for one robot, on the mapper drive's
           scans fused at their true poses: `slam_step` a scan on a
           1.2 m circle round robot 0's circle centre, the divergence
           watchdog fed as MapperNode feeds it, ghost returns on half
           the live beams at steps 15-29; from the declaration on, each
           step is quarantined and calls `Relocalizer.attempt_for`
           through the pyramid cache (per-256^2-tile revisions); a
           verified pose restarts the chain. Checks: declared inside the
           fault window, re-admitted after it, the final pose within
           0.1 m / 0.05 rad. Attempt ms by cache hit and miss, host syncs
           and K1 launches an attempt, the match alone (pruned hit /
           miss, unpruned), a wide basin (1.0 m, 0.3 rad off)
  rendezvous  fleet A: 4 robots of the mapper drive on one grid until
           each has 3 graph poses; fleet B: A's robots 0 and 1 in a frame
           moved by a known transform. `RendezvousMerger.poll` on
           stand-in mappers until it merges (the transform within 0.1 m
           / 0.02 rad), `merge_fleets` alone (ms, K1 launches), one
           `merged_frontier_assignment`
  fuse_paths  `fuse_scans_bucketed` at 37, 100, 200 scans and
           `fuse_scans_touched` at 64, each grid bit-equal to
           `fuse_scans_masked` / `fuse_scans`, the touched tiles to a
           host recomputation
  tenancy  slice 9's main path: `megabatch_tick` over missions of the
           default SlamConfig with lane health armed, mission t on
           rooms_world(4096, 0.05, seed=1 + t) with its robots near
           walls; 6 ticks at 3 tenants (bucket 3) and at 5 in bucket 6
           (a pad lane). Counts are zeroed before each run's ticks and
           read after: K1-K3 must launch, K2 once and K3 three times a
           tick for all tenants. Per run: tick p50/p90, ms per mission
           step, the solo tick on the same worlds and the ratio, host
           syncs of ticks 1-3, pending hops, peak memory, every lane
           against its solo run on the card (bit-equal on the exact
           ladder), the pad lane frozen, occupied cells and accepted
           matches per tenant (all robots, and key robots), and the
           megabatch's matcher with and without its per-lane split
           against solo calls (mismatches, ms; the split must match).
           Then each frontier option alone at 3 tenants (K3 a tick:
           exact_bfs 1 for all 24 fields, decay_aware 3, planned_goals
           6) and the default options at 12 tenants (bucket 12), every
           lane again against its solo run
           Then one lane's grid poisoned with a NaN:
           only its word sets HEALTH_NONFINITE, the co-tenants stay on
           their solo runs, and the words fold through LaneHealthLadder
  stack    slice 10's main path, the way users start the system:
           `launch_sim_stack` of the default SlamConfig, 8 robots on
           rooms_world(1024, 0.05, seed=1) with its doors widened to 2 m
           (the default frontier cells seal 0.5 m doors),
           `brain.start_exploring()`, 150
           `run_steps` (sim, brain, the mapper's steps and frontier
           publish, the planner every 10 steps). Counts are zeroed before
           the steps and read after: K1 (both modes), K2 and K3 must
           launch. Steps/s, wall time, the mapper tick's p50/p90 from
           `utils.global_metrics.stages`, host syncs of mapper ticks
           10-12, launches by route, K1 batches, the K2/K3 calls, matches
           accepted and rejected, cells free and occupied, peak memory.
           Then a burst: 16 sim and brain steps with no mapper tick, then
           one mapper tick, which must fuse a window through K5
  stack_depth  the same stack with `depth_cam=True`: a depth image per
           robot a step, the voxel mapper (K6) at the mapper's corrected
           poses, the planner and the frontier auction on the voxel
           overlay; 150 steps with a mapper restart after 100 (the voxel
           map must survive it, an auto-checkpoint's voxel and keyframe
           sidecars must read back bit-equal), then a re-fuse of the held
           keyframes. K1, K2, K3 and K6 must launch, every image must be
           fused or counted as dropped, the auction must assign. Steps/s,
           tick p50/p90 and host syncs by node, overlay rebuilds and
           reuses, keyframes, voxels, peak memory
  serving  slice 14's main path, map serving and the HTTP API:
           `launch_sim_stack(SlamConfig(), ..., n_robots=8, depth_cam=True,
           http_port=0)` on the stack's world, 40 steps while 8 delta
           clients poll /tiles (336 tiles of 256 cells in 3 levels), 2
           poll /voxel-tiles (21), 2 poll /map-image and one listens on
           /map-events, every 0.1 s. Counts are zeroed before the steps
           and read after: K1, K2, K3 and K6 must launch. Every client's
           mosaic at every level must equal the live map at the served
           revision, bit for bit; the dirty hint must miss nothing; repeat
           GETs answer 304; /save, 10 steps, /load restores the grid and
           poses; /save-map equals the thresholded grid; /goal and
           /goal/cancel reach the brain; /status and /metrics carry the
           serving families. Steps/s beside stack_depth's, the
           `serving.snapshot` stage p50/p90, tiles encoded and skipped a
           refresh, host syncs and peak memory of a refresh (clients
           stopped), request ms by route, bytes a client a second (delta
           against whole PNG), peak memory; then `demo --serve` in a
           process of its own, ended by SIGINT
  scenario  the main path of faults and scripted world dynamics at full
           width: `run_lifelong_mission` of SlamConfig() with
           DecayConfig(enabled=True) and the obs tier (the JAX shared
           mission's staleness SLO), 8 robots on the stack's world with its
           four widened doors registered, a checkpoint dir, 150 steps of
           `day_plan(150, doors, n_crowds=2, door_cycle=60, crowd_cycle=90,
           kill_steps=(100,))`: door cycles, two crowds, the mapper killed
           once and resumed from its checkpoint. Counts are zeroed before
           the mission and read after: K1, K2 and K3 must launch; K5's
           launches are reported. Steps/s, mapper tick p50/p90, world
           updates, the compose's host ms, each upload's bytes, host and
           device ms and host syncs (none allowed), decay passes with
           device ms a pass and the K2/K3 launches of the ticks after one,
           restarts, spans, SLO alerts, host syncs of a whole step with a
           crowd out and of a quiet one, peak memory, and per door the
           occupied cells in its rectangle at the end of each closure and
           of the mission. Checks: on the card; the card's world equals the
           host composition at sampled steps bit for bit; a quiet step
           uploads nothing; the fleet's scans cross the closed first door
           (door_h0); one restart from the checkpoint, and the mapper
           ticks after it; the plan log is the scripted schedule
  world    slice 11's main path, the bounded-memory world: `MapperNode`
           on the default SlamConfig with `world.windowed` (an 8-tile
           2048^2 window of 256-cell tiles over an 8192^2 logical lattice,
           409.6 m) and a 16-tile host budget with a disk spill tier; 8
           robots in formation, scripted noise-free odometry and scans
           raycast on the card in a pillared gallery, a 16-scan window a
           robot a tick, 130 m east (three shifts), a turn, then west
           past the start (host and disk rehydrations; two spilled tiles
           corrupted first). Counts are zeroed before the drive and read
           after: K1 (both modes), K2, K3 and K5 must launch. Tick p50/p90
           of shift ticks and of the others, the `mapper.window_shift`
           stage, host syncs a shift, the store's counters, matches
           accepted, peak memory through the first shift and after it
           (it must not grow), the bytes an unwindowed grid would take.
           Between the second and third shift a checkpoint with its
           `.world` sidecar (and a copy of the spill file) is restored
           into a fresh node that replays the rest of the drive: its grid,
           poses and origin must equal the uninterrupted run's. Last, one
           `MapApiServer` on the drive's mapper serves a full /tiles
           snapshot of the 8192^2 lattice (world_serving line), which
           must equal `world.compose_serving` with its evicted markers
  world_parity  (a) the JAX package's store drive (`tests/test_world.py`:
           shift, poll, `fuse_scan_global`, a decay pass, a pressure
           hold), scaled to the full window, host-only and with a disk
           tier: the window bit-equal to a big-grid oracle (K1 deltas at
           the global origin, clip-added) after every step; (b) a
           windowed `MapperNode` drive at tiny_config on the card and on
           the CPU: schedules and origins equal, estimates within 2e-5 m,
           at most 1e-4 of the cells apart
  lifelong_world  the JAX suite's bounded-memory corridor soak
           (tests/test_world.py, its config, corridor, goal patrol and
           chaos timing) with the planner off, one robot, 800 steps: the
           device window's bytes flat while the distance grows, the
           memory_pressure window fired and cleared through the FaultPlan,
           spill_corrupt rotting real spilled tiles whose rehydrate
           degrades to unknown with a `world_spill_corrupt` event; steps/s
  window   the bench's window workload: 256 scans on a 0.4 m loop into
           the 4096^2 grid through `fuse_scans_window` (K5), and 1024
           scans (K4 subtotals of 512, then one apply)
  kernels  each kernel against its plain PyTorch version on the same
           inputs at the main paths' shapes (K6/K7 on the voxel phases'
           inputs); exact equality is required (K8: see below). K1 at
           every batch the fleet and mapper launch it with (deltas 64, 8
           and 1; rasters
           168, 392, 21, 49), K4/K5 at 15, 16, 17 and 256 scans, each with the
           share of (tile, scan) pairs in each tile class (from the plain
           mirror) and bound / time; edge rows (a pose off its patch, on
           a tile corner, yaws beyond +-pi, +-2pi and +-4pi, all-zero
           scans, hits at max range) for K1, K4 and K5, not timed. K2
           and K3 with their route, cluster size and time per sweep;
           their edge rows: a serpentine mask and a corridor maze whose
           paths cross every slab boundary, seeds off the mask, fields
           with values at blocked cells, zero sweeps, and the global
           route at 1024^2 (timed). K6 and K7 with `device_ms`, the
           share of their byte bound, and their cull's counts from its
           plain mirror (live (tile, image) pairs, kept columns,
           evaluated voxels against the model's live voxels); their edge
           rows (untimed): the poses at the edges of the cull through K6,
           K7's window and K7 over the whole grid. K2 and K3 at the
           exploration path's shapes: the planner's field, one exact_bfs
           field (256^2 x 257 sweeps), every distinct K2/K3 call of the
           publishes (crop-span levels, warm 8 and 0 sweeps). K1 at
           the recovery path's own batches (deltas 48, the bucket of 37;
           the relocalizer's wide stage on the 0.2 m view, rasters 21 and
           529), and every K1 row with its launches on the recovery,
           rendezvous, fuse_paths and tenancy phases. K1 at the
           megabatch's batches (3 x 8 deltas, 3 x 168 and 3 x 392
           rasters), K2 over 3 tenants' masks in one launch and K3 over
           their 24 fields under a mask each. K1 at any batch, and K2/K3 at any
           call, that the stacks launched and no row above covers, and
           every K1 row with its launches on the stacks. K3 with a mask
           per field (exact_bfs' 8 fields, and 3 tenants' 24, 256^2 x
           257 sweeps in one launch), planned_goals' target fields over
           3 tenants, and K6 at the depth stack's 8 images. K8 at each
           call site of one `match_batch` (the top bound, the descent's
           three levels, the fine angles, the level-1 covariance surface)
           on the inputs it gets from the fleet's 8 robots and from the
           12-tenant batch's 96 rows: within 1e-6 relative of a float64
           evaluation of the same sums, against its plain version on the
           same tensors, its 32 x 32 tiles not skipped, and its launches
           a call, equal at 8 and 96 rows
  parity   a tiny mission, each tick run on the card and on the CPU from
           the same state with the same wheel noise; then with each
           frontier option on (the assignment must agree exactly); one
           relocalization streak and one merge (tiny_config), card
           against CPU; a micro_config megabatch of 3 missions, 6 ticks
  slam_parity  a tiny single robot, window and single steps, each run on
           the card and on the CPU from the same state
  voxel    slice 3's main path, the voxel mapper's device work: 8 robots
           on circles near room corners of rooms_world(1024, 0.05, seed=1)
           each render one depth image a tick (160 x 120, 200 samples);
           one `fuse_depths` of the 8 images a tick into the default
           (64, 1024, 1024) grid, 20 ticks. Counts are zeroed before the
           ticks and read after; K6 must launch every tick and the map must
           hold occupied voxels. Then the 256-keyframe re-fuse into an empty
           grid (its peak memory), `height_map` and `obstacle_slice`.
  voxel_bench  bench.py's voxel workload: 32 renders of plank_course(512,
           0.05, n_planks=10, seed=7) fused into an empty grid (images/s),
           and the 32-image shared-patch window (K7, then `apply_patch`)
  voxel_region  one tick's 8 images through `region_delta` over the whole
           grid (the sharded fuse's local step on a 1 x 1 mesh), clamped
           onto the grid
  voxel_parity  a tiny two-robot voxel drive, render and fuse each tick on
           the card and on the CPU from the same grid
  stack_parity  the stack at tiny_config(2), speed_noise_frac=0, 40 steps
           on the card and on the CPU from one seed: truth poses to 1e-6 m,
           the mapper's estimates to 1e-4 m, frontier assignments equal,
           at most 1e-4 of the grid cells apart, and both stacks' full
           /tiles manifests byte-equal

  scenario_parity  the JAX suite's shared scenario mission (tiny_config,
           DecayConfig(True, 8, 0.9, 1.5), obs with the staleness SLO,
           arena_with_door(96), 2 robots, a door closed at step 4 for 16
           steps, a crowd at 26 for 10, the mapper killed at 48, 72 steps,
           a delta client polling at 18 and at the end) on the card and on
           the CPU: plan logs, world updates, decay passes, restarts and
           SLO alerts equal, truth within 1e-5 m, at most 1e-4 of the
           cells apart, span streams equal under obs/diff.py

  sharded  the multi-rank mesh's main path on one NCCL rank
           (a 1 x 1 ('fleet', 'space') mesh brought up in this process):
           `make_fleet_step` of the default SlamConfig, 8 robots on the
           fleet phase's world, 30 ticks (K1's slab fuse and matcher, K2,
           K3; tick p50/p90 beside the fleet phase's `fleet_step` p50, host
           syncs of ticks 1-3, launches by route, peak memory), then the
           closing drive: the same widths from a state whose 8 robots have
           driven a gallery east and back (1016 key poses each), ticked
           until loops close; the closing tick's time, K1 launches and
           peak memory, its repair (every valid ring slot, 8 x 1017 scans)
           held exactly to the full-grid unclamped fuse; the matcher 5
           times on the last tick's inputs (it must be deterministic: a
           mesh's 'space' replicas rely on it); then
           `make_voxel_fuse_step` on the default
           (64, 1024, 1024) grid, the voxel phase's 8 images a tick for 20
           ticks through K7's region route, held to the patch path. Counts
           are zeroed before each part and read after it
  sharded_parity  tiny_config with 8 robots on a 1 x 1 mesh, card against
           CPU (a card mesh and a CPU mesh over one process group): 6 ticks
           in the 4.8 m arena and 10 of the dry run's trajectory (closures,
           thinning), then one tiny voxel fuse
  dryrun   `python -m jax_mapping_torch.parallel.dryrun` on one NCCL rank:
           the trajectory must thin and close loops
  sharded_ranks  4 gloo ranks sharing the card (a 2 x 2 mesh, tiny_config,
           6 ticks), held to the same job on 4 CPU ranks, the 'space'
           replicas bit-equal (gloo takes CUDA tensors in torch 2.11)
  replay   `demo --record` of a tiny_config(2) stack for 40 steps, then
           `demo --replay` of the bag on the card: messages replayed, scans
           fused and dropped, cells occupied and free
  coldstart  the obs tier's device half and the staged restart at full
           width: the stack phase's mission with `obs.devprof` and
           `cold_start` armed (the build cache in a fresh directory), a
           `cache_wipe` at step 30 for 20 steps and the mapper killed at
           step 80, 120 steps: steps/s and host syncs beside `stack`'s,
           syncs inside the profiler (0), the top entry points by dispatch
           time, recompiles of the last 20 steps (0), memory watermarks,
           the warm-up reports, the restart's ms and the kill's to the
           first fused scan, the warming window's probes, the cache's
           counts, the cost ledger and its budget cross-check, K1/K2/K3/K5
           launches with the warm-up's apart; then a tiny drive devprof on
           against off (bit-equal), and the signature manifest saved
  coldstart_resume  two fresh processes of this script resume the
           coldstart stack from its checkpoint: cold (an empty cache root:
           nvcc builds every library) and warm (the coldstart root:
           found, the manifest pre-warmed as `aot`); seconds from each
           process's start to its first fused scan, libraries built; the
           resumed grids bit-equal
  tenancy_plane  the tenancy control plane on a launched stack
           (`launch_sim_stack` of the default SlamConfig with
           TenancyConfig(enabled, lane_health, journal), a checkpoint
           dir, http_port=0, 8 robots on the stack world): tenants A-D
           of the default config (mission t on rooms_world(4096, 0.05,
           seed=1 + t)) admitted, suspended, resumed, C poisoned by a
           FaultPlan into quarantine and readmitted by its probe, a
           `controlplane_crash`, D evicted with a checkpoint. Admission
           ms (with and without a pre-warm) by bucket, tick p50/p90 at
           buckets 3 and 6, checkpoint_all and restore ms, host syncs a
           tick (megabatch_tick's and the plane's own, which must be 0),
           K1-K3 launches with the pre-warms' apart, peak memory; every
           tenant bit-equal to its solo run, the restored set with its
           epochs advanced, a /tiles?tenant=A client resynced
  ld06_wire  8 robots' raycasts on the card through `encode_packets`,
           the C++ parser (scans/s) and one `Ld06IngestNode` a robot
           into the mapper of the `ros_launch` live stack on the card,
           with scripted odometry: 12 ticks of one rotation a robot and
           two bursts of 16 (K5); mapper tick p50; decoded ranges within
           0.01 m of the raycast, and the grid bit-equal to the same
           mapper fed the decoded messages directly
  analysis the port's analysis tier on the card: the static pass over
           jax_mapping_torch/ with its baseline (exit 0: files, findings
           by checker, baselined); every host sync the phases above
           recorded in their sync windows (`SyncWindow`: PyTorch's CUDA
           sync debug mode, each warning kept with its whole Python
           stack) held against A1 — a sync is flagged when a frame of its
           stack under jax_mapping_torch/ lies on a line A1 reports, and
           the phase fails on any unflagged site (the sites and their
           stacks in chiprun_out/analysis_syncs.json); LockWatch and
           RaceWatch over tiny_config(2) with its HTTP API, a /tiles
           client and a /status poller, 30 steps, against the same run
           unwatched (poses equal, observed lock edges consistent with the
           static B1 graph, 0 races); `compilebudget --check --device
           cuda` in a fresh process (exit 0, the entry points above one
           variant). At most 60 s.

Every phase line carries `t_s`, the seconds since the script started.
Then one line {"kernels": [...]} (each row's launches by path, with
`launches_coldstart` and `launches_warmup` since the coldstart phase,
`launches_tenancy_plane`, `launches_tenancy_plane_warmup` and
`launches_ld06` since the tenancy_plane and ld06_wire phases, and
its bound from the cost ledger's kernel arithmetic) and, last, the result
line
{"ok": true, "device": {...}}. Any failed phase exits non-zero before the
result line. Without a CUDA device, or without the package beside this
script, it exits non-zero at once.
"""

from __future__ import annotations

import argparse
import collections
import json
import math
import os
import statistics
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

#: Device of the slice-2 phases (a rehearsal on a machine without a card
#: may point it elsewhere; the script itself always runs on the card).
DEV = "cuda"

# Published H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and the
# float32 rate outside the tensor cores. The bytes and operations each
# kernel row's bound divides by them come from the cost ledger's kernel
# arithmetic (`jax_mapping_torch/obs/ledger.py`: `sensor_model_cost` ...
# `voxel_summed_cost`), the one copy the ledger also counts with.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12

#: The cost ledger module (`jax_mapping_torch.obs.ledger`), bound by
#: `bind_ledger()` once the package is on the path.
L = None


def bind_ledger() -> None:
    """Bind `L` to the package's cost ledger (main does; a driver that
    imports this script and calls phases must too)."""
    global L
    from jax_mapping_torch.obs import ledger
    L = ledger


#: The script's start, for each phase line's `t_s` (seconds since it).
T0 = time.perf_counter()


def emit(obj) -> None:
    if "phase" in obj:
        obj = dict(obj, t_s=round(time.perf_counter() - T0, 1))
    print(json.dumps(obj), flush=True)


class Failed(Exception):
    pass


def check(cond, what: str) -> None:
    if not cond:
        raise Failed(what)


def cuda_ms(fn, reps: int = 10, warmup: int = 3) -> float:
    """Median device time of fn() in ms, from CUDA events around each of
    `reps` calls after `warmup` calls."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def device_ms(fn, kernel: str, reps: int = 10,
              per_call: bool = False) -> float:
    """Median duration in ms of the device kernels whose name holds
    `kernel` (in any case), from torch.profiler over `reps` calls of fn()
    after one: the kernel alone, without the host's time to launch it that
    cuda_ms includes when the kernel is short. With `per_call`, their
    time per call, for a call that launches several: the mean duration
    times the kernels a call launched. The profiler now and then loses a
    few records late in a long run, which neither reading depends on; a
    session that records none is repeated, twice at most, then None."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        durs = [float(e["dur"]) / 1e3 for e in _device_events(prof)
                if kernel.lower() in e.get("name", "").lower()]
        if durs and not per_call:
            return statistics.median(durs)
        if durs:
            return statistics.fmean(durs) * max(1, round(len(durs) / reps))
    return None


def compare(got, want) -> dict:
    """Exact comparison of two tensors: mismatched elements and the
    largest absolute difference."""
    import torch
    diff = got != want
    g = got.to(torch.float64)
    w = want.to(torch.float64)
    return {"mismatches": int(diff.sum()),
            "max_abs_err": float((g - w).abs().max()) if got.numel() else 0.0}


def bound(n_bytes: float, n_ops: float) -> dict:
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bytes": n_bytes, "ops": n_ops}


def nvidia_smi() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0] if out.stdout else \
            f"nvidia-smi gave nothing (rc {out.returncode})"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


# ---------------------------------------------------------------------------
# Phases
# ---------------------------------------------------------------------------

def phase_device(torch):
    smi = nvidia_smi()
    print(smi, flush=True)
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "tf32_matmul_default": torch.backends.cuda.matmul.allow_tf32,
          "tf32_cudnn_default": torch.backends.cudnn.allow_tf32})
    return smi


def phase_build():
    from jax_mapping_torch.ops import _cuda
    t0 = time.perf_counter()
    secs = _cuda.build_all()
    total = time.perf_counter() - t0
    ptxas = {}
    for name in _cuda.SOURCES:
        lines = [ln.strip() for ln in _cuda.build_log(name).splitlines()
                 if "registers" in ln or "Compiling entry" in ln]
        ptxas[name] = lines[:8]
    emit({"phase": "build", "seconds": total, "per_library_s": secs,
          "ptxas": ptxas,
          "sass_instructions": {n: sass_counts(_cuda._target(n))
                                for n in ("sensor_model", "window_fuse")}})


def sass_counts(lib) -> dict:
    """SASS instructions of each kernel in a built library, by its mangled
    name (cuobjdump -sass beside nvcc; {} where it is missing)."""
    import re
    from jax_mapping_torch.ops import _cuda
    tool = os.path.join(os.path.dirname(_cuda.nvcc_path()), "cuobjdump")
    if not os.path.exists(tool):
        return {}
    out = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                         text=True, timeout=120).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = m.group(1)
            counts[fn] = 0
        elif fn and re.search(r"/\*[0-9a-f]{4,}\*/\s+\S", line):
            counts[fn] += 1
    return counts


#: One cell of the sensor model (cell_ray, then the delta and the raster
#: weight), compiled alone to count its SASS instructions.
_CELL_PROBE = r"""
#include "sensor_cell.cuh"
extern "C" __global__ void cell_probe(const float* table, float px,
                                      float py, float yaw,
                                      sensor_cell::Params q, float* out) {
  const int i = threadIdx.x, j = blockIdx.x;
  const sensor_cell::CellRay c = sensor_cell::cell_ray(i, j, px, py, yaw, q);
  out[2 * (i * 1024 + j)] = sensor_cell::delta_of(c, table[c.beam], q);
  out[2 * (i * 1024 + j) + 1] = sensor_cell::raster_of(c, table[c.beam], q);
}
"""


def cell_sass(csrc: str) -> dict:
    """SASS instructions of one cell of the model with the header in
    `csrc` (the _CELL_PROBE kernel, built with the kernels' flags)."""
    from jax_mapping_torch.ops import _cuda
    with tempfile.TemporaryDirectory() as d:
        src = os.path.join(d, "cell_probe.cu")
        with open(src, "w") as f:
            f.write(_CELL_PROBE)
        out = os.path.join(d, "cell_probe.cubin")
        flags = [f for f in _cuda.NVCC_FLAGS
                 if f not in ("-shared", "-Xcompiler", "-fPIC")]
        subprocess.run([_cuda.nvcc_path(), *flags, "-cubin", "-I", csrc,
                        "-o", out, src], check=True, capture_output=True,
                       timeout=300)
        return sass_counts(out)


def _world(cfg, dev, torch):
    from jax_mapping_torch.sim import world as W
    w = W.plank_course(cfg.grid.size_cells, cfg.grid.resolution_m,
                       n_planks=40, seed=0)
    return torch.as_tensor(w, device=dev)


def _poses_near_walls(torch, cfg, world, n: int, gen):
    """n poses in free cells 0.5-4 m from random wall cells, at random
    headings: scans taken there see walls within the LD06's range (the
    default world's 40 planks are spread over 204.8 m, so a random pose
    mostly sees nothing)."""
    res = cfg.grid.resolution_m
    w = world.cpu()
    H, W = w.shape
    walls = torch.nonzero(w)
    out = []
    while sum(len(o) for o in out) < n:
        rc = walls[torch.randint(len(walls), (4 * n,), generator=gen)].float()
        ang = torch.rand(4 * n, generator=gen) * (2 * math.pi)
        d = 0.5 + 3.5 * torch.rand(4 * n, generator=gen)
        x = (rc[:, 1] + 0.5 - W / 2) * res + d * torch.cos(ang)
        y = (rc[:, 0] + 0.5 - H / 2) * res + d * torch.sin(ang)
        col = torch.floor(x / res + W / 2).long()
        row = torch.floor(y / res + H / 2).long()
        ok = (row >= 0) & (row < H) & (col >= 0) & (col < W)
        ok &= ~w[row.clamp(0, H - 1), col.clamp(0, W - 1)]
        yaw = (torch.rand(4 * n, generator=gen) * 2 - 1) * math.pi
        out.append(torch.stack([x, y, yaw], 1)[ok])
    return torch.cat(out)[:n].contiguous().to(world.device)


class VerifyCount:
    """Counts the loop verifications (`_verify_loop`, one per attempting
    robot) that `fleet_step` runs while the context is open."""

    def __enter__(self):
        from jax_mapping_torch.models import fleet as FL
        self.fl, self.orig, self.n = FL, FL._verify_loop, 0

        def counted(*args, **kwargs):
            self.n += 1
            return self.orig(*args, **kwargs)
        FL._verify_loop = counted
        return self

    def __exit__(self, *exc):
        self.fl._verify_loop = self.orig


class BatchCount:
    """Counts K1's launches by mode and batch while the context is open,
    from the calls of its wrappers on CUDA tensors (each such call with
    B > 0 launches the kernel once). A batch is keyed by its scan count B;
    a call on another grid than `base` (loop verification's and the
    relocalizer's coarse view) is keyed "B@<resolution>m"."""

    NAMES = {"scan_deltas": "sensor_model_delta",
             "scan_rasters": "sensor_model_raster"}

    def __init__(self, base=None, capture: bool = False):
        self.base = base
        #: With `capture`: (name, key) -> the first such call's (grid
        #: config, scan config, ranges, poses, origins), cloned.
        self.inputs = {} if capture else None

    def __enter__(self):
        from jax_mapping_torch.ops import sensor_kernel as SK
        self.sk, self.orig = SK, {f: getattr(SK, f) for f in self.NAMES}
        self.n = {k: {} for k in self.NAMES.values()}
        for f, name in self.NAMES.items():
            setattr(SK, f, self._counted(self.orig[f], self.n[name], name))
        return self

    def _counted(self, fn, counts, name):
        def counted(grid_cfg, scan_cfg, ranges_b, *args):
            B = ranges_b.shape[0]
            if ranges_b.device.type == "cuda" and B > 0:
                key = (str(B) if self.base is None or grid_cfg == self.base
                       else f"{B}@{grid_cfg.resolution_m:g}m")
                counts[key] = counts.get(key, 0) + 1
                if self.inputs is not None \
                        and (name, key) not in self.inputs:
                    self.inputs[(name, key)] = (grid_cfg, scan_cfg) + tuple(
                        a.clone() for a in (ranges_b, *args))
            return fn(grid_cfg, scan_cfg, ranges_b, *args)
        return counted

    def __exit__(self, *exc):
        for f, fn in self.orig.items():
            setattr(self.sk, f, fn)

    def per_tick(self, ticks: int) -> dict:
        return {name: {b: c / ticks for b, c in sorted(n.items())}
                for name, n in self.n.items()}


def _split_ms(tick_ms, verifies) -> dict:
    """Median tick time of the ticks with and without loop verification."""
    with_v = [t for t, v in zip(tick_ms, verifies) if v]
    without = [t for t, v in zip(tick_ms, verifies) if not v]
    return {"ticks_verifying": len(with_v),
            "tick_p50_ms_verifying": statistics.median(with_v)
            if with_v else None,
            "tick_p50_ms_not_verifying": statistics.median(without)
            if without else None}


#: The kernels the fleet tick runs (K1 in both modes, K2, K3).
FLEET_KERNELS = ("sensor_model_delta", "sensor_model_raster", "label_prop",
                 "costfield_relax")

#: Launches a fleet tick makes of K2 (one call) and K3 (one a level).
FLEET_SWEEP_LAUNCHES = {"label_prop": 1, "costfield_relax": 3}


def phase_fleet(torch, cfg, world, ticks: int, seed: int):
    from jax_mapping_torch.models import fleet as FL
    from jax_mapping_torch.ops import _cuda
    gen = torch.Generator().manual_seed(seed)
    st = FL.init_fleet_state(cfg, generator=gen)       # default: the card
    check(st.grid.device.type == "cuda", "fleet state is not on the card")
    res = cfg.grid.resolution_m
    torch.cuda.synchronize()
    _cuda.reset_launches()
    tick_ms, verifies, keys, closed, syncs = [], [], 0, 0, []
    with VerifyCount() as vc, BatchCount(cfg.grid) as bc:
        for i in range(ticks):
            n0 = vc.n
            t0 = time.perf_counter()
            if 1 <= i <= 3:
                # Host syncs of three ordinary ticks, counted by PyTorch's
                # sync debug mode (a warning each, a few microseconds).
                (st, diag), n_sync = _count_syncs(torch, lambda: FL.fleet_step(
                    cfg, st, res, world, generator=gen))
                syncs.append(n_sync)
            else:
                st, diag = FL.fleet_step(cfg, st, res, world, generator=gen)
            torch.cuda.synchronize()
            tick_ms.append((time.perf_counter() - t0) * 1e3)
            verifies.append(vc.n - n0)
            keys += int(diag.is_key.any())
            closed += int(diag.loop_closed.sum())
    launches = dict(_cuda.LAUNCHES)
    routes = {k: dict(v) for k, v in _cuda.ROUTES.items()}

    grid = st.grid
    occ = int((grid > cfg.grid.occ_threshold).sum())
    free = int((grid < cfg.grid.free_threshold).sum())
    observed = int((grid != 0).sum())
    steady = tick_ms[1:] if len(tick_ms) > 1 else tick_ms
    q = statistics.quantiles(steady, n=10) if len(steady) > 1 else steady
    out = {"phase": "fleet", "ticks": ticks, "robots": cfg.fleet.n_robots,
           "grid_cells": cfg.grid.size_cells,
           "first_tick_ms": tick_ms[0],
           "tick_p50_ms": statistics.median(steady),
           "tick_p90_ms": q[-1] if len(steady) > 1 else steady[0],
           "tick_ms": tick_ms,
           "verifications_per_tick": verifies,
           "host_syncs_ticks_1_to_3": syncs,
           **_split_ms(steady, verifies[len(verifies) - len(steady):]),
           "mapped_occ_cells": occ, "mapped_free_cells": free,
           "observed_cells": observed,
           "mean_pose_err_m": float(diag.pose_err.mean()),
           "ticks_with_key_robots": keys, "loops_closed": closed,
           "launches": launches,
           "launches_per_tick": {k: v / ticks for k, v in launches.items()},
           "routes": routes,
           "k1_launches_per_tick_by_batch": bc.per_tick(ticks),
           "tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
           "tf32_cudnn": torch.backends.cudnn.allow_tf32}
    emit(out)
    check(bool(torch.isfinite(grid).all()), "grid holds non-finite values")
    check(float(grid.abs().max()) <= cfg.grid.logodds_max,
          "grid outside the log-odds bounds")
    check(bool(torch.isfinite(st.est_poses).all()), "non-finite estimates")
    check(bool(torch.isfinite(diag.pose_err).all()), "non-finite pose_err")
    check(observed > 0, "the fleet observed no cell")
    check(keys > 0, "no tick had a key robot")
    for name in FLEET_KERNELS + ("match_correlate",):
        check(launches[name] > 0,
              f"kernel {name} never launched on the fleet path")
    # K2 once a tick, K3 once a level (three a tick), all cluster launches.
    for name, per_tick in FLEET_SWEEP_LAUNCHES.items():
        check(launches[name] == per_tick * ticks,
              f"{name} launched {launches[name]} times in {ticks} ticks, "
              f"not {per_tick} a tick")
        check(all(r.startswith("cluster") for r in routes[name]),
              f"{name} left the cluster route: {routes[name]}")
    return st, out


def phase_stages(torch, cfg, st, world):
    """Device time of each stage of a tick, called alone on `st`; within
    `compute_frontiers`, `cost_fields` and K3's share of it."""
    from jax_mapping_torch._util import div
    from jax_mapping_torch.models import slam as S
    from jax_mapping_torch.ops import costfield as CF
    from jax_mapping_torch.ops import frontier as F
    from jax_mapping_torch.ops import grid as G
    from jax_mapping_torch.ops import posegraph as PG
    from jax_mapping_torch.ops import scan_match as M
    from jax_mapping_torch.sim import lidar
    res = cfg.grid.resolution_m
    n_samples = int(cfg.scan.range_max_m / (res * 0.5))
    scans = lidar.simulate_scans(cfg.scan, world, res, n_samples,
                                 st.sim.poses)
    key = torch.ones(cfg.fleet.n_robots, dtype=torch.bool, device=world.device)
    # One robot's loop verification against its own chain, as a verifying
    # tick runs it once per attempting robot.
    k = int(st.graphs.n_poses[0]) - 1
    stages = {
        "verify_loop_one_robot": lambda: S._verify_loop(
            cfg, PG.index(st.graphs, 0), st.scan_rings[0], 0, k, scans[0],
            st.est_poses[0]),
        "simulate_scans": lambda: lidar.simulate_scans(
            cfg.scan, world, res, n_samples, st.sim.poses),
        "compute_frontiers": lambda: F.compute_frontiers(
            cfg.frontier, cfg.grid, st.grid, st.est_poses),
        "match_batch": lambda: M.match_batch(
            cfg.grid, cfg.scan, cfg.matcher, st.grid, scans, st.est_poses),
        "fuse_scans_masked": lambda: G.fuse_scans_masked(
            cfg.grid, cfg.scan, st.grid, scans, st.est_poses, key),
    }
    ms = {k: cuda_ms(f, reps=5, warmup=1) for k, f in stages.items()}

    # Inside compute_frontiers: the cost fields and K3's three launches in
    # them, on the state's own blocked map and robot cells.
    fcfg = cfg.frontier
    free, _occ, unknown = F.coarsen(fcfg, cfg.grid, st.grid)
    fmask = F.frontier_mask(free, unknown)
    passable, bfs_res = F.bfs_passability(fcfg, cfg.grid, free, unknown,
                                          fmask)
    ox, oy = cfg.grid.origin_m
    rc = torch.stack([div(st.est_poses[:, 1] - oy, bfs_res).to(torch.int32),
                      div(st.est_poses[:, 0] - ox, bfs_res).to(torch.int32)],
                     dim=1)
    levels = []

    def recorded(blk, init, iters):
        levels.append((blk, init, iters))
        return CF.relax_level(blk, init, iters)
    CF.cost_fields(~passable, rc, fcfg.mg_levels, fcfg.mg_refine_iters,
                   relax=recorded)
    ms["cost_fields"] = cuda_ms(lambda: CF.cost_fields(
        ~passable, rc, fcfg.mg_levels, fcfg.mg_refine_iters), reps=5,
        warmup=1)
    k3_ms = [cuda_ms(lambda b=b, i=i, it=it: CF.relax_level(b, i, it),
                     reps=5, warmup=1) for b, i, it in levels]

    # The matcher's own stages (the branch-and-bound path of match_batch).
    m = cfg.matcher
    origin = G.patch_origin(cfg.grid, st.est_poses[:, :2])
    P = cfg.grid.patch_cells
    ar = torch.arange(P, device=world.device)
    patch = st.grid[(origin[:, 0:1].long() + ar)[:, :, None],
                    (origin[:, 1:2].long() + ar)[:, None, :]]
    field = M.likelihood_field(cfg.grid, m, patch)
    stride, n_steps = M.window_params(cfg.grid, m)
    n_lv = M.bnb_num_levels(m, n_steps)
    levels = M.build_levels(field, n_steps, stride, n_lv)
    dth, rasters, mass = M._bnb_setup(cfg.grid, cfg.scan, m, origin, scans,
                                      st.est_poses)
    top = M._bnb_top(levels, rasters, mass, n_steps, stride, n_lv)
    zeros = torch.zeros((cfg.fleet.n_robots, 2), device=world.device)
    matcher = {
        "field_and_pyramid": lambda: M.build_levels(
            M.likelihood_field(cfg.grid, m, patch), n_steps, stride, n_lv),
        "coarse_rasters": lambda: M._bnb_setup(
            cfg.grid, cfg.scan, m, origin, scans, st.est_poses),
        "bnb_top_conv": lambda: M._bnb_top(levels, rasters, mass, n_steps,
                                           stride, n_lv),
        "bnb_descent_fine_cov": lambda: M._bnb_finish(
            cfg.grid, cfg.scan, m, levels, top, rasters, mass, dth, origin,
            scans, st.est_poses, n_lv),
        "fine_stages_alone": lambda: M._fine_stages(
            cfg.grid, cfg.scan, m, field, origin, scans, st.est_poses, mass,
            zeros[:, 0], zeros),
    }
    emit({"phase": "stages", "ms": ms,
          "cost_fields_ms": ms["cost_fields"], "k3_ms": sum(k3_ms),
          "k3_ms_by_level": k3_ms,
          "match_batch_ms": {k: cuda_ms(f, reps=5, warmup=1)
                             for k, f in matcher.items()}})


# Device-side records of the profiler's own buffer handling, not work.
_PROFILER_OWN = ("Activity Buffer Request", "Buffer Flush")


def _union_us(spans) -> float:
    """Length of the union of (start, end) intervals: device time in which
    at least one kernel or copy ran, overlaps counted once."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(spans):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def _device_events(prof) -> list:
    """The kernels, copies and memsets of a finished torch.profiler run,
    from its exported trace."""
    with tempfile.TemporaryDirectory() as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            trace = json.load(f)
    events = trace["traceEvents"] if isinstance(trace, dict) else trace
    return [e for e in events
            if e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


def phase_profile(torch, cfg, st, world, seed: int, ticks: int = 3):
    """The next ticks of the mission: `ticks` timed alone, then `ticks`
    under torch.profiler for the device's busy share of the wall time
    (time in which any stream ran a kernel or copy), device work per
    stream, launches per tick and the kernels that take the most device
    time. The profiler slows the host, so the busy share there is a lower
    bound on the unprofiled one. Each tick's loop verifications are
    counted, since a verifying tick does far more work."""
    from torch.profiler import ProfilerActivity, profile
    from jax_mapping_torch.models import fleet as FL
    gen = torch.Generator().manual_seed(seed + 3)
    res = cfg.grid.resolution_m
    alone_ms, alone_v = [], []
    with VerifyCount() as vc:
        for _ in range(ticks):
            n0 = vc.n
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            st, _ = FL.fleet_step(cfg, st, res, world, generator=gen)
            torch.cuda.synchronize()
            alone_ms.append((time.perf_counter() - t0) * 1e3)
            alone_v.append(vc.n - n0)
        n0 = vc.n
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(ticks):
                st, _ = FL.fleet_step(cfg, st, res, world, generator=gen)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        profiled_v = vc.n - n0

    def dev_us(e):
        v = getattr(e, "self_device_time_total", None)
        return v if v is not None else getattr(e, "self_cuda_time_total", 0)

    # Device work by stream: cuDNN may run the groups of a grouped
    # convolution on streams of its own, so kernels overlap and their
    # summed time exceeds the time the device was busy.
    streams = {}
    for e in _device_events(prof):
        ts = float(e["ts"])
        streams.setdefault(str(e.get("tid")), []).append(
            (ts, ts + float(e["dur"])))
    spans = [s for v in streams.values() for s in v]
    busy_ms = _union_us(spans) / 1e3
    avg = sorted(prof.key_averages(), key=dev_us, reverse=True)
    top = [{"name": e.key[:80], "calls": e.count,
            "device_ms_per_tick": dev_us(e) / 1e3 / ticks}
           for e in avg[:15] if dev_us(e) > 0 and e.key not in _PROFILER_OWN]
    emit({"phase": "profile", "ticks": ticks,
          "unprofiled_tick_ms": alone_ms,
          "unprofiled_verifications_per_tick": alone_v,
          "profiled_verifications": profiled_v,
          "wall_ms_per_tick": wall_ms / ticks,
          "device_busy_ms_per_tick": busy_ms / ticks if spans else None,
          "device_busy_share": busy_ms / wall_ms if spans else None,
          "device_kernel_ms_per_tick": sum(b - a for a, b in spans) / 1e3
          / ticks,
          "device_ops_per_tick": len(spans) / ticks,
          "streams": {k: {"ops_per_tick": len(v) / ticks,
                          "busy_ms_per_tick": _union_us(v) / 1e3 / ticks}
                      for k, v in streams.items()},
          "top": top})


def phase_kernels(torch, cfg, world, mapped, seed: int, fleet: dict,
                  mapper: dict, voxel: tuple, explore: tuple,
                  new_paths: dict, tenancy: dict, stack_rec, world_paths,
                  options: dict):
    """Each kernel against its plain version at the main path's shapes.
    The scans are taken near walls and the frontier comes from `mapped`,
    the re-fused map, so that every kernel sees non-trivial input; the
    voxel kernels take the voxel phases' images (`voxel`: their states).
    Every K1 row also carries its batch's launches on the recovery path's
    phases (`new_paths`), and the batches only those paths launch get rows
    of their own. `options` holds the K2/K3 calls of the frontier
    options (`recs`, by tag: exact_bfs' 8 fields under 8 masks in one
    launch, 3 tenants' 24, the depth-camera stack's) and the depth stack's
    K6 batch (`k6`, with its launches a step); planned_goals' fields over
    the megabatch's grids are made here. K8 at the fleet's 8 robots near
    walls, each scan matched a few cm off against a map fused from it,
    and its 12-tenant rows (`tenancy["k8_rows"]`, made by the tenancy
    phase): within K8_REL_TOL of float64 rather than exact, launching
    as often for 96 rows as for 8."""
    from jax_mapping_torch.ops import costfield as CF
    from jax_mapping_torch.ops import frontier as F
    from jax_mapping_torch.ops import grid as G
    from jax_mapping_torch.sim import lidar
    dev = world.device
    res = cfg.grid.resolution_m
    n_samples = int(cfg.scan.range_max_m / (res * 0.5))
    gen = torch.Generator().manual_seed(seed + 1)
    rows = {}

    # K1 at every batch the main paths launch it with: deltas of one
    # stream sub-batch (64 scans: the closure re-fuse), of the fleet tick's
    # 8 robots and of `fuse_scan` (1 scan); the
    # matcher's rasters of the fleet's 8 robots (coarse and fine angles,
    # 168 each; 7 x 7 sub-cell offsets, 392) and of one robot's match in
    # the mapper (21, 21, 49).
    guess = _poses_near_walls(torch, cfg, world, cfg.fleet.n_robots, gen)
    scans = lidar.simulate_scans(cfg.scan, world, res, n_samples, guess)
    for B in (64, 8, 1):
        poses = _poses_near_walls(torch, cfg, world, B, gen)
        ranges = lidar.simulate_scans(cfg.scan, world, res, n_samples, poses)
        origins = G.patch_origin(cfg.grid, poses[:, :2]).contiguous()
        rows["sensor_model_delta" + ("" if B == 64 else f"_b{B}")] = \
            _k1_row(torch, cfg, False, ranges, poses, origins, fleet, mapper,
                    new_paths=new_paths)
    n_r = cfg.fleet.n_robots
    for name, R, stage in (("sensor_model_raster", n_r, "coarse"),
                           ("sensor_model_raster_b392", n_r, "subcell"),
                           ("sensor_model_raster_b21", 1, "coarse"),
                           ("sensor_model_raster_b49", 1, "subcell")):
        r_b, p_b, o_b = _raster_inputs(torch, cfg, scans[:R], guess[:R],
                                       stage)
        rows[name] = _k1_row(torch, cfg, True, r_b, p_b, o_b, fleet, mapper,
                             new_paths=new_paths)
    rows.update(recovery_k1_rows(torch, cfg, world, gen, fleet, mapper,
                                 new_paths))
    rows.update(tenancy_kernel_rows(torch, cfg, world, gen, fleet, mapper,
                                    new_paths, tenancy))

    # K2: the 256^2 clustering mask of the fused map's frontier.
    fcfg = cfg.frontier
    free, _occ, unknown = F.coarsen(fcfg, cfg.grid, mapped)
    mask = F.frontier_mask(free, unknown)
    mask2 = F._pool_any(mask, fcfg.cluster_downsample)
    n = mask2.shape[0]
    iters = max(1, -(-fcfg.label_prop_iters // fcfg.cluster_downsample))
    lin = torch.arange(n * n, dtype=torch.int32, device=dev).reshape(n, n)
    seed_lab = torch.where(mask2, lin, -1).to(torch.int32)
    sweeps = 2 * iters + 1
    got, ran = F.label_sweeps(mask2, seed_lab, sweeps)
    want = F._label_prop_plain(mask2, seed_lab, iters)
    rows["label_prop"] = dict(
        compare(got, want), shape=[n, n], sweeps=sweeps, **ran,
        mask_cells=int(mask2.sum()),
        components=int(torch.unique(want[want >= 0]).numel()),
        **_sweep_times(lambda: F.label_prop(mask2, seed_lab, iters),
                       lambda: F._label_prop_plain(mask2, seed_lab, iters),
                       "label", sweeps),
        **bound(*L.label_prop_cost(mask2, sweeps)))

    # K3: the obstacle-aware cost fields of every robot, three levels.
    R = guess.shape[0]
    passable, bfs_res = F.bfs_passability(fcfg, cfg.grid, free, unknown,
                                          mask)
    blocked = ~passable
    ox, oy = cfg.grid.origin_m
    pose = guess
    rc = torch.stack([((pose[:, 1] - oy) / bfs_res).to(torch.int32),
                      ((pose[:, 0] - ox) / bfs_res).to(torch.int32)], 1)
    calls = []                       # each level's relaxation inputs

    def relax_recorded(blk, init, iters):
        calls.append((blk, init, iters))
        return CF.relax_level(blk, init, iters)

    got = CF.cost_fields(blocked, rc, fcfg.mg_levels, fcfg.mg_refine_iters,
                         relax=relax_recorded)
    want = CF.cost_fields(blocked, rc, fcfg.mg_levels, fcfg.mg_refine_iters,
                          relax=CF._relax_level_xla)
    cmp = compare(got, want)
    levels = [dict(n=init.shape[-1], sweeps=2 * iters,
                   **CF.relax_sweeps(blk, init, 2 * iters)[1],
                   **_sweep_times(
                       lambda: CF.relax_level(blk, init, iters),
                       lambda: CF._relax_level_xla(blk, init, iters),
                       "relax", 2 * iters))
              for blk, init, iters in calls]
    # The function's own work, level by level (the ledger's K3 arithmetic).
    costs = [L.relax_cost(blk, init, 2 * iters) for blk, init, iters in calls]
    n_bytes = sum(c[0] for c in costs)
    n_ops = sum(c[1] for c in costs)
    nb_ = blocked.shape[0]
    rows["costfield_relax"] = dict(
        cmp, shape=[R, nb_, nb_], blocked_cells=int(blocked.sum()),
        reachable_cells=int((want < CF._BIG).sum()), levels=levels,
        **{k: (None if None in [v[k] for v in levels]
               else sum(v[k] for v in levels))
           for k in ("ms", "device_ms", "plain_ms")},
        cost_fields_ms=cuda_ms(lambda: CF.cost_fields(
            blocked, rc, fcfg.mg_levels, fcfg.mg_refine_iters)),
        cost_fields_plain_ms=cuda_ms(lambda: CF.cost_fields(
            blocked, rc, fcfg.mg_levels, fcfg.mg_refine_iters,
            relax=CF._relax_level_xla)),
        **bound(n_bytes, n_ops))
    rows.update(sweep_edge_rows(torch, dev, R))

    rows.update(window_kernel_rows(torch, cfg, world, mapped, seed, mapper))
    rows.update(edge_rows(torch, cfg, world, mapped, gen))
    rows.update(voxel_kernel_rows(torch, cfg, *voxel))
    rows.update(exploration_kernel_rows(torch, cfg, *explore))
    rows.update(stack_kernel_rows(torch, cfg, world, gen, fleet, mapper,
                                  new_paths, stack_rec, rows))
    rows.update(world_kernel_rows(torch, cfg, fleet, mapper, new_paths,
                                  *world_paths, rows))
    for tag, rec in options["recs"].items():
        rows.update(_new_sweep_rows(torch, cfg, rec, rows, tag))
    # planned_goals' target-seeded fields over the megabatch's grids: one
    # K3 launch a level for every tenant's robots.
    import dataclasses
    pg = dataclasses.replace(fcfg, planned_goals=True)
    fr_t = F.compute_frontiers(pg, cfg.grid, tenancy["grids"],
                               tenancy["poses"])
    with SweepRecorder() as rec:
        F.assigned_waypoints(pg, cfg.grid, tenancy["grids"],
                             tenancy["poses"], fr_t.targets,
                             fr_t.assignment)
    T = tenancy["grids"].shape[0]
    for name, m, init, s in rec.calls:
        rows[f"costfield_relax_planned_goals_tenant_t{T}_n{init.shape[-1]}"
             f"_s{s}"] = _sweep_row(torch, name, m, init, s)
    del fr_t, rec
    d, p, o = options["k6"]
    rows[f"voxel_image_stack_depth_b{int(d.shape[0])}"] = _k6_row(
        torch, cfg, d, p, o,
        launches_per_stack_step=options["k6_launches_per_step"])
    fused = G.fuse_scans_masked(
        cfg.grid, cfg.scan, G.empty_grid(cfg.grid, dev), scans, guess,
        torch.ones(R, dtype=torch.bool, device=dev))
    rows.update(k8_rows(torch, cfg, fused, scans, guess + torch.tensor(
        [0.03, -0.02, 0.01], device=dev)))
    del fused
    rows.update(tenancy["k8_rows"])
    emit({"phase": "kernels", "rows": rows})
    for name, r in rows.items():
        check(r["mismatches"] == 0,
              f"kernel {name} differs from its plain version in "
              f"{r['mismatches']} elements (max abs {r['max_abs_err']})")
    k8_calls = {k: r["launches_per_match_batch"] for k, r in rows.items()
                if "launches_per_match_batch" in r}
    check(len(k8_calls) == 2 and all(
        n == 2 * len(rows[k]["sites"]) for k, n in k8_calls.items()),
          f"K8's launches a match_batch are not 2 a site at 8 and at 96 "
          f"rows: {k8_calls}")
    for name, r in rows.items():
        if "plain_float64_max_rel_err" in r:
            check(r["plain_max_rel_err"] <= K8_REL_TOL
                  + r["plain_float64_max_rel_err"],
                  f"{name} is {r['plain_max_rel_err']:.3g} from its plain "
                  f"version, beyond {K8_REL_TOL} + the plain version's own "
                  f"{r['plain_float64_max_rel_err']:.3g} from float64")
    return rows


def _sweep_times(kernel, plain, name: str, sweeps: int) -> dict:
    """K2's or K3's times: the wrapper's call on CUDA events (`ms`, what a
    caller pays), the kernel alone from the profiler (`device_ms`), the
    latter per sweep, and the plain version's time (5 calls after 1, as
    the voxel rows time theirs: the plain sweeps take up to 0.45 s)."""
    dev_ms = device_ms(kernel, name, per_call=True)
    return {"ms": cuda_ms(kernel), "device_ms": dev_ms,
            "us_per_sweep": (None if dev_ms is None
                             else dev_ms * 1e3 / max(1, sweeps)),
            "plain_ms": cuda_ms(plain, reps=5, warmup=1)}


def sweep_edge_rows(torch, dev, R: int) -> dict:
    """K2 and K3 on paths that cross every slab boundary and outrun the
    sweeps (the serpentine mask and the corridor maze of
    tests/torch_kernel_inputs.py), a K2 seed with labels off the
    mask, K3 fields that hold values at blocked cells, zero sweeps, and
    the global route at 1024^2 (timed); exact against the plain versions."""
    from jax_mapping_torch.ops import costfield as CF
    from jax_mapping_torch.ops import frontier as F
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import torch_kernel_inputs as KI
    rows = {}
    for n in (256, 40, 1024):
        m = KI.serpentine_mask(n, seed=n)
        mask = torch.as_tensor(m).to(dev)
        for off in (False, True):
            seed = torch.as_tensor(KI.label_seed(m, off, seed=n)).to(dev)
            got, ran = F.label_sweeps(mask, seed, 49)
            want = F._label_prop_plain(mask, seed, 24)
            row = dict(compare(got, want), shape=[n, n], sweeps=49, **ran)
            if n == 1024 and not off:
                row.update(_sweep_times(
                    lambda: F.label_prop(mask, seed, 24),
                    lambda: F._label_prop_plain(mask, seed, 24), "label",
                    49))
            rows[f"edge_label_prop_serpentine_n{n}"
                 + ("_seed_off_mask" if off else "")] = row
    for n, iters in ((64, 32), (256, 8), (48, 8), (1024, 8)):
        blocked = KI.corridor_maze(n, seed=n)
        blk = torch.as_tensor(blocked).to(dev)
        for dense in (False, True):
            init = torch.as_tensor(KI.maze_init(blocked, R, seed=n,
                                                dense=dense)).to(dev)
            got, ran = CF.relax_sweeps(blk, init, 2 * iters)
            want = CF._relax_level_xla(blk, init, iters)
            row = dict(compare(got, want), shape=[R, n, n],
                       sweeps=2 * iters, **ran)
            if n == 1024 and not dense:
                row.update(_sweep_times(
                    lambda: CF.relax_level(blk, init, iters),
                    lambda: CF._relax_level_xla(blk, init, iters), "relax",
                    2 * iters))
            rows[f"edge_costfield_relax_maze_n{n}"
                 + ("_dense" if dense else "")] = row
    m = torch.as_tensor(KI.serpentine_mask(256)).to(dev)
    seed = torch.as_tensor(KI.label_seed(KI.serpentine_mask(256), True)
                           ).to(dev)
    got, ran = F.label_sweeps(m, seed, 0)
    rows["edge_label_prop_zero_sweeps"] = dict(compare(got, seed), **ran)
    init = torch.as_tensor(KI.maze_init(~KI.serpentine_mask(256), R,
                                        dense=True)).to(dev)
    got, ran = CF.relax_sweeps(~m, init, 0)
    rows["edge_costfield_relax_zero_sweeps"] = dict(compare(got, init), **ran)
    return rows


def _raster_inputs(torch, cfg, scans, guess, stage):
    """One match's raster batch for R robots (scans (R, beams) at guess
    (R, 3)), each at its robot's patch origin: the coarse candidates (R x
    21 angles around the guess), or the sub-cell stage (R x 7 x 7 offsets
    of fine_step_m at a fine angle off the guess, scan_match.py's last
    stage)."""
    from jax_mapping_torch.ops import grid as G
    from jax_mapping_torch.ops import scan_match as M
    m = cfg.matcher
    dev = guess.device
    if stage == "coarse":
        dth = M._angle_grid(m.coarse_angle_half_rad, m.coarse_angle_step_rad,
                            dev)
        cand = M._coarse_poses(guess, dth)                     # (R, A, 3)
    else:
        k = max(1, int(round(0.5 * cfg.grid.resolution_m / m.fine_step_m))
                + 1)
        d1 = torch.arange(-k, k + 1, dtype=torch.float32,
                          device=dev) * m.fine_step_m
        ddy, ddx = torch.meshgrid(d1, d1, indexing="ij")
        off = torch.stack([ddx.reshape(-1), ddy.reshape(-1)], -1)
        yaw = guess[:, 2:3] + 3 * m.fine_angle_step_rad
        cand = torch.cat([guess[:, None, :2] + off[None],
                          yaw[:, None, :].expand(-1, off.shape[0], 1)], -1)
    R, A = cand.shape[0], cand.shape[1]
    nb = scans.shape[1]
    r_b = scans[:, None, :].expand(R, A, nb).reshape(R * A, nb).contiguous()
    p_b = cand.reshape(R * A, 3).contiguous()
    o_b = G.patch_origin(cfg.grid, guess[:, :2])[:, None, :].expand(
        R, A, 2).reshape(R * A, 2).contiguous()
    return r_b, p_b, o_b


def _class_shares(cfg, ranges, poses, origins, raster: bool) -> dict:
    """Share of (16 x 16 tile, scan) pairs in each class of the kernels'
    tile class, from its plain mirror on the same inputs."""
    from jax_mapping_torch.ops import sensor_kernel as SK
    return SK.tile_class_shares(SK.tile_classes_plain(
        cfg.grid, cfg.scan, ranges, poses, origins, raster=raster))


def _k1_row(torch, cfg, raster: bool, ranges, poses, origins, fleet: dict,
            mapper: dict, key: str = None, new_paths: dict = None) -> dict:
    """K1 against its plain version on one batch: exact comparison, times,
    the bound from the function (output bytes; 55 operations per cell
    within max range), the tile-class shares, launches per tick of this
    batch on the fleet and mapper paths, and its launches on the recovery
    path's phases (`new_paths`: BatchCount totals and their units by
    phase). `key` is the batch's BatchCount key (default: B)."""
    from jax_mapping_torch.ops import sensor_kernel as SK
    kernel = SK.scan_rasters if raster else SK.scan_deltas
    plain = SK.scan_rasters_plain if raster else SK.scan_deltas_plain
    B, nb = ranges.shape
    key = key or str(B)
    P = cfg.grid.patch_cells
    got = kernel(cfg.grid, cfg.scan, ranges, poses, origins)
    want = plain(cfg.grid, cfg.scan, ranges, poses, origins)
    row = compare(got, want)
    row["nonzero_cells"] = int((want != 0).sum())
    del got, want
    name = "sensor_model_raster" if raster else "sensor_model_delta"
    cells = SK.model_cells(cfg.grid, poses, origins)
    row.update(
        shape=[B, P, P], cells_within_range=cells,
        class_shares=_class_shares(cfg, ranges, poses, origins, raster),
        launches_per_fleet_tick=fleet["k1_launches_per_tick_by_batch"][
            name].get(key, 0.0),
        launches_per_mapper_tick=mapper["k1_launches_per_tick_by_batch"][
            name].get(key, 0.0),
        launches_recovery_path={
            phase: {"launches": v["k1_launches_by_batch"][name].get(key, 0),
                    "per": v["per"]}
            for phase, v in (new_paths or {}).items()},
        library_ms=None,
        ms=cuda_ms(lambda: kernel(cfg.grid, cfg.scan, ranges, poses,
                                  origins)),
        device_ms=device_ms(lambda: kernel(cfg.grid, cfg.scan, ranges, poses,
                                           origins), "sensor_model_kernel"),
        plain_ms=cuda_ms(lambda: plain(cfg.grid, cfg.scan, ranges, poses,
                                       origins)),
        **bound(*L.sensor_model_cost(cfg.grid, cfg.scan, ranges, poses,
                                     origins)))
    row["bound_share"] = row["bound_ms"] / row["ms"]
    return row


def phase_refuse(torch, cfg, world, seed: int):
    """The closure re-fuse: every ring slot of every robot (R * max_poses
    scans) into an empty grid, as `fleet._close_loops` does."""
    from jax_mapping_torch.ops import _cuda
    from jax_mapping_torch.ops import grid as G
    from jax_mapping_torch.sim import lidar
    dev = world.device
    res = cfg.grid.resolution_m
    n_samples = int(cfg.scan.range_max_m / (res * 0.5))
    N = cfg.fleet.n_robots * cfg.loop.max_poses
    gen = torch.Generator().manual_seed(seed + 2)
    poses = _poses_near_walls(torch, cfg, world, N, gen)
    ranges = torch.cat([lidar.simulate_scans(cfg.scan, world, res, n_samples,
                                             poses[s:s + 512])
                        for s in range(0, N, 512)])
    mask = torch.ones(N, dtype=torch.bool, device=dev)
    empty = G.empty_grid(cfg.grid, dev)
    G.fuse_scans_masked(cfg.grid, cfg.scan, empty, ranges[:64], poses[:64],
                        mask[:64])                       # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    before = _cuda.LAUNCHES["sensor_model_delta"]
    t0 = time.perf_counter()
    out = G.fuse_scans_masked(cfg.grid, cfg.scan, empty, ranges, poses, mask)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    check(bool(torch.isfinite(out).all()), "re-fused grid non-finite")
    check(int((out > cfg.grid.occ_threshold).sum()) > 0,
          "re-fuse mapped nothing")
    emit({"phase": "refuse", "scans": N, "ms": ms,
          "peak_mem_bytes": torch.cuda.max_memory_allocated(),
          "peak_above_inputs_bytes": torch.cuda.max_memory_allocated() - base,
          "k1_launches": _cuda.LAUNCHES["sensor_model_delta"] - before,
          "occ_cells": int((out > cfg.grid.occ_threshold).sum()),
          "free_cells": int((out < cfg.grid.free_threshold).sum())})
    return out


def phase_parity(torch, seed: int, ticks: int = 6, option_ticks: int = 4):
    """A tiny mission: from each CPU state, one tick on the card and one on
    the CPU with the same wheel noise; then the same with each frontier
    option on. The CPU path runs the plain versions; the card runs the
    kernels. The frontier assignment, computed from the same state on
    both, must agree exactly. Tolerances: sin/cos and the matcher's
    convolution round differently on the two devices, so a simulated beam
    may move by one sample step and a matched pose by a fine step; cells
    may differ on sensor-model boundaries. Then one relocalization streak
    and one merge (`_parity_recovery`)."""
    import dataclasses
    from jax_mapping_torch.config import tiny_config
    base = tiny_config(2)
    worst = _parity_mission(torch, base, seed, ticks)
    options = {}
    for name, kw in FLEET_OPTIONS.items():
        cfg = base.replace(frontier=dataclasses.replace(base.frontier, **kw))
        options[name] = _parity_mission(torch, cfg, seed, option_ticks)
    n_cells = base.grid.size_cells ** 2
    recovery = _parity_recovery(torch)
    megabatch = _parity_megabatch(torch, seed)
    emit({"phase": "parity", "config": "tiny_config(2)", "ticks": ticks,
          "worst": worst, "option_ticks": option_ticks, "options": options,
          "recovery": recovery, "cells_total": n_cells,
          "megabatch": megabatch})
    check(megabatch["pose_m"] <= 1e-2,
          f"parity (megabatch): estimates differ by {megabatch}")
    check(megabatch["cells"] <= 1e-3 * megabatch["cells_total"],
          f"parity (megabatch): {megabatch['cells']} grid cells differ")
    for name, w in (("default", worst), *options.items()):
        check(w["pose_m"] <= 1e-2 and w["yaw_rad"] <= 1e-2,
              f"parity ({name}): estimates differ by {w}")
        check(w["cells"] <= 1e-3 * n_cells,
              f"parity ({name}): {w['cells']} grid cells differ")


def _parity_mission(torch, cfg, seed: int, ticks: int) -> dict:
    from jax_mapping_torch import interop
    from jax_mapping_torch.models import fleet as FL
    from jax_mapping_torch.sim import world as W
    res = cfg.grid.resolution_m
    w = W.plank_course(cfg.grid.size_cells, res, n_planks=8, seed=0)
    w_cpu = torch.as_tensor(w)
    w_gpu = w_cpu.cuda()
    gen = torch.Generator().manual_seed(seed)
    st = FL.init_fleet_state(cfg, device="cpu", generator=gen)
    worst = {"pose_m": 0.0, "yaw_rad": 0.0, "cells": 0, "assigned": 0}
    for _ in range(ticks):
        normals = torch.randn((cfg.fleet.n_robots, 2), generator=gen)
        st_gpu = interop.fleet_state_from_numpy(
            interop.fleet_state_to_numpy(st), "cuda")
        g, gd = FL.fleet_step(cfg, st_gpu, res, w_gpu, wheel_normals=normals)
        st, cd = FL.fleet_step(cfg, st, res, w_cpu, wheel_normals=normals)
        check(torch.equal(gd.is_key.cpu(), cd.is_key), "parity: key gate")
        check(torch.equal(gd.loop_closed.cpu(), cd.loop_closed),
              "parity: loop closure")
        check(torch.equal(gd.frontiers.assignment.cpu(),
                          cd.frontiers.assignment), "parity: assignment")
        worst["assigned"] += int((cd.frontiers.assignment >= 0).sum())
        dp = (g.est_poses.cpu() - st.est_poses).abs()
        worst["pose_m"] = max(worst["pose_m"], float(dp[:, :2].max()))
        worst["yaw_rad"] = max(worst["yaw_rad"], float(dp[:, 2].max()))
        worst["cells"] = max(worst["cells"],
                             int((g.grid.cpu() != st.grid).sum()))
    return worst


# ---------------------------------------------------------------------------

def _is_sync(w) -> bool:
    """A warning of PyTorch's CUDA sync debug mode that flags a
    synchronising call (not its one-time notice that the mode is a
    prototype, which also names synchronisation)."""
    msg = str(w.message)
    return "synchroniz" in msg and "prototype feature" not in msg


#: One warning raised inside a `SyncWindow`, with the whole Python stack
#: at the moment it was raised as (filename, lineno) pairs, outermost
#: frame first.
SyncRecord = collections.namedtuple(
    "SyncRecord", "message category filename lineno stack")


#: Every host sync any `SyncWindow` recorded in this run, in order: the
#: analysis phase holds each one's stack against the A1 checker.
SYNC_LOG: list = []


class SyncWindow:
    """PyTorch's CUDA sync debug mode over a block, which warns at every
    synchronising call. Each warning is kept with the Python stack at the
    moment it is raised (the frames' files and lines, walked in a
    `warnings.showwarning` hook with no source-line lookup): a C++
    warning's own file and line are only the innermost Python frame,
    often inside `torch/`. `records` are
    the block's warnings in order, `syncs` counts those that flag a
    synchronising call, and every such one is also appended to SYNC_LOG.
    A window opened inside another keeps its warnings to itself, as
    `warnings.catch_warnings(record=True)` does, and the mode in force
    before a window is restored after it. With `armed=False` the window
    records nothing and leaves the mode alone."""

    def __init__(self, torch, armed: bool = True):
        self.torch, self.armed = torch, armed
        self.records: list = []

    def __enter__(self):
        import warnings
        self._cm = warnings.catch_warnings()
        self._cm.__enter__()
        if self.armed:
            warnings.simplefilter("always")
            warnings.showwarning = self._show
            self._mode = self.torch.cuda.get_sync_debug_mode()
            self.torch.cuda.set_sync_debug_mode("warn")
        return self

    def _show(self, message, category, filename, lineno, file=None,
              line=None):
        import traceback
        stack = [(f.f_code.co_filename, n)
                 for f, n in traceback.walk_stack(sys._getframe(1))]
        rec = SyncRecord(message, category, filename, lineno, stack[::-1])
        self.records.append(rec)
        if _is_sync(rec):
            SYNC_LOG.append(rec)

    def __exit__(self, *exc):
        try:
            if self.armed:
                self.torch.cuda.set_sync_debug_mode(self._mode)
        finally:
            self._cm.__exit__(*exc)
        return False

    def __len__(self) -> int:
        return len(self.records)

    @property
    def syncs(self) -> int:
        return sum(_is_sync(r) for r in self.records)


def _count_syncs(torch, fn):
    """(fn(), host syncs it made), counted in a `SyncWindow`."""
    with SyncWindow(torch) as win:
        out = fn()
    return out, win.syncs


def _p50_p90(xs) -> dict:
    q = statistics.quantiles(xs, n=10) if len(xs) > 1 else xs
    return {"p50": statistics.median(xs), "p90": q[-1]}


class _Drive:
    """8 robots, each on a 0.4 m circle whose centre is 3.5 m from two
    walls of rooms_world (a wall crossing), at 0.1 m/s: a 16-scan window
    covers 0.16 m, so every window's last scan passes the 0.1 m key gate,
    and the two single scans after it (0.01 and 0.02 m) do not. True
    poses follow the commanded wheel speeds; the measured ones carry 2%
    noise from a torch.Generator."""

    RADIUS = 0.4
    SPEED = 0.1
    DT = 0.1

    def __init__(self, torch, cfg, seed: int):
        from jax_mapping_torch.ops.odometry import twist_to_wheel_units
        from jax_mapping_torch.sim import world as W
        self.torch, self.cfg = torch, cfg
        dev = torch.device(DEV)
        n, res = cfg.grid.size_cells, cfg.grid.resolution_m
        self.world = torch.as_tensor(W.rooms_world(n, res, seed=1),
                                     device=dev)
        self.n_samples = int(cfg.scan.range_max_m / (res * 0.5))
        walls = [int(n * f) for f in (0.33, 0.66)]   # rooms_world's walls
        centres = []
        for wx in walls:
            for wy in walls:
                for s in (1, -1):
                    # The wall's face on side s, then 3.5 m into the room.
                    fx = (wx + (2 if s > 0 else 0) - n / 2) * res
                    fy = (wy + (2 if s > 0 else 0) - n / 2) * res
                    centres.append((fx + 3.5 * s, fy + 3.5 * s))
        R = cfg.fleet.n_robots
        c = torch.tensor(centres[:R], dtype=torch.float32, device=dev)
        self.truth = torch.stack([c[:, 0] + self.RADIUS, c[:, 1],
                                  torch.full((R,), math.pi / 2,
                                             device=dev)], 1)
        wl, wr = twist_to_wheel_units(cfg.robot, self.SPEED,
                                      self.SPEED / self.RADIUS)
        self.cmd = torch.tensor([wl, wr], dtype=torch.float32, device=dev)
        self.gen = torch.Generator().manual_seed(seed)

    def next(self, n_scans: int):
        """The next n_scans of every robot: ((R, n, beams) scans at the
        true poses, (R, n, 2) measured wheel speeds). The true poses stay
        in `self.poses`."""
        from jax_mapping_torch.ops.odometry import rk2_step
        from jax_mapping_torch.sim import lidar
        torch, cfg = self.torch, self.cfg
        R = self.truth.shape[0]
        dt = torch.tensor(self.DT, device=self.truth.device)
        poses = []
        for _ in range(n_scans):
            self.truth = rk2_step(cfg.robot, self.truth, self.cmd[0],
                                  self.cmd[1], dt)
            poses.append(self.truth)
        poses = torch.stack(poses, 1)                          # (R, n, 3)
        self.poses = poses
        scans = lidar.simulate_scans(
            cfg.scan, self.world, cfg.grid.resolution_m, self.n_samples,
            poses.reshape(R * n_scans, 3)).reshape(R, n_scans, -1)
        noise = torch.randn((R, n_scans, 2), generator=self.gen).to(
            self.truth.device)
        return scans, self.cmd * (1.0 + 0.02 * noise)


def phase_mapper(torch, cfg, seed: int, ticks: int = 10, on_tick=None):
    """Slice 2's main path, as `MapperNode` runs it: per robot, its own
    SlamState on the shared grid; the shared grid becomes each step's
    output grid. `on_tick(grid, poses)` runs after each timed tick."""
    import dataclasses
    from jax_mapping_torch.models import slam as S
    from jax_mapping_torch.ops import _cuda
    W = cfg.fleet.batch_scans
    drive = _Drive(torch, cfg, seed)
    R = cfg.fleet.n_robots
    states = [S.init_state(cfg, drive.truth[r], DEV) for r in range(R)]
    check(states[0].grid.device.type == DEV, "SLAM state not on the card")
    shared = states[0].grid

    def robot_tick(r, scans, wheels, c=cfg, times=None, diags=None):
        t0 = time.perf_counter()
        st, d = S.slam_step_window(c, states[r]._replace(grid=shared),
                                   scans[r, :W], wheels[r, :W], drive.DT)
        torch.cuda.synchronize()
        if times is not None:
            times["window"].append((time.perf_counter() - t0) * 1e3)
            diags.append(d)
        for j in range(W, scans.shape[1]):
            t0 = time.perf_counter()
            st, d = S.slam_step(c, st, scans[r, j], wheels[r, j, 0],
                                wheels[r, j, 1], drive.DT)
            torch.cuda.synchronize()
            if times is not None:
                times["single"].append((time.perf_counter() - t0) * 1e3)
                diags.append(d)
        return st

    torch.cuda.synchronize()
    _cuda.reset_launches()
    tick_ms, times, diags = [], {"window": [], "single": []}, []
    with BatchCount(cfg.grid) as bc:
        for _ in range(ticks):
            scans, wheels = drive.next(W + 2)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for r in range(R):
                states[r] = robot_tick(r, scans, wheels, times=times,
                                       diags=diags)
                shared = states[r].grid
            torch.cuda.synchronize()
            tick_ms.append((time.perf_counter() - t0) * 1e3)
            if on_tick is not None:
                # The publish's launches go on its own line.
                saved = (dict(_cuda.LAUNCHES),
                         {k: dict(v) for k, v in _cuda.ROUTES.items()})
                on_tick(shared, torch.stack([s.pose for s in states]))
                _cuda.LAUNCHES.update(saved[0])
                for k, v in saved[1].items():
                    _cuda.ROUTES[k].clear()
                    _cuda.ROUTES[k].update(v)
    launches = dict(_cuda.LAUNCHES)
    truth = drive.truth.clone()

    # Host syncs of one step of each kind, and the purity of a step.
    scans, wheels = drive.next(W + 2)
    before = shared.clone()
    (st, d), n_window = _count_syncs(torch, lambda: S.slam_step_window(
        cfg, states[0]._replace(grid=shared), scans[0, :W], wheels[0, :W],
        drive.DT))
    (_, d1), n_single = _count_syncs(torch, lambda: S.slam_step(
        cfg, st, scans[0, W], wheels[0, W, 0], wheels[0, W, 1], drive.DT))
    check(torch.equal(before, shared), "a SLAM step changed its input grid")
    del before

    # fused_fusion=False: the window sum goes through K4, then apply_patch.
    cfg_k4 = cfg.replace(grid=dataclasses.replace(cfg.grid,
                                                  fused_fusion=False))
    _cuda.reset_launches()
    for r in range(3):
        out = robot_tick(r, scans, wheels, c=cfg_k4)
        check(bool(torch.isfinite(out.grid).all()), "K4 window non-finite")
    torch.cuda.synchronize()
    launches_k4 = dict(_cuda.LAUNCHES)

    stages = _mapper_stages(torch, cfg, states[0]._replace(grid=shared),
                            scans[0], wheels[0], drive.DT)
    busy = _mapper_profile(torch, lambda: [
        robot_tick(r, scans, wheels) for r in range(R)])

    grid = shared
    occ = int((grid > cfg.grid.occ_threshold).sum())
    free = int((grid < cfg.grid.free_threshold).sum())
    n_scans = R * (W + 2)
    steady = tick_ms[1:] if len(tick_ms) > 1 else tick_ms
    matched = sum(int(d.matched) for d in diags)
    keys = sum(int(d.key_added) for d in diags)
    out = {"phase": "mapper", "ticks": ticks, "robots": R, "window": W,
           "scans_per_tick": n_scans, "first_tick_ms": tick_ms[0],
           "tick_ms": _p50_p90(steady),
           "window_step_ms": _p50_p90(times["window"][R:]),
           "single_step_ms": _p50_p90(times["single"][2 * R:]),
           "scans_per_s": n_scans / (statistics.median(steady) / 1e3),
           "matched": matched, "key_steps": keys, "steps": len(diags),
           "n_keyscans": [int(s.n_keyscans) for s in states],
           "occ_cells": occ, "free_cells": free,
           "host_syncs": {"window_step": n_window,
                          "single_step": n_single,
                          "single_step_was_key": bool(d1.key_added)},
           "launches": launches,
           "launches_per_tick": {k: v / ticks for k, v in launches.items()},
           "k1_launches_per_tick_by_batch": bc.per_tick(ticks),
           "launches_fused_fusion_false_3_windows": launches_k4,
           "window_step_stages_ms": stages, "profiled_tick": busy,
           "pose_err_m": [float(torch.dist(s.pose[:2], truth[r, :2]))
                          for r, s in enumerate(states)]}
    emit(out)
    check(bool(torch.isfinite(grid).all()), "mapper grid non-finite")
    check(all(bool(torch.isfinite(s.pose).all()) for s in states),
          "non-finite SLAM pose")
    check(matched > 0, "no match was accepted in the mapper phase")
    check(occ > 0, "the mapper mapped no occupied cell")
    for name in ("sensor_model_delta", "sensor_model_raster",
                 "window_apply"):
        check(launches[name] > 0, f"kernel {name} never launched on the "
              "mapper path")
    check(launches_k4["window_delta"] > 0,
          "kernel window_delta never launched with fused_fusion=False")
    return out


def _mapper_stages(torch, cfg, st, scans, wheels, dt) -> dict:
    """Time of each stage of one window step, called alone on `st`
    (CUDA-event medians; the stages are host-bound, so these include the
    host's gaps between launches)."""
    from jax_mapping_torch.models import slam as S
    from jax_mapping_torch.ops import grid as G
    from jax_mapping_torch.ops import posegraph as PG
    from jax_mapping_torch.ops import scan_match as M
    from jax_mapping_torch.ops.odometry import rk2_step
    W = cfg.fleet.batch_scans
    dtt = torch.full((), dt, device=st.pose.device)

    def integrate():
        p, out = st.pose, []
        for i in range(W):
            p = rk2_step(cfg.robot, p, wheels[i, 0], wheels[i, 1], dtt)
            out.append(p)
        return torch.stack(out)

    poses = integrate()
    k = int(st.graph.n_poses)

    def graph_ops():
        g = PG.add_pose(st.graph, poses[-1])
        g = PG.odometry_edge(g, k - 1, k) if k > 0 else g
        return PG.loop_candidate(cfg.loop, PG.batch1(g),
                                 torch.full((1,), k, dtype=torch.int32,
                                            device=poses.device))
    stages = {
        "integrate": integrate,
        "window_agreement": lambda: S._window_agreement(
            cfg, st.grid, scans[:W - 1], poses[:W - 1]),
        "fuse_scans_window_checked": lambda: G.fuse_scans_window_checked(
            cfg.grid, cfg.scan, st.grid, scans[:W - 1], poses[:W - 1]),
        "match": lambda: M.match(cfg.grid, cfg.scan, cfg.matcher, st.grid,
                                 scans[W - 1], poses[-1]),
        "fuse_scan": lambda: G.fuse_scan(cfg.grid, cfg.scan, st.grid,
                                         scans[W - 1], poses[-1]),
        "graph_and_loop_candidate": graph_ops,
        "window_step": lambda: S.slam_step_window(cfg, st, scans[:W],
                                                  wheels[:W], dt),
    }
    return {k: cuda_ms(f, reps=5, warmup=1) for k, f in stages.items()}


def _mapper_profile(torch, fn) -> dict:
    """One call of fn under torch.profiler: wall time, the time in which
    any stream ran a kernel or copy, and the device's busy share."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    spans = [(float(e["ts"]), float(e["ts"]) + float(e["dur"]))
             for e in _device_events(prof)]
    busy_ms = _union_us(spans) / 1e3
    return {"wall_ms": wall_ms, "device_busy_ms": busy_ms,
            "device_busy_share": busy_ms / wall_ms if spans else None,
            "device_ops": len(spans)}


def _bench_window(torch, cfg, B: int):
    """bench.py's window workload: B scans on a 0.4 m loop, ranges
    uniform 1-10 m with 5% dropouts (numpy seed 0)."""
    import numpy as np
    s = cfg.scan
    rng = np.random.default_rng(0)
    t = np.linspace(0, 2 * math.pi, B, endpoint=False)
    poses = np.stack([0.4 * np.cos(t), 0.4 * np.sin(t), t + math.pi / 2],
                     axis=1).astype(np.float32)
    ranges = rng.uniform(1.0, 10.0, (B, s.padded_beams)).astype(np.float32)
    ranges[:, s.n_beams:] = 0.0
    ranges[rng.random((B, s.padded_beams)) < 0.05] = 0.0
    return (torch.as_tensor(ranges, device=DEV),
            torch.as_tensor(poses, device=DEV))


def phase_window(torch, cfg):
    """`fuse_scans_window` on the bench's workload, B = 256 (one K5
    launch) and B = 1024 (two K4 subtotals, then one apply)."""
    from jax_mapping_torch.ops import _cuda
    from jax_mapping_torch.ops import grid as G
    from jax_mapping_torch.ops import sensor_kernel as SK
    out = {"phase": "window"}
    empty = G.empty_grid(cfg.grid, DEV)
    for B in (256, 1024):
        ranges, poses = _bench_window(torch, cfg, B)
        origin = G.patch_origin(cfg.grid, poses[:, :2].mean(dim=0))
        fits = bool(SK.window_fits(cfg.grid, poses, origin))
        check(fits, f"the {B}-scan window does not fit its patch")
        before = dict(_cuda.LAUNCHES)
        res = G.fuse_scans_window(cfg.grid, cfg.scan, empty, ranges, poses)
        torch.cuda.synchronize()
        used = {k: v - before[k] for k, v in _cuda.LAUNCHES.items()
                if v != before[k]}
        check(bool(torch.isfinite(res).all()), "window grid non-finite")
        check(int((res != 0).sum()) > 0, "the window changed no cell")
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        G.fuse_scans_window(cfg.grid, cfg.scan, empty, ranges, poses)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated()
        ms = cuda_ms(lambda: G.fuse_scans_window(cfg.grid, cfg.scan, empty,
                                                 ranges, poses))
        out[f"b{B}"] = {"fits": fits, "ms": ms, "scans_per_s": B / ms * 1e3,
                        "launches_per_call": used,
                        "peak_mem_bytes": peak,
                        "peak_above_inputs_bytes": peak - base,
                        "changed_cells": int((res != 0).sum())}
    emit(out)
    return out


def _window_inputs(torch, cfg, world, B: int, gen):
    """B scans on a 0.4 m loop around a pose near walls whose loop fits
    one shared patch (a pose near the border may not): scans that see
    walls."""
    from jax_mapping_torch.ops import grid as G
    from jax_mapping_torch.ops import sensor_kernel as SK
    from jax_mapping_torch.sim import lidar
    res = cfg.grid.resolution_m
    t = torch.linspace(0, 2 * math.pi, B + 1, device=world.device)[:B]
    for c in _poses_near_walls(torch, cfg, world, 64, gen):
        poses = torch.stack([c[0] + 0.4 * torch.cos(t),
                             c[1] + 0.4 * torch.sin(t), c[2] + t],
                            1).contiguous()
        origin = G.patch_origin(cfg.grid, poses[:, :2].mean(dim=0))
        if bool(SK.window_fits(cfg.grid, poses, origin)):
            break
    ranges = lidar.simulate_scans(cfg.scan, world, res,
                                  int(cfg.scan.range_max_m / (res * 0.5)),
                                  poses)
    return ranges, poses, origin


def window_kernel_rows(torch, cfg, world, mapped, seed: int,
                       mapper: dict) -> dict:
    """K4 and K5 against their plain versions at B = 15 (the mapper's
    W - 1), 16, 17 (more than one 16-scan chunk) and 256, on scans near
    walls; K5 on a copy of a mapped grid. No single PyTorch call computes
    either function (library_ms none). Launches per mapper tick: K5 at
    the default fused_fusion=True, K4 per window with fused_fusion=False.
    The bound counts the function's work: 56 operations (the model and
    the add) per scan and cell within its max range, 3 per cell for the
    apply."""
    per_tick = mapper["launches_per_tick"]
    k4_per_window = (mapper["launches_fused_fusion_false_3_windows"]
                     ["window_delta"] / 3)
    from jax_mapping_torch.ops import fuse_kernel as FK
    from jax_mapping_torch.ops import sensor_kernel as SK
    gen = torch.Generator().manual_seed(seed + 4)
    P = cfg.grid.patch_cells
    nb = cfg.scan.padded_beams
    rows = {}
    for B in (15, 16, 17, 256):
        ranges, poses, origin = _window_inputs(torch, cfg, world, B, gen)
        check(bool(SK.window_fits(cfg.grid, poses, origin)),
              "kernel-check window does not fit its patch")
        origins = origin.reshape(1, 2).expand(B, 2)
        cells = SK.model_cells(cfg.grid, poses, origins)
        shares = _class_shares(cfg, ranges, poses, origins, False)
        got = SK.window_delta(cfg.grid, cfg.scan, ranges, poses, origin)
        want = SK.window_delta_plain(cfg.grid, cfg.scan, ranges, poses,
                                     origin)
        cmp = compare(got, want)
        cmp["nonzero_cells"] = int((want != 0).sum())
        rows[f"window_delta_b{B}"] = dict(
            cmp, shape=[B, P, P], cells_within_range=cells,
            class_shares=shares,
            launches_per_mapper_tick=per_tick["window_delta"],
            launches_per_window_fused_fusion_false=k4_per_window,
            library_ms=None,
            ms=cuda_ms(lambda: SK.window_delta(cfg.grid, cfg.scan, ranges,
                                               poses, origin)),
            device_ms=device_ms(lambda: SK.window_delta(
                cfg.grid, cfg.scan, ranges, poses, origin), "window_kernel"),
            plain_ms=cuda_ms(lambda: SK.window_delta_plain(
                cfg.grid, cfg.scan, ranges, poses, origin)),
            **bound(*L.window_delta_cost(cfg.grid, cfg.scan, ranges,
                                         poses, origin)))
        got_g, want_g = mapped.clone(), mapped.clone()
        FK.window_apply(cfg.grid, cfg.scan, got_g, ranges, poses, origin)
        FK.window_apply_plain(cfg.grid, cfg.scan, want_g, ranges, poses,
                              origin)
        cmp = compare(got_g, want_g)
        cmp["changed_cells"] = int((want_g != mapped).sum())
        scratch = mapped.clone()
        rows[f"window_apply_b{B}"] = dict(
            cmp, shape=[B, P, P], cells_within_range=cells,
            class_shares=shares,
            launches_per_mapper_tick=per_tick["window_apply"],
            library_ms=None,
            ms=cuda_ms(lambda: FK.window_apply(cfg.grid, cfg.scan, scratch,
                                               ranges, poses, origin)),
            device_ms=device_ms(lambda: FK.window_apply(
                cfg.grid, cfg.scan, scratch, ranges, poses, origin),
                "window_kernel"),
            plain_ms=cuda_ms(lambda: FK.window_apply_plain(
                cfg.grid, cfg.scan, scratch, ranges, poses, origin)),
            **bound(*L.window_apply_cost(cfg.grid, cfg.scan, ranges,
                                         poses, origin)))
        for k in ("window_delta", "window_apply"):
            r = rows[f"{k}_b{B}"]
            r["bound_share"] = r["bound_ms"] / r["ms"]
        del got_g, want_g, scratch
    return rows


#: Edge cases of the kernels' tile class, each checked for K1 (both
#: modes), K4 and K5 against the plain versions.
EDGE_CASES = ("pose_outside_patch", "pose_on_tile_corner",
              "yaw_beyond_pi_and_2pi", "yaw_beyond_4pi", "all_zero_ranges",
              "hits_at_max_range")


def _edge_inputs(torch, cfg, world, case: str, gen):
    """17 scans near walls (more than one 16-scan chunk for K4/K5), with
    the poses or ranges of `case`; origins at the undisturbed poses."""
    from jax_mapping_torch.ops import grid as G
    from jax_mapping_torch.sim import lidar
    g, s = cfg.grid, cfg.scan
    res = g.resolution_m
    B = 17
    poses = _poses_near_walls(torch, cfg, world, B, gen)
    ranges = lidar.simulate_scans(s, world, res,
                                  int(s.range_max_m / (res * 0.5)), poses)
    origins = G.patch_origin(g, poses[:, :2]).contiguous()
    poses = poses.clone()
    k = torch.arange(B, device=poses.device)
    if case == "pose_outside_patch":
        poses[:, 0] += 0.75 * g.patch_cells * res
        poses[:, 1] -= 0.6 * g.patch_cells * res
    elif case == "pose_on_tile_corner":
        ox, oy = g.origin_m
        t = 16 * (1 + k % (g.patch_cells // 16 - 1))
        poses[:, 0] = (origins[:, 1] + t).to(torch.float32) * res + ox
        poses[:, 1] = (origins[:, 0] + t.flip(0)).to(torch.float32) * res + oy
    elif case == "yaw_beyond_pi_and_2pi":
        vals = torch.tensor([3.5, -3.5, 2 * math.pi, -2 * math.pi, 5.0, -6.0],
                            device=poses.device)
        poses[:, 2] = vals[k % len(vals)]
    elif case == "yaw_beyond_4pi":
        vals = torch.tensor([4 * math.pi, -4 * math.pi, 13.0, -40.0, 63.0],
                            device=poses.device)
        poses[:, 2] = vals[k % len(vals)]
    elif case == "all_zero_ranges":
        ranges = torch.zeros_like(ranges)
    elif case == "hits_at_max_range":
        ranges = torch.full_like(ranges, g.max_range_m)
        ranges[:, s.n_beams:] = 0.0
    return ranges.contiguous(), poses.contiguous(), origins


def edge_rows(torch, cfg, world, mapped, gen) -> dict:
    """Each edge case through K1 (delta and raster, own origins) and K4/K5
    (all 17 scans on the patch at the first scan's origin), compared
    exactly with the plain versions; not timed."""
    from jax_mapping_torch.ops import fuse_kernel as FK
    from jax_mapping_torch.ops import sensor_kernel as SK
    rows = {}
    for case in EDGE_CASES:
        r, p, o = _edge_inputs(torch, cfg, world, case, gen)
        for raster in (False, True):
            kernel = SK.scan_rasters if raster else SK.scan_deltas
            plain = SK.scan_rasters_plain if raster else SK.scan_deltas_plain
            want = plain(cfg.grid, cfg.scan, r, p, o)
            rows[f"edge_{'raster' if raster else 'delta'}_{case}"] = dict(
                compare(kernel(cfg.grid, cfg.scan, r, p, o), want),
                nonzero_cells=int((want != 0).sum()),
                class_shares=_class_shares(cfg, r, p, o, raster))
        origin = o[0].contiguous()
        want = SK.window_delta_plain(cfg.grid, cfg.scan, r, p, origin)
        rows[f"edge_window_delta_{case}"] = dict(
            compare(SK.window_delta(cfg.grid, cfg.scan, r, p, origin), want),
            nonzero_cells=int((want != 0).sum()))
        got_g, want_g = mapped.clone(), mapped.clone()
        FK.window_apply(cfg.grid, cfg.scan, got_g, r, p, origin)
        FK.window_apply_plain(cfg.grid, cfg.scan, want_g, r, p, origin)
        rows[f"edge_window_apply_{case}"] = compare(got_g, want_g)
        del got_g, want_g
    return rows


def phase_slam_parity(torch, seed: int, steps: int = 6):
    """A tiny single robot near a room corner, alternating 4-scan windows
    and single scans: from each CPU state one step on the card and one on
    the CPU with the same scans and wheel speeds. Tolerances as the fleet
    parity phase."""
    from jax_mapping_torch import interop
    from jax_mapping_torch.config import tiny_config
    from jax_mapping_torch.models import slam as S
    from jax_mapping_torch.ops.odometry import rk2_step, twist_to_wheel_units
    from jax_mapping_torch.sim import lidar
    from jax_mapping_torch.sim import world as Wd
    cfg = tiny_config()
    res = cfg.grid.resolution_m
    w = torch.as_tensor(Wd.rooms_world(cfg.grid.size_cells, res))
    gen = torch.Generator().manual_seed(seed)
    st = S.init_state(cfg, torch.tensor([1.4, 1.0, math.pi / 2]), "cpu")
    truth = st.pose
    wl, wr = twist_to_wheel_units(cfg.robot, 0.3, 0.75)
    worst = {"pose_m": 0.0, "yaw_rad": 0.0, "cells": 0}
    keys = 0
    dt = torch.tensor(0.1)
    for t in range(steps):
        n = 4 if t % 2 == 0 else 1
        tp = []
        for _ in range(n):
            truth = rk2_step(cfg.robot, truth, torch.tensor(wl),
                             torch.tensor(wr), dt)
            tp.append(truth)
        scans = lidar.simulate_scans(cfg.scan, w, res, 120, torch.stack(tp))
        wheels = torch.tensor([wl, wr]) * (
            1.0 + 0.02 * torch.randn((n, 2), generator=gen))
        on_card = interop.slam_state_from_numpy(
            interop.slam_state_to_numpy(st), DEV)
        if n > 1:
            g, gd = S.slam_step_window(cfg, on_card, scans.to(DEV),
                                       wheels.to(DEV), 0.1)
            st, cd = S.slam_step_window(cfg, st, scans, wheels, 0.1)
        else:
            g, gd = S.slam_step(cfg, on_card, scans[0].to(DEV), wheels[0, 0],
                                wheels[0, 1], 0.1)
            st, cd = S.slam_step(cfg, st, scans[0], wheels[0, 0],
                                 wheels[0, 1], 0.1)
        check(bool(gd.key_added) == bool(cd.key_added), "slam parity: key")
        check(bool(gd.loop_closed) == bool(cd.loop_closed),
              "slam parity: loop closure")
        keys += int(cd.key_added)
        dp = (g.pose.cpu() - st.pose).abs()
        worst["pose_m"] = max(worst["pose_m"], float(dp[:2].max()))
        worst["yaw_rad"] = max(worst["yaw_rad"], float(dp[2]))
        worst["cells"] = max(worst["cells"],
                             int((g.grid.cpu() != st.grid).sum()))
    n_cells = cfg.grid.size_cells ** 2
    emit({"phase": "slam_parity", "config": "tiny_config()", "steps": steps,
          "key_steps": keys, "worst": worst, "cells_total": n_cells})
    check(keys > 0, "slam parity: no key step")
    check(worst["pose_m"] <= 1e-2 and worst["yaw_rad"] <= 1e-2,
          f"slam parity: poses differ by {worst}")
    check(worst["cells"] <= 1e-3 * n_cells,
          f"slam parity: {worst['cells']} grid cells differ")


# ---------------------------------------------------------------------------
# Slice 7: the exploration-planning path (frontier options, incremental
# publish, goal planner), on K2 and K3
# ---------------------------------------------------------------------------

#: The frontier options of the fleet tick, each on in turn.
FLEET_OPTIONS = {"planned_goals": {"planned_goals": True},
                 "decay_aware": {"decay_aware": True},
                 "exact_bfs": {"exact_bfs": True}}

#: K3 launches a tick under each option: the assignment's three
#: multigrid levels, three more for planned_goals' target-seeded fields;
#: exact_bfs runs one 256^2 field a robot instead, every robot's (and
#: every tenant's) in one launch with a blocked mask per field.
OPTION_K3_PER_TICK = {"planned_goals": 6, "decay_aware": 3, "exact_bfs": 1}

#: JAX's default ServingConfig.tile_cells: the publish's tile.
PUBLISH_TILE = 256


class WaypointCount:
    """Collects the validity of the planned waypoints `fleet_step` steers
    at while the context is open (tensors, summed once after)."""

    def __enter__(self):
        from jax_mapping_torch.ops import frontier as F
        self.f, self.orig, self.valid = F, F.assigned_waypoints, []

        def counted(*args, **kwargs):
            wp, ok = self.orig(*args, **kwargs)
            self.valid.append(ok)
            return wp, ok
        F.assigned_waypoints = counted
        return self

    def __exit__(self, *exc):
        self.f.assigned_waypoints = self.orig

    def n_valid(self) -> int:
        return sum(int(v.sum()) for v in self.valid)


class K3MaskCount:
    """Counts the K3 calls (`costfield.relax_sweeps`) with a blocked mask
    per field, more than one field (`exact_bfs`' one launch for every
    robot), while the context is open."""

    def __enter__(self):
        from jax_mapping_torch.ops import costfield as CF
        self.cf, self.orig, self.n = CF, CF.relax_sweeps, 0

        def counted(blocked, init, n_sweeps):
            if blocked.dim() == 3 and blocked.shape[0] == init.shape[0] > 1:
                self.n += 1
            return self.orig(blocked, init, n_sweeps)
        CF.relax_sweeps = counted
        return self

    def __exit__(self, *exc):
        self.cf.relax_sweeps = self.orig


class SweepRecorder:
    """Records the inputs of the first K2 (`frontier.label_sweeps`) and K3
    (`costfield.relax_sweeps`) call of each (name, shape, sweeps) while
    the context is open, so the kernels phase can hold those shapes
    against the plain versions. It keeps references, no copies (no caller
    writes into those tensors), and only one call a signature, so that a
    long drive's device memory does not grow with its calls."""

    def __enter__(self):
        from jax_mapping_torch.ops import costfield as CF
        from jax_mapping_torch.ops import frontier as F
        self.mods = ((CF, "relax_sweeps"), (F, "label_sweeps"))
        self.orig = [getattr(m, n) for m, n in self.mods]
        self.calls, self._seen = [], set()
        for (mod, name), fn in zip(self.mods, self.orig):
            setattr(mod, name, self._recorded(name, fn))
        return self

    def _recorded(self, name, fn):
        def recorded(mask, init, n_sweeps):
            sig = (name, tuple(init.shape), n_sweeps)
            if sig not in self._seen:
                self._seen.add(sig)
                self.calls.append((name, mask, init, n_sweeps))
            return fn(mask, init, n_sweeps)
        return recorded

    def __exit__(self, *exc):
        for (mod, name), fn in zip(self.mods, self.orig):
            setattr(mod, name, fn)


class K8Recorder:
    """Records the inputs of every K8 call (`match_kernel.window_scores`,
    dense, and `candidate_scores`, a candidate list) made while the
    context is open, in call order, by reference."""

    def __enter__(self):
        from jax_mapping_torch.ops import match_kernel as MK
        self.mk = MK
        self.orig = (MK.window_scores, MK.candidate_scores)
        self.calls = []
        MK.window_scores = self._recorded("dense", self.orig[0])
        MK.candidate_scores = self._recorded("list", self.orig[1])
        return self

    def _recorded(self, mode, fn):
        def recorded(*args):
            self.calls.append((mode, args))
            return fn(*args)
        return recorded

    def __exit__(self, *exc):
        self.mk.window_scores, self.mk.candidate_scores = self.orig


#: K8's relative tolerance against a float64 evaluation of the same sums.
K8_REL_TOL = 1e-6


def _k8_site_names(n_levels: int) -> list:
    """K8's call sites in one pruned `match_batch`, in call order: the
    top bound, the descent's levels from the coarsest, the fine angles,
    the level-1 covariance surface."""
    return (["top"] + [f"level{lv}" for lv in range(n_levels - 1, -1, -1)]
            + ["fine", "surface"])


def _k8_float64(args, mode: str):
    """A K8 call's scores, flat in output order, each sum in float64 from
    the same float32 inputs (tests/torch_kernel_inputs.py)."""
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import torch_kernel_inputs as KI
    if mode == "dense":
        fld, ras, mass, n_out, stride = args
        R, A, P, _ = ras.shape
        starts, _ = KI.dense_starts(R, A, *fld.shape[-2:], P, n_out, stride,
                                    fld.device)
    else:
        fld, ras, a_idx, oy, ox, mass = args
        starts = KI.list_starts(a_idx, oy, ox, *fld.shape[-2:],
                                ras.shape[-1])
    return KI.direct64(fld, ras, *starts, mass)


def _rel_err(got, want):
    """|got - want| / |want| elementwise, flat, in float64 (where want is
    0: 0 if got is 0 too, else 1)."""
    import torch
    got, want = got.double().reshape(-1), want.double().reshape(-1)
    err = (got - want).abs() / want.abs().clamp_min(1e-30)
    return torch.where(want == 0, (got != 0).double(), err)


def k8_rows(torch, cfg, grid, scans, guess, tenant=None) -> dict:
    """K8 at each of its call sites in one `match_batch` of `cfg` (R rows:
    8 robots on one map, or a tenant megabatch's rows with `tenant`), on
    the inputs that call gave it. Per site: the kernel against a float64
    evaluation of the same sums (`mismatches`: scores off it by more
    than K8_REL_TOL relative) and against its plain version on the same
    card tensors (TF32 off; it sums in another order, so the two may
    differ by K8's and the plain version's distances from the float64
    sums together), the wrapper's time, the kernels alone, the plain
    version's time, and the bound from the ledger's arithmetic. Row
    `match_correlate_b<R>` sums the sites: one `match_batch`'s K8 work,
    with the K8 launches that call made. `phase_kernels` checks them."""
    from jax_mapping_torch._util import full_f32
    from jax_mapping_torch.ops import _cuda
    from jax_mapping_torch.ops import match_kernel as MK
    from jax_mapping_torch.ops import scan_match as M

    def call():
        return M.match_batch(cfg.grid, cfg.scan, cfg.matcher, grid, scans,
                             guess, tenant=tenant)

    call()
    torch.cuda.synchronize()
    before = _cuda.LAUNCHES["match_correlate"]
    with K8Recorder() as rec:
        call()
    launches = _cuda.LAUNCHES["match_correlate"] - before
    _stride, n_steps = M.window_params(cfg.grid, cfg.matcher)
    names = _k8_site_names(M.bnb_num_levels(cfg.matcher, n_steps))
    check([m for m, _ in rec.calls] == ["dense"] + ["list"] * (
        len(names) - 3) + ["dense"] * 2,
        f"K8's calls in match_batch: {[m for m, _ in rec.calls]}")
    full_f32()
    R = scans.shape[0]
    rows, costs = {}, []
    for site, (mode, args) in zip(names, rec.calls):
        if mode == "dense":
            kernel, plain = MK.window_scores, MK.window_scores_plain
            fld, ras, mass = args[:3]
        else:
            kernel, plain = MK.candidate_scores, MK.candidate_scores_plain
            fld, ras, mass = args[0], args[1], args[5]
        got = kernel(*args)
        want = plain(*args)
        exact = _k8_float64(args, mode)
        rel = _rel_err(got, exact)
        cost = (L.match_correlate_cost(ras, fld, got.numel())
                if mode == "dense" else
                L.match_correlate_cost(ras, fld, got.numel(),
                                       index_bytes=3 * 8 * got.numel()))
        costs.append(cost)
        row = dict(
            shape=list(got.shape), raster=list(ras.shape),
            field=list(fld.shape), scores=got.numel(),
            mismatches=int((rel > K8_REL_TOL).sum()),
            float64_max_rel_err=float(rel.max()),
            plain_float64_max_rel_err=float(_rel_err(want, exact).max()),
            plain_max_rel_err=float(_rel_err(got, want).max()),
            max_abs_err=float((got.double() - want.double()).abs().max()),
            nonzero_tile_share=_tile_nonzero_share(torch, ras),
            ms=cuda_ms(lambda: kernel(*args)),
            device_ms=device_ms(lambda: kernel(*args), "correlate_",
                                per_call=True),
            plain_ms=cuda_ms(lambda: plain(*args), reps=5, warmup=1),
            library_ms=None, **bound(*cost))
        row["bound_share"] = row["bound_ms"] / row["ms"]
        rows[f"match_correlate_b{R}_{site}"] = row
        del got, want, exact, rel
    sites = list(rows.values())
    total = {k: (None if None in [v[k] for v in sites]
                 else sum(v[k] for v in sites))
             for k in ("ms", "device_ms", "plain_ms")}
    rows[f"match_correlate_b{R}"] = dict(
        sites=names, mismatches=sum(v["mismatches"] for v in sites),
        float64_max_rel_err=max(v["float64_max_rel_err"] for v in sites),
        plain_max_rel_err=max(v["plain_max_rel_err"] for v in sites),
        max_abs_err=max(v["max_abs_err"] for v in sites),
        launches_per_match_batch=launches, **total, library_ms=None,
        **bound(sum(c[0] for c in costs), sum(c[1] for c in costs)))
    return rows


def _tile_nonzero_share(torch, ras) -> float:
    """Share of K8's 32 x 32 raster tiles (ragged at the edge) that hold a
    non-zero cell: the tiles the kernel does not skip. Rasters are >= 0."""
    R, A, P, _ = ras.shape
    tiles = torch.nn.functional.max_pool2d(ras.reshape(R * A, 1, P, P), 32,
                                           ceil_mode=True)
    return float((tiles > 0).float().mean())


def _ulps(a, b):
    """Float32 ulps between a and b, elementwise (same-signed values)."""
    import numpy as np
    ia = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    ib = np.asarray(b, np.float32).view(np.int32).astype(np.int64)
    return np.abs(ia - ib)


class _Publisher:
    """The mapper's frontier publish (`IncrementalFrontierPipeline`, tile
    256) fed after each tick of the mapper drive: the tiles whose
    log-odds changed that tick get the tick's revision. Every publish is
    timed, its host syncs and K2/K3 launches counted, its mode read from
    the pipeline's counters, and its result held against the full
    `compute_frontiers` of the same inputs on the card."""

    def __init__(self, torch, cfg):
        import numpy as np
        from jax_mapping_torch.ops.frontier_incremental import \
            IncrementalFrontierPipeline
        self.torch, self.cfg = torch, cfg
        self.pipe = IncrementalFrontierPipeline(cfg.frontier, cfg.grid,
                                                PUBLISH_TILE, device=DEV)
        nt = cfg.grid.size_cells // PUBLISH_TILE
        self.tile_rev = np.zeros((nt, nt), np.int64)
        self.rev = 0
        self.grid = None
        self.poses = None
        self.last = None
        self.rows = []
        self.recorded = {}

    def tick(self, grid, poses):
        """After a mapper tick: mark the changed tiles, publish, then
        publish the same inputs again (the bridge's republish: a skip)."""
        self.mark(grid)
        self.poses = poses.cpu().numpy()
        self.publish("tick")
        self.publish("republish")

    def mark(self, grid):
        from jax_mapping_torch.ops import frontier as F
        if self.grid is None:
            changed = grid.new_ones(self.tile_rev.shape, dtype=self.torch.bool)
        else:
            changed = F._pool_any(grid != self.grid, PUBLISH_TILE)
        self.rev += 1
        self.tile_rev[changed.cpu().numpy()] = self.rev
        self.grid = grid.clone()

    def publish(self, what: str):
        import numpy as np
        from jax_mapping_torch.ops import _cuda
        from jax_mapping_torch.ops import frontier as F
        torch, cfg, pipe = self.torch, self.cfg, self.pipe
        before = dict(pipe.status())
        k_before = {k: _cuda.LAUNCHES[k] for k in ("label_prop",
                                                    "costfield_relax")}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with SweepRecorder() as rec:
            pub, n_sync = _count_syncs(torch, lambda: pipe.compute(
                self.grid, self.poses, self.tile_rev, self.rev))
        ms = (time.perf_counter() - t0) * 1e3
        launches = {k: _cuda.LAUNCHES[k] - v for k, v in k_before.items()}
        after = pipe.status()
        if not pub.recomputed:
            mode = "skip"
        elif after["n_field_reuses"] > before["n_field_reuses"]:
            mode = "reuse"
        elif after["n_warm_starts"] > before["n_warm_starts"]:
            mode = "warm"
        else:
            mode = "cold"
        full_refresh = after["n_full_refreshes"] > before["n_full_refreshes"]
        for name, mask, init, s in rec.calls:
            n = init.shape[-1]
            key = (f"{name}_publish_{mode}_n{n}_s{s}"
                   + (f"_r{init.shape[0]}" if init.dim() == 3 else ""))
            self.recorded.setdefault(key, (name, mask, init, s))
        poses_d = torch.as_tensor(self.poses, device=self.grid.device)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fr = F.compute_frontiers(cfg.frontier, cfg.grid, self.grid, poses_d)
        torch.cuda.synchronize()
        full_ms = (time.perf_counter() - t0) * 1e3
        want_t = fr.targets.cpu().numpy()
        ulps = _ulps(pub.targets, want_t)
        row = {"what": what, "mode": mode, "full_refresh": full_refresh,
               "ms": ms, "full_compute_frontiers_ms": full_ms,
               "host_syncs": n_sync, "launches": launches,
               "crop": list(pub.crop_rc),
               "dirty_tiles": after["cache_misses"] - before["cache_misses"],
               "clusters": int((pub.sizes > 0).sum()),
               "targets_bit_equal": int((ulps == 0).all(axis=1).sum()),
               "targets_max_ulps": int(ulps.max()),
               "sizes_equal": bool(np.array_equal(pub.sizes,
                                                  fr.sizes.cpu().numpy())),
               "assignment_equal": bool(np.array_equal(
                   pub.assignment, fr.assignment.cpu().numpy()))}
        self.rows.append(row)
        self.last = pub
        check(row["sizes_equal"] and row["assignment_equal"]
              and row["targets_max_ulps"] <= 1,
              f"publish ({what}, {mode}) differs from the full recompute: "
              f"{row}")
        return row


def phase_publish(torch, cfg, pub, mapped):
    """After the mapper drive's publishes: a publish with every robot
    moved to its BFS cell's centre (the carried fields are exact: reuse),
    one with every robot 1 m east (warm), then one on the re-fuse phase's
    map, whose tiles all changed (dense dirt: the full refresh)."""
    import numpy as np
    from jax_mapping_torch.ops import frontier as F
    pipe = pub.pipe
    drive_pub, drive_poses = pub.last, pub.poses.copy()
    res1 = cfg.grid.resolution_m * cfg.frontier.downsample
    c = cfg.frontier.cluster_downsample
    ox, oy = cfg.grid.origin_m
    bfs = pipe._robot_cells(pub.poses) // c
    centre = np.stack([(bfs[:, 1] * c + c / 2) * res1 + ox,
                       (bfs[:, 0] * c + c / 2) * res1 + oy], 1)
    pub.poses = np.concatenate([centre, pub.poses[:, 2:]], 1).astype(
        np.float32)
    pub.publish("poses_to_cell_centres")
    pub.poses[:, 0] += 1.0
    pub.publish("poses_1m_east")
    mapper_grid = pub.grid
    pub.mark(mapped)
    pub.publish("refuse_map")
    rows = pub.rows
    by_mode = {}
    for m in ("cold", "warm", "reuse", "skip"):
        sel = [r for r in rows if r["mode"] == m]
        if not sel:
            continue
        by_mode[m] = {
            "publishes": len(sel),
            "ms": _p50_p90([r["ms"] for r in sel]),
            "host_syncs": sorted({r["host_syncs"] for r in sel}),
            "launches_label_prop": sorted({r["launches"]["label_prop"]
                                           for r in sel}),
            "launches_costfield_relax": sorted(
                {r["launches"]["costfield_relax"] for r in sel}),
            "crop_spans": sorted({r["crop"][2] for r in sel}),
            "full_compute_frontiers_ms": _p50_p90(
                [r["full_compute_frontiers_ms"] for r in sel])}
    n_targets = len(rows) * cfg.frontier.max_clusters
    # The auction alone (robot by robot, as compute_frontiers runs it):
    # how many of a publish's host syncs are its.
    fr = pub.pipe.last_device_result
    _a, auction_syncs = _count_syncs(torch, lambda: F.assign_frontiers(
        fr.costs))
    out = {"phase": "publish", "tile_cells": PUBLISH_TILE,
           "host_syncs_assign_frontiers": auction_syncs,
           "publishes": len(rows), "by_mode": by_mode,
           "full_refreshes": sum(r["full_refresh"] for r in rows),
           "full_refresh_ms": [r["ms"] for r in rows if r["full_refresh"]],
           "targets_bit_equal": sum(r["targets_bit_equal"] for r in rows),
           "targets_compared": n_targets,
           "status": pipe.status(), "rows": rows}
    emit(out)
    for m in ("cold", "warm", "reuse", "skip"):
        check(m in by_mode, f"publish: no {m} publish")
    check(out["full_refreshes"] >= 2, "publish: no full refresh after the "
          "first publish")
    # The planner phase plans on the drive's map, for its robots and
    # the drive's last publish.
    pub.grid, pub.poses, pub.last = mapper_grid, drive_poses, drive_pub
    return out


def _planner_k3_inputs(torch, cfg, grid, goal):
    """(blocked, init, sweeps) of goal_field's K3 call, as goal_field
    builds them."""
    import dataclasses
    from jax_mapping_torch.ops import frontier as F
    from jax_mapping_torch.ops import planner as P
    free, _occ, unknown = F.coarsen(cfg.frontier, cfg.grid, grid)
    passable = free | F.frontier_mask(free, unknown) | unknown
    res = cfg.grid.resolution_m * cfg.frontier.downsample
    rc = P._world_to_cell(cfg.grid, res, goal, passable.shape[0])
    got = []
    F.cost_to_go(dataclasses.replace(cfg.frontier,
                                     bfs_iters=cfg.planner.bfs_iters),
                 passable, rc[None],
                 torch.ones(1, dtype=torch.bool, device=grid.device),
                 relax=lambda b, i, s: got.append((b, i, s)) or i)
    return got[0]


#: The planner phase's start (robot 0's circle, east of the vertical wall
#: of rooms_world(4096, 0.05, seed=1) at x = -34.85 m, whose door is at
#: y = 2.15 m) and goal (west of that wall; the mapper drive mapped the
#: wall on both sides from y -47 to -20 m).
PLAN_START = (-30.85, -31.25)
PLAN_GOAL = (-38.35, -31.25)


def phase_planner(torch, cfg, grid, poses, pub, reps: int = 5):
    """The planner node's calls on the mapper drive's map: `plan_to_goal`
    from behind a wall (a 1024^2 field of 1025 sweeps on K3's global
    route, then 256 descent steps), and one replan as the node runs it:
    one `goal_field` per distinct assigned frontier target of the last
    publish, one `descend_field` per robot."""
    import numpy as np
    from jax_mapping_torch.ops import _cuda
    from jax_mapping_torch.ops import planner as P
    pcfg, fcfg, g = cfg.planner, cfg.frontier, cfg.grid
    dev = grid.device
    start = torch.tensor(PLAN_START, device=dev)
    goal = torch.tensor(PLAN_GOAL, device=dev)
    plan = P.plan_to_goal(pcfg, fcfg, g, grid, goal, start)    # warm-up
    torch.cuda.synchronize()
    _cuda.reset_launches()
    plan, n_sync = _count_syncs(torch, lambda: P.plan_to_goal(
        pcfg, fcfg, g, grid, goal, start))
    torch.cuda.synchronize()
    launches = _cuda.LAUNCHES["costfield_relax"]
    routes = dict(_cuda.ROUTES["costfield_relax"])
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        plan = P.plan_to_goal(pcfg, fcfg, g, grid, goal, start)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    dist = P.goal_field(pcfg, fcfg, g, grid, goal)
    field_ms = cuda_ms(lambda: P.goal_field(pcfg, fcfg, g, grid, goal),
                       reps=reps, warmup=1)
    descend_ms = cuda_ms(lambda: P.descend_field(pcfg, fcfg, g, dist, goal,
                                                 start), reps=reps, warmup=1)
    _d, descend_syncs = _count_syncs(torch, lambda: P.descend_field(
        pcfg, fcfg, g, dist, goal, start))
    path = plan.path_xy[plan.path_valid].cpu()

    # The planner node's replan: a field per distinct assigned target.
    targets = pub.targets
    assignment = pub.assignment
    poses_d = torch.as_tensor(poses, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fields = {int(k): P.goal_field(pcfg, fcfg, g, grid, torch.as_tensor(
        targets[k], device=dev)) for k in np.unique(assignment[assignment >= 0])}
    plans = [P.descend_field(pcfg, fcfg, g, fields[int(a)], torch.as_tensor(
        targets[a], device=dev), poses_d[r, :2])
        for r, a in enumerate(assignment) if a >= 0]
    torch.cuda.synchronize()
    replan_ms = (time.perf_counter() - t0) * 1e3
    out = {"phase": "planner", "start": PLAN_START, "goal": PLAN_GOAL,
           "plan_to_goal_ms": _p50_p90(times), "plan_to_goal_runs_ms": times,
           "goal_field_ms": field_ms, "descend_field_ms": descend_ms,
           "reachable": bool(plan.reachable), "arrived": bool(plan.arrived),
           "n_steps": int(plan.n_steps),
           "path_end": path[-1].tolist() if len(path) else None,
           "path_max_y": float(path[:, 1].max()) if len(path) else None,
           "k3_launches_per_plan": launches, "k3_routes": routes,
           "host_syncs_plan_to_goal": n_sync,
           "host_syncs_descend_field": descend_syncs,
           "replan": {"goal_fields": len(fields), "descents": len(plans),
                      "reachable": sum(bool(p.reachable) for p in plans),
                      "ms": replan_ms}}
    emit(out)
    sweeps = 2 * pcfg.bfs_iters + 1
    check(bool(plan.reachable) and int(plan.n_steps) > 0,
          "planner: the goal behind the wall is unreachable")
    check(int(plan.n_steps) == pcfg.max_path_len
          or float(torch.dist(path[-1], goal.cpu())) <= 0.3,
          f"planner: the path ends at {path[-1].tolist()}, not the goal")
    check(bool(torch.isfinite(plan.path_xy).all()), "planner: non-finite")
    check(launches == sweeps and routes == {"global": sweeps},
          f"planner: K3 ran {routes}, not {sweeps} global launches")
    check(len(plans) > 0, "planner: no robot had an assigned target")
    check(descend_syncs == 0,
          f"planner: the descent made {descend_syncs} host syncs")
    return out, (dist, goal, start)


def phase_fleet_modes(torch, cfg, grid, seed: int, ticks: int = 10):
    """`fleet_step` with each frontier option on in turn, 8 robots where
    the mapper drive placed them on rooms_world(4096, 0.05, seed=1), its
    map as their starting map (decayed x 0.5, cap 1.5, for decay_aware):
    tick p50/p90, host syncs of ticks 1-3, K2/K3 launches by route, and
    the K3 launches with a mask per field (exact_bfs: one a tick for the
    8 robots). Returns (the line, the K2/K3 calls exact_bfs made)."""
    import dataclasses
    from jax_mapping_torch.models import fleet as FL
    from jax_mapping_torch.ops import _cuda
    from jax_mapping_torch.ops import grid as G
    drive = _Drive(torch, cfg, seed)
    world, start = drive.world, drive.truth
    res = cfg.grid.resolution_m
    out = {"phase": "fleet_modes", "ticks": ticks,
           "robots": cfg.fleet.n_robots, "options": {}}
    for name, kw in FLEET_OPTIONS.items():
        c = cfg.replace(frontier=dataclasses.replace(cfg.frontier, **kw))
        gen = torch.Generator().manual_seed(seed)
        st = FL.init_fleet_state(c, device=DEV, generator=gen)
        g0 = G.decay_grid(grid, 0.5, 1.5) if name == "decay_aware" else grid
        st = st._replace(sim=st.sim._replace(poses=start.clone()),
                         est_poses=start.clone(), grid=g0.clone())
        torch.cuda.synchronize()
        _cuda.reset_launches()
        tick_ms, syncs, assigned = [], [], 0
        with WaypointCount() as wc, K3MaskCount() as km, \
                SweepRecorder() as rec:
            for i in range(ticks):
                t0 = time.perf_counter()
                if 1 <= i <= 3:
                    (st, diag), n_sync = _count_syncs(
                        torch, lambda: FL.fleet_step(c, st, res, world,
                                                     generator=gen))
                    syncs.append(n_sync)
                else:
                    st, diag = FL.fleet_step(c, st, res, world,
                                             generator=gen)
                torch.cuda.synchronize()
                tick_ms.append((time.perf_counter() - t0) * 1e3)
                assigned += int((diag.frontiers.assignment >= 0).sum())
        launches = {k: _cuda.LAUNCHES[k] for k in ("label_prop",
                                                   "costfield_relax")}
        routes = {k: dict(_cuda.ROUTES[k]) for k in launches}
        row = {"first_tick_ms": tick_ms[0], "tick_ms": _p50_p90(tick_ms[1:]),
               "tick_ms_all": tick_ms, "host_syncs_ticks_1_to_3": syncs,
               "launches": launches,
               "launches_per_tick": {k: v / ticks for k, v in launches.items()},
               "routes": routes, "assigned_robot_ticks": assigned,
               "clusters_last_tick": int((diag.frontiers.sizes > 0).sum()),
               "valid_waypoints": wc.n_valid(),
               "k3_per_field_mask_launches": km.n,
               "k3_launches_per_tick": launches["costfield_relax"] / ticks}
        out["options"][name] = row
        if name == "exact_bfs":
            exact_rec = rec
            check(km.n == ticks, f"fleet_modes exact_bfs: {km.n} K3 "
                  f"launches with a mask per field in {ticks} ticks")
        check(bool(torch.isfinite(st.grid).all())
              and bool(torch.isfinite(st.est_poses).all()),
              f"fleet_modes {name}: non-finite state")
        check(launches["label_prop"] == ticks,
              f"fleet_modes {name}: K2 launched {launches['label_prop']}")
        want = OPTION_K3_PER_TICK[name] * ticks
        check(launches["costfield_relax"] == want,
              f"fleet_modes {name}: K3 launched "
              f"{launches['costfield_relax']} times, not {want}")
        check(all(r.startswith("cluster") for v in routes.values()
                  for r in v), f"fleet_modes {name}: routes {routes}")
        check(assigned > 0, f"fleet_modes {name}: no robot was assigned")
        if name == "planned_goals":
            check(row["valid_waypoints"] > 0,
                  "fleet_modes: no planned waypoint was valid")
    emit(out)
    return out, exact_rec


def exploration_kernel_rows(torch, cfg, grid, publisher, planner) -> dict:
    """K2 and K3 at the exploration path's shapes against their plain
    versions: the planner's 1024^2 field (1025 sweeps, global route), one
    exact_bfs field (256^2, 257 sweeps, the call's own mask), and every
    distinct K2/K3 call the publishes made (crop-span levels, warm 8 and
    0 sweeps, K2 at the crop's clustering grid)."""
    import dataclasses
    from jax_mapping_torch._util import div
    from jax_mapping_torch.ops import frontier as F
    dist, goal, start = planner
    calls = {}
    blk, init, s = _planner_k3_inputs(torch, cfg, grid, goal)
    calls[f"costfield_relax_planner_n{init.shape[-1]}_s{s}"] = (
        "relax_sweeps", blk, init, s)
    # One exact_bfs field: robot 0's cell on the mapper map's clustering
    # grid, 2 * ceil(512 / 4) + 1 sweeps.
    fcfg = cfg.frontier
    c = fcfg.cluster_downsample
    free, _occ, unknown = F.coarsen(fcfg, cfg.grid, grid)
    mask = F.frontier_mask(free, unknown)
    passable, bfs_res = F.bfs_passability(fcfg, cfg.grid, free, unknown,
                                          mask)
    ox, oy = cfg.grid.origin_m
    rc = torch.stack([div(start[1:2] - oy, bfs_res),
                      div(start[0:1] - ox, bfs_res)], 1).to(torch.int32)
    got = []
    F.cost_to_go(dataclasses.replace(fcfg, bfs_iters=-(-fcfg.bfs_iters // c)),
                 passable, rc, torch.ones(1, dtype=torch.bool,
                                          device=grid.device),
                 relax=lambda b, i, s: got.append((b, i, s)) or i)
    blk, init, s = got[0]
    calls[f"costfield_relax_exact_bfs_n{init.shape[-1]}_s{s}"] = (
        "relax_sweeps", blk, init, s)
    for key, val in sorted(publisher.recorded.items()):
        calls[key.replace("relax_sweeps", "costfield_relax").replace(
            "label_sweeps", "label_prop")] = val
    return {key: _sweep_row(torch, name, m, init, s)
            for key, (name, m, init, s) in calls.items()}


def _sweep_row(torch, name: str, m, init, s: int) -> dict:
    """One K3 (`relax_sweeps`) or K2 (`label_sweeps`) call against its
    plain version: exact comparison, route, times, bound."""
    from jax_mapping_torch.ops import costfield as CF
    from jax_mapping_torch.ops import frontier as F
    n = init.shape[-1]
    if name == "relax_sweeps":
        R = init.shape[0]
        got, ran = CF.relax_sweeps(m, init, s)
        want = CF._relax_sweeps_plain(m, init, s)
        times = _sweep_times(lambda: CF.relax_sweeps(m, init, s),
                             lambda: CF._relax_sweeps_plain(m, init, s),
                             "relax", s)
        masks = m.shape[0] if m.dim() == 3 else 1
        b = bound(*L.relax_cost(m, init, s))
        extra = {"fields": R, "masks": masks, "reachable_cells": int(
            (want < CF._BIG).sum())}
    else:
        got, ran = F.label_sweeps(m, init, s)
        want = init
        for _ in range(s):
            want = F._neighbor_max_sweep(want, m)
        times = _sweep_times(lambda: F.label_sweeps(m, init, s),
                             lambda: F._label_prop_plain(
                                 m, init, (s - 1) // 2), "label", s)
        b = bound(*L.label_prop_cost(m, s))
        extra = {"mask_cells": int(m.sum())}
    return dict(compare(got, want), shape=list(init.shape), sweeps=s, **ran,
                **times, **b, **extra)


# ---------------------------------------------------------------------------
# Slice 3: the voxel path
# ---------------------------------------------------------------------------

class _VoxelDrive:
    """8 robots, each on a 0.4 m circle whose centre is 1.5 m from two
    walls of rooms_world (a room corner), at 0.1 m/s: 0.025 rad of arc a
    tick of 0.1 s. Poses are made on the host, as the voxel mapper gets
    them from odometry."""

    RADIUS = 0.4
    ARC = 0.025

    def __init__(self, torch, cfg):
        import numpy as np
        from jax_mapping_torch.sim import world as W
        vox = cfg.voxel
        n, res = vox.size_x_cells, vox.resolution_m
        self.torch, self.np = torch, np
        self.world = torch.as_tensor(W.rooms_world(n, res, seed=1),
                                     device=DEV)
        walls = [int(n * f) for f in (0.33, 0.66)]   # rooms_world's walls
        centres = []
        for wx in walls:
            for wy in walls:
                for s in (1, -1):
                    fx = (wx + (2 if s > 0 else 0) - n / 2) * res
                    fy = (wy + (2 if s > 0 else 0) - n / 2) * res
                    centres.append((fx + 1.5 * s, fy + 1.5 * s))
        self.centres = np.array(centres[:cfg.fleet.n_robots], np.float64)
        self.phase = np.linspace(0, 2 * math.pi, len(self.centres),
                                 endpoint=False)

    def poses(self, angles) -> "torch.Tensor":
        """(R * len(angles), 3) poses, robot-major, at arc angles offset by
        each robot's phase."""
        np = self.np
        a = self.phase[:, None] + np.asarray(angles, np.float64)[None, :]
        x = self.centres[:, 0, None] + self.RADIUS * np.cos(a)
        y = self.centres[:, 1, None] + self.RADIUS * np.sin(a)
        p = np.stack([x, y, a + math.pi / 2], -1).reshape(-1, 3)
        return self.torch.as_tensor(p.astype(np.float32), device=DEV)


def _voxel_counts(vox, grid) -> dict:
    occ = int((grid > vox.occ_threshold).sum())
    free = int((grid < vox.free_threshold).sum())
    return {"occupied": occ, "free": free,
            "unknown": grid.numel() - occ - free}


def phase_voxel(torch, cfg, ticks: int = 20):
    """Slice 3's main path, as `VoxelMapperNode` runs it on the device:
    every tick one depth image per robot, then one `fuse_depths` of the
    batch onto the grid (a new grid; the input is never written). Then the
    keyframe re-fuse: 32 images per robot along the same circles (256, the
    default keyframe_cap) into an empty grid."""
    from jax_mapping_torch.ops import _cuda
    from jax_mapping_torch.ops import voxel as V
    from jax_mapping_torch.sim import depthcam as D
    vox, cam = cfg.voxel, cfg.depthcam
    res = vox.resolution_m
    n_samples = D.n_samples_for(cam, res)
    drive = _VoxelDrive(torch, cfg)
    grid = V.empty_voxel_grid(vox, DEV)
    check(grid.device.type == DEV, "voxel grid is not on the card")
    poses = [drive.poses([t * drive.ARC]) for t in range(ticks)]
    torch.cuda.synchronize()
    _cuda.reset_launches()
    with_render, fuse_only = [], []
    for t in range(ticks):
        t0 = time.perf_counter()
        depths = D.render_depths(cam, drive.world, res, n_samples, poses[t])
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        grid = V.fuse_depths(vox, cam, grid, depths, poses[t])
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        with_render.append((t2 - t0) * 1e3)
        fuse_only.append((t2 - t1) * 1e3)
    launches = dict(_cuda.LAUNCHES)
    counts = _voxel_counts(vox, grid)
    before = grid.clone()
    _, n_syncs = _count_syncs(torch, lambda: V.fuse_depths(
        vox, cam, grid, depths, poses[-1]))
    check(torch.equal(before, grid), "fuse_depths wrote its input grid")
    del before

    # The keyframe re-fuse (`_refuse_from_keyframes`' shape).
    ring_p = drive.poses([2 * math.pi * k / 32 for k in range(32)])
    ring_d = D.render_depths(cam, drive.world, res, n_samples, ring_p)
    empty = V.empty_voxel_grid(vox, DEV)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    refused = V.fuse_depths(vox, cam, empty, ring_d, ring_p)
    torch.cuda.synchronize()
    refuse_ms = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    refuse_counts = _voxel_counts(vox, refused)
    hm = V.height_map(vox, refused)
    sl = V.obstacle_slice(vox, refused, 0.05, 0.30)
    steady = slice(1, None) if ticks > 1 else slice(None)
    out = {"phase": "voxel", "ticks": ticks, "robots": len(drive.centres),
           "grid": [vox.size_z_cells, vox.size_y_cells, vox.size_x_cells],
           "image": [cam.height_px, cam.width_px], "n_samples": n_samples,
           "first_tick_ms": with_render[0],
           "tick_ms_with_render": _p50_p90(with_render[steady]),
           "tick_ms_fuse": _p50_p90(fuse_only[steady]),
           "images_per_s_fuse": len(drive.centres)
           / (statistics.median(fuse_only[steady]) / 1e3),
           "host_syncs_per_fuse": n_syncs,
           "launches": launches,
           "launches_per_tick": {k: v / ticks for k, v in launches.items()},
           "map": counts,
           "refuse": {"images": int(ring_d.shape[0]), "ms": refuse_ms,
                      "peak_mem_bytes": peak,
                      "peak_above_inputs_bytes": peak - base,
                      "map": refuse_counts},
           "height_map_ms": cuda_ms(lambda: V.height_map(vox, refused)),
           "obstacle_slice_ms": cuda_ms(lambda: V.obstacle_slice(
               vox, refused, 0.05, 0.30)),
           "height_map_columns_with_surface": int((hm > 0).sum()),
           "obstacle_slice_cells": int(sl.sum())}
    emit(out)
    check(bool(torch.isfinite(grid).all()), "voxel grid non-finite")
    check(float(grid.abs().max()) <= vox.logodds_max,
          "voxel grid outside the log-odds bounds")
    check(counts["occupied"] > 0, "the voxel drive mapped no occupied voxel")
    check(counts["free"] > 0, "the voxel drive mapped no free voxel")
    check(refuse_counts["occupied"] > 0, "the keyframe re-fuse mapped nothing")
    check(launches["voxel_image"] >= ticks,
          "kernel voxel_image did not launch on every voxel tick")
    check(int(sl.sum()) > 0, "the obstacle slice holds no cell")
    return {"out": out, "grid": grid, "depths": depths, "poses": poses[-1],
            "origins": V.patch_origin(vox, poses[-1][:, :2]).contiguous()}


def voxel_bench_inputs(torch, cfg) -> tuple:
    """bench.py's voxel inputs: 32 renders of plank_course(512, 0.05,
    n_planks=10, seed=7) on a 3 m circle (the fuse's poses), and the
    window's poses on a 0.2 m circle (the window takes the same images)."""
    import numpy as np
    from jax_mapping_torch.sim import depthcam as D
    from jax_mapping_torch.sim import world as W
    vox, cam = cfg.voxel, cfg.depthcam
    VB = 32
    world = torch.as_tensor(W.plank_course(512, vox.resolution_m,
                                           n_planks=10, seed=7), device=DEV)
    t = np.linspace(0, 2 * math.pi, VB, endpoint=False)
    vposes = torch.as_tensor(np.stack(
        [3.0 * np.cos(t), 3.0 * np.sin(t), t + math.pi / 2],
        axis=1).astype(np.float32), device=DEV)
    depths = D.render_depths(cam, world, vox.resolution_m, 200, vposes)
    wt = np.linspace(0, 0.5, VB).astype(np.float32)
    wposes = torch.as_tensor(np.stack(
        [0.2 * np.cos(wt * 2 * np.pi), 0.2 * np.sin(wt * 2 * np.pi), wt],
        axis=1).astype(np.float32), device=DEV)
    return depths, vposes, wposes


def voxel_tick_inputs(torch, cfg) -> tuple:
    """One voxel tick's 8 images: the voxel phase's robots at their first
    poses, rendered on rooms_world(1024, 0.05, seed=1)."""
    from jax_mapping_torch.sim import depthcam as D
    vox, cam = cfg.voxel, cfg.depthcam
    drive = _VoxelDrive(torch, cfg)
    poses = drive.poses([0.0])
    return D.render_depths(cam, drive.world, vox.resolution_m,
                           D.n_samples_for(cam, vox.resolution_m),
                           poses), poses


def phase_voxel_bench(torch, cfg):
    """bench.py's voxel workload (renders outside the timed region):
    32 images of a 3 m circle fused into an empty grid, and the 32-image
    window on a 0.2 m circle (K7, then `apply_patch`)."""
    from jax_mapping_torch.ops import _cuda
    from jax_mapping_torch.ops import voxel as V
    from jax_mapping_torch.ops import voxel_kernel as VK
    vox, cam = cfg.voxel, cfg.depthcam
    VB = 32
    depths, vposes, wposes = voxel_bench_inputs(torch, cfg)
    empty = V.empty_voxel_grid(vox, DEV)
    fused = V.fuse_depths(vox, cam, empty, depths, vposes)
    check(bool(torch.isfinite(fused).all()), "bench fuse non-finite")
    check(int((fused > vox.occ_threshold).sum()) > 0,
          "the bench fuse mapped no occupied voxel")
    fuse_ms = cuda_ms(lambda: V.fuse_depths(vox, cam, empty, depths, vposes))

    worigin = V.patch_origin(vox, wposes[:, :2].mean(dim=0))
    check(bool(VK.window_fits(vox, wposes, worigin)),
          "the bench window does not fit its patch")
    wo = worigin.tolist()

    def window():
        return V.apply_patch(vox, empty, VK.window_delta(
            vox, cam, depths, wposes, worigin), wo)
    torch.cuda.synchronize()
    _cuda.reset_launches()
    wgrid = window()
    torch.cuda.synchronize()
    launches = dict(_cuda.LAUNCHES)
    check(launches["voxel_summed"] >= 1,
          "kernel voxel_summed did not launch on the bench window")
    check(int((wgrid != 0).sum()) > 0, "the bench window changed nothing")
    window_ms = cuda_ms(window)
    delta_ms = cuda_ms(lambda: VK.window_delta(vox, cam, depths, wposes,
                                               worigin))
    out = {"phase": "voxel_bench", "images": VB,
           "fuse_ms": fuse_ms, "images_per_s": VB / fuse_ms * 1e3,
           "fuse_map": _voxel_counts(vox, fused),
           "window_ms": window_ms, "window_delta_ms": delta_ms,
           "window_images_per_s": VB / window_ms * 1e3,
           "window_launches": launches,
           "window_changed_voxels": int((wgrid != 0).sum())}
    emit(out)
    return {"out": out, "depths": depths, "vposes": vposes,
            "vorigins": V.patch_origin(vox, vposes[:, :2]).contiguous(),
            "wposes": wposes, "worigin": worigin,
            "launches": launches}


def phase_voxel_region(torch, cfg, vstate):
    """One tick's 8 images through `region_delta` over the whole grid as
    one Y slab, then clip(grid + delta): `make_voxel_fuse_step`'s local
    step on a 1 x 1 mesh."""
    from jax_mapping_torch.ops import _cuda
    from jax_mapping_torch.ops import voxel_kernel as VK
    vox, cam = cfg.voxel, cfg.depthcam
    grid, d, p = vstate["grid"], vstate["depths"], vstate["poses"]
    Y, X = vox.size_y_cells, vox.size_x_cells

    def step():
        return torch.clamp(grid + VK.region_delta(vox, cam, d, p, 0, Y, X),
                           vox.logodds_min, vox.logodds_max)
    before = _cuda.LAUNCHES["voxel_summed"]
    out_grid = step()
    torch.cuda.synchronize()
    launched = _cuda.LAUNCHES["voxel_summed"] - before
    check(launched >= 1, "kernel voxel_summed did not launch on the region")
    check(bool(torch.isfinite(out_grid).all()), "region fuse non-finite")
    changed = int((out_grid != grid).sum())
    check(changed > 0, "the region fuse changed nothing")
    out = {"phase": "voxel_region", "images": int(d.shape[0]),
           "region": [vox.size_z_cells, Y, X],
           "ms": cuda_ms(step, reps=5, warmup=1),
           "region_delta_ms": cuda_ms(lambda: VK.region_delta(
               vox, cam, d, p, 0, Y, X), reps=5, warmup=1),
           "launches_per_step": launched, "changed_voxels": changed,
           "map": _voxel_counts(vox, out_grid)}
    emit(out)
    return out


def _voxel_cull(vox, cam, poses, origins, ny: int, nx: int,
                group: int) -> tuple:
    """The kernels' cull on B images over a (ny, nx) region, from its plain
    mirrors (`voxel_kernel.cull_counts`): live (tile, image) pairs, kept
    columns, evaluated voxels (K7 in whole z groups), and the function's
    live columns and voxels; and the operations the function needs (its
    live voxels', not the kernels')."""
    ops, c = L.voxel_ops(vox, cam, poses, origins, ny, nx, group)
    return {"live_pairs": c["live_pairs"], "pairs": c["pairs"],
            "kept_voxel_columns": c["kept_columns"],
            "live_voxel_columns": c["model_columns"],
            "evaluated_voxels": c["evaluated_voxels"],
            "live_voxels": c["model_voxels"],
            "evaluated_per_live_voxel":
                c["evaluated_voxels"] / max(c["model_voxels"], 1)}, ops


def _k6_row(torch, cfg, d, p, o, **extra) -> dict:
    """K6 (`image_deltas`) on B images at their patch origins against its
    plain version: exact comparison, the cull's counts, times, bound."""
    from jax_mapping_torch.ops import voxel_kernel as VK
    vox, cam = cfg.voxel, cfg.depthcam
    Z, P = vox.size_z_cells, vox.patch_cells
    B = int(d.shape[0])
    got = VK.image_deltas(vox, cam, d, p, o)
    want = VK.image_deltas_plain(vox, cam, d, VK.pose_table(p), o)
    cmp = compare(got, want)
    cmp["nonzero_voxels"] = int((want != 0).sum())
    del got, want
    cull, ops = _voxel_cull(vox, cam, p, o, P, P, group=1)

    def kernel():
        return VK.image_deltas(vox, cam, d, p, o)
    return dict(
        cmp, shape=[B, Z, P, P], **cull, **extra, library_ms=None,
        ms=cuda_ms(kernel), device_ms=device_ms(kernel, "voxel_image"),
        plain_ms=cuda_ms(lambda: VK.image_deltas_plain(
            vox, cam, d, VK.pose_table(p), o), reps=5, warmup=1),
        **bound(L.voxel_image_bytes(vox, cam, B), ops))


def voxel_kernel_rows(torch, cfg, vstate, bench, voxel_out) -> dict:
    """K6 at B = 8 (one voxel tick) and 32 (the bench batch), K7 through
    the bench's 32-image window and through the region at B = 8, each
    against its plain version, with the kernel alone from the profiler
    (`device_ms`) and the cull's counts from its plain mirror; then the
    edge rows (untimed): the poses at the edges of the cull
    (tests/torch_kernel_inputs.py voxel_edge_case) through K6, K7's window
    and K7's whole-grid region. No single PyTorch call computes either
    function (library_ms none)."""
    from jax_mapping_torch.ops import voxel_kernel as VK
    vox, cam = cfg.voxel, cfg.depthcam
    Z, P = vox.size_z_cells, vox.patch_cells
    rows = {}
    per_tick = voxel_out["launches_per_tick"]["voxel_image"]
    for name, d, p, o in (
            ("voxel_image_b8", vstate["depths"], vstate["poses"],
             vstate["origins"]),
            ("voxel_image_b32", bench["depths"], bench["vposes"],
             bench["vorigins"])):
        rows[name] = _k6_row(torch, cfg, d, p, o,
                             launches_per_voxel_tick=per_tick)

    Y, X = vox.size_y_cells, vox.size_x_cells
    wo = bench["worigin"]
    for name, d, p, o, ny, nx in (
            ("voxel_summed_window_b32", bench["depths"], bench["wposes"],
             wo.reshape(1, 2).expand(32, 2).contiguous(), P, P),
            ("voxel_summed_region_b8", vstate["depths"], vstate["poses"],
             torch.zeros((int(vstate["depths"].shape[0]), 2),
                         dtype=torch.int32, device=DEV), Y, X)):
        B = int(d.shape[0])

        def kernel(d=d, p=p, o=o, ny=ny, nx=nx):
            return VK._summed_delta(vox, cam, d, p, o, ny, nx)

        def plain(d=d, p=p, o=o, ny=ny, nx=nx):
            return VK.summed_delta_plain(vox, cam, d, VK.pose_table(p), o,
                                         ny, nx)
        got, want = kernel(), plain()
        cmp = compare(got, want)
        cmp["nonzero_voxels"] = int((want != 0).sum())
        del got, want
        cull, ops = _voxel_cull(vox, cam, p, o, ny, nx, group=VK.Z_CHUNK)
        rows[name] = dict(
            cmp, shape=[B, Z, ny, nx], **cull, library_ms=None,
            ms=cuda_ms(kernel), device_ms=device_ms(kernel, "voxel_summed"),
            plain_ms=cuda_ms(plain, reps=5, warmup=1),
            **bound(L.voxel_summed_bytes(vox, cam, B, ny, nx), ops))
    for r in rows.values():
        r["bound_share"] = r["bound_ms"] / r["ms"]
        r["device_bound_share"] = (None if r["device_ms"] is None
                                   else r["bound_ms"] / r["device_ms"])
    rows.update(voxel_edge_rows(torch, cfg))
    return rows


def voxel_edge_rows(torch, cfg) -> dict:
    """Each edge case of the voxel cull (6 images) through K6 at the
    images' own origins, K7's window at the first image's patch and K7
    over the whole grid, compared exactly with the plain versions."""
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import torch_kernel_inputs as KI
    from jax_mapping_torch.ops import voxel_kernel as VK
    vox, cam = cfg.voxel, cfg.depthcam
    Y, X = vox.size_y_cells, vox.size_x_cells
    rows = {}
    for case in KI.VOXEL_EDGES:
        d, p, o = (x.to(DEV).contiguous()
                   for x in KI.voxel_edge_case(cfg, case))
        table = VK.pose_table(p)
        want = VK.image_deltas_plain(vox, cam, d, table, o)
        rows[f"edge_voxel_image_{case}"] = dict(
            compare(VK.image_deltas(vox, cam, d, p, o), want),
            nonzero_voxels=int((want != 0).sum()))
        origin = o[0].contiguous()
        want = VK.summed_delta_plain(vox, cam, d, table,
                                     origin.reshape(1, 2).expand(6, 2),
                                     vox.patch_cells, vox.patch_cells)
        rows[f"edge_voxel_window_{case}"] = dict(
            compare(VK.window_delta(vox, cam, d, p, origin), want),
            nonzero_voxels=int((want != 0).sum()))
        zero = torch.zeros((6, 2), dtype=torch.int32, device=DEV)
        want = VK.summed_delta_plain(vox, cam, d, table, zero, Y, X)
        rows[f"edge_voxel_region_{case}"] = dict(
            compare(VK.region_delta(vox, cam, d, p, 0, Y, X), want),
            nonzero_voxels=int((want != 0).sum()))
        del want
    return rows


def phase_voxel_parity(torch, seed: int, ticks: int = 6):
    """A tiny two-robot voxel drive near room corners: from each CPU grid,
    one tick (render, then fuse) on the card and one on the CPU. The card
    runs K6, the CPU its plain version. Tolerances as the fleet parity
    phase: cos/sin and the render's products may round differently on the
    two devices, so a pixel may differ by an ulp (>= 99% within 1e-6
    relative is required) and voxels on model boundaries may differ (at
    most 1e-3 of them)."""
    from jax_mapping_torch.config import tiny_config
    from jax_mapping_torch.ops import _cuda
    from jax_mapping_torch.ops import voxel as V
    from jax_mapping_torch.sim import depthcam as D
    from jax_mapping_torch.sim import world as W
    cfg = tiny_config(2)
    vox, cam = cfg.voxel, cfg.depthcam
    res = vox.resolution_m
    w = torch.as_tensor(W.rooms_world(vox.size_x_cells, res, seed=1))
    w_dev = w.to(DEV)
    n = D.n_samples_for(cam, res)
    g = V.empty_voxel_grid(vox, device="cpu")
    worst = {"pixels_not_close": 0.0, "voxels": 0}
    before = _cuda.LAUNCHES["voxel_image"]
    for t in range(ticks):
        a = 0.15 * t + seed
        poses = torch.tensor([[-1.6 + 0.5 * math.cos(a),
                               -1.5 + 0.5 * math.sin(a), a + math.pi / 2],
                              [1.7 - 0.5 * math.cos(a),
                               1.6 - 0.5 * math.sin(a), a - math.pi / 2]])
        dc = D.render_depths(cam, w, res, n, poses)
        dg = D.render_depths(cam, w_dev, res, n, poses.to(DEV))
        close = ((dg.cpu() - dc).abs() <= 1e-6 * dc.abs()).float().mean()
        gg = V.fuse_depths(vox, cam, g.to(DEV), dg, poses.to(DEV))
        g = V.fuse_depths(vox, cam, g, dc, poses)
        worst["pixels_not_close"] = max(worst["pixels_not_close"],
                                        1.0 - float(close))
        worst["voxels"] = max(worst["voxels"], int((gg.cpu() != g).sum()))
    launched = _cuda.LAUNCHES["voxel_image"] - before
    emit({"phase": "voxel_parity", "config": "tiny_config(2)",
          "ticks": ticks, "worst": worst, "voxels_total": g.numel(),
          "k6_launches": launched, "map": _voxel_counts(vox, g)})
    check(launched >= ticks, "voxel parity: K6 did not run on the card")
    check(worst["pixels_not_close"] <= 0.01,
          f"voxel parity: renders differ in {worst}")
    check(worst["voxels"] <= 1e-3 * g.numel(),
          f"voxel parity: {worst['voxels']} voxels differ")
    check(int((g > vox.occ_threshold).sum()) > 0,
          "voxel parity: the tiny drive mapped nothing")


def frontier_inputs(torch, seed: int) -> dict:
    """K2's and K3's inputs at the fleet's shapes (default SlamConfig), made
    from `seed` on the card: the 256^2 clustering mask at the fleet's ~4%
    density with `label_components`' seed labels and sweep count, and each
    level's (blocked, init, iters) of 8 robots' cost fields (64^2, 128^2,
    256^2) on a map with 10% of its cells blocked, every init being the
    plain relaxation of the level below it."""
    from jax_mapping_torch.config import SlamConfig
    from jax_mapping_torch.ops import costfield as CF
    cfg = SlamConfig()
    fcfg = cfg.frontier
    n = cfg.grid.size_cells // fcfg.downsample // fcfg.cluster_downsample
    dev = torch.device(DEV)
    g = torch.Generator().manual_seed(seed + 7)
    mask = torch.rand((n, n), generator=g) < 0.04
    lin = torch.arange(n * n, dtype=torch.int32).reshape(n, n)
    blocked = torch.rand((n, n), generator=g) < 0.1
    rc = torch.randint(0, n, (cfg.fleet.n_robots, 2), generator=g)
    blocked[rc[:, 0], rc[:, 1]] = False
    levels = []

    def recorded(blk, init, iters):
        levels.append((blk, init, iters))
        return CF._relax_level_xla(blk, init, iters)
    CF.cost_fields(blocked.to(dev), rc.to(dev), fcfg.mg_levels,
                   fcfg.mg_refine_iters, relax=recorded)
    return {"mask": mask.to(dev),
            "seed": torch.where(mask, lin, -1).to(torch.int32).to(dev),
            "iters": max(1, -(-fcfg.label_prop_iters
                              // fcfg.cluster_downsample)),
            "levels": levels}


def kernel_times(torch, seed: int) -> dict:
    """Device times of K1, K4 and K5 at the main paths' batches, of K2 at
    the fleet's 256^2 x 49 sweeps, of K3 at each of its three levels and
    in `compute_frontiers` with exact_bfs for 8 robots, of
    K6 at a voxel tick's 8 images and of K7 at the bench's 32-image window
    and the tick's images over the whole grid, and the host-clock times of
    the voxel tick's fuse and the bench window, on fixed inputs (seeded), through the wrappers of whichever
    `jax_mapping_torch` comes first on sys.path, and the SASS instruction
    counts of its builds. The --ab comparison runs this for two trees in
    turns. K2's and K3's device times are per call (a parent's call
    launched one grid a sweep)."""
    import jax_mapping_torch
    from jax_mapping_torch.config import SlamConfig
    from jax_mapping_torch.ops import _cuda
    from jax_mapping_torch.ops import costfield as CF
    from jax_mapping_torch.ops import frontier as F
    from jax_mapping_torch.ops import fuse_kernel as FK
    from jax_mapping_torch.ops import grid as G
    from jax_mapping_torch.ops import sensor_kernel as SK
    from jax_mapping_torch.ops import voxel as V
    from jax_mapping_torch.ops import voxel_kernel as VK
    from jax_mapping_torch.sim import lidar
    cfg = SlamConfig()
    dev = torch.device("cuda")
    world = _world(cfg, dev, torch)
    res = cfg.grid.resolution_m
    n_samples = int(cfg.scan.range_max_m / (res * 0.5))
    gen = torch.Generator().manual_seed(seed + 1)
    libs = {n: _cuda._target(n) for n in ("sensor_model", "window_fuse",
                                          "label_prop", "costfield_relax",
                                          "voxel_model")}
    for n in libs:
        _cuda.library(n)
    ms, dev_ms = {}, {}

    def timed(name, fn, kernel, per_call=False):
        ms[name] = cuda_ms(fn)
        dev_ms[name] = device_ms(fn, kernel, per_call=per_call)

    fr = frontier_inputs(torch, seed)
    timed("label_prop_256_s49", lambda: F.label_prop(
        fr["mask"], fr["seed"], fr["iters"]), "label", per_call=True)
    for blk, init, it in fr["levels"]:
        timed(f"costfield_relax_{init.shape[-1]}_s{2 * it}",
              lambda blk=blk, init=init, it=it: CF.relax_level(blk, init, it),
              "relax", per_call=True)
    k3 = [k for k in ms if k.startswith("costfield_relax_")]
    for d in (ms, dev_ms):
        vals = [d[k] for k in k3]
        d["costfield_relax_levels"] = None if None in vals else sum(vals)
    del fr

    # exact_bfs' frontier costs of the fleet's 8 robots on the world's
    # planks (the west eighth unknown): a tree that batches the fields
    # launches K3 once, an older one once a robot.
    import dataclasses
    n = cfg.grid.size_cells
    lo = torch.where(world, 3.0, -1.0)
    lo[:, : n // 8] = 0.0
    exact = dataclasses.replace(cfg.frontier, exact_bfs=True)
    robots = _poses_near_walls(torch, cfg, world, cfg.fleet.n_robots, gen)
    timed("exact_bfs_frontiers_r8", lambda: F.compute_frontiers(
        exact, cfg.grid, lo, robots), "relax", per_call=True)
    del lo

    # 30 steps of the mission stack on STACK_WORLD after 5 to warm up
    # (host clock, synchronised): the stack path's cost in either tree.
    from jax_mapping_torch.bridge.launch import launch_sim_stack
    st = launch_sim_stack(cfg, _stack_world(res), n_robots=STACK_ROBOTS,
                          seed=seed)
    st.brain.start_exploring()
    st.run_steps(5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st.run_steps(30)
    torch.cuda.synchronize()
    ms["stack_step_30"] = (time.perf_counter() - t0) * 1e3 / 30
    dev_ms["stack_step_30"] = None
    st.shutdown()
    del st

    guess = _poses_near_walls(torch, cfg, world, cfg.fleet.n_robots, gen)
    scans = lidar.simulate_scans(cfg.scan, world, res, n_samples, guess)
    for B in (64, 8, 1):
        poses = _poses_near_walls(torch, cfg, world, B, gen)
        ranges = lidar.simulate_scans(cfg.scan, world, res, n_samples, poses)
        origins = G.patch_origin(cfg.grid, poses[:, :2]).contiguous()
        timed(f"sensor_model_delta_b{B}", lambda: SK.scan_deltas(
            cfg.grid, cfg.scan, ranges, poses, origins), "sensor_model")
    n_r = cfg.fleet.n_robots
    for R, stage in ((n_r, "coarse"), (n_r, "subcell"), (1, "coarse"),
                     (1, "subcell")):
        r_b, p_b, o_b = _raster_inputs(torch, cfg, scans[:R], guess[:R],
                                       stage)
        timed(f"sensor_model_raster_b{r_b.shape[0]}",
              lambda: SK.scan_rasters(cfg.grid, cfg.scan, r_b, p_b, o_b),
              "sensor_model")
        del r_b, p_b, o_b
    grid = G.empty_grid(cfg.grid, dev)
    wgen = torch.Generator().manual_seed(seed + 4)
    for B in (15, 16, 17, 256):
        ranges, poses, origin = _window_inputs(torch, cfg, world, B, wgen)
        timed(f"window_delta_b{B}", lambda: SK.window_delta(
            cfg.grid, cfg.scan, ranges, poses, origin), "window_kernel")
        timed(f"window_apply_b{B}", lambda: FK.window_apply(
            cfg.grid, cfg.scan, grid, ranges, poses, origin), "window_kernel")
    del grid

    # K6 on one voxel tick's 8 images; K7 on the bench's 32-image window
    # and on the tick's images over the whole grid (region_delta).
    vox, cam = cfg.voxel, cfg.depthcam
    d8, p8 = voxel_tick_inputs(torch, cfg)
    o8 = V.patch_origin(vox, p8[:, :2]).contiguous()
    timed("voxel_image_b8", lambda: VK.image_deltas(vox, cam, d8, p8, o8),
          "voxel_image")
    d32, _, wposes = voxel_bench_inputs(torch, cfg)
    worigin = V.patch_origin(vox, wposes[:, :2].mean(dim=0))
    timed("voxel_summed_window_b32", lambda: VK.window_delta(
        vox, cam, d32, wposes, worigin), "voxel_summed")
    timed("voxel_summed_region_b8", lambda: VK.region_delta(
        vox, cam, d8, p8, 0, vox.size_y_cells, vox.size_x_cells),
        "voxel_summed")
    # The paths they belong to (CUDA events around the call, no device
    # time): the voxel tick's fuse of 8 images onto a grid, and the bench
    # window (K7, then apply_patch).
    grid = V.empty_voxel_grid(vox, dev)
    wo = worigin.tolist()
    for name, fn in (
            ("fuse_depths_b8", lambda: V.fuse_depths(vox, cam, grid, d8, p8)),
            ("bench_window_b32", lambda: V.apply_patch(
                vox, grid, VK.window_delta(vox, cam, d32, wposes, worigin),
                wo))):
        ms[name] = cuda_ms(fn, reps=20)
        dev_ms[name] = None
    return {"package": os.path.dirname(jax_mapping_torch.__file__),
            "ms": ms, "device_ms": dev_ms,
            "sass_instructions": {
                **{n: sass_counts(p) for n, p in libs.items()},
                "one_cell": cell_sass(os.path.join(os.path.dirname(
                    jax_mapping_torch.__file__), "csrc"))}}


# ---------------------------------------------------------------------------
# The recovery path (relocalization, rendezvous merge, fuse paths)
# ---------------------------------------------------------------------------

#: Tile side (cells) of the recovery phase's region revisions: the serving
#: tile of the JAX package's default ServingConfig.
REVISION_TILE = 256
#: The recovery drive: steps, the ghost-return window [start, end) and
#: the share of the live beams it replaces.
RECOVERY_STEPS = 70
FAULT_WINDOW = (15, 30)
GHOST_FRAC = 0.5
#: Fleet B's frame -> fleet A's frame in the rendezvous phase, about the
#: mean start of B's robots: a fleet's belief frame has its origin where
#: the fleet started, so B's poses sit metres, not tens of metres, from
#: it (the merge's transform error grows with that lever arm).
RENDEZVOUS_T = (2.0, -1.5, 0.3)


class _Revisions:
    """Per-tile map revisions, as the mapper's serving side keeps them:
    `mark(r0, c0)` stamps the tiles a fused patch at (r0, c0) covers with
    a new map revision; `region(row0, col0, span)`, the relocalizer's
    `region_rev_fn`, is the newest revision of the tiles a region
    covers."""

    def __init__(self, cfg):
        import numpy as np
        nt = cfg.grid.size_cells // REVISION_TILE
        self.tile_rev = np.zeros((nt, nt), np.int64)
        self.rev = 0
        self.P = cfg.grid.patch_cells

    def _tiles(self, row0, col0, span):
        t = REVISION_TILE
        return (slice(row0 // t, (row0 + span - 1) // t + 1),
                slice(col0 // t, (col0 + span - 1) // t + 1))

    def mark(self, r0, c0):
        self.rev += 1
        self.tile_rev[self._tiles(r0, c0, self.P)] = self.rev

    def region(self, row0, col0, span):
        return int(self.tile_rev[self._tiles(row0, col0, span)].max())


class _RecoveryDrive(_Drive):
    """One robot on a 1.2 m circle round the centre of the mapper drive's
    first circle: 0.0083 rad a scan, so the heading a quarantine leaves
    behind stays well inside the matcher's 0.35 rad window."""

    RADIUS = 1.2


def _truth_map(torch, cfg, seed: int, ticks: int = 10):
    """The mapper drive's scans (8 robots, `ticks` x 18 each) fused at
    their true poses into an empty grid, as `phase_refuse` fuses its
    map: the recovery phase's map, so that a pose relocalized against it
    can be held to the truth (the mapper drive's own map carries its
    0.2-0.4 m drift)."""
    from jax_mapping_torch.ops import grid as G
    drive = _Drive(torch, cfg, seed)
    grid = G.empty_grid(cfg.grid, drive.truth.device)
    nb = cfg.scan.padded_beams
    for _ in range(ticks):
        scans, _w = drive.next(cfg.fleet.batch_scans + 2)
        grid = G.fuse_scans(cfg.grid, cfg.scan, grid, scans.reshape(-1, nb),
                            drive.poses.reshape(-1, 3))
    return grid


def _attempt_cache(before: dict, after: dict) -> str:
    dh = after["n_hits"] - before["n_hits"]
    dm = after["n_misses"] - before["n_misses"]
    return "hit" if (dh, dm) == (2, 0) else "miss" if (dh, dm) == (0, 2) \
        else f"{dh} hits, {dm} misses"


def phase_recovery(torch, cfg, seed: int):
    """The recovery path for one robot, as `MapperNode` runs it:
    `slam_step` a scan on `_truth_map` (the mapper drive's region of
    rooms_world, fused at the true poses), the divergence
    watchdog fed every step (a key step's diag agreement, match and
    covariance trace; a sub-gate step's `scan_agreement` at the post-step
    pose), ghost returns on half the live beams in FAULT_WINDOW. From the
    declaration on, steps are quarantined (not run, not installed) and
    each calls `Relocalizer.attempt_for` with its scan from the last
    estimate, through the pyramid cache keyed on per-tile revisions; a
    verified re-anchor restarts the chain at the pose on the kept map."""
    import dataclasses
    import numpy as np
    from jax_mapping_torch.models import slam as S
    from jax_mapping_torch.ops import pyramid as PYR
    from jax_mapping_torch.recovery import (RecoveryManager, Relocalizer,
                                            relocalize_match)
    from jax_mapping_torch.sim.lidar import apply_ghost_returns
    cfg1 = cfg.replace(fleet=dataclasses.replace(cfg.fleet, n_robots=1))
    drive = _RecoveryDrive(torch, cfg1, seed + 5)
    rec = RecoveryManager(cfg.recovery, 1, robot=cfg.robot)
    wd, reloc = rec.watchdog, rec.relocalizer
    revs = _Revisions(cfg)
    grid = _truth_map(torch, cfg, seed)
    mapped_occ = int((grid > cfg.grid.occ_threshold).sum())
    st = S.init_state(cfg, drive.truth[0], DEV)._replace(grid=grid)
    declared_at = readmitted_at = None
    attempts, steps_key, quarantined = [], 0, 0
    for t in range(RECOVERY_STEPS):
        scans, wheels = drive.next(1)
        ranges = scans[0, 0]
        if FAULT_WINDOW[0] <= t < FAULT_WINDOW[1]:
            ranges = torch.as_tensor(apply_ghost_returns(
                cfg.scan, ranges.cpu().numpy(), GHOST_FRAC,
                np.random.default_rng((seed, t, 0))), device=grid.device)
        if not wd.is_diverged(0):
            st2, d = S.slam_step(cfg, st, ranges, wheels[0, 0, 0],
                                 wheels[0, 0, 1], drive.DT)
            key, matched = bool(d.key_added), bool(d.matched)
            if key:
                agreement = float(d.window_agreement)
                cov_trace = float(d.cov.sum()) if matched else None
            else:
                agreement = float(S.scan_agreement(cfg, grid, ranges,
                                                   st2.pose))
                cov_trace = None
            if wd.observe(0, key, matched, agreement, cov_trace):
                declared_at = t
                reloc.reset(0)
                quarantined += 1
                continue
            if key:
                steps_key += 1
                revs.mark(*PYR.patch_origin_host(cfg.grid,
                                                 st2.pose[:2].cpu()))
            st, grid = st2, st2.grid
            continue
        quarantined += 1
        guess = st.pose.cpu().numpy()
        before = reloc.pyramid_cache.snapshot()
        torch.cuda.synchronize()
        with BatchCount(cfg.grid) as bc:
            t0 = time.perf_counter()
            pose, n_sync = _count_syncs(torch, lambda: reloc.attempt_for(
                0, cfg, grid, ranges, guess, region_rev_fn=revs.region,
                grid_revision=revs.rev))
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
        attempts.append({
            "step": t, "ms": ms, "host_syncs": n_sync,
            "cache": _attempt_cache(before, reloc.pyramid_cache.snapshot()),
            "k1_launches": bc.n, "verified": pose is not None})
        if pose is not None:
            readmitted_at = t
            st = S.init_state(cfg, torch.as_tensor(pose), DEV)._replace(
                grid=grid)
            wd.readmit(0)
    truth = drive.truth[0]
    err = (st.pose - truth).cpu()
    err_m = float(torch.hypot(err[0], err[1]))
    err_rad = abs(math.remainder(float(err[2]), 2 * math.pi))

    # The match alone: pruned through a warm cache (hits) and a cold one
    # (misses), and the unpruned relocalize_match, on the last scan from
    # a guess 0.1 m and 0.05 rad off; then a wide basin, 1.0 m and 0.3
    # rad off.
    guess = (truth + torch.tensor([0.08, -0.06, 0.05],
                                  device=truth.device)).cpu().numpy()
    warm = Relocalizer(cfg.recovery, 1)

    def pruned(r):
        return r._match_pruned(cfg, grid, ranges, guess, revs.region,
                               revs.rev)

    pruned(warm)
    guess_t = torch.as_tensor(guess, device=grid.device)
    (_, syncs_unpruned) = _count_syncs(torch, lambda: relocalize_match(
        cfg, grid, ranges, guess_t))
    times = {
        "pruned_hit_ms": cuda_ms(lambda: pruned(warm)),
        "pruned_miss_ms": cuda_ms(lambda: pruned(Relocalizer(cfg.recovery,
                                                             1))),
        "unpruned_ms": cuda_ms(lambda: relocalize_match(cfg, grid, ranges,
                                                        guess_t))}
    wide_guess = truth + torch.tensor([0.8, 0.6, 0.3], device=truth.device)
    wide = relocalize_match(cfg, grid, ranges, wide_guess)
    wide_err = (wide.pose[0] - truth).cpu()
    times["wide_basin_ms"] = cuda_ms(lambda: relocalize_match(
        cfg, grid, ranges, wide_guess))

    verify_at = [a["step"] for a in attempts if a["verified"]]
    by_cache = {}
    for a in attempts:
        by_cache.setdefault(a["cache"], []).append(a)
    launches = attempts[0]["k1_launches"] if attempts else {}
    out = {"phase": "recovery", "map_occ_cells": mapped_occ,
           "steps": RECOVERY_STEPS,
           "fault_window": list(FAULT_WINDOW), "ghost_frac": GHOST_FRAC,
           "declared_at_step": declared_at,
           "steps_to_declare": (None if declared_at is None
                                else declared_at - FAULT_WINDOW[0] + 1),
           "readmitted_at_step": readmitted_at,
           "attempts": len(attempts),
           "attempts_to_verify": (None if not verify_at else
                                  sum(a["step"] <= verify_at[0]
                                      for a in attempts)),
           "attempts_after_fault_to_verify": (
               None if not verify_at else
               sum(FAULT_WINDOW[1] <= a["step"] <= verify_at[0]
                   for a in attempts)),
           "steps_quarantined": quarantined, "key_steps_installed": steps_key,
           "attempt_ms": {c: _p50_p90([a["ms"] for a in v])
                          for c, v in by_cache.items()},
           "attempt_host_syncs": {c: sorted({a["host_syncs"] for a in v})
                                  for c, v in by_cache.items()},
           "k1_launches_per_attempt": launches,
           "unpruned_host_syncs": syncs_unpruned, **times,
           "wide_basin": {"guess_off_m": 1.0, "guess_off_rad": 0.3,
                          "accepted": bool(wide.accepted[0]),
                          "response": float(wide.response[0]),
                          "err_m": float(torch.hypot(wide_err[0],
                                                     wide_err[1])),
                          "err_rad": abs(math.remainder(float(wide_err[2]),
                                                        2 * math.pi))},
           "relocalizer": reloc.snapshot(), "watchdog": wd.snapshot(),
           "transitions": [list(x) for x in wd.transitions],
           "pose_err_m": err_m, "pose_err_rad": err_rad,
           "attempt_log": attempts}
    emit(out)
    check(declared_at is not None
          and FAULT_WINDOW[0] <= declared_at < FAULT_WINDOW[1],
          f"recovery: divergence declared at step {declared_at}, not "
          f"inside the fault window {FAULT_WINDOW}")
    check(readmitted_at is not None and readmitted_at >= FAULT_WINDOW[1],
          f"recovery: re-admitted at step {readmitted_at}, not after the "
          f"fault window")
    check(not wd.is_diverged(0), "recovery: the robot ends diverged")
    check(err_m <= 0.1 and err_rad <= 0.05,
          f"recovery: final pose {err_m} m / {err_rad} rad off the truth")
    check("hit" in by_cache and "miss" in by_cache,
          f"recovery: attempts saw no cache hit and miss: {list(by_cache)}")
    check(launches.get("sensor_model_raster"),
          "recovery: an attempt launched no K1 raster")
    return {"per": "attempt", "k1_launches_by_batch": _k1_sum(
        [a["k1_launches"] for a in attempts], len(attempts))}, out


def _k1_sum(counts, n: int = 1) -> dict:
    """BatchCount counts (a list of {mode: {batch: launches}}) summed and
    divided by n."""
    tot = {name: {} for name in BatchCount.NAMES.values()}
    for by_name in counts:
        for name, by in by_name.items():
            for k, c in by.items():
                tot[name][k] = tot[name].get(k, 0) + c
    return {name: {k: c / n for k, c in by.items()}
            for name, by in tot.items()}


def phase_rendezvous(torch, cfg, seed: int):
    """The rendezvous merge: fleet A is 4 robots of the mapper drive
    (`_Drive`, `slam_step_window` on one shared grid) until each has the
    merger's min_keyscans graph poses; fleet B is A's robots 0 and 1 in a
    frame RENDEZVOUS_T maps onto A's (poses, graphs and rings through its
    inverse, a grid re-fused in B's frame). `RendezvousMerger.poll` on
    stand-in mappers until it merges; then `merge_fleets` alone and one
    `merged_frontier_assignment` on the merged grid."""
    import dataclasses
    import inspect
    import numpy as np
    from jax_mapping_torch.models import slam as S
    from jax_mapping_torch.ops import _cuda
    from jax_mapping_torch.ops import grid as G
    from jax_mapping_torch.scenarios import rendezvous as RV
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import torch_kernel_inputs as KI
    cfg4 = cfg.replace(fleet=dataclasses.replace(cfg.fleet, n_robots=4))
    drive = _Drive(torch, cfg4, seed + 7)
    W = cfg.fleet.batch_scans
    states = [S.init_state(cfg, drive.truth[r], DEV) for r in range(4)]
    drive_start = drive.truth.cpu()
    shared = states[0].grid
    min_keys = inspect.signature(RV.RendezvousMerger).parameters[
        "min_keyscans"].default
    ticks = 0
    while min(int(s.graph.n_poses) for s in states) < min_keys:
        check(ticks < 8, "rendezvous: fleet A made too few key scans")
        scans, wheels = drive.next(W)
        for r in range(4):
            states[r], _ = S.slam_step_window(
                cfg, states[r]._replace(grid=shared), scans[r], wheels[r],
                drive.DT)
            shared = states[r].grid
        ticks += 1
    cap = cfg.loop.max_poses
    states_a = [s._replace(grid=shared) for s in states]
    start = drive_start[:2, :2].mean(dim=0).tolist()
    T = np.asarray([start[0] + RENDEZVOUS_T[0], start[1] + RENDEZVOUS_T[1],
                    RENDEZVOUS_T[2]], np.float32)
    t_inv = RV.se2_from_pair(np.zeros(3, np.float32), T)
    moved = [RV.transform_state(st, t_inv) for st in states_a[:2]]
    grid_b = G.empty_grid(cfg.grid, shared.device)
    for st in moved:
        grid_b = G.fuse_scans_masked(cfg.grid, cfg.scan, grid_b,
                                     st.scan_ring, st.graph.poses[:cap],
                                     st.graph.pose_valid[:cap])
    states_b = [st._replace(grid=grid_b) for st in moved]
    merger = RV.RendezvousMerger(cfg, KI.StandInMapper(states_a, cap),
                                 KI.StandInMapper(states_b, cap))
    poll_ms = []
    torch.cuda.synchronize()
    with BatchCount(cfg.grid) as bc:
        for _ in range(4):
            t0 = time.perf_counter()
            merged = merger.poll()
            torch.cuda.synchronize()
            poll_ms.append((time.perf_counter() - t0) * 1e3)
            if merged:
                break
    check(merger.merged, f"rendezvous: no merge in 4 polls: "
          f"{merger.snapshot()}")
    err = merger.transform - T
    err_m = float(np.hypot(err[0], err[1]))
    err_rad = abs(math.remainder(float(err[2]), 2 * math.pi))

    # merge_fleets alone, anchored as the merger anchors it.
    j = 0
    n = int(states_b[j].graph.n_poses)
    verified = RV.se2_apply(merger.transform,
                            states_b[j].graph.poses[n - 1].cpu().numpy())
    with BatchCount(cfg.grid) as bm:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        grid_m, merged_states = RV.merge_fleets(
            cfg, states_a, states_b, merger.transform, anchor=(j, verified))
        torch.cuda.synchronize()
        merge_ms = (time.perf_counter() - t0) * 1e3
    before = dict(_cuda.LAUNCHES)
    t0 = time.perf_counter()
    fr = RV.merged_frontier_assignment(cfg, merger.merged_grid,
                                       merger.merged_states)
    torch.cuda.synchronize()
    assign_ms = (time.perf_counter() - t0) * 1e3
    assign_launches = {k: _cuda.LAUNCHES[k] - before[k]
                       for k in ("label_prop", "costfield_relax")}
    assignment = fr.assignment.cpu().numpy()
    costs = fr.costs.cpu().numpy()
    sizes = fr.sizes.cpu().numpy()
    # The auction's promise: a robot left without a frontier could reach
    # none that an earlier robot had not taken.
    taken = set(int(a) for a in assignment if a >= 0)
    starved = [r for r, a in enumerate(assignment)
               if a < 0 and any(costs[r, k] < 1e9 and sizes[k] > 0
                                and k not in taken
                                for k in range(len(sizes)))]
    occ = cfg.grid.occ_threshold
    out = {"phase": "rendezvous", "robots_a": 4, "robots_b": 2,
           "drive_ticks": ticks,
           "n_poses_a": [int(s.graph.n_poses) for s in states_a],
           "transform_true": [float(v) for v in T],
           "transform": [float(v) for v in merger.transform],
           "transform_err_m": err_m, "transform_err_rad": err_rad,
           "polls_to_merge": len(poll_ms), "poll_ms": poll_ms,
           "k1_launches_polls": bc.n,
           "merge_fleets_ms": merge_ms, "k1_launches_merge": bm.n,
           "assignment_ms": assign_ms,
           "assignment_launches": assign_launches,
           "assignment": assignment.tolist(),
           "clusters": int((sizes > 0).sum()),
           "occ_cells_before": int((shared > occ).sum()),
           "occ_cells_after": int((merger.merged_grid > occ).sum()),
           "merger": merger.snapshot()}
    emit(out)
    check(err_m <= 0.1 and err_rad <= 0.02,
          f"rendezvous: transform {err_m} m / {err_rad} rad off the truth")
    check(torch.equal(grid_m, merger.merged_grid),
          "rendezvous: merge_fleets differs from the merger's merge")
    check(len(merged_states) == 6
          and all(s.grid is merger.merged_grid
                  for s in merger.merged_states),
          "rendezvous: merged states do not share one grid")
    check(bool(torch.isfinite(merger.merged_grid).all()),
          "rendezvous: merged grid non-finite")
    check(not starved, f"rendezvous: robots {starved} could reach an "
          "untaken frontier but got none")
    check((assignment >= 0).any(), "rendezvous: no robot got a frontier")
    return {"per": "poll (the last one merges)",
            "k1_launches_by_batch": _k1_sum([bc.n], len(poll_ms))}, out


def phase_fuse_paths(torch, cfg, mapped, seed: int):
    """`fuse_scans_bucketed` at 37, 100 and 200 scans near walls of
    rooms_world (70% of them unmasked) onto the mapper drive's map, each
    held bit for bit against `fuse_scans_masked` on the same batch; then
    `fuse_scans_touched` at 64 scattered poses (tile 256), its grid held
    against `fuse_scans` and its touched tiles against a host
    recomputation from `patch_origin_host`."""
    import numpy as np
    from jax_mapping_torch.ops import fuse_kernel as FK
    from jax_mapping_torch.ops import grid as G
    from jax_mapping_torch.ops import pyramid as PYR
    from jax_mapping_torch.sim import lidar
    from jax_mapping_torch.sim import world as Wd
    n, res = cfg.grid.size_cells, cfg.grid.resolution_m
    world = torch.as_tensor(Wd.rooms_world(n, res, seed=1),
                            device=mapped.device)
    n_samples = int(cfg.scan.range_max_m / (res * 0.5))
    gen = torch.Generator().manual_seed(seed + 11)
    out = {"phase": "fuse_paths", "bucketed": {}}
    launches = {}
    for B in (37, 100, 200):
        poses = _poses_near_walls(torch, cfg, world, B, gen)
        ranges = lidar.simulate_scans(cfg.scan, world, res, n_samples, poses)
        mask = (torch.rand(B, generator=gen) < 0.7).to(mapped.device)
        with BatchCount(cfg.grid) as bc:
            got = G.fuse_scans_bucketed(cfg.grid, cfg.scan, mapped, ranges,
                                        poses, mask)
        want = G.fuse_scans_masked(cfg.grid, cfg.scan, mapped, ranges,
                                   poses, mask)
        equal = bool(torch.equal(got, want))
        ms = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            G.fuse_scans_bucketed(cfg.grid, cfg.scan, mapped, ranges, poses,
                                  mask)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        out["bucketed"][str(B)] = {
            "bucket": G._batch_bucket(B), "unmasked": int(mask.sum()),
            "ms": statistics.median(ms), "bit_equal_masked": equal,
            "cells_changed": int((got != mapped).sum()),
            "k1_launches": bc.n}
        launches[f"bucketed_{B}"] = bc.n
        check(equal, f"fuse_paths: fuse_scans_bucketed({B}) differs from "
              "fuse_scans_masked")
        del got, want
    B = 64
    poses = _poses_near_walls(torch, cfg, world, B, gen)
    ranges = lidar.simulate_scans(cfg.scan, world, res, n_samples, poses)
    with BatchCount(cfg.grid) as bc:
        grid_t, touched = FK.fuse_scans_touched(cfg.grid, cfg.scan,
                                                REVISION_TILE, mapped,
                                                ranges, poses)
    want = G.fuse_scans(cfg.grid, cfg.scan, mapped, ranges, poses)
    K = FK.patch_span_tiles(cfg.grid, REVISION_TILE)
    nt = n // REVISION_TILE
    host = np.zeros((nt, nt), bool)
    for p in poses.cpu().numpy():
        r0, c0 = PYR.patch_origin_host(cfg.grid, p[:2])
        tr = min(r0 // REVISION_TILE, nt - K)
        tc = min(c0 // REVISION_TILE, nt - K)
        host[tr:tr + K, tc:tc + K] = True
    ms = cuda_ms(lambda: FK.fuse_scans_touched(
        cfg.grid, cfg.scan, REVISION_TILE, mapped, ranges, poses), reps=3,
        warmup=1)
    out["touched"] = {
        "scans": B, "tile_cells": REVISION_TILE, "boxes": K,
        "ms": ms, "grid_bit_equal": bool(torch.equal(grid_t, want)),
        "touched_equal_host": bool(np.array_equal(touched.cpu().numpy(),
                                                  host)),
        "tiles_touched": int(touched.sum()), "tiles": nt * nt,
        "k1_launches": bc.n}
    launches["touched_64"] = bc.n
    emit(out)
    check(out["touched"]["grid_bit_equal"],
          "fuse_paths: fuse_scans_touched's grid differs from fuse_scans")
    check(out["touched"]["touched_equal_host"],
          "fuse_paths: touched tiles differ from the host recomputation")
    return {"per": "phase (three bucketed fuses, one touched fuse)",
            "k1_launches_by_batch": _k1_sum(launches.values())}, out


def recovery_k1_rows(torch, cfg, world, gen, fleet: dict, mapper: dict,
                     new_paths: dict) -> dict:
    """K1 at the batches only the recovery path launches: deltas at 48
    scans (the bucket of a 37-scan `fuse_scans_bucketed`), and the
    relocalizer's wide stage on the 4x coarser view (0.2 m cells, the
    same 640^2 patch): 21 coarse angles and 23 x 23 sub-cell offsets
    (529)."""
    from jax_mapping_torch.models import slam as S
    from jax_mapping_torch.ops import grid as G
    from jax_mapping_torch.sim import lidar
    res = cfg.grid.resolution_m
    n_samples = int(cfg.scan.range_max_m / (res * 0.5))
    rows = {}
    poses = _poses_near_walls(torch, cfg, world, 48, gen)
    ranges = lidar.simulate_scans(cfg.scan, world, res, n_samples, poses)
    origins = G.patch_origin(cfg.grid, poses[:, :2]).contiguous()
    rows["sensor_model_delta_b48"] = _k1_row(
        torch, cfg, False, ranges, poses, origins, fleet, mapper,
        new_paths=new_paths)
    g_c, m_c = S._loop_wide_cfgs(cfg)
    cfg_c = cfg.replace(grid=g_c, matcher=m_c)
    guess = _poses_near_walls(torch, cfg, world, 1, gen)
    scans = lidar.simulate_scans(cfg.scan, world, res, n_samples, guess)
    tag = f"@{g_c.resolution_m:g}m"
    for stage, B in (("coarse", 21), ("subcell", 529)):
        r_b, p_b, o_b = _raster_inputs(torch, cfg_c, scans, guess, stage)
        check(r_b.shape[0] == B, f"wide {stage} batch {r_b.shape[0]}")
        rows[f"sensor_model_raster_wide_b{B}"] = dict(
            _k1_row(torch, cfg_c, True, r_b, p_b, o_b, fleet, mapper,
                    key=f"{B}{tag}", new_paths=new_paths),
            grid_resolution_m=g_c.resolution_m)
    return rows


def _parity_recovery(torch) -> dict:
    """One relocalization streak and one merge at tiny_config, each on the
    card and on the CPU from the same inputs (tests/torch_kernel_inputs.py
    `reloc_inputs`, `tiny_fleets`): the same streak, cache counters and
    merge poll; poses within the matcher's tolerance (one fine step, one
    fine angle step: its convolution rounds differently on the two
    devices), the anchored graphs within the Gauss-Newton tolerance
    (1e-3) and at most 1e-3 of the merged grid's cells apart."""
    import numpy as np
    from jax_mapping_torch.config import tiny_config
    from jax_mapping_torch.recovery import Relocalizer
    from jax_mapping_torch.scenarios import rendezvous as RV
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import torch_kernel_inputs as KI
    cfg = tiny_config(2)
    m = cfg.matcher
    out = {"reloc_pose_m": 0.0, "reloc_yaw_rad": 0.0}
    grid, ranges, guess = KI.reloc_inputs(cfg)
    card, cpu = Relocalizer(cfg.recovery, 1), Relocalizer(cfg.recovery, 1)
    streak = []
    for _ in range(2):
        a = card.attempt_for(0, cfg, grid.cuda(), ranges.numpy(),
                             guess.numpy(), lambda *_: 1)
        b = cpu.attempt_for(0, cfg, grid, ranges.numpy(), guess.numpy(),
                            lambda *_: 1)
        check((a is None) == (b is None), "parity: relocalization streak")
        if a is not None:
            out["reloc_pose_m"] = max(out["reloc_pose_m"],
                                      float(np.abs(a[:2] - b[:2]).max()))
            out["reloc_yaw_rad"] = max(out["reloc_yaw_rad"],
                                       float(abs(a[2] - b[2])))
        streak.append(a is not None)
    out["streak"] = streak
    check(streak == [False, True], f"parity: streak {streak}")
    check(card.snapshot() == cpu.snapshot(),
          "parity: relocalizer counters differ")
    T = np.array([0.9, -0.7, 0.6], np.float32)
    a_cpu, b_cpu = KI.tiny_fleets(cfg, T)
    a_dev, b_dev = KI.tiny_fleets(cfg, T, "cuda")
    anchor = (1, a_cpu[1].graph.poses[5].numpy() + np.float32(0.02))
    g1, m1 = RV.merge_fleets(cfg, a_dev, b_dev, T, anchor=anchor)
    g0, m0 = RV.merge_fleets(cfg, a_cpu, b_cpu, T, anchor=anchor)
    out["merge_pose"] = max(float((x.graph.poses.cpu() - y.graph.poses)
                                  .abs().max()) for x, y in zip(m1, m0))
    out["merge_cells"] = int((g1.cpu() != g0).sum())
    cap = cfg.loop.max_poses
    polls = []
    for a, b in ((a_dev, b_dev), (a_cpu, b_cpu)):
        mg = RV.RendezvousMerger(cfg, KI.StandInMapper(a, cap),
                                 KI.StandInMapper(b, cap))
        polls.append(([mg.poll() for _ in range(3)], mg.transform))
    out["merge_polls"] = polls[0][0]
    check(polls[0][0] == polls[1][0] and any(polls[0][0]),
          f"parity: merger polls {polls[0][0]} (card) vs {polls[1][0]}")
    dt = np.abs(polls[0][1] - polls[1][1])
    out["merge_transform"] = [float(v) for v in dt]
    n_cells = cfg.grid.size_cells ** 2
    check(out["reloc_pose_m"] <= m.fine_step_m + 1e-5
          and out["reloc_yaw_rad"] <= m.fine_angle_step_rad + 1e-5,
          f"parity: relocalized poses differ by {out}")
    check(out["merge_pose"] <= 1e-3 and out["merge_cells"] <= 1e-3 * n_cells,
          f"parity: merges differ by {out}")
    check(dt[:2].max() <= m.fine_step_m + 1e-5
          and dt[2] <= m.fine_angle_step_rad + 1e-5,
          f"parity: merge transforms differ by {dt}")
    return out


# ---------------------------------------------------------------------------
# Slice 9: the tenant megabatch
# ---------------------------------------------------------------------------

#: (active tenants, bucket) of the tenancy phase's runs: bucket 3 full,
#: then 5 tenants in bucket 6 (one pad lane).
TENANT_RUNS = ((3, 3), (5, 6))
#: Cut from 10 (PR 9) to keep the whole smoke near 660 s with the
#: coldstart phases; the checks count per tick and need ticks 0-3.
TENANT_TICKS = 6
#: The frontier options' megabatch runs, each at 3 tenants in bucket 3.
TENANT_OPTIONS = ("exact_bfs", "decay_aware", "planned_goals")
#: The default options at the top of the exact ladder.
TENANT_WIDE = (12, 12)


class HopCount:
    """Counts the solo `fleet_step` calls (pending hops) made while the
    context is open."""

    def __enter__(self):
        from jax_mapping_torch.models import fleet as FL
        self.fl, self.orig, self.n = FL, FL.fleet_step, 0

        def counted(*args, **kwargs):
            self.n += 1
            return self.orig(*args, **kwargs)
        FL.fleet_step = counted
        return self

    def __exit__(self, *exc):
        self.fl.fleet_step = self.orig


def _tenant_missions(torch, cfg, n: int, seed: int):
    """n missions of the default config: mission t on rooms_world(4096,
    0.05, seed=1 + t), its robots started near walls (`_poses_near_walls`)
    so that every mission maps walls from its first tick."""
    from jax_mapping_torch.models import fleet as FL
    from jax_mapping_torch.sim import world as Wd
    states, worlds = [], []
    for t in range(n):
        gen = torch.Generator().manual_seed(seed + 100 + t)
        w = torch.as_tensor(Wd.rooms_world(cfg.grid.size_cells,
                                           cfg.grid.resolution_m,
                                           seed=1 + t), device=DEV)
        st = FL.init_fleet_state(cfg, device=DEV, generator=gen)
        p = _poses_near_walls(torch, cfg, w, cfg.fleet.n_robots, gen)
        states.append(st._replace(sim=st.sim._replace(poses=p.clone()),
                                  est_poses=p.clone()))
        worlds.append(w)
    return states, worlds


def _tree_equal(torch, a, b) -> bool:
    from jax_mapping_torch.tenancy import megabatch as MB
    out = []
    MB._tree_map(lambda x, y: out.append(bool(torch.equal(x, y))), a, b)
    return all(out)


def _tree_max_diff(torch, a, b) -> float:
    from jax_mapping_torch.tenancy import megabatch as MB
    out = [0.0]

    def d(x, y):
        if not torch.equal(x, y):
            out.append(float((x.double() - y.double()).abs().nan_to_num(
                posinf=1e30).max()) if x.is_floating_point() else 1.0)
    MB._tree_map(d, a, b)
    return max(out)


def _solo_runs(torch, cfg, states, worlds, normals, ticks: int):
    """Each mission's solo `fleet_step` run on the card with its lane's
    normals: (final states, tick ms, host syncs of mission 0's ticks 1-3,
    peak bytes)."""
    from jax_mapping_torch.models import fleet as FL
    res = cfg.grid.resolution_m
    finals, ms, syncs = [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for t, (st, w) in enumerate(zip(states, worlds)):
        for k in range(ticks):
            t0 = time.perf_counter()
            if t == 0 and 1 <= k <= 3:
                (st, _d), n = _count_syncs(torch, lambda: FL.fleet_step(
                    cfg, st, res, w, wheel_normals=normals[k][t]))
                syncs.append(n)
            else:
                st, _d = FL.fleet_step(cfg, st, res, w,
                                       wheel_normals=normals[k][t])
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        finals.append(st)
    return finals, ms, syncs, torch.cuda.max_memory_allocated()


def _tenant_run(torch, cfg, n_active: int, bucket: int, seed: int,
                masks: "K3MaskCount" = None) -> dict:
    """One megabatch run of TENANT_TICKS ticks and each mission's solo
    run; `masks`, an open K3MaskCount, is read after the megabatch ticks
    (before the solo runs)."""
    from jax_mapping_torch.ops import _cuda
    from jax_mapping_torch.tenancy import megabatch as MB
    res = cfg.grid.resolution_m
    R = cfg.fleet.n_robots
    states, worlds = _tenant_missions(torch, cfg, n_active, seed)
    batch0 = MB.make_tenant_batch(states, worlds, list(range(n_active)),
                                  capacity=bucket)
    gen = torch.Generator().manual_seed(seed + 7 * bucket)
    normals = [torch.randn((bucket, R, 2), generator=gen).to(DEV)
               for _ in range(TENANT_TICKS)]
    b = batch0
    tick_ms, syncs, words, keys = [], [], [], []
    accepted = torch.zeros(bucket, dtype=torch.int64)
    accepted_key = torch.zeros(bucket, dtype=torch.int64)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    with BatchCount(cfg.grid) as bc, HopCount() as hops:
        for k in range(TENANT_TICKS):
            t0 = time.perf_counter()
            if 1 <= k <= 3:
                (b, diag, h), n = _count_syncs(torch, lambda: MB.megabatch_tick(
                    cfg, b, res, wheel_normals=normals[k]))
                syncs.append(n)
            else:
                b, diag, h = MB.megabatch_tick(cfg, b, res,
                                               wheel_normals=normals[k])
            torch.cuda.synchronize()
            tick_ms.append((time.perf_counter() - t0) * 1e3)
            words.append([int(x) for x in h])
            keys.append(diag.is_key.sum(dim=1).tolist())
            ok = diag.match_response >= cfg.matcher.min_response
            accepted += ok.sum(dim=1).cpu()
            accepted_key += (ok & diag.is_key).sum(dim=1).cpu()
    launches = dict(_cuda.LAUNCHES)
    routes = {k: dict(v) for k, v in _cuda.ROUTES.items()}
    per_field_masks = None if masks is None else masks.n
    peak = torch.cuda.max_memory_allocated()
    occ = (b.states.grid > cfg.grid.occ_threshold).flatten(1).sum(1).cpu()

    solo, solo_ms, solo_syncs, solo_peak = _solo_runs(
        torch, cfg, states, worlds, normals, TENANT_TICKS)
    equal = [_tree_equal(torch, MB.lane_state(b, t), solo[t])
             for t in range(n_active)]
    diffs = [_tree_max_diff(torch, MB.lane_state(b, t), solo[t])
             for t in range(n_active)]
    pad_frozen = [_tree_equal(torch, MB.lane_state(b, t),
                              MB.lane_state(batch0, t))
                  for t in range(n_active, bucket)]
    steady = tick_ms[1:]
    p = _p50_p90(steady)
    solo_p = _p50_p90(solo_ms)
    out = {
        "tenants": n_active, "bucket": bucket, "ticks": TENANT_TICKS,
        "robots_per_tenant": R, "tick_ms": tick_ms,
        "tick_p50_ms": p["p50"], "tick_p90_ms": p["p90"],
        "ms_per_mission_step": p["p50"] / n_active,
        "solo_tick_p50_ms": solo_p["p50"], "solo_tick_p90_ms": solo_p["p90"],
        "speedup_vs_sequential_solo": solo_p["p50"] * n_active / p["p50"],
        "host_syncs_ticks_1_to_3": syncs,
        "solo_host_syncs_ticks_1_to_3": solo_syncs,
        "pending_hops": hops.n, "launches": launches,
        "launches_per_tick": {k: v / TENANT_TICKS
                              for k, v in launches.items()},
        "routes": routes,
        "k1_launches_per_tick_by_batch": bc.per_tick(TENANT_TICKS),
        "k1_launches_by_batch": bc.n,
        "peak_bytes": peak, "solo_peak_bytes": solo_peak,
        "lanes_bit_equal_solo": equal, "lane_max_abs_diff": diffs,
        "pad_lanes_frozen": pad_frozen,
        "occupied_cells": occ[:n_active].tolist(),
        "accepted_matches": accepted[:n_active].tolist(),
        "accepted_key_matches": accepted_key[:n_active].tolist(),
        "key_robots_per_tick": keys, "health_words": words,
        "k3_per_field_mask_launches": per_field_masks}
    return out, b, solo, worlds


def _megabatch_match_inputs(torch, cfg, b) -> tuple:
    """A tenant batch's `match_batch` inputs, (grid, scans, guesses,
    tenant): every lane's scans simulated at its sim poses in its world,
    against its own grid from its estimates, the rows in tenant order."""
    from jax_mapping_torch.sim import lidar
    res = cfg.grid.resolution_m
    ns = int(cfg.scan.range_max_m / (res * 0.5))
    B, R = b.active.shape[0], cfg.fleet.n_robots
    ten = torch.arange(B, device=b.states.grid.device).repeat_interleave(R)
    scans = lidar.simulate_scans(cfg.scan, b.worlds, res, ns,
                                 b.states.sim.poses.reshape(B * R, 3),
                                 tenant=ten)
    return (b.states.grid, scans, b.states.est_poses.reshape(B * R, 3),
            ten)


def _matcher_split(torch, cfg, b) -> dict:
    """The megabatch's `match_batch` (every lane's scans at its sim poses
    against its own grid) with the per-lane split of the float
    reductions (the correlations are K8's, whole either way), without
    it, and as one solo call a lane: mismatched elements of each field
    against the solo calls, and CUDA-event ms."""
    from jax_mapping_torch.ops import scan_match as M
    B, R = b.active.shape[0], cfg.fleet.n_robots
    _grid, scans, est, ten = _megabatch_match_inputs(torch, cfg, b)

    def batched():
        return M.match_batch(cfg.grid, cfg.scan, cfg.matcher,
                             b.states.grid, scans, est, tenant=ten)

    def solo():
        return [M.match_batch(cfg.grid, cfg.scan, cfg.matcher,
                              b.states.grid[t], scans[t * R:(t + 1) * R],
                              est[t * R:(t + 1) * R]) for t in range(B)]

    want = M.MatchResult(*(torch.cat(x) for x in zip(*solo())))

    def diff(got):
        return {f: compare(x, y)
                for f, x, y in zip(M.MatchResult._fields, got, want)}

    out = {"split_mismatches": diff(batched()),
           "split_ms": cuda_ms(batched, reps=3, warmup=1),
           "solo_calls_ms": cuda_ms(solo, reps=3, warmup=1)}
    split = M._per_lane
    M._per_lane = lambda fn, *xs: fn(*xs)
    try:
        out["whole_mismatches"] = diff(batched())
        out["whole_ms"] = cuda_ms(batched, reps=3, warmup=1)
    finally:
        M._per_lane = split
    return out


def _check_tenant_run(out: dict, k3_per_tick: int = 3) -> None:
    from jax_mapping_torch.tenancy import megabatch as MB
    n_active, words = out["tenants"], out["health_words"]
    launches, routes = out["launches"], out["routes"]
    check(all(w == 0 for ws in words for w in ws),
          f"tenancy T={n_active}: a health word is set on a clean run")
    for name in FLEET_KERNELS:
        check(launches[name] > 0,
              f"tenancy: kernel {name} never launched on the megabatch path")
    for name, per_tick in dict(FLEET_SWEEP_LAUNCHES,
                               costfield_relax=k3_per_tick).items():
        check(launches[name] == per_tick * TENANT_TICKS,
              f"tenancy T={n_active}: {name} launched {launches[name]} "
              f"times in {TENANT_TICKS} ticks, not {per_tick} a tick")
        check(all(r.startswith("cluster") for r in routes[name]),
              f"tenancy: {name} left the cluster route: {routes[name]}")
    check(all(out["pad_lanes_frozen"]),
          f"tenancy T={n_active}: a pad lane moved")
    check(all(o > 0 for o in out["occupied_cells"]),
          f"tenancy T={n_active}: a tenant mapped no wall")
    check(all(a > 0 for a in out["accepted_matches"]),
          f"tenancy T={n_active}: a tenant accepted no match")
    check("matcher_split" not in out or not any(
        v["mismatches"] for v in
        out["matcher_split"]["split_mismatches"].values()),
        f"tenancy T={n_active}: the split matcher differs from solo")
    if out["bucket"] in MB.EXACT_BUCKETS:
        check(all(out["lanes_bit_equal_solo"]),
              f"tenancy: bucket {out['bucket']} is on the exact ladder but "
              f"lanes differ from solo: {out['lane_max_abs_diff']}")


def _tenant_health(torch, cfg, b, solo, worlds, seed: int) -> dict:
    """Lane 1's grid poisoned with a NaN before ticks 0, 2 and 3 of four
    (cleared before tick 1): only lane 1's word may carry
    HEALTH_NONFINITE, the co-tenants stay bit-equal to their solo runs,
    and the words fold through `LaneHealthLadder`."""
    from jax_mapping_torch.models import fleet as FL
    from jax_mapping_torch.tenancy import lanehealth as LH
    from jax_mapping_torch.tenancy import megabatch as MB
    res = cfg.grid.resolution_m
    n = cfg.grid.size_cells // 2
    B, R = b.active.shape[0], cfg.fleet.n_robots
    gen = torch.Generator().manual_seed(seed + 31)
    ladder = LH.LaneHealthLadder(cfg.tenancy)
    words = []
    solo = list(solo)
    for k, poison in enumerate((True, False, True, True)):
        grid = b.states.grid.clone()
        grid[1, n, n] = float("nan") if poison else 0.0
        b = b._replace(states=b.states._replace(grid=grid))
        normals = torch.randn((B, R, 2), generator=gen).to(DEV)
        b, _diag, h = MB.megabatch_tick(cfg, b, res, wheel_normals=normals)
        words.append([int(x) for x in h])
        for t in (0, 2):
            solo[t], _ = FL.fleet_step(cfg, solo[t], res, worlds[t],
                                       wheel_normals=normals[t])
        for t, w in enumerate(h):
            ladder.observe(f"m{t}", int(w), k)
    co_equal = [_tree_equal(torch, MB.lane_state(b, t), solo[t])
                for t in (0, 2)]
    out = {"poisoned_lane": 1, "poisoned_ticks": [0, 2, 3],
           "health_words": words, "co_tenants_bit_equal_solo": co_equal,
           "ladder_transitions": [list(x) for x in ladder.transitions],
           "ladder_states": {f"m{t}": ladder.state(f"m{t}")
                             for t in range(B)}}
    return out


def _check_tenant_health(out: dict, B: int) -> None:
    from jax_mapping_torch.tenancy import lanehealth as LH
    from jax_mapping_torch.tenancy import megabatch as MB
    words = out["health_words"]
    check(all(words[k][1] & MB.HEALTH_NONFINITE for k in (0, 2, 3)),
          "tenancy: the poisoned lane's word lacks HEALTH_NONFINITE")
    check(all(w[t] == 0 for w in words for t in range(B) if t != 1),
          "tenancy: a co-tenant's health word is set")
    check(all(out["co_tenants_bit_equal_solo"]),
          "tenancy: a co-tenant of the poisoned lane moved off its solo run")
    check(out["ladder_states"]["m1"] == LH.QUARANTINED,
          "tenancy: the poisoned lane was not quarantined")


def phase_tenancy(torch, cfg, seed: int):
    """Slice 9's main path: `megabatch_tick` over missions of the default
    config (TenancyConfig(enabled=True, lane_health=True)), each on its own
    rooms_world(4096, 0.05, seed=1 + t) with its robots near walls, 10
    ticks at 3 tenants (bucket 3) and at 5 in bucket 6 (one pad lane).
    Launch counts are zeroed before each run's ticks and read after; K2
    must launch once and K3 three times a tick for all tenants. Every lane
    is held against the mission's solo `fleet_step` run on the card from
    the same state with the same normals; then the NaN-poisoned lane.
    Then each frontier option of TENANT_OPTIONS alone at 3 tenants (K3 a
    tick: exact_bfs 1, all 24 fields under a mask each; decay_aware 3;
    planned_goals 6), and the default options at 12 tenants (bucket 12),
    each lane again against its solo run; K8 at each call site of the
    12-tenant batch's `match_batch` (`k8_rows`). Returns (the path's K1
    counts, the first run's grids and poses with the K8 rows, the line,
    the option runs' K2/K3 calls)."""
    import dataclasses
    from jax_mapping_torch.config import TenancyConfig
    cfg = cfg.replace(tenancy=TenancyConfig(enabled=True, lane_health=True))
    runs, k1, keep = {}, [], None
    for n_active, bucket in TENANT_RUNS:
        out, b, solo, worlds = _tenant_run(torch, cfg, n_active, bucket,
                                           seed)
        out["matcher_split"] = _matcher_split(torch, cfg, b)
        runs[f"T{n_active}_in_{bucket}"] = out
        k1.append(out.pop("k1_launches_by_batch"))
        if keep is None:
            keep = (b, solo, worlds)
        del b, solo, worlds
    b, solo, worlds = keep
    grids, poses = b.states.grid.clone(), b.states.est_poses.clone()
    health = _tenant_health(torch, cfg, b, solo, worlds, seed)
    del keep, b, solo, worlds
    k3_per_tick, recs = {}, {}
    for name in TENANT_OPTIONS:
        c = cfg.replace(frontier=dataclasses.replace(cfg.frontier,
                                                     **{name: True}))
        with K3MaskCount() as km, SweepRecorder() as rec:
            run, b, solo, worlds = _tenant_run(torch, c, 3, 3, seed, km)
        del b, solo, worlds
        run["option"] = name
        key = f"T3_in_3_{name}"
        runs[key], recs[name] = run, rec
        k3_per_tick[key] = OPTION_K3_PER_TICK[name]
        k1.append(run.pop("k1_launches_by_batch"))
    n_active, bucket = TENANT_WIDE
    with K3MaskCount() as km:
        run, b, solo, worlds = _tenant_run(torch, cfg, n_active, bucket,
                                           seed, km)
    del solo, worlds
    k8 = k8_rows(torch, cfg, *_megabatch_match_inputs(torch, cfg, b))
    del b
    runs[f"T{n_active}_in_{bucket}"] = run
    k1.append(run.pop("k1_launches_by_batch"))
    out = {"phase": "tenancy", "config": "SlamConfig(), lane_health",
           "runs": runs, "health": health}
    emit(out)
    for key, run in runs.items():
        _check_tenant_run(run, k3_per_tick.get(key, 3))
    check(runs["T3_in_3_exact_bfs"]["k3_per_field_mask_launches"]
          == TENANT_TICKS, "tenancy: exact_bfs did not make one K3 launch "
          "with a mask per field a tick")
    _check_tenant_health(health, TENANT_RUNS[0][1])
    n_runs = len(TENANT_RUNS) + len(TENANT_OPTIONS) + 1
    return ({"per": f"{n_runs} runs of {TENANT_TICKS} ticks",
             "k1_launches_by_batch": _k1_sum(k1)},
            {"grids": grids, "poses": poses, "k8_rows": k8}, out, recs)


def tenancy_kernel_rows(torch, cfg, world, gen, fleet: dict, mapper: dict,
                        new_paths: dict, tenancy: dict) -> dict:
    """K1 at the megabatch's batches (T = 3: rasters 3 x 168 and 3 x 392,
    deltas 3 x 8), K2 over the 3 tenants' 256^2 clustering masks in one
    launch, K3 over their 3 x 8 fields under a mask each (three levels):
    exact against the plain versions, bounds T times the solo rows'."""
    from jax_mapping_torch.ops import costfield as CF
    from jax_mapping_torch.ops import frontier as F
    from jax_mapping_torch.ops import grid as G
    from jax_mapping_torch.sim import lidar
    res = cfg.grid.resolution_m
    n_samples = int(cfg.scan.range_max_m / (res * 0.5))
    T, R = TENANT_RUNS[0][0], cfg.fleet.n_robots
    rows = {}
    guess = _poses_near_walls(torch, cfg, world, T * R, gen)
    scans = lidar.simulate_scans(cfg.scan, world, res, n_samples, guess)
    origins = G.patch_origin(cfg.grid, guess[:, :2]).contiguous()
    rows[f"sensor_model_delta_tenant_b{T * R}"] = _k1_row(
        torch, cfg, False, scans, guess, origins, fleet, mapper,
        new_paths=new_paths)
    for stage, per in (("coarse", 21), ("subcell", 49)):
        r_b, p_b, o_b = _raster_inputs(torch, cfg, scans, guess, stage)
        rows[f"sensor_model_raster_tenant_b{T * R * per}"] = _k1_row(
            torch, cfg, True, r_b, p_b, o_b, fleet, mapper,
            new_paths=new_paths)

    fcfg = cfg.frontier
    grids = tenancy["grids"][:T]
    free, _occ, unknown = F.coarsen(fcfg, cfg.grid, grids)
    mask = F.frontier_mask(free, unknown)
    mask2 = F._pool_any(mask, fcfg.cluster_downsample).contiguous()
    n = mask2.shape[-1]
    iters = max(1, -(-fcfg.label_prop_iters // fcfg.cluster_downsample))
    lin = torch.arange(n * n, dtype=torch.int32,
                       device=grids.device).reshape(n, n)
    seed_lab = torch.where(mask2, lin, -1).to(torch.int32)
    sweeps = 2 * iters + 1
    got, ran = F.label_sweeps(mask2, seed_lab, sweeps)
    want = torch.stack([F._label_prop_plain(mask2[t], seed_lab[t], iters)
                        for t in range(T)])
    rows[f"label_prop_tenant_t{T}"] = dict(
        compare(got, want), shape=[T, n, n], sweeps=sweeps, **ran,
        mask_cells=int(mask2.sum()),
        **_sweep_times(lambda: F.label_prop(mask2, seed_lab, iters),
                       lambda: F._label_prop_plain(mask2, seed_lab, iters),
                       "label", sweeps),
        **bound(*L.label_prop_cost(mask2, sweeps)))

    passable, bfs_res = F.bfs_passability(fcfg, cfg.grid, free, unknown,
                                          mask)
    blocked = ~passable
    ox, oy = cfg.grid.origin_m
    pose = tenancy["poses"][:T]
    rc = torch.stack([((pose[..., 1] - oy) / bfs_res).to(torch.int32),
                      ((pose[..., 0] - ox) / bfs_res).to(torch.int32)], -1)
    calls = []

    def relax_recorded(blk, init, iters):
        calls.append((blk, init, iters))
        return CF.relax_level(blk, init, iters)

    got = CF.cost_fields(blocked, rc, fcfg.mg_levels, fcfg.mg_refine_iters,
                         relax=relax_recorded)
    want = torch.stack([CF.cost_fields(blocked[t], rc[t], fcfg.mg_levels,
                                       fcfg.mg_refine_iters,
                                       relax=CF._relax_level_xla)
                        for t in range(T)])
    levels = [dict(n=init.shape[-1], sweeps=2 * iters,
                   **CF.relax_sweeps(blk, init, 2 * iters)[1],
                   **_sweep_times(
                       lambda: CF.relax_level(blk, init, iters),
                       lambda: CF._relax_level_xla(blk, init, iters),
                       "relax", 2 * iters))
              for blk, init, iters in calls]
    costs = [L.relax_cost(blk, init, 2 * iters) for blk, init, iters in calls]
    n_bytes = sum(c[0] for c in costs)
    n_ops = sum(c[1] for c in costs)
    rows[f"costfield_relax_tenant_t{T}"] = dict(
        compare(got, want), shape=[T, R, n, n],
        reachable_cells=int((want < CF._BIG).sum()), levels=levels,
        **{k: (None if None in [v[k] for v in levels]
               else sum(v[k] for v in levels))
           for k in ("ms", "device_ms", "plain_ms")},
        **bound(n_bytes, n_ops))
    return rows


def _parity_megabatch(torch, seed: int, T: int = 3, ticks: int = 6) -> dict:
    """A micro_config megabatch of T missions, each tick run on the card
    and on the CPU from the same CPU batch with the same normals."""
    from jax_mapping_torch import interop
    from jax_mapping_torch.config import micro_config
    from jax_mapping_torch.models import fleet as FL
    from jax_mapping_torch.sim import world as Wd
    from jax_mapping_torch.tenancy import megabatch as MB
    cfg = micro_config(2)
    res = cfg.grid.resolution_m
    gen = torch.Generator().manual_seed(seed + 5)
    states = [FL.init_fleet_state(cfg, device="cpu", generator=gen)
              for _ in range(T)]
    worlds = [Wd.rooms_world(64, res, seed=1 + t) for t in range(T)]
    b = MB.make_tenant_batch(states, worlds, list(range(T)))
    worst = {"config": f"micro_config(2) x {T}", "ticks": ticks,
             "pose_m": 0.0, "cells": 0, "keys": 0,
             "cells_total": T * cfg.grid.size_cells ** 2}
    for _ in range(ticks):
        normals = torch.randn((b.active.shape[0], 2, 2), generator=gen)
        on_card = interop.tenant_batch_from_numpy(
            interop.tenant_batch_to_numpy(b), "cuda")
        g, gd, _h = MB.megabatch_tick(cfg, on_card, res,
                                      wheel_normals=normals)
        b, cd, _h = MB.megabatch_tick(cfg, b, res, wheel_normals=normals)
        check(torch.equal(gd.is_key.cpu(), cd.is_key),
              "parity megabatch: key gate")
        check(torch.equal(gd.frontiers.assignment.cpu(),
                          cd.frontiers.assignment),
              "parity megabatch: assignment")
        worst["keys"] += int(cd.is_key.sum())
        dp = (g.states.est_poses.cpu() - b.states.est_poses).abs()
        worst["pose_m"] = max(worst["pose_m"], float(dp.max()))
        worst["cells"] = max(worst["cells"], int(
            (g.states.grid.cpu() != b.states.grid).sum()))
    return worst


# ---------------------------------------------------------------------------
# Slice 10: the simulated mission stack
# ---------------------------------------------------------------------------

STACK_ROBOTS = 8
STACK_STEPS = 150
STACK_BURST = 16
STACK_SYNC_TICKS = (10, 11, 12)
STACK_PARITY_STEPS = 40
#: Robot 0's navigation goal (x, y, theta) in the stack's room.
STACK_GOAL = (4.0, 2.0, 0.0)
#: The stack's world: rooms_world(1024, 0.05, seed=1) with 2 m doors. The
#: default frontier config plans on 0.8 m cells pooled conservatively,
#: which seal the generated 0.5 m doors, so in rooms_world itself every
#: frontier the fleet sees through a door costs 1e9 in both packages
#: (ROADMAP C.3, tests/test_torch_frontier_scene.py).
STACK_WORLD = "rooms_wide_doors(1024, 0.05, door_m=2.0, seed=1)"
#: The depth-camera stack's mapper restart, after this many steps.
STACK_DEPTH_RESTART = 100


def _stack_world(res: float):
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import torch_kernel_inputs as KI
    return KI.rooms_wide_doors(1024, res, door_m=2.0, seed=1)


def _timed(fn, ms: list):
    """fn, with each call's host-clock duration appended to `ms`."""
    def timed(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            ms.append((time.perf_counter() - t0) * 1e3)
    return timed


class StageSamples:
    """The durations `utils.global_metrics.stages` records for one stage
    while the context is open (its histogram keeps buckets, not
    samples)."""

    def __init__(self, name: str):
        self.name, self.ms = name, []

    def __enter__(self):
        from jax_mapping_torch.utils import global_metrics as M
        self.timer, self.orig = M.stages, M.stages.observe

        def observe(name, dt_s):
            if name == self.name:
                self.ms.append(dt_s * 1e3)
            self.orig(name, dt_s)
        self.timer.observe = observe
        return self

    def __exit__(self, *exc):
        del self.timer.observe


class HashDevices:
    """The device types of the images `ops/grid.tile_hashes` is handed
    while the context is open (a tile store hashes an image where it
    lies)."""

    def __enter__(self):
        from jax_mapping_torch.ops import grid as G
        self.G, self.orig, self.seen = G, G.tile_hashes, set()

        def recording(arr, tile_cells):
            self.seen.add(arr.device.type)
            return self.orig(arr, tile_cells)
        G.tile_hashes = recording
        return self

    def __exit__(self, *exc):
        self.G.tile_hashes = self.orig


def _stack_step_reads(mapper) -> list:
    """Wraps the mapper's per-step host read: returns the list every
    step's StepRead is appended to."""
    reads, orig = [], mapper._read_step

    def read(*args, **kwargs):
        r = orig(*args, **kwargs)
        reads.append(r)
        return r
    mapper._read_step = read
    return reads


def phase_stack(torch, seed: int):
    """Slice 10's main path, the way users start the system:
    `launch_sim_stack` of the default SlamConfig with 8 robots on
    STACK_WORLD, `brain.start_exploring()`, 150
    `run_steps` (sim physics and raycasts, the brain tick, the mapper's
    SLAM steps and frontier publish, the planner every 10 steps, with an
    operator's `/goal_pose` for robot 0). Counts are zeroed before the
    steps and read after: K1 (both modes), K2 and K3 must launch, and the
    planner must plan, and the auction must assign a frontier. Host syncs
    of mapper ticks 10-12 (and of their frontier publishes), host time by
    node. Then a burst: 16 sim and brain
    steps with no mapper tick, and one mapper tick, which must take
    `_step_window` and launch K5."""
    import numpy as np
    from jax_mapping_torch.bridge.launch import launch_sim_stack
    from jax_mapping_torch.bridge.messages import Pose2D
    from jax_mapping_torch.config import SlamConfig
    from jax_mapping_torch.ops import _cuda
    cfg = SlamConfig()
    world = _stack_world(cfg.grid.resolution_m)
    t0 = time.perf_counter()
    st = launch_sim_stack(cfg, world, n_robots=STACK_ROBOTS, seed=seed)
    torch.cuda.synchronize()
    launch_s = time.perf_counter() - t0
    check(st.device.type == "cuda" and st.mapper.shared_grid.is_cuda,
          "the stack is not on the card")
    reads = _stack_step_reads(st.mapper)
    m = st.mapper
    p0 = st.sim.truth_poses()
    fronts = []
    st.bus.subscribe("/frontiers",
                     callback=lambda f: fronts.append(
                         np.asarray(f.assignment)))
    st.brain.start_exploring()
    # An operator's navigation goal for robot 0 (RViz's SetGoal tool):
    # the planner runs plan_to_goal for it every period.
    st.bus.publisher("/goal_pose").publish(Pose2D(*STACK_GOAL))
    node_ms = {k: [] for k in ("sim", "brain", "mapper", "planner")}
    timed = ((st.sim, "step", "sim"), (st.brain, "update_loop", "brain"),
             (m, "tick", "mapper"), (st.planner, "tick", "planner"))
    for node, attr, key in timed:
        setattr(node, attr, _timed(getattr(node, attr), node_ms[key]))
    mapper_tick, publish = m.tick, m.publish_frontiers
    syncs = []

    def counted_tick():
        """Mapper ticks 10-12 under the sync debug mode: the tick's host
        syncs, and those of its frontier publish."""
        if st._steps_run not in STACK_SYNC_TICKS:
            return mapper_tick()
        marks = []

        def marked_publish(corrections=()):
            marks.append(len(win))
            publish(corrections)
            marks.append(len(win))
        with SyncWindow(torch) as win:
            m.publish_frontiers = marked_publish
            try:
                mapper_tick()
            finally:
                del m.publish_frontiers
        flags = [_is_sync(w) for w in win.records]
        syncs.append({"tick": sum(flags), "publish": sum(
            flags[marks[0]:marks[1]]) if marks else 0})
    m.tick = counted_tick
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    with BatchCount(cfg.grid) as bc, SweepRecorder() as rec, \
            StageSamples("mapper.tick") as ticks:
        t0 = time.perf_counter()
        st.run_steps(STACK_STEPS)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    for node, attr, _key in timed:
        delattr(node, attr)
    launches = dict(_cuda.LAUNCHES)
    routes = {k: dict(v) for k, v in _cuda.ROUTES.items()}
    peak = torch.cuda.max_memory_allocated()
    grid = m.shared_grid
    assigned = np.stack(fronts)
    keys = [r for r in reads if r.key_added]
    steady = ticks.ms[1:]
    out = {"phase": "stack", "config": "SlamConfig()",
           "world": STACK_WORLD,
           "robots": STACK_ROBOTS, "steps": STACK_STEPS,
           "launch_s": launch_s, "wall_s": wall,
           "steps_per_s": STACK_STEPS / wall,
           "mapper_tick_first_ms": ticks.ms[0],
           "mapper_tick_ms": {**_p50_p90(steady), "n": len(steady),
                              "max": max(steady)},
           "host_syncs_per_mapper_tick": syncs,
           "sync_ticks": list(STACK_SYNC_TICKS),
           "ms_per_step_by_node": {k: sum(v) / STACK_STEPS
                                   for k, v in node_ms.items()},
           "calls_by_node": {k: len(v) for k, v in node_ms.items()},
           "node_p50_ms": {k: statistics.median(v) for k, v in
                           node_ms.items() if v},
           "launches": launches, "routes": routes,
           "k1_launches_by_batch": bc.n,
           "sweep_calls": sorted({f"{n}_n{i.shape[-1]}_s{s}"
                                  + (f"_r{i.shape[0]}" if i.dim() == 3
                                     else "")
                                  for n, _m, i, s in rec.calls}),
           "steps_read": len(reads), "key_steps": len(keys),
           "matches_accepted": sum(r.matched for r in keys),
           "matches_rejected": sum(not r.matched for r in keys),
           "scans_fused": m.n_scans_fused,
           "loops_closed": m.n_loops_closed,
           "windows_rejected": m.n_windows_rejected_low_agreement,
           "scans_quarantined": m.n_scans_quarantined,
           "frontier_publish": m.frontier_stats(),
           "planner": {"plans": st.planner.n_plans,
                       "reachable": st.planner.last_reachable,
                       "frontier_plans": st.planner.n_frontier_plans,
                       "goal_fields": st.planner.n_goal_fields},
           "goal": list(STACK_GOAL),
           "publishes": len(assigned),
           "publishes_assigning": int((assigned >= 0).any(axis=1).sum()),
           "robot_assignments": int((assigned >= 0).sum()),
           "last_assignment": assigned[-1].tolist(),
           "cells_free": int((grid < cfg.grid.free_threshold).sum()),
           "cells_occupied": int((grid > cfg.grid.occ_threshold).sum()),
           "moved_m": float(np.linalg.norm(
               st.sim.truth_poses()[:, :2] - p0[:, :2], axis=1).max()),
           "peak_bytes": peak}

    # The burst: a stalled mapper's queue, drained as one window.
    n_win = m.n_windows_fused
    _cuda.reset_launches()
    for _ in range(STACK_BURST):
        st.sim.step()
        st.brain.update_loop()
    t0 = time.perf_counter()
    m.tick()
    torch.cuda.synchronize()
    out["burst"] = {"scans_per_robot": STACK_BURST,
                    "mapper_tick_ms": (time.perf_counter() - t0) * 1e3,
                    "windows_fused": m.n_windows_fused - n_win,
                    "launches": dict(_cuda.LAUNCHES)}
    emit(out)
    check(bool(torch.isfinite(grid).all()), "stack grid non-finite")
    check(out["cells_free"] > 0 and out["cells_occupied"] > 0,
          "the stack mapped no free or no occupied cell")
    check(out["moved_m"] > 0.05, "no robot of the stack moved")
    for name in FLEET_KERNELS:
        check(launches[name] > 0,
              f"kernel {name} never launched on the stack path")
    check(out["planner"]["plans"] > 0,
          "the planner made no plan for the operator's goal")
    check(out["robot_assignments"] > 0,
          "the stack's auction assigned no frontier")
    check(out["burst"]["windows_fused"] >= 1
          and out["burst"]["launches"]["window_apply"] >= 1,
          f"the burst did not go through K5: {out['burst']}")
    st.shutdown()
    return ({"per": f"{STACK_STEPS} stack steps",
             "k1_launches_by_batch": bc.n},
            out, rec)


class K6Capture:
    """Keeps the first `voxel_kernel.image_deltas` call's inputs of each
    batch size while the context is open (references: no caller writes
    into them)."""

    def __enter__(self):
        from jax_mapping_torch.ops import voxel_kernel as VK
        self.vk, self.orig, self.inputs = VK, VK.image_deltas, {}

        def captured(vox, cam, d, p, o):
            self.inputs.setdefault(int(d.shape[0]), (d, p, o))
            return self.orig(vox, cam, d, p, o)
        VK.image_deltas = captured
        return self

    def __exit__(self, *exc):
        self.vk.image_deltas = self.orig


def phase_stack_depth(torch, seed: int):
    """The depth-camera stack's main path, as users start it:
    `launch_sim_stack(SlamConfig(), STACK_WORLD, n_robots=8,
    depth_cam=True)` with `planner.use_voxel_obstacles` (the default):
    the sim renders a depth image per robot a step, the voxel mapper fuses
    them at the mapper's corrected poses (K6), the planner plans and the
    mapper's frontier auction runs on the voxel-overlaid map.
    `brain.start_exploring()`, STACK_STEPS `run_steps`, with
    `restart_mapper` after STACK_DEPTH_RESTART of them: the voxel node and
    its map must survive it, and the voxel and keyframe sidecars of an
    auto-checkpoint just before must load back bit-equal. Last, the ring
    of keyframes the drive holds is re-fused once (a closure's repair). Counts are
    zeroed before the steps and read after: K1, K2, K3 and K6 must launch;
    images fused must be 8 a step less those the pairer dropped; the
    auction must assign. Steps/s, the mapper's and the voxel mapper's
    tick p50/p90, host syncs a step by node (steps 10-12), the overlay's
    rebuilds and reuses, keyframes stored and re-fuses, voxels occupied,
    peak memory."""
    import numpy as np
    from jax_mapping_torch.bridge.launch import launch_sim_stack
    from jax_mapping_torch.config import SlamConfig
    from jax_mapping_torch.io import checkpoint as CK
    from jax_mapping_torch.ops import _cuda
    from jax_mapping_torch.ops import voxel as V
    cfg = SlamConfig()
    check(cfg.planner.use_voxel_obstacles, "the planner's overlay is off")
    world = _stack_world(cfg.grid.resolution_m)
    t0 = time.perf_counter()
    st = launch_sim_stack(cfg, world, n_robots=STACK_ROBOTS, seed=seed,
                          depth_cam=True)
    torch.cuda.synchronize()
    launch_s = time.perf_counter() - t0
    vm, pl = st.voxel_mapper, st.planner
    check(vm is not None and vm.voxel_grid().is_cuda,
          "the voxel map is not on the card")
    check(st.mapper.frontier_grid_provider == pl._planning_grid,
          "the mapper's frontier basis is not the planner's overlay")
    fronts = []
    st.bus.subscribe("/frontiers", callback=lambda f: fronts.append(
        np.asarray(f.assignment)))
    st.brain.start_exploring()
    nodes = {"sim": (st.sim, "step"), "brain": (st.brain, "update_loop"),
             "mapper": (st.mapper, "tick"), "voxel_mapper": (vm, "tick"),
             "planner": (pl, "tick")}
    node_ms = {k: [] for k in nodes}
    syncs = {k: [] for k in nodes}

    def instrument(key, obj, attr):
        fn = getattr(obj, attr)

        def wrapped():
            t0 = time.perf_counter()
            if st._steps_run in STACK_SYNC_TICKS:
                _r, n = _count_syncs(torch, fn)
                syncs[key].append(n)
            else:
                fn()
            torch.cuda.synchronize()
            node_ms[key].append((time.perf_counter() - t0) * 1e3)
        setattr(obj, attr, wrapped)

    for key, (obj, attr) in nodes.items():
        instrument(key, obj, attr)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    rt = {}
    with BatchCount(cfg.grid) as bc, SweepRecorder() as rec, \
            K6Capture() as k6:
        t0 = time.perf_counter()
        st.run_steps(STACK_DEPTH_RESTART)
        # An auto-checkpoint, then a mapper restart mid-run.
        with tempfile.TemporaryDirectory() as tmp:
            st.auto_checkpoint_path = os.path.join(tmp, "auto.npz")
            t1 = time.perf_counter()
            st.save_auto_checkpoint()
            rt["save_s"] = time.perf_counter() - t1
            grid_before = vm.voxel_grid()
            kf = vm.snapshot_keyframes()
            g2 = CK.load_voxel_sidecar(st.auto_checkpoint_path,
                                       vm.snapshot_grid(),
                                       running_config_json=cfg.to_json())
            kf2 = CK.load_keyframe_sidecar(
                st.auto_checkpoint_path, running_config_json=cfg.to_json())
            rt["voxel_sidecar_bit_equal"] = bool(torch.equal(g2,
                                                             grid_before))
            rt["keyframe_sidecar_bit_equal"] = all(
                np.array_equal(kf[k], kf2[k]) for k in kf)
            rt["keyframes_in_sidecar"] = int(len(kf["robot"]))
            del g2, kf, kf2
            old_mapper = st.mapper
            t1 = time.perf_counter()
            st.restart_mapper()
            torch.cuda.synchronize()
            rt["restart_s"] = time.perf_counter() - t1
            instrument("mapper", st.mapper, "tick")
            rt["voxel_map_kept"] = (st.voxel_mapper is vm
                                    and vm.voxel_grid() is grid_before)
            rt["voxel_follows_new_mapper"] = (vm.mapper is st.mapper
                                              and st.mapper is not
                                              old_mapper)
            rt["overlay_rewired"] = (st.mapper.frontier_grid_provider
                                     == pl._planning_grid)
            st.auto_checkpoint_path = ""
        fused_before = vm.n_images_fused
        st.run_steps(STACK_STEPS - STACK_DEPTH_RESTART)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    for _key, (obj, attr) in nodes.items():
        if attr in vars(obj):
            delattr(obj, attr)
    if "tick" in vars(st.mapper):
        del st.mapper.tick
    launches = dict(_cuda.LAUNCHES)
    routes = {k: dict(v) for k, v in _cuda.ROUTES.items()}
    peak = torch.cuda.max_memory_allocated()
    assigned = np.stack(fronts)
    counts = _voxel_counts(cfg.voxel, vm.voxel_grid())
    # The closure repair at the ring the drive left (the drive may close
    # no loop): the held keyframes re-fused at the graphs' node poses.
    held = sum(len(r) for r in vm._keyframes)
    refuses = vm.n_refuses
    t1 = time.perf_counter()
    vm._refuse_from_keyframes()
    torch.cuda.synchronize()
    refuse = {"keyframes": held, "ms": (time.perf_counter() - t1) * 1e3,
              "voxels": _voxel_counts(cfg.voxel, vm.voxel_grid())}
    steady = {k: v[1:] for k, v in node_ms.items()}
    out = {"phase": "stack_depth", "config": "SlamConfig(), depth_cam",
           "world": STACK_WORLD, "robots": STACK_ROBOTS,
           "steps": STACK_STEPS, "launch_s": launch_s, "wall_s": wall,
           "steps_per_s": STACK_STEPS / wall,
           "tick_ms": {k: dict(_p50_p90(v), n=len(v), max=max(v))
                       for k, v in steady.items() if v},
           "ms_per_step_by_node": {k: sum(v) / STACK_STEPS
                                   for k, v in node_ms.items()},
           "host_syncs_by_node_steps_10_to_12": syncs,
           "launches": launches, "routes": routes,
           "k1_launches_by_batch": bc.n,
           "k6_batches": sorted(k6.inputs),
           "images_fused": vm.n_images_fused,
           "images_dropped_unpaired": vm.n_images_dropped_unpaired,
           "images_fused_after_restart": vm.n_images_fused - fused_before,
           "keyframes_stored": vm.n_keyframes_stored,
           "keyframes_held": sum(len(r) for r in vm._keyframes),
           "refuses": vm.n_refuses, "voxel_revision": vm.map_revision,
           "loops_closed_before_restart": st.mapper.n_loops_closed,
           "overlay": {"rebuilds": pl.n_overlay_rebuilds,
                       "reuses": pl.n_overlay_reuses},
           "frontier_publish": st.mapper.frontier_stats(),
           "publishes": len(assigned),
           "robot_assignments": int((assigned >= 0).sum()),
           "planner": {"plans": pl.n_plans,
                       "frontier_plans": pl.n_frontier_plans,
                       "goal_fields": pl.n_goal_fields},
           "voxels": counts, "restart": rt, "peak_bytes": peak,
           "refuse_of_held_ring": refuse}
    emit(out)
    for name in FLEET_KERNELS + ("voxel_image",):
        check(launches[name] > 0,
              f"kernel {name} never launched on the depth-camera stack")
    check(vm.n_images_fused + vm.n_images_dropped_unpaired
          == STACK_ROBOTS * STACK_STEPS,
          f"stack_depth: {vm.n_images_fused} images fused and "
          f"{vm.n_images_dropped_unpaired} dropped of "
          f"{STACK_ROBOTS * STACK_STEPS}")
    check(out["robot_assignments"] > 0,
          "stack_depth: the auction assigned no frontier")
    check(counts["occupied"] > 0, "stack_depth: no voxel occupied")
    check(bool(torch.isfinite(vm.voxel_grid()).all()),
          "stack_depth: the voxel grid is not finite")
    check(all(rt[k] for k in ("voxel_sidecar_bit_equal",
                              "keyframe_sidecar_bit_equal",
                              "voxel_map_kept", "voxel_follows_new_mapper",
                              "overlay_rewired")),
          f"stack_depth: the restart or the sidecars failed: {rt}")
    check(out["images_fused_after_restart"] > 0,
          "stack_depth: no image fused after the restart")
    check(pl.n_overlay_rebuilds > 0, "stack_depth: no overlay was built")
    check(held > 0 and vm.n_refuses == refuses + 1
          and refuse["voxels"]["occupied"] + refuse["voxels"]["free"] > 0,
          f"stack_depth: the keyframe re-fuse did not run: {refuse}")
    k6_in = k6.inputs.get(STACK_ROBOTS)
    st.shutdown()
    return ({"per": f"{STACK_STEPS} depth-camera stack steps",
             "k1_launches_by_batch": bc.n},
            out, rec, k6_in)


#: The serving phase: steps, the clients' poll period, and the steps
#: between the /save and the /load.
#: Cut from 100 (PR 14) to keep the whole smoke near 660 s with the
#: coldstart phases; no check of the phase depends on the step count.
SERVING_STEPS = 40
SERVING_POLL_S = 0.1
SERVING_SAVE_STEPS = 10
#: Delta clients on /tiles and /voxel-tiles, whole-PNG pollers on
#: /map-image, and SSE listeners on /map-events.
SERVING_CLIENTS = {"/tiles": 8, "/voxel-tiles": 2, "/map-image": 2,
                   "/map-events": 1}
#: The mapper publishes /map (the /map-image route's source) every this
#: many steps, as its map timer does in a realtime stack.
SERVING_PUBLISH_EVERY = 10


class _ServingClients:
    """The serving phase's concurrent clients, each on a thread of its
    own polling every SERVING_POLL_S: DeltaMapClients on the tile routes
    (every pyramid level), whole-PNG pollers and SSE listeners. Each keeps
    its request latencies by route and its errors."""

    def __init__(self, base: str):
        import threading
        from jax_mapping_torch.serving.client import DeltaMapClient
        self.base, self.stop = base, threading.Event()
        self.delta = {route: [DeltaMapClient(base, route=route,
                                             timeout_s=120)
                              for _ in range(SERVING_CLIENTS[route])]
                      for route in ("/tiles", "/voxel-tiles")}
        self.png_bytes = [0] * SERVING_CLIENTS["/map-image"]
        self.sse = {"events": 0, "bytes": 0, "connections": 0}
        self.lat, self.errors = [], []
        # Daemons: a phase that fails mid-drive must not leave the
        # interpreter waiting on its clients at exit.
        self.threads = [threading.Thread(target=self._delta, args=(c, r),
                                         daemon=True)
                        for r, cs in self.delta.items() for c in cs]
        self.threads += [threading.Thread(target=self._png, args=(k,),
                                          daemon=True)
                         for k in range(len(self.png_bytes))]
        self.threads += [threading.Thread(target=self._sse, daemon=True)
                         for _ in range(SERVING_CLIENTS["/map-events"])]

    def _note(self, route, t0):
        self.lat.append((route, (time.perf_counter() - t0) * 1e3))

    def _delta(self, client, route):
        while not self.stop.is_set():
            t0 = time.perf_counter()
            try:
                client.poll()
                self._note(route, t0)
            except Exception as e:               # noqa: BLE001
                self.errors.append(f"{route}: {type(e).__name__}: {e}")
            self.stop.wait(SERVING_POLL_S)

    def _png(self, k):
        import urllib.error
        import urllib.request
        while not self.stop.is_set():
            t0 = time.perf_counter()
            try:
                with urllib.request.urlopen(self.base + "/map-image",
                                            timeout=120) as r:
                    self.png_bytes[k] += len(r.read())
                self._note("/map-image", t0)
            except urllib.error.HTTPError as e:
                if e.code != 404:                # before the first /map
                    self.errors.append(f"/map-image: {e}")
            except Exception as e:               # noqa: BLE001
                self.errors.append(f"/map-image: {type(e).__name__}: {e}")
            self.stop.wait(SERVING_POLL_S)

    def _sse(self):
        import urllib.request
        while not self.stop.is_set():
            try:
                with urllib.request.urlopen(
                        self.base + "/map-events?timeout_s=10",
                        timeout=120) as r:
                    self.sse["connections"] += 1
                    for line in r:
                        self.sse["bytes"] += len(line)
                        self.sse["events"] += line.startswith(b"data:")
                        if self.stop.is_set():
                            break
            except Exception as e:               # noqa: BLE001
                self.errors.append(f"/map-events: {type(e).__name__}: {e}")
                self.stop.wait(SERVING_POLL_S)

    def start(self):
        for t in self.threads:
            t.start()

    def join(self):
        self.stop.set()
        for t in self.threads:
            t.join(timeout=180)
        check(not any(t.is_alive() for t in self.threads),
              "a serving client thread did not stop")

    def latency_by_route(self) -> dict:
        out = {}
        for route in SERVING_CLIENTS:
            xs = sorted(ms for r, ms in self.lat if r == route)
            if xs:
                out[route] = {"n": len(xs), "p50": statistics.median(xs),
                              "p99": xs[min(len(xs) - 1,
                                            int(0.99 * len(xs)))],
                              "max": xs[-1]}
        return out


def _serving_expected(torch, cfg, st) -> dict:
    """route -> the mosaic each pyramid level must hold at the served
    revision: the grid's `to_gray` and its `downsample_gray` levels, the
    voxel height image and its block-max levels (host numpy), as many
    levels as the route's store serves."""
    from jax_mapping_torch.ops import grid as G
    from jax_mapping_torch.serving.tiles import _downsample_max_u8
    out = {}
    for route, img, down in (
            ("/tiles", G.to_gray(cfg.grid, st.mapper.merged_grid()),
             G.downsample_gray),
            ("/voxel-tiles", torch.as_tensor(
                st.voxel_mapper.serving_snapshot()[1],
                device=st.voxel_mapper.device),
             _downsample_max_u8)):
        store = st.api.serving.store(
            "grid" if route == "/tiles" else "voxel-height")
        levels = [img]
        for _ in range(len(store.tiles_since(-1, level=0)[2]["levels"])
                       - 1):
            levels.append(down(levels[-1]))
        out[route] = [x.cpu().numpy() for x in levels]
    return out


def _demo_serve(seed: int) -> dict:
    """`python -m jax_mapping_torch.demo --serve --http-port 0` in a
    process of its own on the card (tiny_config, 2 robots, 20 steps): its
    summary's URL must answer /status, /tiles and /metrics while it
    serves, and Ctrl-C (SIGINT) must end it with exit code 0."""
    import queue
    import signal
    import threading
    import urllib.request
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [HERE] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, "-m", "jax_mapping_torch.demo", "--serve",
         "--http-port", "0", "--steps", "20", "--robots", "2", "--seed",
         str(seed)], cwd=HERE, env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    lines = queue.Queue()
    readers = [threading.Thread(
        target=lambda f=f, k=k: [lines.put((k, x)) for x in f], daemon=True)
        for k, f in (("out", proc.stdout), ("err", proc.stderr))]
    for r in readers:
        r.start()
    out, text = {"phase_part": "demo_serve"}, {"out": "", "err": ""}
    try:
        summary = None
        deadline = time.perf_counter() + 300
        while summary is None and time.perf_counter() < deadline:
            try:
                k, line = lines.get(timeout=1.0)
                text[k] += line
            except queue.Empty:
                check(proc.poll() is None,
                      f"demo --serve exited {proc.returncode}: {text}")
                continue
            i, j = text["out"].find("{\n"), text["out"].find("\n}\n")
            if 0 <= i < j:
                summary = json.loads(text["out"][i:j + 2])
        check(summary is not None and "http" in summary,
              f"demo --serve printed no summary with a URL: {text}")
        out["serving_after_s"] = time.perf_counter() - t0
        out["device"] = summary["device"]
        for route in ("/status", "/tiles", "/metrics"):
            with urllib.request.urlopen(summary["http"] + route,
                                        timeout=60) as r:
                out[route] = {"status": r.status, "bytes": len(r.read())}
        tiles = json.loads(urllib.request.urlopen(
            summary["http"] + "/tiles", timeout=60).read())
        out["tiles"] = len(tiles["tiles"])
    finally:
        proc.send_signal(signal.SIGINT)
        try:
            rc = proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            proc.kill()
            rc = proc.wait()
    out["rc_after_sigint"] = rc
    check(rc == 0, f"demo --serve exited {rc} after SIGINT")
    check(out["device"].startswith("cuda"), "demo --serve ran off the card")
    check(out["tiles"] > 0, "demo --serve served no tile")
    return out


def phase_serving(torch, seed: int, depth_steps_per_s=None):
    """Slice 14's main path, map serving and the HTTP API, as users start
    it: `launch_sim_stack(SlamConfig(), STACK_WORLD, n_robots=8,
    depth_cam=True, http_port=0)` (the 4096^2 grid served as 336 tiles of
    256 cells in 3 levels, the voxel height map as 21), then
    `brain.start_exploring()` and SERVING_STEPS `run_steps` while
    SERVING_CLIENTS poll every SERVING_POLL_S from threads (delta clients
    on every pyramid level, whole-PNG pollers, an SSE listener), /map
    published every SERVING_PUBLISH_EVERY steps. Counts are zeroed before
    the steps and read after: K1, K2, K3 and K6 must launch. Then, with
    the clients stopped: every client's mosaic at every level equal to
    the live map bit for bit, `n_hint_missed` 0, a repeat GET answering
    304, the refresh's host syncs and its peak memory above a tick's,
    `POST /save`, SERVING_SAVE_STEPS steps, `POST /load` (grid and poses
    back to the saved ones), `/save-map` against the thresholded grid,
    `/goal` and `/goal/cancel` at the brain, the serving families on
    /status and /metrics; last, `demo --serve` in a process of its own."""
    import urllib.error
    import urllib.request
    import numpy as np
    from jax_mapping_torch.bridge.launch import launch_sim_stack
    from jax_mapping_torch.config import SlamConfig
    from jax_mapping_torch.io import rosmap
    from jax_mapping_torch.ops import _cuda
    cfg = SlamConfig()
    world = _stack_world(cfg.grid.resolution_m)
    t0 = time.perf_counter()
    st = launch_sim_stack(cfg, world, n_robots=STACK_ROBOTS, seed=seed,
                          depth_cam=True, http_port=0)
    torch.cuda.synchronize()
    launch_s = time.perf_counter() - t0
    api, m, vm = st.api, st.mapper, st.voxel_mapper
    base = f"http://127.0.0.1:{api.port}"
    gstore, vstore = api.serving.map_store, api.serving.voxel_store
    check(gstore is not None and vstore is not None,
          "the stack serves no grid or voxel tiles")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_serving_")
    api.checkpoint_dir = tmp

    def post(route):
        req = urllib.request.Request(base + route, method="POST")
        with urllib.request.urlopen(req, timeout=300) as r:
            return json.loads(r.read())

    def get(route, headers=None):
        req = urllib.request.Request(base + route, headers=headers or {})
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.headers, r.read()
    clients = _ServingClients(base)
    try:
        st.brain.start_exploring()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _cuda.reset_launches()
        clients.start()
        with BatchCount(cfg.grid) as bc, SweepRecorder() as rec, \
                StageSamples("serving.snapshot") as snap, \
                HashDevices() as hashed:
            t0 = time.perf_counter()
            for k in range(SERVING_STEPS):
                st.run_steps(1)
                if (k + 1) % SERVING_PUBLISH_EVERY == 0:
                    m.publish_map()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = dict(_cuda.LAUNCHES)
            clients.join()
            poll_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        check(clients.errors == [],
              f"serving clients failed: {clients.errors[:5]}")
        check(hashed.seen == {"cuda"},
              f"the tile stores hashed on {sorted(hashed.seen)}, not the card")
        g_stats = gstore.stats()
        v_stats = vstore.stats()
        n_tiles = {"/tiles": len(gstore.tiles_since(-1)[1]),
                   "/voxel-tiles": len(vstore.tiles_since(-1)[1])}

        # Quiescent: one more poll brings every client to the live
        # revision; each mosaic must equal the map at every level.
        expect = _serving_expected(torch, cfg, st)
        revs = {"/tiles": m.serving_revision(),
                "/voxel-tiles": vm.serving_revision()}
        bad, snapshot_bytes, steady_bytes = [], {}, {}
        for route, cs in clients.delta.items():
            for c in cs:
                c.poll()
                if c.revision != revs[route] \
                        or len(c.mosaics) != len(expect[route]) or any(
                            not np.array_equal(c.mosaics.get(lvl), want)
                            for lvl, want in enumerate(expect[route])):
                    bad.append((route, c.revision))
            snapshot_bytes[route] = statistics.mean(
                c.snapshot_bytes for c in cs)
            steady_bytes[route] = statistics.mean(
                (c.bytes_received - c.snapshot_bytes) / poll_s for c in cs)
        c0 = clients.delta["/tiles"][0]
        n304 = c0.n_not_modified
        c0.poll()
        etag_hit = c0.n_not_modified == n304 + 1

        # A refresh's host syncs and its peak above a tick's, counted with
        # no client running (the sync debug mode is process-wide).
        refresh = {"syncs": [], "peak_above_live": [],
                   "tick_peak_above_live": []}
        for _ in range(3):
            torch.cuda.synchronize()
            live = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            st.run_steps(1)
            torch.cuda.synchronize()
            refresh["tick_peak_above_live"].append(
                torch.cuda.max_memory_allocated() - live)
            live = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            _r, n = _count_syncs(torch, gstore.refresh)
            torch.cuda.synchronize()
            refresh["syncs"].append(n)
            refresh["peak_above_live"].append(
                torch.cuda.max_memory_allocated() - live)

        # /save, steps, /load: the grid and poses come back.
        saved = post("/save")
        grid_saved = m.merged_grid().clone()
        poses_saved = m._read_poses()
        st.run_steps(SERVING_SAVE_STEPS)
        moved = not torch.equal(m.merged_grid(), grid_saved)
        poses_moved = not np.array_equal(m._read_poses(), poses_saved)
        loaded = post("/load")
        roundtrip = {
            "saved": saved["status"], "loaded": loaded["status"],
            "voxel_sidecar": "voxel_path" in loaded,
            "grid_moved_between": moved, "poses_moved_between": poses_moved,
            "grid_equal": bool(torch.equal(m.merged_grid(), grid_saved)),
            "poses_equal": bool(np.array_equal(m._read_poses(),
                                               poses_saved))}
        body = post("/save-map?name=map")
        occ, _res, _origin = rosmap.load_map(body["yaml"])
        lo = m.merged_grid().cpu().numpy()
        want = np.full(lo.shape, -1, np.int8)
        want[lo <= cfg.grid.free_threshold] = 0
        want[lo >= cfg.grid.occ_threshold] = 100
        save_map_equal = bool(np.array_equal(occ, want))
        goal = post("/goal?x=1.0&y=-0.5&robot=3")
        goal_at_brain = st.brain.status()["goals"][3] == {"x": 1.0,
                                                         "y": -0.5}
        cancel = post("/goal/cancel?robot=3")
        goal_cleared = st.brain.status()["goals"][3] is None
        _s, _h, status = get("/status")
        status = json.loads(status)
        _s, _h, metrics = get("/metrics")
        metrics = metrics.decode()
        families = ("jax_mapping_serving_grid_revision",
                    "jax_mapping_serving_grid_tiles_encoded_total",
                    "jax_mapping_serving_voxel_revision",
                    "jax_mapping_serving_events_total",
                    "jax_mapping_stage_serving_snapshot_seconds",
                    "jax_mapping_http_request_seconds",
                    "jax_mapping_checkpoint_fallback_total")
        missing = [f for f in families if f"# TYPE {f} " not in metrics]
        _s, h, _b = get("/map-image")
        try:
            get("/map-image", {"If-None-Match": h["ETag"]})
            png_304 = False
        except urllib.error.HTTPError as e:
            png_304 = e.code == 304
        demo = _demo_serve(seed)

        n_ref = max(1, g_stats["n_refreshes"])
        png_rate = statistics.mean(b / poll_s for b in clients.png_bytes)
        out = {"phase": "serving",
               "config": "SlamConfig(), depth_cam, http_port=0",
               "world": STACK_WORLD, "robots": STACK_ROBOTS,
               "steps": SERVING_STEPS, "clients": SERVING_CLIENTS,
               "poll_s": SERVING_POLL_S, "launch_s": launch_s,
               "wall_s": wall, "steps_per_s": SERVING_STEPS / wall,
               "stack_depth_steps_per_s_reference": depth_steps_per_s,
               "serving_snapshot_ms": {**_p50_p90(snap.ms),
                                       "n": len(snap.ms),
                                       "max": max(snap.ms)},
               "grid_store": g_stats, "voxel_store": v_stats,
               "tiles_in_snapshot": n_tiles,
               "tiles_encoded_per_refresh":
                   g_stats["n_tiles_encoded"] / n_ref,
               "tiles_clean_skipped_per_refresh":
                   g_stats["n_tiles_clean_skipped"] / n_ref,
               "refresh": refresh,
               "request_ms_by_route": clients.latency_by_route(),
               "bytes_per_client_per_s": {
                   "tiles_steady": steady_bytes["/tiles"],
                   "voxel_tiles_steady": steady_bytes["/voxel-tiles"],
                   "whole_png": png_rate,
                   "png_over_tiles": (png_rate / steady_bytes["/tiles"]
                                      if steady_bytes["/tiles"] else None)},
               "snapshot_bytes": snapshot_bytes,
               "sse": clients.sse,
               "events": api.serving.stats()["events"],
               "clients_at_live_revision_and_equal":
                   sum(len(cs) for cs in clients.delta.values()) - len(bad),
               "clients_bad": bad, "etag_304": etag_hit,
               "map_image_304": png_304,
               "save_load": roundtrip, "save_map_equal": save_map_equal,
               "goal": [goal.get("status"), goal_at_brain,
                        cancel.get("status"), goal_cleared],
               "status_keys": sorted(status),
               "metrics_missing": missing,
               "launches": launches, "k1_launches_by_batch": bc.n,
               "peak_bytes": peak, "demo_serve": demo}
        emit(out)
        check(bad == [], f"serving: clients off the live map: {bad}")
        check(g_stats["n_hint_missed"] == 0,
              f"serving: the dirty hint missed {g_stats['n_hint_missed']}")
        check(etag_hit and png_304, "serving: a repeat GET did not 304")
        check(all(roundtrip[k] for k in ("voxel_sidecar", "poses_moved_between",
                                         "grid_equal", "poses_equal")),
              f"serving: /save then /load: {roundtrip}")
        check(save_map_equal, "serving: /save-map differs from the grid")
        check(goal_at_brain and goal_cleared,
              "serving: /goal or /goal/cancel did not reach the brain")
        check(not missing and status["n_scans_fused"] > 0
              and status["n_images_fused"] > 0,
              f"serving: /status or /metrics incomplete: {missing}")
        check(clients.sse["events"] > 0, "serving: the SSE listener got no event")
        for name in FLEET_KERNELS + ("voxel_image",):
            check(launches[name] > 0,
                  f"kernel {name} never launched on the serving path")
        return ({"per": f"{SERVING_STEPS} serving stack steps",
                 "k1_launches_by_batch": bc.n}, out, rec)
    finally:
        clients.stop.set()
        st.shutdown()
        import shutil
        shutil.rmtree(tmp, ignore_errors=True)


def _k1_key(row: dict) -> str:
    """A K1 row's BatchCount key."""
    tag = (f"@{row['grid_resolution_m']:g}m" if "grid_resolution_m" in row
           else "")
    return f"{row['shape'][0]}{tag}"


def stack_kernel_rows(torch, cfg, world, gen, fleet: dict, mapper: dict,
                      new_paths: dict, stack_rec, rows: dict) -> dict:
    """Rows for the K1 batches and the K2/K3 calls the stack launched that
    `rows` (the kernels phase so far) does not hold yet, each against its
    plain version: K1 at the batch on poses near walls (the coarse view
    for a batch keyed at its resolution), K2/K3 on the very inputs the
    stack passed."""
    from jax_mapping_torch.models import slam as S
    from jax_mapping_torch.ops import grid as G
    from jax_mapping_torch.sim import lidar
    res = cfg.grid.resolution_m
    n_samples = int(cfg.scan.range_max_m / (res * 0.5))
    out = {}
    stacks = [new_paths[k]["k1_launches_by_batch"]
              for k in ("stack", "stack_depth", "serving", "scenario")
              if k in new_paths]
    for name, raster in (("sensor_model_delta", False),
                         ("sensor_model_raster", True)):
        covered = {_k1_key(r) for k, r in rows.items()
                   if k.startswith(name) and "shape" in r
                   and "cells_within_range" in r}
        for key in sorted(set().union(*(b[name] for b in stacks))
                          - covered):
            B, _, tag = key.partition("@")
            c = cfg
            if tag:
                g_c, m_c = S._loop_wide_cfgs(cfg)
                c = cfg.replace(grid=g_c, matcher=m_c)
            poses = _poses_near_walls(torch, cfg, world, int(B), gen)
            ranges = lidar.simulate_scans(cfg.scan, world, res, n_samples,
                                          poses)
            origins = G.patch_origin(c.grid, poses[:, :2]).contiguous()
            out[f"{name}_stack_b{key}"] = _k1_row(
                torch, c, raster, ranges, poses, origins, fleet, mapper,
                key=key, new_paths=new_paths)
    out.update(_new_sweep_rows(torch, cfg, stack_rec, {**rows, **out},
                               "stack"))
    return out


def _new_sweep_rows(torch, cfg, rec, rows: dict, tag: str) -> dict:
    """A row for each distinct K2/K3 call `rec` recorded that no row of
    `rows` covers, on the very inputs the path passed."""
    covered = set()
    for r in rows.values():
        if "sweeps" in r and "shape" in r:
            covered.add((tuple(r["shape"]), r["sweeps"]))
        for lv in r.get("levels", ()) if isinstance(r, dict) else ():
            covered.add(((cfg.fleet.n_robots, lv["n"], lv["n"]),
                         lv["sweeps"]))
    out, seen = {}, set()
    for name, m, init, s in rec.calls:
        sig = (tuple(init.shape), s)
        if sig in covered or (name, sig) in seen:
            continue
        seen.add((name, sig))
        key = ("costfield_relax" if name == "relax_sweeps"
               else "label_prop") + f"_{tag}_n{init.shape[-1]}_s{s}" + (
                   f"_r{init.shape[0]}" if init.dim() == 3 else "") + (
                   f"_m{m.shape[0]}" if name == "relax_sweeps"
                   and m.dim() == 3 else "")
        out[key] = _sweep_row(torch, name, m, init, s)
    return out


def world_kernel_rows(torch, cfg, fleet: dict, mapper: dict,
                      new_paths: dict, world_rec, k1_inputs: dict,
                      rows: dict) -> dict:
    """K1 on the first inputs of each batch the world phases launched
    (`k1_inputs`: ((name, key), inputs) pairs of BatchCount captures; the
    window's grid, the coarse view of the window's loop verification, and
    the store's `fuse_scan_global` on the logical grid), each against its
    plain version; K2/K3 at any call of the world phase that no row
    covers."""
    out = {}
    for (name, key), (g, sc, ranges, poses, origins) in k1_inputs:
        tag = "global" if g.size_cells == WORLD_LOGICAL_CELLS else "window"
        row = _k1_row(torch, cfg.replace(grid=g, scan=sc),
                      name == "sensor_model_raster", ranges, poses, origins,
                      fleet, mapper, key=key, new_paths=new_paths)
        row["grid_cells"] = g.size_cells
        out[f"{name}_world_{tag}_b{key}"] = row
    out.update(_new_sweep_rows(torch, cfg, world_rec, {**rows, **out},
                               "world"))
    return out


def phase_stack_parity(torch, seed: int, steps: int = STACK_PARITY_STEPS):
    """The stack at tiny_config(2) with speed_noise_frac=0 on
    plank_course(96, 0.05, n_planks=4, seed=3), the same seed, `steps`
    steps on the card and on the CPU: truth poses to 1e-6 m, the mapper's
    estimates to 1e-4 m, every step; every frontier assignment equal; the
    grids equal but for at most 1e-4 of the cells. Both stacks serve HTTP
    (`http_port=0`): their full `/tiles` manifests must be byte-equal, the
    card's hashed on the card."""
    import dataclasses
    import numpy as np
    from jax_mapping_torch.bridge.launch import launch_sim_stack
    from jax_mapping_torch.config import tiny_config
    from jax_mapping_torch.sim import world as W
    cfg = tiny_config(2)
    cfg = cfg.replace(robot=dataclasses.replace(cfg.robot,
                                                speed_noise_frac=0.0))
    world = W.plank_course(96, cfg.grid.resolution_m, n_planks=4, seed=3)
    runs = {}
    for dev in ("cuda", "cpu"):
        st = launch_sim_stack(cfg, world, n_robots=2, seed=seed, device=dev,
                              http_port=0)
        fronts = []
        st.bus.subscribe("/frontiers", callback=lambda f, fr=fronts:
                         fr.append(np.asarray(f.assignment)))
        st.brain.start_exploring()
        truth, est = [], []
        for _ in range(steps):
            st.run_steps(1)
            truth.append(st.sim.truth_poses())
            est.append(st.mapper._read_poses())
        runs[dev] = {"truth": np.stack(truth), "est": np.stack(est),
                     "fronts": np.stack(fronts),
                     "grid": st.mapper.shared_grid.cpu().numpy(),
                     "keys": [int(s.n_keyscans) for s in st.mapper.states],
                     "plans": st.planner.n_frontier_plans}
        with HashDevices() as hashed:
            runs[dev]["tiles"] = st.api.handle("/tiles?since=-1")[2]
        runs[dev]["hashed_on"] = ",".join(sorted(hashed.seen))
        st.shutdown()
    a, b = runs["cuda"], runs["cpu"]
    out = {"phase": "stack_parity", "config": "tiny_config(2), "
           "speed_noise_frac=0", "steps": steps,
           "truth_m": float(np.abs(a["truth"] - b["truth"]).max()),
           "est_m": float(np.abs(a["est"][..., :2]
                                 - b["est"][..., :2]).max()),
           "est_rad": float(np.abs(a["est"][..., 2]
                                   - b["est"][..., 2]).max()),
           "publishes": len(a["fronts"]),
           "assignments_equal": bool(
               a["fronts"].shape == b["fronts"].shape
               and np.array_equal(a["fronts"], b["fronts"])),
           "assigned": int((b["fronts"] >= 0).sum()),
           "cells_differ": int((a["grid"] != b["grid"]).sum()),
           "cells_total": int(a["grid"].size),
           "key_scans": {"cuda": a["keys"], "cpu": b["keys"]},
           "frontier_plans": {"cuda": a["plans"], "cpu": b["plans"]},
           "tiles_manifest_bytes": len(a["tiles"]),
           "tiles_manifests_equal": a["tiles"] == b["tiles"],
           "tiles_hashed_on": [a["hashed_on"], b["hashed_on"]]}
    emit(out)
    check(out["truth_m"] <= 1e-6, f"stack parity: truth poses {out}")
    check(out["est_m"] <= 1e-4 and out["est_rad"] <= 1e-4,
          f"stack parity: estimates {out}")
    check(out["assignments_equal"], "stack parity: frontier assignments")
    check(out["cells_differ"] <= 1e-4 * out["cells_total"],
          f"stack parity: {out['cells_differ']} grid cells differ")
    check(out["tiles_manifests_equal"]
          and out["tiles_hashed_on"] == ["cuda", "cpu"],
          "stack parity: the card's /tiles manifest differs from the CPU's")
    return out


WORLD_ROBOTS = 8
WORLD_LOGICAL_CELLS = 8192          # 32 x 32 tiles of 256 cells, 409.6 m
WORLD_HOST_BUDGET = 16
WORLD_SCANS = 16                    # a window a robot a tick: K5
WORLD_STEP_M = 0.25                 # between a robot's scans
WORLD_DT_S = 2.0                    # between a robot's scan stamps
WORLD_EAST_M = 130.0                # three shifts east
WORLD_WEST_M = -6.0                 # back past the start
#: The formation's offsets from the lead robot, metres.
WORLD_FORMATION = [(-1.5 * (i // 2), 1.5 if i % 2 else -1.5)
                   for i in range(WORLD_ROBOTS)]


def _world_config(base, logical: int, **world_kw):
    """`base` with a `logical`-cell lattice and `world.windowed`."""
    import dataclasses
    from jax_mapping_torch.config import WorldConfig
    return base.replace(
        grid=dataclasses.replace(base.grid, size_cells=logical),
        world=WorldConfig(windowed=True, **world_kw))


def _gallery(n: int, res: float, x0: float, x1: float, half_w: float,
             pillar_m: float, seed: int):
    """An n x n occupancy map at `res` centred on the origin: an east-west
    gallery between walls at y = +-half_w from x0 to x1 m, closed at both
    ends, with 0.4 m pillars every `pillar_m` metres alternately at
    y = +-half_w / 2 and seeded boxes against the walls, so that scans
    constrain every direction along the route."""
    import numpy as np
    w = np.zeros((n, n), bool)
    o = -n * res / 2

    def rect(xa, xb, ya, yb):
        c0, c1 = int((xa - o) / res), int(math.ceil((xb - o) / res))
        r0, r1 = int((ya - o) / res), int(math.ceil((yb - o) / res))
        w[max(r0, 0):r1, max(c0, 0):c1] = True
    t = 0.2
    rect(x0, x1, half_w, half_w + t)
    rect(x0, x1, -half_w - t, -half_w)
    rect(x0 - t, x0, -half_w, half_w)
    rect(x1, x1 + t, -half_w, half_w)
    k, x = 0, x0 + pillar_m
    while x < x1:
        y = half_w / 2 if k % 2 == 0 else -half_w / 2
        rect(x - 0.2, x + 0.2, y - 0.2, y + 0.2)
        k, x = k + 1, x + pillar_m
    rng = np.random.default_rng(seed)
    for _ in range(int((x1 - x0) / 3)):
        x, d = rng.uniform(x0, x1), rng.uniform(0.3, 1.2)
        ya = half_w - d if rng.random() < 0.5 else -half_w
        rect(x - d / 2, x + d / 2, ya, ya + d)
    return w


def _course_ticks(east_m: float, west_m: float, step: float, scans: int):
    """The lead robot's (x, heading) at every scan, in ticks of `scans`:
    east from 0, a turn in place to heading pi (one tick), then west to
    `west_m`, the west leg's first scan repeating the turn's last pose (a
    stationary scan). Returns (ticks, the index of the turn tick)."""
    n_e = int(math.ceil(east_m / (scans * step)))
    east = [(k * step, 0.0) for k in range(n_e * scans)]
    x = east[-1][0]
    turn = [(x, math.pi * (j + 1) / scans) for j in range(scans)]
    n_w = int(math.ceil((x - west_m) / (scans * step)))
    west = [(x - k * step, math.pi) for k in range(n_w * scans)]
    flat = east + turn + west
    ticks = [flat[i:i + scans] for i in range(0, len(flat), scans)]
    return ticks, n_e


class _WorldCourse:
    """Scripted, noise-free messages for R robots in formation: per tick
    each robot's scans (raycast on `dev` in one call, read in one copy)
    and the odometry at each scan's pose, with stamps WORLD_DT_S apart."""

    def __init__(self, torch, cfg, world_np, dev, formation, lead_ticks):
        self.torch, self.cfg = torch, cfg
        self.world = torch.as_tensor(world_np, device=dev)
        self.formation = formation
        self.lead = lead_ticks
        res = cfg.grid.resolution_m
        self.n_samples = int(cfg.scan.range_max_m / (res * 0.5))
        self.k = 0                        # scans so far, for the stamps

    def poses(self, t: int):
        """(R, n, 3) float32 poses of tick t."""
        import numpy as np
        return np.array([[(x + dx, dy, th) for x, th in self.lead[t]]
                         for dx, dy in self.formation], np.float32)

    def tick(self, t: int):
        """(poses (R, n, 3), ranges (R, n, beams), stamps (n,)) of tick t,
        all host arrays."""
        import numpy as np
        from jax_mapping_torch.sim import lidar
        torch = self.torch
        poses = self.poses(t)
        R, n, _ = poses.shape
        ranges = lidar.simulate_scans(
            self.cfg.scan, self.world, self.cfg.grid.resolution_m,
            self.n_samples, torch.as_tensor(poses.reshape(R * n, 3),
                                            device=self.world.device)
        ).reshape(R, n, -1).cpu().numpy()
        stamps = (self.k + 1 + np.arange(n)) * WORLD_DT_S
        self.k += n
        return poses, ranges, stamps


def _world_publish(bus, R: int, cfg, poses, ranges, stamps) -> None:
    """Each robot's odometry and scan at every stamp of a tick, in the
    JAX stack's order (odometry first)."""
    from jax_mapping_torch.bridge.brain import robot_ns
    from jax_mapping_torch.bridge.messages import (Header, LaserScan,
                                                   Odometry, Pose2D, Twist)
    for i in range(R):
        ns = robot_ns(i, R)
        odom, scan = bus.publisher(f"{ns}odom"), bus.publisher(f"{ns}scan")
        for k, stamp in enumerate(stamps):
            x, y, th = (float(v) for v in poses[i, k])
            odom.publish(Odometry(header=Header(stamp=float(stamp),
                                                frame_id="odom"),
                                  pose=Pose2D(x, y, th),
                                  twist=Twist(linear_x=0.0, angular_z=0.0)))
            scan.publish(LaserScan(
                header=Header(stamp=float(stamp), frame_id="base_laser"),
                angle_increment=cfg.scan.angle_increment_rad,
                ranges=ranges[i, k, :cfg.scan.n_beams]))


def _world_mapper(torch, cfg, R: int, spill_dir, device, start):
    """A windowed MapperNode on its own bus, every chain at its row of
    `start` (R, 3)."""
    from jax_mapping_torch.bridge.bus import Bus
    from jax_mapping_torch.bridge.mapper import MapperNode
    bus = Bus()
    m = MapperNode(cfg, bus, n_robots=R, device=device, spill_dir=spill_dir)
    poses = torch.as_tensor(start, device=m.device)
    for i, st in enumerate(m.states):
        m.states[i] = st._replace(pose=poses[i])
    return m, bus


def phase_world(torch, seed: int):
    """Slice 11's main path: the windowed mapper over a logical world 4x
    its window's edge, with a checkpoint restored mid-drive (see the
    module docstring)."""
    import shutil
    import numpy as np
    from jax_mapping_torch.config import SlamConfig
    from jax_mapping_torch.io.checkpoint import (
        load_checkpoint, load_world_sidecar, save_checkpoint,
        save_world_sidecar)
    from jax_mapping_torch.ops import _cuda
    cfg = _world_config(SlamConfig(), WORLD_LOGICAL_CELLS,
                        host_tile_budget=WORLD_HOST_BUDGET)
    R = WORLD_ROBOTS
    res = cfg.grid.resolution_m
    world = _gallery(WORLD_LOGICAL_CELLS, res, -12.0, 150.0, 8.0, 4.0,
                     seed + 11)
    lead, _turn = _course_ticks(WORLD_EAST_M, WORLD_WEST_M, WORLD_STEP_M,
                                WORLD_SCANS)
    course = _WorldCourse(torch, cfg, world, DEV, WORLD_FORMATION, lead)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_world_")
    nodes = []
    try:
        m, bus = _world_mapper(torch, cfg, R, os.path.join(tmp, "spill"),
                               DEV, course.poses(0)[:, 0])
        nodes.append(m)
        check(m.shared_grid.is_cuda and m.shared_grid.shape[0]
              == cfg.world.window_tiles * cfg.serving.tile_cells,
              "the window is not on the card at its size")
        reads = _stack_step_reads(m)
        shift_syncs, upkeep_syncs = [], []
        orig_upkeep = m._maybe_shift_window

        def counted_upkeep():
            n0 = m.world.n_shifts
            _, k = _count_syncs(torch, orig_upkeep)
            (shift_syncs if m.world.n_shifts > n0
             else upkeep_syncs).append(k)
        m._maybe_shift_window = counted_upkeep
        ck = os.path.join(tmp, "mid.npz")
        replay, tick_ms, shifted, live = [], [], [], []
        peak_first = ck_tick = None
        corrupted = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _cuda.reset_launches()
        with BatchCount(m.cfg.grid, capture=True) as bc, \
                SweepRecorder() as rec, \
                StageSamples("mapper.window_shift") as shift_ms:
            t = -1
            while t + 1 < len(lead):
                t += 1
                msgs = course.tick(t)
                _world_publish(bus, R, cfg, *msgs)
                n0 = m.world.n_shifts
                t0 = time.perf_counter()
                m.tick()
                torch.cuda.synchronize()
                tick_ms.append((time.perf_counter() - t0) * 1e3)
                shifted.append(m.world.n_shifts > n0)
                if shifted[-1]:
                    live.append(torch.cuda.memory_allocated())
                    if peak_first is None:
                        peak_first = torch.cuda.max_memory_allocated()
                        torch.cuda.reset_peak_memory_stats()
                if ck_tick is not None:
                    replay.append(msgs)
                elif m.world.n_shifts >= 2 and not shifted[-1]:
                    # Between the second and the third shift, with no
                    # prefetch in flight: checkpoint the states and the
                    # window manifest (which flushes the host tier to the
                    # spill file), corrupt two spilled tiles, and copy the
                    # spill file for the resumed node. Tiles evicted after
                    # this come back from the host on the way west.
                    ck_tick = t
                    # The resumed node's odometry pairing starts empty, as
                    # after any restart: the next tick holds still (its
                    # first scan has no motion to pair on either node).
                    lead.insert(t + 1, [lead[t][-1]] * WORLD_SCANS)
                    save_checkpoint(ck, m.snapshot_states(),
                                    config_json=cfg.to_json())
                    save_world_sidecar(ck, m.world.checkpoint_payload(),
                                       config_json=cfg.to_json())
                    corrupted = m.world.corrupt_spill(2)
                    shutil.copytree(os.path.join(tmp, "spill"),
                                    os.path.join(tmp, "spill_resumed"))
            launches = dict(_cuda.LAUNCHES)
        peak_rest = torch.cuda.max_memory_allocated()
        status = m.world.status()
        grid_a = m.shared_grid
        poses_a = m._read_poses()
        keys = [r for r in reads if r.key_added]

        # The resumed node: the checkpoint, its manifest and the spill
        # copy; the same messages after the turn.
        states, _ = load_checkpoint(ck, m.checkpoint_template())
        payload = load_world_sidecar(ck, running_config_json=cfg.to_json())
        b, bus_b = _world_mapper(torch, cfg, R,
                                 os.path.join(tmp, "spill_resumed"), DEV,
                                 np.zeros((R, 3), np.float32))
        nodes.append(b)
        b.resume(states, payload)
        for msgs in replay:
            _world_publish(bus_b, R, cfg, *msgs)
            b.tick()
        torch.cuda.synchronize()
        poses_b = b._read_poses()
        shift_ticks = [x for x, s_ in zip(tick_ms, shifted) if s_]
        other = [x for x, s_ in zip(tick_ms, shifted) if not s_]
        out = {"phase": "world", "config": "SlamConfig(), grid 8192^2, "
               "world.windowed (8 tiles of 256), host_tile_budget 16, "
               "a disk tier",
               "world": "gallery x -12..150 m, walls y +-8 m, pillars 4 m",
               "robots": R, "ticks": len(lead),
               "scans_per_robot_tick": WORLD_SCANS,
               "route_m": [0.0, max(x for tk in lead for x, _ in tk),
                           lead[-1][-1][0]],
               "shift_tick_ms": {**_p50_p90(shift_ticks),
                                 "n": len(shift_ticks)},
               "other_tick_ms": {**_p50_p90(other[1:]),
                                 "n": len(other) - 1,
                                 "first": other[0]},
               "window_shift_stage_ms": {**_p50_p90(shift_ms.ms),
                                         "n": len(shift_ms.ms)},
               "host_syncs_per_shift": shift_syncs,
               "host_syncs_per_upkeep_without_shift": sorted(
                   set(upkeep_syncs)),
               "store": status,
               "corrupted_tiles": [list(x) for x in corrupted],
               "key_steps": len(keys),
               "matches_accepted": sum(r.matched for r in keys),
               "scans_fused": m.n_scans_fused,
               "windows_fused": m.n_windows_fused,
               "loops_closed": m.n_loops_closed,
               "launches": launches,
               "k1_launches_by_batch": bc.n,
               "sweep_calls": sorted({f"{n}_n{i.shape[-1]}_s{s}"
                                      + (f"_r{i.shape[0]}" if i.dim() == 3
                                         else "")
                                      for n, _m, i, s in rec.calls}),
               "peak_bytes_through_first_shift": peak_first,
               "peak_bytes_after_first_shift": peak_rest,
               "live_bytes_after_each_shift": live,
               "window_bytes": m.shared_grid.numel() * 4,
               "unwindowed_grid_bytes": WORLD_LOGICAL_CELLS ** 2 * 4,
               "cells_free": int((grid_a < cfg.grid.free_threshold).sum()),
               "cells_occupied": int((grid_a > cfg.grid.occ_threshold)
                                     .sum()),
               "resumed": {
                   "checkpoint_tick": ck_tick,
                   "ticks_replayed": len(replay),
                   "grid_equal": bool(torch.equal(grid_a, b.shared_grid)),
                   "cells_differ": int((grid_a != b.shared_grid).sum()),
                   "pose_max_diff_m": float(np.abs(poses_a[:, :2]
                                                   - poses_b[:, :2]).max()),
                   "pose_max_diff_rad": float(np.abs(poses_a[:, 2]
                                                     - poses_b[:, 2]).max()),
                   "origin": list(b.world.origin_tile)}}
        emit(out)
        check(bool(torch.isfinite(grid_a).all()), "world grid non-finite")
        check(status["shifts"] >= 3, f"{status['shifts']} shifts, < 3")
        check(status["rehydrated_host"] > 0 and status["rehydrated_disk"] > 0,
              f"no host or no disk rehydration: {status}")
        check(out["matches_accepted"] > 0, "no match accepted")
        check(peak_rest <= 1.1 * peak_first,
              f"peak memory grew with distance: {peak_first} -> "
              f"{peak_rest}")
        for name in FLEET_KERNELS + ("window_apply",):
            check(launches[name] > 0,
                  f"kernel {name} never launched on the world path")
        r_ = out["resumed"]
        check(ck_tick is not None and len(corrupted) == 2,
              f"no checkpoint or no corrupted tiles: {ck_tick}, {corrupted}")
        check(r_["grid_equal"] and r_["pose_max_diff_m"] == 0.0
              and r_["pose_max_diff_rad"] == 0.0
              and tuple(r_["origin"]) == tuple(status["origin_tile"]),
              f"the resumed run differs from the continuous one: {r_}")
        _world_serving(torch, m, bus)
        return ({"per": f"{len(lead)} world ticks",
                 "k1_launches_by_batch": bc.n}, out, rec, bc.inputs)
    finally:
        for nd in nodes:
            nd.destroy()
        shutil.rmtree(tmp, ignore_errors=True)


def _world_serving(torch, m, bus) -> dict:
    """One `MapApiServer` on the world drive's windowed mapper: a full
    `/tiles` snapshot of the 8192^2 lattice (32 x 32 level-0 tiles, three
    levels) must equal `world.compose_serving` of the window's gray, with
    every away tile a typed evicted marker and the coarser levels the
    composed mosaic's `downsample_gray`."""
    import numpy as np
    from jax_mapping_torch.bridge.http_api import MapApiServer
    from jax_mapping_torch.ops import grid as G
    from jax_mapping_torch.serving.client import DeltaMapClient
    api = MapApiServer(bus, mapper=m, port=0)
    try:
        torch.cuda.synchronize()
        live = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with HashDevices() as hashed:
            res = api.handle("/tiles?since=-1")
        ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - live
        check(res[0] == 200, f"world serving: /tiles answered {res[0]}")
        body = json.loads(res[2])
        client = DeltaMapClient("http://unused")
        client.apply(body)
        g = m.full_cfg.grid
        mosaic, evicted = m.world.compose_serving(
            G.to_gray(g, m.merged_grid()).cpu().numpy())
        levels = [torch.as_tensor(mosaic)]
        for _ in range(len(body["levels"]) - 1):
            levels.append(G.downsample_gray(levels[-1]))
        markers = sorted((e["ty"], e["tx"]) for e in body["tiles"]
                         if e.get("evicted"))
        out = {"phase": "world_serving", "size_cells": body["size_cells"],
               "levels": [lv["size_cells"] for lv in body["levels"]],
               "tiles": len(body["tiles"]), "evicted_markers": len(markers),
               "evicted_tiles_meta": body.get("evicted_tiles"),
               "first_snapshot_ms": ms, "body_bytes": len(res[2]),
               "refresh_peak_above_live": peak,
               "hashed_on": ",".join(sorted(hashed.seen)),
               "levels_equal": [bool(np.array_equal(
                   client.image(k), lv.cpu().numpy()))
                   for k, lv in enumerate(levels)],
               "markers_equal_away_set": markers == sorted(
                   map(tuple, np.argwhere(evicted).tolist()))}
    finally:
        api.shutdown()
    emit(out)
    check(out["size_cells"] == WORLD_LOGICAL_CELLS
          and out["hashed_on"] == "cuda",
          f"world serving: the manifest is not the logical lattice: {out}")
    check(all(out["levels_equal"]) and out["markers_equal_away_set"]
          and out["evicted_markers"] > 0,
          f"world serving: the snapshot differs from compose_serving: {out}")
    return out


#: The JAX package's store walk (`tests/test_world.py::_WALK`, metres at
#: a 4-tile window of 64-cell tiles), scaled to the 8-tile window of
#: 256-cell tiles: 8x.
WORLD_WALK = [8.0 * x for x in (0.0, 1.6, 3.3, 6.6, 9.9, 6.6, 3.3, 0.0)]


def _store_walk(torch, cfg, spill_dir, decay_at=(), pressure_at=()):
    """One robot along y = 0, a scan a pose, through the store as the
    mapper drives it (poll, recentre, fuse), with a big-grid oracle (K1's
    deltas at the global origin, clip-added) beside it; the window must
    equal the oracle's region after every step. Returns (store,
    bit-equal steps)."""
    import numpy as np
    from jax_mapping_torch.ops import grid as G
    from jax_mapping_torch.ops import sensor_kernel as SK
    from jax_mapping_torch.world.store import WorldStore
    store = WorldStore(cfg, spill_dir=spill_dir)
    win = G.empty_grid(store.cfg.grid, DEV)
    big = G.empty_grid(cfg.grid, DEV)
    g = cfg.grid
    ranges = np.random.default_rng(0).uniform(
        1.0, 11.0, cfg.scan.padded_beams).astype(np.float32)
    r_dev = torch.as_tensor(ranges, device=DEV).reshape(1, -1)
    t, w, p = store.tile_cells, store.window_cells, g.patch_cells
    equal = 0
    for i, x in enumerate(WORLD_WALK):
        pose_w = np.array([x, 0.0, 0.0], np.float32)
        win, _ = store.poll_prefetch(win)
        off = store.offset_xy()
        dr, dc = store.desired_shift(
            [pose_w - np.array([off[0], off[1], 0.0], np.float32)])
        if (dr, dc) != (0, 0):
            win = store.shift(win, dr, dc)
            win, _ = store.poll_prefetch(win)
        win = store.fuse_scan_global(win, ranges, pose_w)
        pose = torch.as_tensor(pose_w, device=DEV).reshape(1, 3)
        og = G.patch_origin(g, torch.as_tensor(pose_w[:2])).numpy()
        delta = SK.scan_deltas(g, cfg.scan, r_dev, pose, torch.as_tensor(
            og.astype(np.int32), device=DEV).reshape(1, 2))[0]
        r, c = int(og[0]), int(og[1])
        big[r:r + p, c:c + p] = torch.clamp(big[r:r + p, c:c + p] + delta,
                                            g.logodds_min, g.logodds_max)
        if i in decay_at:
            d = cfg.decay
            win = G.decay_grid(win, d.factor, d.evidence_cap)
            store.note_decay_pass()
            big = G.decay_grid(big, d.factor, d.evidence_cap)
        if i in pressure_at:
            store.hold_pressure(f"walk@{i}", 0.5)
        r0, c0 = store.origin_tile
        equal += bool(torch.equal(win, big[r0 * t:r0 * t + w,
                                           c0 * t:c0 * t + w]))
    return store, equal


def _tiny_world_drive(torch, dev: str, cfg, msgs, start):
    """A windowed MapperNode at tiny config on `dev` fed `msgs`: ((R, n,
    3) poses, ranges, stamps) a tick. Returns its schedule, origins,
    estimates a tick and final grid (host)."""
    import numpy as np
    R = start.shape[0]
    m, bus = _world_mapper(torch, cfg, R, None, dev, start)
    try:
        origins, est = [], []
        for poses, ranges, stamps in msgs:
            _world_publish(bus, R, cfg, poses, ranges, stamps)
            m.tick()
            origins.append(m.world.origin_tile)
            est.append(m._read_poses() + np.array(
                [*m.world.offset_xy(), 0.0], np.float32))
        return {"schedule": list(m.world.schedule), "origins": origins,
                "est": np.stack(est), "grid": m.shared_grid.cpu().numpy(),
                "shifts": m.world.n_shifts,
                "rehydrated_host": m.world.n_rehydrated_host}
    finally:
        m.destroy()


#: Card against CPU on the tiny windowed drive, metres and radians. The
#: estimates agree exactly through the shifts and part at the drive's
#: first loop closures, whose pose-graph solve rounds differently on the
#: card: an H100 run of this phase read 4.1e-6 m, 4.3 float32 spacings at
#: the drive's largest world coordinate (8.9 m, spacing 9.5e-7 m). The
#: bound is ~5x that reading.
WORLD_PARITY_EST = 2e-5


def phase_world_parity(torch, seed: int):
    """(a) the store walk at the full window, host-only and with a disk
    tier, bit-equal to its oracle at every step; (b) a windowed tiny
    MapperNode drive on the card and on the CPU from the same messages:
    schedules and origins equal, estimates within WORLD_PARITY_EST, at
    most 1e-4 of the cells apart."""
    import shutil
    import numpy as np
    from jax_mapping_torch.config import SlamConfig, tiny_config
    tmp = tempfile.mkdtemp(prefix="chip_smoke_world_parity_")
    out = {"phase": "world_parity", "walk_m": WORLD_WALK, "store": {}}
    bc = BatchCount(capture=True)
    try:
        bc.__enter__()
        for name, kw, spill, decay_at, pressure_at in (
                ("host", {}, None, (4,), ()),
                ("disk", dict(host_tile_budget=1, retention_coarsen=1),
                 os.path.join(tmp, "spill"), (4,), (3,))):
            cfg = _world_config(SlamConfig(), WORLD_LOGICAL_CELLS, **kw)
            store, equal = _store_walk(torch, cfg, spill, decay_at,
                                       pressure_at)
            st = store.status()
            out["store"][name] = {
                "steps_bit_equal": equal, "steps": len(WORLD_WALK),
                **{k: st[k] for k in ("shifts", "evictions",
                                      "rehydrated_host",
                                      "rehydrated_disk", "lost_tiles",
                                      "decay_epoch")}}
            store.close()
    finally:
        bc.__exit__(None, None, None)
        shutil.rmtree(tmp, ignore_errors=True)
    out["k1_launches_by_batch"] = bc.n

    # (b): tiny_config(2) over a 768-cell lattice with a 4-tile window; a
    # gallery walk east past two shifts and back, 4 scans a robot a tick
    # (tiny_config's window).
    base = tiny_config(2)
    cfg = _world_config(base, 768, window_tiles=4, margin_tiles=1,
                        host_tile_budget=64)
    world = _gallery(768, cfg.grid.resolution_m, -3.0, 15.0, 1.6, 1.0,
                     seed + 12)
    n = base.fleet.batch_scans
    lead, _turn = _course_ticks(9.0, -0.5, 0.1, n)
    form = [(0.0, 0.4), (-0.6, -0.4)]
    course = _WorldCourse(torch, cfg, world, "cpu", form, lead)
    msgs = [course.tick(t) for t in range(len(lead))]
    start = course.poses(0)[:, 0]
    a = _tiny_world_drive(torch, DEV, cfg, msgs, start)
    c = _tiny_world_drive(torch, "cpu", cfg, msgs, start)
    # The estimates' gap a tick, split at the first shift: the world
    # frame's coordinates there are several metres, whose float32 spacing
    # is ~1e-6 m.
    gap = np.abs(a["est"][..., :2] - c["est"][..., :2]).reshape(
        len(msgs), -1).max(1)
    first_shift = next((k for k, o in enumerate(a["origins"])
                        if o != a["origins"][0]), len(msgs))
    out["mapper"] = {
        "config": "tiny_config(2), 768^2 logical, 4-tile window",
        "ticks": len(msgs), "shifts": a["shifts"],
        "rehydrated_host": a["rehydrated_host"],
        "schedules_equal": a["schedule"] == c["schedule"],
        "origins_equal": a["origins"] == c["origins"],
        "est_m": float(gap.max()),
        "est_rad": float(np.abs(a["est"][..., 2] - c["est"][..., 2]).max()),
        "first_shift_tick": first_shift,
        "est_m_before_first_shift": float(gap[:first_shift].max(
            initial=0.0)),
        "est_m_after_first_shift": float(gap[first_shift:].max(
            initial=0.0)),
        "first_gap_tick": int(np.argmax(gap > 0)) if (gap > 0).any()
        else None,
        "max_abs_coord_m": float(np.abs(a["est"][..., :2]).max()),
        "f32_spacing_at_max_m": float(np.spacing(np.float32(
            np.abs(a["est"][..., :2]).max()))),
        "cells_differ": int((a["grid"] != c["grid"]).sum()),
        "cells_total": int(a["grid"].size)}
    emit(out)
    for name, r in out["store"].items():
        check(r["steps_bit_equal"] == r["steps"],
              f"world store ({name}) differs from its oracle: {r}")
        check(r["shifts"] >= 2 and r["rehydrated_host"]
              + r["rehydrated_disk"] > 0, f"world store ({name}): {r}")
    check(out["store"]["disk"]["rehydrated_disk"] > 0,
          "the disk walk rehydrated nothing from disk")
    mp = out["mapper"]
    check(mp["shifts"] >= 2, f"the tiny windowed drive: {mp}")
    check(mp["schedules_equal"] and mp["origins_equal"],
          f"the windowed mapper's schedule differs card / CPU: {mp}")
    check(mp["est_m"] <= WORLD_PARITY_EST and
          mp["est_rad"] <= WORLD_PARITY_EST,
          f"windowed mapper estimates card / CPU: {mp}")
    check(mp["cells_differ"] <= 1e-4 * mp["cells_total"],
          f"windowed mapper grids card / CPU: {mp}")
    return out, bc.inputs


# ---------------------------------------------------------------------------
# The multi-rank mesh, trace replay
# ---------------------------------------------------------------------------

SHARDED_TICKS = 30
SHARDED_VOXEL_TICKS = 20


def _sharded_world(torch, cfg):
    """The fleet phase's world, plank_course(4096, 0.05, n_planks=40,
    seed=0), on the card."""
    return _world(cfg, torch.device(DEV), torch)


#: Ring slots the closing drive leaves free: its ring holds max_poses less
#: these key poses, so the closure's key pose lands without a thinning.
SHARDED_CLOSING_FREE_SLOTS = 8
SHARDED_CLOSING_TICKS = 3


def _sharded_closing_state(torch, cfg, mesh, seed: int):
    """A state that a long mission reaches just before it closes its loops,
    and its world: each robot of a formation has driven a gallery (the
    world phase's `_gallery`, walls, pillars and boxes) east and back west
    to its start, a key pose every `min_travel_m`, max_poses less
    SHARDED_CLOSING_FREE_SLOTS of them in its graph (odometry edges) and
    ring (noise-free scans); the grid is the ring fused onto the slab. Its
    estimate stands one key step west of its start, heading west, so its
    next key pose lies within the search disc of its chain's first poses.
    Built with the step's own pieces (`_update_graphs`, `_slab_delta`), on
    the mesh's device. Returns (state, world)."""
    from jax_mapping_torch.models import fleet as FL
    from jax_mapping_torch.parallel import fleet_sharded as FS
    from jax_mapping_torch.sim import lidar
    dev = FS.mesh_device(mesh)
    Rl, slab_rows = FS.shard_shape(cfg, mesh)
    res, cap = cfg.grid.resolution_m, cfg.loop.max_poses
    step_m = cfg.matcher.min_travel_m
    K = cap - SHARDED_CLOSING_FREE_SLOTS
    east = K // 2
    length = east * step_m
    world = torch.as_tensor(_gallery(cfg.grid.size_cells, res, -4.0,
                                     length + 4.0, 4.0, 2.0, seed + 21),
                            device=dev)
    ys = torch.tensor([-1.2, -0.4, 0.4, 1.2])
    form = torch.stack([-1.0 * ((torch.arange(Rl) // 4) % 2),
                        ys[torch.arange(Rl) % 4]], 1)
    k = torch.arange(K, dtype=torch.float64)
    x = torch.where(k < east, k * step_m, (2 * east - 1 - k) * step_m)
    th = torch.where(k < east, 0.0, math.pi)
    course = torch.stack([x, torch.zeros_like(x), th], 1)      # (K, 3)
    poses = (course[None] + torch.cat(
        [form, torch.zeros(Rl, 1)], 1)[:, None].double()).float().to(dev)
    n_samples = int(cfg.scan.range_max_m / (res * 0.5))
    flat = poses.reshape(-1, 3)
    scans = torch.cat([lidar.simulate_scans(cfg.scan, world, res, n_samples,
                                            flat[s:s + 512])
                       for s in range(0, flat.shape[0], 512)]
                      ).reshape(Rl, K, -1)
    st = FS.init_sharded_state(cfg, mesh)
    graphs, rings = st.graphs, st.scan_rings
    key = torch.ones(Rl, dtype=torch.bool, device=dev)
    for j in range(K):
        graphs, rings, _ = FL._update_graphs(cfg, graphs, poses[:, j], key,
                                             scans[:, j], rings)
    grid = torch.clamp(FS._slab_delta(
        cfg, scans.reshape(Rl * K, -1), poses.reshape(Rl * K, 3),
        FS.axis_index(mesh, "space") * slab_rows, slab_rows),
        cfg.grid.logodds_min, cfg.grid.logodds_max)
    start = poses[:, 0] + torch.tensor([-step_m, 0.0, math.pi], device=dev)
    return st._replace(true_poses=start, est_poses=start.clone(), grid=grid,
                       last_key_poses=poses[:, -1].contiguous(),
                       graphs=graphs, scan_rings=rings,
                       t=st.t + K), world


def _repair_fold_times(torch, cfg, scans, poses) -> dict:
    """The closure repair's fold two ways on the same ring scans, each
    after a warm-up: `_slab_delta`'s slice add a scan (what the step runs)
    and one accumulating `index_put_` a 64-scan sub-batch (measured only:
    the port does not use it); times, peak memory above the inputs, and
    the largest difference (the two sum overlapping patches in different
    orders)."""
    from jax_mapping_torch.ops import grid as G
    from jax_mapping_torch.ops.fuse_kernel import _STREAM_CHUNK
    from jax_mapping_torch.parallel import fleet_sharded as FS
    g = cfg.grid
    P, N = g.patch_cells, g.size_cells

    def index_put():
        canvas = torch.zeros((N + 2 * P, N), device=scans.device)
        ar = torch.arange(P, device=scans.device)
        for c in range(0, scans.shape[0], _STREAM_CHUNK):
            d, o = G._classify_batch(g, cfg.scan, scans[c:c + _STREAM_CHUNK],
                                     poses[c:c + _STREAM_CHUNK])
            rows = (o[:, 0, None, None] + P + ar[None, :, None]).long()
            cols = (o[:, 1, None, None] + ar[None, None, :]).long()
            canvas.index_put_((rows, cols), d, accumulate=True)
        return canvas[P:P + N]

    out = {"scans": int(scans.shape[0])}
    res = {}
    for name, fn in (("slice_adds", lambda: FS._slab_delta(
            cfg, scans, poses, 0, N)), ("index_put", index_put)):
        fn()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        res[name] = fn()
        torch.cuda.synchronize()
        out[f"{name}_ms"] = (time.perf_counter() - t0) * 1e3
        out[f"{name}_peak_above_inputs_bytes"] = \
            torch.cuda.max_memory_allocated() - base
    out["max_abs_diff"] = float((res["slice_adds"] - res["index_put"])
                                .abs().max())
    return out


def phase_sharded(torch, cfg, fleet: dict, seed: int,
                  ticks: int = SHARDED_TICKS,
                  voxel_ticks: int = SHARDED_VOXEL_TICKS):
    """The multi-rank mesh's main path on one NCCL rank (a 1 x 1 mesh,
    brought up in this process): `make_fleet_step` of the default
    SlamConfig, 8 robots on the fleet phase's world, `ticks` ticks, then
    the closing drive (`_sharded_closing_state`: the same widths from a
    state whose robots have driven their loops) until a tick closes loops,
    whose repair re-fuses every valid ring slot of every robot (about 8 x
    1024 scans), held to the port's full-grid unclamped fuse; then
    `make_voxel_fuse_step` on the default (64, 1024, 1024) voxel grid, the
    voxel phase's 8 images a tick for `voxel_ticks` ticks, held to the
    patch path's grid. Counts are zeroed before each part and read after
    it: K1 (both modes), K2, K3 and K7 must launch. The matcher runs 5
    times on the last tick's inputs: the space replicas of a mesh rely on
    it being deterministic."""
    from jax_mapping_torch.ops import _cuda
    from jax_mapping_torch.ops import grid as G
    from jax_mapping_torch.ops import scan_match as M
    from jax_mapping_torch.ops import voxel as V
    from jax_mapping_torch.parallel import fleet_sharded as FS
    from jax_mapping_torch.parallel import mesh as MESH
    from jax_mapping_torch.parallel import voxel_sharded as VS
    from jax_mapping_torch.sim import depthcam as D
    from jax_mapping_torch.sim import lidar
    world = _sharded_world(torch, cfg)
    mesh = MESH.make_mesh(1, 1)                      # default: the card
    check(mesh.device_type == "cuda", "the sharded mesh is not on the card")
    R, res = cfg.fleet.n_robots, cfg.grid.resolution_m
    st = FS.init_sharded_state(cfg, mesh)
    step = FS.make_fleet_step(cfg, mesh, res)
    gen = torch.Generator().manual_seed(seed)
    normals = [torch.randn((R, 2), generator=gen).to(DEV)
               for _ in range(ticks + SHARDED_CLOSING_TICKS)]
    cst, cworld = _sharded_closing_state(torch, cfg, mesh, seed)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    _cuda.reset_launches()
    tick_ms, syncs, verifies, closing = [], [], [], []
    with VerifyCount() as vc, BatchCount(cfg.grid) as bc:
        for i in range(ticks):
            n0, k0 = vc.n, _cuda.LAUNCHES["sensor_model_delta"]
            loops0 = int(st.n_loops.sum())
            t0 = time.perf_counter()
            if 1 <= i <= 3:
                (st, met), n_sync = _count_syncs(
                    torch, lambda: step(st, world, normals[i]))
                syncs.append(n_sync)
            else:
                st, met = step(st, world, normals[i])
            torch.cuda.synchronize()
            tick_ms.append((time.perf_counter() - t0) * 1e3)
            verifies.append(vc.n - n0)
            if int(st.n_loops.sum()) > loops0:
                closing.append({"tick": i, "k1_delta_launches":
                                _cuda.LAUNCHES["sensor_model_delta"] - k0})
        peak = torch.cuda.max_memory_allocated()
        # The closing drive, until a tick closes loops.
        torch.cuda.reset_peak_memory_stats()
        for i in range(SHARDED_CLOSING_TICKS):
            k0 = _cuda.LAUNCHES["sensor_model_delta"]
            loops0 = int(cst.n_loops.sum())
            t0 = time.perf_counter()
            cst, _ = step(cst, cworld, normals[ticks + i])
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            if int(cst.n_loops.sum()) > loops0:
                closing.append({
                    "drive": "closing", "tick": i, "ms": ms,
                    "loops_closed": int(cst.n_loops.sum()) - loops0,
                    "repair_scans": int(cst.graphs.pose_valid.sum()),
                    "k1_delta_launches":
                        _cuda.LAUNCHES["sensor_model_delta"] - k0})
                break
        close_peak = torch.cuda.max_memory_allocated()
    launches = dict(_cuda.LAUNCHES)
    routes = {k: dict(v) for k, v in _cuda.ROUTES.items()}
    grid = st.grid
    # The repair held to the port's full-grid unclamped fuse of the same
    # ring scans at the same poses, folded in the same order.
    valid = cst.graphs.pose_valid[:, :cfg.loop.max_poses].reshape(-1)
    want = torch.clamp(G.scan_deltas_full(
        cfg.grid, cfg.scan,
        cst.scan_rings.reshape(valid.shape[0], -1)[valid],
        cst.graphs.poses[:, :cfg.loop.max_poses].reshape(-1, 3)[valid]),
        cfg.grid.logodds_min, cfg.grid.logodds_max)
    repair_apart = int((cst.grid != want).sum())
    repair_max_abs = float((cst.grid - want).abs().max())
    del want
    fold = _repair_fold_times(
        torch, cfg, cst.scan_rings.reshape(valid.shape[0], -1)[valid],
        cst.graphs.poses[:, :cfg.loop.max_poses].reshape(-1, 3)[valid])
    del cst, cworld
    # The matcher on the last tick's inputs, 5 times.
    scans = lidar.simulate_scans(cfg.scan, world, res,
                                 max(8, int(cfg.scan.range_max_m
                                            / (res * 0.5))), st.true_poses)
    runs = [M.match_batch(cfg.grid, cfg.scan, cfg.matcher, grid, scans,
                          st.est_poses) for _ in range(5)]
    deterministic = all(torch.equal(r.pose, runs[0].pose)
                        and torch.equal(r.response, runs[0].response)
                        for r in runs)
    del runs, scans

    # The Y-slab voxel fuse on the same mesh.
    vox, cam = cfg.voxel, cfg.depthcam
    drive = _VoxelDrive(torch, cfg)
    n_samples = D.n_samples_for(cam, vox.resolution_m)
    batches = []
    for t in range(voxel_ticks):
        p = drive.poses([t * drive.ARC])
        batches.append((D.render_depths(cam, drive.world, vox.resolution_m,
                                        n_samples, p), p))
    fuse = VS.make_voxel_fuse_step(vox, cam, mesh)
    vgrid = VS.init_sharded_voxel_grid(vox, mesh)
    check(vgrid.device.type == DEV, "the voxel slab is not on the card")
    torch.cuda.synchronize()
    _cuda.reset_launches()
    voxel_ms = []
    for d, p in batches:
        t0 = time.perf_counter()
        vgrid = fuse(vgrid, d, p)
        torch.cuda.synchronize()
        voxel_ms.append((time.perf_counter() - t0) * 1e3)
    voxel_launches = dict(_cuda.LAUNCHES)
    _, voxel_syncs = _count_syncs(torch, lambda: fuse(vgrid, *batches[-1]))
    patch = V.empty_voxel_grid(vox, DEV)
    for d, p in batches:
        patch = V.fuse_depths(vox, cam, patch, d, p)
    voxel_apart = int(((vgrid - patch).abs() > 1e-5).sum())
    vcounts = _voxel_counts(vox, vgrid)
    steady = tick_ms[1:]
    import torch.distributed as dist
    out = {"phase": "sharded", "mesh": [1, 1],
           "backend": str(dist.get_backend()),
           "ticks": ticks, "robots": R, "grid_cells": cfg.grid.size_cells,
           "world": "plank_course(4096, 0.05, n_planks=40, seed=0)",
           "first_tick_ms": tick_ms[0], "tick_ms": _p50_p90(steady),
           "fleet_step_tick_p50_ms": fleet["tick_p50_ms"],
           "host_syncs_ticks_1_to_3": syncs,
           "verifications_per_tick": verifies,
           "loops_closed": int(st.n_loops.sum()),
           "closing_ticks": closing,
           "closing_peak_mem_bytes": close_peak,
           "repair_cells_apart_from_full_grid_fuse": repair_apart,
           "repair_max_abs_err": repair_max_abs,
           "repair_fold": fold,
           "launches": launches,
           "launches_per_tick": {k: v / ticks for k, v in launches.items()},
           "routes": routes,
           "k1_launches_by_batch": bc.per_tick(1),
           "peak_mem_bytes": peak, "peak_above_start_bytes": peak - base,
           "mean_pose_err_m": float(met["mean_pose_err_m"]),
           "mapped_occ_cells": int((grid > cfg.grid.occ_threshold).sum()),
           "observed_cells": int((grid != 0).sum()),
           "matcher_deterministic_5_calls": deterministic,
           "voxel": {"ticks": voxel_ticks, "images_per_tick":
                     int(batches[0][0].shape[0]),
                     "grid": [vox.size_z_cells, vox.size_y_cells,
                              vox.size_x_cells],
                     "region_route": VS.uses_region_kernel(vox, cam, mesh),
                     "tick_ms": _p50_p90(voxel_ms[1:]),
                     "host_syncs_per_fuse": voxel_syncs,
                     "launches": voxel_launches,
                     "voxels_apart_from_patch_path": voxel_apart,
                     "map": vcounts}}
    emit(out)
    check(bool(torch.isfinite(grid).all()), "sharded grid non-finite")
    check(float(grid.abs().max()) <= cfg.grid.logodds_max,
          "sharded grid outside the log-odds bounds")
    check(out["observed_cells"] > 0, "the sharded fleet observed no cell")
    check(closing, "no sharded tick closed a loop")
    check(repair_apart == 0,
          f"the sharded repair differs from the full-grid fuse in "
          f"{repair_apart} cells (max abs {repair_max_abs})")
    for name in FLEET_KERNELS:
        check(launches[name] > 0,
              f"kernel {name} never launched on the sharded path")
    check(deterministic, "the card's matcher is not deterministic")
    check(out["voxel"]["region_route"], "the voxel fuse left the region route")
    check(voxel_launches["voxel_summed"] >= voxel_ticks,
          "kernel voxel_summed did not launch on every sharded voxel tick")
    check(bool(torch.isfinite(vgrid).all()), "sharded voxel grid non-finite")
    check(vcounts["occupied"] > 0, "the sharded voxel fuse mapped nothing")
    check(voxel_apart <= 1e-4 * vgrid.numel(),
          f"sharded voxel grid: {voxel_apart} voxels off the patch path")
    launches_all = {k: launches[k] + voxel_launches[k] for k in launches}
    return out, launches_all


def sharded_kernel_rows(torch, cfg, seed: int, fleet: dict, mapper: dict,
                        batches: dict, rows: dict) -> dict:
    """Rows for the K1 batches the sharded path launched (`batches`: its
    BatchCount totals) that the kernels phase holds no row for, each
    against its plain version on poses near walls (the coarse view for a
    batch keyed at its resolution), with its launches on the sharded
    path. Its K2, K3 and K7 shapes are the fleet's and the voxel region's
    rows."""
    from jax_mapping_torch.models import slam as S
    from jax_mapping_torch.ops import grid as G
    from jax_mapping_torch.sim import lidar
    world = _sharded_world(torch, cfg)
    gen = torch.Generator().manual_seed(seed)
    res = cfg.grid.resolution_m
    n_samples = int(cfg.scan.range_max_m / (res * 0.5))
    out = {}
    for name, raster in (("sensor_model_delta", False),
                         ("sensor_model_raster", True)):
        covered = {_k1_key(r) for k, r in rows.items()
                   if k.startswith(name) and "shape" in r
                   and "cells_within_range" in r}
        for key in sorted(set(batches[name]) - covered):
            B, _, tag = key.partition("@")
            c = cfg
            if tag:
                g_c, m_c = S._loop_wide_cfgs(cfg)
                c = cfg.replace(grid=g_c, matcher=m_c)
            poses = _poses_near_walls(torch, cfg, world, int(B), gen)
            ranges = lidar.simulate_scans(cfg.scan, world, res, n_samples,
                                          poses)
            origins = G.patch_origin(c.grid, poses[:, :2]).contiguous()
            row = _k1_row(torch, c, raster, ranges, poses, origins, fleet,
                          mapper, key=key)
            row["launches_sharded"] = batches[name][key]
            out[f"{name}_sharded_b{key}"] = row
    emit({"phase": "kernels_sharded", "rows": out})
    for name, r in out.items():
        check(r["mismatches"] == 0,
              f"kernel {name} differs from its plain version in "
              f"{r['mismatches']} elements (max abs {r['max_abs_err']})")
    return out


def phase_sharded_parity(torch, seed: int):
    """tiny_config with 8 robots on a 1 x 1 mesh, on the card and on the
    CPU (a card mesh and a CPU mesh over the same process group) from one
    state with the same wheel normals: 6 ticks in the 4.8 m arena, and 10
    of the dry run's trajectory (closures and thinning) in its 2.4 m
    arena. Truth poses to 1e-6 m, estimates to 1e-4 m, assignments and
    loop counts equal, at most 1e-4 of the grid cells apart, every tick;
    then one voxel fuse of 8 tiny images, at most 1e-4 of the voxels
    apart. The drive is tests/torch_sharded_drive.py, which the card
    tests share."""
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import torch_sharded_drive as SD
    out = {"phase": "sharded_parity", "mesh": [1, 1], "robots": SD.ROBOTS}
    for name in SD.TICKS:
        out[name] = SD.step_card_and_cpu(name, seed)
    out["voxel"] = SD.voxel_fuse_card_and_cpu()
    emit(out)
    for name in SD.TICKS:
        bad = SD.step_failures(name, out[name])
        check(not bad, f"sharded parity {name}: {bad} {out[name]}")
    bad = SD.voxel_failures(out["voxel"])
    check(not bad, f"sharded parity voxel: {bad} {out['voxel']}")
    return out


def phase_dryrun(torch):
    """`parallel.dryrun` on one NCCL rank: the 16-step trajectory must
    thin and close loops, planned steering runs, the voxel fuse leaves
    evidence (K1-K3 and K7 on the card)."""
    from jax_mapping_torch.ops import _cuda
    from jax_mapping_torch.parallel import dryrun as DR
    _cuda.reset_launches()
    t0 = time.perf_counter()
    summary = DR.dryrun(1)
    secs = time.perf_counter() - t0
    out = {"phase": "dryrun", **summary, "seconds": secs,
           "launches": dict(_cuda.LAUNCHES)}
    emit(out)
    check(summary["thins"] >= 1, "dry run: no thinning")
    check(summary["loops_closed"] >= 1, "dry run: no loop closed")
    check(summary["voxels_updated"] > 0, "dry run: no voxel evidence")
    for name in FLEET_KERNELS + ("voxel_summed",):
        check(out["launches"][name] > 0, f"dry run: {name} never launched")
    return out


SHARDED_RANKS_TICKS = 6


def _sharded_rank(argv) -> None:
    """One rank of the `sharded_ranks` phase's gloo jobs (spawned by
    `parallel.dryrun.spawn`): argv = [device, ticks, seed, output dir].
    tiny_config with 8 robots on a 2 x 2 mesh in the 4.8 m arena, the
    fleet's wheel normals from one seeded stream; writes this rank's
    robots, its launch counts and (rank 0) the gathered global state."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from jax_mapping_torch import interop
    from jax_mapping_torch.config import tiny_config
    from jax_mapping_torch.ops import _cuda
    from jax_mapping_torch.parallel import fleet_sharded as FS
    from jax_mapping_torch.parallel import mesh as MESH
    from jax_mapping_torch.sim import world as W
    dev, ticks, seed, out_dir = argv[0], int(argv[1]), int(argv[2]), argv[3]
    rank = dist.get_rank()
    mesh = MESH.make_mesh(2, 2, device_type=dev)
    cfg = tiny_config(8)
    res = cfg.grid.resolution_m
    st = FS.init_sharded_state(cfg, mesh)
    step = FS.make_fleet_step(cfg, mesh, res)
    world = torch.as_tensor(W.empty_arena(96, res),
                            device=FS.mesh_device(mesh))
    gen = torch.Generator().manual_seed(seed)
    out, ms = {}, []
    _cuda.reset_launches()
    for t in range(ticks):
        t0 = time.perf_counter()
        st, met = step(st, world, torch.randn((8, 2), generator=gen))
        if dev == "cuda":
            torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        g = interop.sharded_state_to_numpy(st, mesh)
        out[f"truth{t}"], out[f"est{t}"] = g.true_poses, g.est_poses
        out[f"grid{t}"] = g.grid
        out[f"assign{t}"] = MESH.gather_rows(met["assignment"], mesh,
                                             "fleet").cpu().numpy()
        out[f"loops{t}"] = np.asarray(int(met["n_loops"]))
    mine = {"truth": st.true_poses.cpu().numpy(),
            "est": st.est_poses.cpu().numpy(),
            "n_poses": st.graphs.n_poses.cpu().numpy(),
            "tick_ms": np.asarray(ms),
            "launches": np.asarray([_cuda.LAUNCHES[k]
                                    for k in FLEET_KERNELS])}
    np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **mine)
    if rank == 0:
        np.savez(os.path.join(out_dir, "global.npz"), **out)


def phase_sharded_ranks(torch, seed: int, ticks: int = SHARDED_RANKS_TICKS):
    """4 gloo ranks sharing the one card (a 2 x 2 mesh; gloo takes the
    card's tensors for all_reduce and all_gather_into_tensor), tiny_config
    with 8 robots, `ticks` ticks, held to the same 2 x 2 job on 4 CPU
    ranks: truth poses to 1e-6 m, estimates to 1e-4 m, assignments and
    loop counts equal, at most 1e-4 of the cells apart, every tick; the
    'space' replicas of each robot bit-equal on the card; K1-K3 launched
    on every card rank. No multi-card speed: the ranks share one card."""
    import numpy as np
    from jax_mapping_torch.parallel import dryrun as DR
    res = {}
    for dev in ("cuda", "cpu"):
        with tempfile.TemporaryDirectory() as d:
            t0 = time.perf_counter()
            DR.spawn("chip_smoke:_sharded_rank", 4,
                     [dev, str(ticks), str(seed), d], timeout_s=300)
            secs = time.perf_counter() - t0
            with np.load(os.path.join(d, "global.npz")) as z:
                g = {k: z[k] for k in z.files}
            ranks = []
            for r in range(4):
                with np.load(os.path.join(d, f"rank{r}.npz")) as z:
                    ranks.append({k: z[k] for k in z.files})
        res[dev] = (g, ranks, secs)
    (a, ra, sa), (b, _rb, sb) = res["cuda"], res["cpu"]
    T = range(ticks)
    out = {"phase": "sharded_ranks", "mesh": [2, 2], "backend": "gloo",
           "ranks_share_one_card": True, "ticks": ticks, "robots": 8,
           "job_s": {"cuda": sa, "cpu": sb},
           "rank0_tick_ms_cuda": _p50_p90(list(ra[0]["tick_ms"][1:])),
           "truth_m": max(float(np.abs(a[f"truth{t}"]
                                       - b[f"truth{t}"]).max()) for t in T),
           "est_m": max(float(np.abs(a[f"est{t}"] - b[f"est{t}"]).max())
                        for t in T),
           "cells_apart_max_share": max(float(
               (np.abs(a[f"grid{t}"] - b[f"grid{t}"]) > 1e-5).mean())
               for t in T),
           "assignments_equal": all(np.array_equal(a[f"assign{t}"],
                                                   b[f"assign{t}"])
                                    for t in T),
           "loops_equal": all(int(a[f"loops{t}"]) == int(b[f"loops{t}"])
                              for t in T),
           "space_replicas_bit_equal": all(
               np.array_equal(ra[2 * f][k], ra[2 * f + 1][k])
               for f in range(2) for k in ("truth", "est", "n_poses")),
           "launches_by_rank_cuda": {
               str(r): dict(zip(FLEET_KERNELS,
                                ra[r]["launches"].tolist()))
               for r in range(4)}}
    emit(out)
    check(out["truth_m"] <= 1e-6, f"sharded ranks: truth {out['truth_m']}")
    check(out["est_m"] <= 1e-4, f"sharded ranks: estimates {out['est_m']}")
    check(out["assignments_equal"], "sharded ranks: assignments")
    check(out["loops_equal"], "sharded ranks: loop counts")
    check(out["cells_apart_max_share"] <= 1e-4, "sharded ranks: grid cells")
    check(out["space_replicas_bit_equal"],
          "sharded ranks: the 'space' replicas differ on the card")
    for r, launches in out["launches_by_rank_cuda"].items():
        for name in FLEET_KERNELS:
            check(launches[name] > 0,
                  f"sharded ranks: {name} never launched on rank {r}")
    return out


def _demo(argv) -> tuple:
    """jax_mapping_torch.demo.main(argv) with its standard output captured:
    (rc, the summary JSON it printed, or None)."""
    import contextlib
    import io
    from jax_mapping_torch import demo
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = demo.main(argv)
    text = buf.getvalue()
    i = text.find("{")
    return rc, (json.loads(text[i:]) if i >= 0 else None)


def phase_replay(torch, seed: int, steps: int = 40):
    """The rosbag workflow on the card: `demo --record` of a tiny_config(2)
    stack for `steps` steps (every robot's /scan and /odom), then `demo
    --replay` of that bag into a fresh mapper. The replay must fuse scans
    and map occupied cells; K1 launches on the replay."""
    from jax_mapping_torch.io.trace import TraceReplayer
    from jax_mapping_torch.ops import _cuda
    with tempfile.TemporaryDirectory() as d:
        bag = os.path.join(d, "run.npz")
        t0 = time.perf_counter()
        rc, live = _demo(["--robots", "2", "--steps", str(steps),
                          "--seed", str(seed), "--record", bag])
        record_s = time.perf_counter() - t0
        check(rc == 0 and live is not None, f"demo --record rc {rc}")
        n_bag = len(TraceReplayer(bag))
        torch.cuda.synchronize()
        _cuda.reset_launches()
        t0 = time.perf_counter()
        rc, rep = _demo(["--robots", "2", "--replay", bag])
        replay_s = time.perf_counter() - t0
        launches = dict(_cuda.LAUNCHES)
    check(rc == 0 and rep is not None, f"demo --replay rc {rc}")
    out = {"phase": "replay", "steps_recorded": steps,
           "bag_messages": n_bag, "record_s": record_s,
           "replay_s": replay_s, "device": rep["device"],
           "replayed": rep["replayed"], "scans_fused": rep["scans_fused"],
           "scans_dropped_unpaired": rep["scans_dropped_unpaired"],
           "cells_occupied": rep["cells_occupied"],
           "cells_free": rep["cells_free"],
           "live_cells_occupied": live["cells_occupied"],
           "launches": launches}
    emit(out)
    check(rep["device"].startswith("cuda"), "the replay ran off the card")
    check(rep["replayed"] == n_bag, "the replay skipped messages")
    check(rep["scans_fused"] > 0, "the replay fused no scan")
    check(rep["cells_occupied"] > 0, "the replayed map holds no occupied cell")
    check(launches["sensor_model_delta"] > 0 or launches["window_apply"] > 0,
          "no fusion kernel launched on the replay")
    return out


#: The scenario phase: the day's schedule over STACK_WORLD's rooms at full
#: width. The first door in the plan is door_h0 (the horizontal wall's
#: door 8.75 m south of the spawn): from the spawn poses, 102 of the 8
#: robots' beams cross it when it is closed, door_v0's 104, door_h1's and
#: door_v1's none (a raycast of the closed against the open world).
SCENARIO_STEPS = 150
SCENARIO_DOORS = ("door_h0", "door_v0", "door_h1", "door_v1")
SCENARIO_KILL = 100
SCENARIO_SAMPLE_EVERY = 5
#: Steps whose world on the card is compared with the host composition.
SCENARIO_WORLD_CHECKS = (0, 12, 30, 62, 74, 120, 149)
#: Host syncs are counted over the whole step (sim, brain, mapper) of a
#: step with a crowd out (30) and of a quiet one (62: no crowd, no toggle).
SCENARIO_SYNC_STEPS = {"crowd": 30, "quiet": 62}
#: A step inside door_h0's first closure (steps 10-39) at which the
#: fleet's scans must cross the closed door.
SCENARIO_CROSS_STEP = 20


def _scenario_config(cfg):
    """`cfg` with map healing at its defaults (every 20 ticks, x 0.92, cap
    2.0) and the obs tier with the JAX shared mission's staleness
    objective."""
    from jax_mapping_torch.config import DecayConfig, ObsConfig, SloObjective
    return cfg.replace(
        decay=DecayConfig(enabled=True),
        obs=ObsConfig(enabled=True, slo=(SloObjective(
            name="staleness", metric="tile_staleness_revs", threshold=30.0,
            fast_window_ticks=8, slow_window_ticks=24, fast_burn=0.5,
            slow_burn=0.25),)))


class _Patched:
    """Class attributes replaced for a measurement while the context is
    open, restored after."""

    def __init__(self, *triples):
        self.triples = triples

    def __enter__(self):
        self.saved = [(cls, name, cls.__dict__[name])
                      for cls, name, _ in self.triples]
        for cls, name, fn in self.triples:
            setattr(cls, name, fn)
        return self

    def __exit__(self, *exc):
        for cls, name, fn in self.saved:
            setattr(cls, name, fn)


def _stub_plan_log(events, seed: int) -> list:
    """The log a FaultPlan of `events` writes against a stack that takes
    every call: the scripted schedule on the step clock."""
    from jax_mapping_torch.resilience.faultplan import FaultPlan

    class Any:
        def __getattr__(self, name):
            return lambda *a, **k: None
    stub = Any()
    stub.bus, stub.sim, stub.driver = Any(), Any(), Any()
    stub.brain = type("B", (), {"n_robots": STACK_ROBOTS})()
    plan = FaultPlan(list(events), seed=seed)
    for t in range(SCENARIO_STEPS):
        plan.apply(stub, t)
    return list(plan.log)


def phase_scenario(torch, seed: int):
    """Faults and scripted world dynamics at full width:
    `run_lifelong_mission` of SlamConfig() with decay and the obs tier on
    STACK_WORLD's rooms, their widened doors registered, 8 robots, a
    checkpoint dir, 150 steps of
    `day_plan(150, doors, n_crowds=2, door_cycle=60, crowd_cycle=90,
    kill_steps=(100,))`. Counts are zeroed before the mission and read
    after: K1 (both modes), K2 and K3 must launch; K5 is reported."""
    import numpy as np
    from jax_mapping_torch.bridge.launch import Stack
    from jax_mapping_torch.bridge.mapper import MapperNode
    from jax_mapping_torch.bridge.sim_node import SimNode
    from jax_mapping_torch.config import SlamConfig
    from jax_mapping_torch.obs.recorder import flight_recorder
    from jax_mapping_torch.ops import _cuda
    from jax_mapping_torch.scenarios import (WorldDynamics, day_plan,
                                             run_lifelong_mission)
    from jax_mapping_torch.sim import lidar
    cfg = _scenario_config(SlamConfig())
    sys.path.insert(0, os.path.join(HERE, "tests"))
    import torch_kernel_inputs as KI
    world, doors = KI.rooms_wide_doors(1024, cfg.grid.resolution_m,
                                       door_m=2.0, seed=1,
                                       return_doors=True)
    by_name = {d["name"]: d for d in doors}
    doors = [by_name[n] for n in SCENARIO_DOORS]
    events = day_plan(SCENARIO_STEPS, SCENARIO_DOORS, n_crowds=2,
                      door_cycle=60, crowd_cycle=90,
                      kill_steps=(SCENARIO_KILL,))
    off = (cfg.grid.size_cells - world.shape[0]) // 2
    closure_ends = {}
    for e in events:
        if e.kind == "door_close" and e.step + e.duration <= SCENARIO_STEPS:
            closure_ends.setdefault(e.step + e.duration, []).append(e.name)
    box = {"stacks": [], "step_s": [], "compose_ms": [], "uploads": [],
           "upload_syncs": 0, "decay": [], "decay_launches": {"label_prop": 0,
                                           "costfield_relax": 0},
           "syncs": {}, "world_equal": {}, "occupied": {}, "cross": None}
    orig_run, orig_world_at = Stack.run_steps, WorldDynamics.world_at
    orig_upload, orig_decay = SimNode._upload_world, MapperNode._apply_decay
    orig_tick = MapperNode.tick
    occ = cfg.grid.occ_threshold

    def world_at(self, step):
        t0 = time.perf_counter()
        try:
            return orig_world_at(self, step)
        finally:
            box["compose_ms"].append((time.perf_counter() - t0) * 1e3)

    def upload(self, w):
        # Outside the steps whose syncs are counted whole, the upload's
        # own host syncs are counted here (the sync debug mode is off).
        counting = torch.cuda.get_sync_debug_mode() == 0
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        with SyncWindow(torch, armed=counting) as win:
            t0 = time.perf_counter()
            ev[0].record()
            try:
                orig_upload(self, w)
            finally:
                ev[1].record()
        box["uploads"].append(((time.perf_counter() - t0) * 1e3,
                               int(w.nbytes), ev))
        if counting:
            box["upload_syncs"] += win.syncs

    def decay(self):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        orig_decay(self)
        ev[1].record()
        box["decay"].append(ev)

    def tick(self):
        n0 = self.n_decay_passes
        l0 = {k: _cuda.LAUNCHES[k] for k in box["decay_launches"]}
        orig_tick(self)
        if self.n_decay_passes != n0:
            # The publish after a decay pass recomputes every tile.
            for k in box["decay_launches"]:
                box["decay_launches"][k] += _cuda.LAUNCHES[k] - l0[k]

    def one_step(self):
        k = self._steps_run
        if k in SCENARIO_SYNC_STEPS.values():
            n_up = self.sim.n_world_updates
            with SyncWindow(torch) as win:
                orig_run(self, 1)
            box["syncs"][k] = {
                "syncs": win.syncs,
                "uploads": self.sim.n_world_updates - n_up}
        else:
            orig_run(self, 1)

    def run_steps(self, n):
        if not box["stacks"]:
            box["stacks"].append(self)
        for _ in range(n):
            k = self._steps_run
            t0 = time.perf_counter()
            one_step(self)
            box["step_s"].append(time.perf_counter() - t0)
            if k in SCENARIO_WORLD_CHECKS:
                dyn = self.sim._world_dyn
                shadow = WorldDynamics(dyn.base, dyn.res_m,
                                       doors=dyn.doors.values(),
                                       seed=dyn.seed)
                snap = dyn.snapshot()
                for name, closed in snap["doors"].items():
                    shadow.set_door(name, closed)
                for cid, r in snap["crowds"].items():
                    shadow.set_crowd(cid, r)
                box["world_equal"][k] = bool(np.array_equal(
                    self.sim.world.cpu().numpy(), orig_world_at(shadow, k)))
            if k == SCENARIO_CROSS_STEP:
                # The fleet's scans at this step's truth poses, on the card,
                # in the sim's world (door_h0 closed) and with it open.
                d = by_name[SCENARIO_DOORS[0]]
                shut = self.sim.world
                opened = shut.clone()
                opened[d["r0"]:d["r1"], d["c0"]:d["c1"]] = False
                poses = self.sim.sim_state.poses
                a = lidar.simulate_scans(cfg.scan, shut, 0.05,
                                         self.sim.n_samples, poses)
                b = lidar.simulate_scans(cfg.scan, opened, 0.05,
                                         self.sim.n_samples, poses)
                box["cross"] = {"door": d["name"], "step": k,
                                "closed": bool(shut[d["r0"]:d["r1"],
                                                    d["c0"]:d["c1"]].all()),
                                "beams": int((a != b).sum())}
            done = self._steps_run
            if done in closure_ends or done == SCENARIO_STEPS:
                g = self.mapper.merged_grid()
                for name in (SCENARIO_DOORS if done == SCENARIO_STEPS
                             else closure_ends[done]):
                    d = by_name[name]
                    rect = g[d["r0"] + off:d["r1"] + off,
                             d["c0"] + off:d["c1"] + off]
                    box["occupied"].setdefault(name, []).append(
                        [done, int((rect > occ).sum())])

    ck = tempfile.mkdtemp(prefix="scenario_ckpt_")
    mark = flight_recorder.mark()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    with _Patched((Stack, "run_steps", run_steps),
                  (WorldDynamics, "world_at", world_at),
                  (SimNode, "_upload_world", upload),
                  (MapperNode, "_apply_decay", decay),
                  (MapperNode, "tick", tick)), \
            StageSamples("mapper.tick") as ticks, \
            BatchCount(cfg.grid) as bc, SweepRecorder() as rec:
        t0 = time.perf_counter()
        rep = run_lifelong_mission(cfg, world, doors, events, SCENARIO_STEPS,
                                   seed=seed, checkpoint_dir=ck,
                                   n_robots=STACK_ROBOTS,
                                   sample_every=SCENARIO_SAMPLE_EVERY)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    st = box["stacks"][0]
    evs = flight_recorder.events_since(mark)
    restarts = [e for e in evs if e["kind"] == "restart_epoch"]
    up_ms = [u[0] for u in box["uploads"]]
    up_dev = [u[2][0].elapsed_time(u[2][1]) for u in box["uploads"]]
    decay_ms = [e[0].elapsed_time(e[1]) for e in box["decay"]]
    expected_log = _stub_plan_log(events, seed)
    out = {"phase": "scenario", "config": "SlamConfig(), DecayConfig("
           "enabled=True), ObsConfig(enabled=True, staleness SLO)",
           "world": STACK_WORLD + ", doors registered",
           "robots": STACK_ROBOTS, "steps": SCENARIO_STEPS,
           "plan": f"day_plan({SCENARIO_STEPS}, {list(SCENARIO_DOORS)}, "
                   "n_crowds=2, door_cycle=60, crowd_cycle=90, "
                   f"kill_steps=({SCENARIO_KILL},))",
           "first_door": box["cross"],
           "wall_s": wall, "steps_per_s": SCENARIO_STEPS / sum(box["step_s"]),
           "mapper_tick_ms": {**_p50_p90(ticks.ms), "n": len(ticks.ms),
                              "max": max(ticks.ms)},
           "n_world_updates": rep.n_world_updates,
           "compose_host_ms": {"p50": statistics.median(box["compose_ms"]),
                               "max": max(box["compose_ms"]),
                               "n": len(box["compose_ms"])},
           "uploads": {"n": len(box["uploads"]),
                       "bytes_each": sorted({u[1] for u in box["uploads"]}),
                       "host_ms_p50": statistics.median(up_ms),
                       "host_ms_max": max(up_ms),
                       "device_ms_p50": statistics.median(up_dev),
                       "device_ms_max": max(up_dev),
                       "host_syncs": box["upload_syncs"]},
           "decay_passes": len(decay_ms),
           "decay_passes_restarted_mapper": rep.n_decay_passes,
           "decay_device_ms": decay_ms,
           "k2_k3_launches_in_decay_ticks": box["decay_launches"],
           "mapper_restarts": rep.n_mapper_restarts,
           "restart_epoch": rep.restart_epoch,
           "resumed_from_checkpoint": [e["resumed_from_checkpoint"]
                                       for e in restarts],
           "mapper_ticks_after_restart": st.mapper._tick_no,
           "scans_fused_after_restart": st.mapper.n_scans_fused,
           "plan_log_len": len(rep.plan_log),
           "spans": st.tracer.last_seq(),
           "slo_alerts": rep.slo_alerts,
           "launches": launches,
           "k1_launches_by_batch": bc.n,
           "host_syncs": {name: box["syncs"].get(k)
                          for name, k in SCENARIO_SYNC_STEPS.items()},
           "world_equal_at": box["world_equal"],
           "door_occupied_cells": box["occupied"],
           "scans_fused": rep.n_scans_fused,
           "map_revision": rep.map_revision,
           "cells_occupied": int((rep.grid > occ).sum()),
           "cells_free": int((rep.grid < cfg.grid.free_threshold).sum()),
           "checkpoint_files": rep.checkpoint_files,
           "peak_bytes": peak}
    emit(out)
    check(st.device.type == "cuda" and st.sim.world.is_cuda
          and st.mapper.shared_grid.is_cuda, "the scenario stack is not on "
          "the card")
    check(len(box["world_equal"]) == len(SCENARIO_WORLD_CHECKS)
          and all(box["world_equal"].values()),
          f"the card's world differs from the host composition: "
          f"{box['world_equal']}")
    quiet = out["host_syncs"]["quiet"]
    check(quiet is not None and quiet["uploads"] == 0,
          f"a quiet step uploaded the world: {quiet}")
    crowd = out["host_syncs"]["crowd"]
    check(crowd is not None and crowd["uploads"] == 1,
          f"a crowd step did not upload once: {crowd}")
    check(box["upload_syncs"] == 0,
          f"the world uploads made {box['upload_syncs']} host syncs")
    check(box["cross"] is not None and box["cross"]["closed"]
          and box["cross"]["beams"] > 0,
          f"the fleet's scans do not cross the closed first door: "
          f"{box['cross']}")
    check(rep.n_mapper_restarts == 1 and rep.restart_epoch == 1
          and out["resumed_from_checkpoint"] == [True],
          f"the mapper was not restarted once from the checkpoint: {out}")
    check(out["mapper_ticks_after_restart"] > 0
          and out["scans_fused_after_restart"] > 0,
          "the restarted mapper did not tick")
    for name in FLEET_KERNELS:
        check(launches[name] > 0,
              f"kernel {name} never launched on the scenario path")
    check(rep.plan_log == expected_log,
          f"the plan log is not the scripted schedule: {rep.plan_log}")
    check(rep.n_decay_passes > 0 and rep.n_world_updates > 0,
          "no decay pass or no world update")
    check(bool(np.isfinite(rep.grid).all()), "scenario grid non-finite")
    return ({"per": f"{SCENARIO_STEPS} scenario steps",
             "k1_launches_by_batch": bc.n}, out, rec)


#: The JAX suite's shared scenario mission (tests/test_scenarios.py).
SCENARIO_PARITY_STEPS = 72
SCENARIO_PARITY_POLL = 18


def _parity_scenario_config():
    from jax_mapping_torch.config import (DecayConfig, ObsConfig,
                                          SloObjective, tiny_config)
    return tiny_config().replace(
        decay=DecayConfig(enabled=True, every_n_ticks=8, factor=0.9,
                          evidence_cap=1.5),
        obs=ObsConfig(enabled=True, slo=(SloObjective(
            name="staleness", metric="tile_staleness_revs", threshold=30.0,
            fast_window_ticks=8, slow_window_ticks=24, fast_burn=0.5,
            slow_burn=0.25),)))


def phase_scenario_parity(torch, seed: int):
    """The JAX suite's shared scenario mission on the card and on the CPU
    in this process: tiny_config, DecayConfig(True, 8, 0.9, 1.5), obs with
    the staleness SLO, arena_with_door(96), 2 robots, door_close at step 4
    for 16 steps, a crowd at 26 for 10 steps (0.25 m), kill_node of the
    mapper at 48, 72 steps, a delta client polling at step 18 and at the
    end. Plan logs, world updates, decay passes and SLO alerts equal,
    truth within 1e-5 m, the grids at most 1e-4 of the cells apart, and
    the span streams equal under obs/diff.py."""
    import numpy as np
    from jax_mapping_torch.obs.diff import diff_streams
    from jax_mapping_torch.obs.recorder import flight_recorder
    from jax_mapping_torch.resilience.faultplan import FaultEvent, FaultPlan
    from jax_mapping_torch.scenarios import launch_scenario_stack
    from jax_mapping_torch.serving.client import DeltaMapClient
    from jax_mapping_torch.sim import world as W
    cfg = _parity_scenario_config()
    world, doors = W.arena_with_door(96, cfg.grid.resolution_m)
    runs = {}
    for dev in ("cuda", "cpu"):
        mark = flight_recorder.mark()
        st = launch_scenario_stack(cfg, world, doors=doors, n_robots=2,
                                   seed=seed, http_port=0, device=dev,
                                   checkpoint_dir=tempfile.mkdtemp(
                                       prefix="scenario_parity_"))
        st.brain.start_exploring()
        st.brain.reconnect_period_s = 0.0
        plan = FaultPlan([
            FaultEvent(step=4, kind="door_close", name="door0",
                       duration=16),
            FaultEvent(step=26, kind="crowd", robot=0, duration=10,
                       value=0.25),
            FaultEvent(step=48, kind="kill_node", name="jax_mapper")],
            seed=seed)
        st.attach_fault_plan(plan)
        client = DeltaMapClient(f"http://127.0.0.1:{st.api.port}")
        truth = []
        t0 = time.perf_counter()
        for k in range(SCENARIO_PARITY_STEPS):
            st.run_steps(1)
            truth.append(st.sim.truth_poses())
            if k + 1 == SCENARIO_PARITY_POLL:
                client.poll()
        client.poll()
        wall = time.perf_counter() - t0
        evs = flight_recorder.events_since(mark)
        runs[dev] = {
            "wall_s": wall, "truth": np.stack(truth),
            "grid": st.mapper.merged_grid().cpu().numpy(),
            "log": list(plan.log),
            "counts": [st.sim.n_world_updates, st.mapper.n_decay_passes,
                       st.supervisor.n_restarts("jax_mapper"),
                       st.mapper.restart_epoch],
            "slo": [(e["tick"], e["state"]) for e in evs
                    if e["kind"] == "slo_alert"],
            "spans": [{k: s[k] for k in ("name", "trace_id", "span_id",
                                         "parent_span")}
                      for s in st.tracer.spans_since(0)],
            "client": [client.epoch, client.n_epoch_resyncs]}
        st.shutdown()
    a, b = runs["cuda"], runs["cpu"]
    div = diff_streams(a["spans"], b["spans"])
    out = {"phase": "scenario_parity",
           "config": "tiny_config(), DecayConfig(True, 8, 0.9, 1.5), obs + "
                     "staleness SLO, arena_with_door(96), 2 robots",
           "steps": SCENARIO_PARITY_STEPS,
           "steps_per_s": {d: SCENARIO_PARITY_STEPS / r["wall_s"]
                           for d, r in runs.items()},
           "plan_logs_equal": a["log"] == b["log"],
           "plan_log": [d for _, d in a["log"]],
           "counts": {"cuda": a["counts"], "cpu": b["counts"]},
           "slo_alerts": {"cuda": a["slo"], "cpu": b["slo"]},
           "truth_m": float(np.abs(a["truth"] - b["truth"]).max()),
           "cells_differ": int((a["grid"] != b["grid"]).sum()),
           "cells_total": int(a["grid"].size),
           "spans": len(a["spans"]),
           "span_divergence": None if div is None else div.describe(),
           "client": {"cuda": a["client"], "cpu": b["client"]}}
    emit(out)
    check(out["plan_logs_equal"] and a["counts"] == b["counts"]
          and a["slo"] == b["slo"] and a["client"] == b["client"],
          f"scenario parity: schedules differ {out}")
    check(a["counts"][1] > 0 and a["counts"][2] == 1 and a["slo"],
          f"scenario parity: no decay, restart or alert {out}")
    check(out["truth_m"] <= 1e-5, f"scenario parity: truth {out['truth_m']}")
    check(out["cells_differ"] <= 1e-4 * out["cells_total"],
          f"scenario parity: {out['cells_differ']} cells differ")
    check(div is None, f"scenario parity: span streams {out}")
    return out


#: The JAX suite's bounded-memory corridor soak
#: (tests/test_world.py::test_bounded_memory_corridor_soak), with the
#: planner off: the port refuses a windowed stack with the planner.
LIFELONG_STEPS = 800


def _lifelong_world_config():
    import dataclasses
    from jax_mapping_torch.config import WorldConfig, tiny_config
    base = tiny_config()
    return base.replace(
        grid=dataclasses.replace(base.grid, size_cells=768),
        serving=dataclasses.replace(base.serving, tile_cells=32),
        matcher=dataclasses.replace(base.matcher, min_travel_m=1e9),
        robot=dataclasses.replace(base.robot,
                                  speed_coeff_m_per_unit_s=0.003027,
                                  speed_noise_frac=0.0,
                                  lidar_warn_dist_m=0.5,
                                  lidar_stop_dist_m=0.8),
        recovery=dataclasses.replace(base.recovery, enabled=False),
        planner=dataclasses.replace(base.planner, enabled=False),
        world=WorldConfig(windowed=True, window_tiles=8, margin_tiles=3,
                          host_tile_budget=6, retention_coarsen=1))


def phase_lifelong_world(torch, seed: int):
    """The corridor soak on the card: one robot patrols a 3.2 m corridor of
    a 768^2 logical lattice through a 256^2 window (out east, back past
    the spawn, out again), with a memory_pressure window over the return
    leg's shift-back and two spill_corrupt rots while the spill holds the
    outbound tiles. The device window's bytes must stay flat while the
    distance grows; the pressure must fire and clear through the
    FaultPlan; the rots must hit real spilled tiles, and their rehydrate
    must degrade to unknown with a `world_spill_corrupt` event."""
    import numpy as np
    from jax_mapping_torch.obs.recorder import flight_recorder
    from jax_mapping_torch.ops import _cuda
    from jax_mapping_torch.resilience.faultplan import FaultEvent
    from jax_mapping_torch.scenarios import run_lifelong_mission
    from jax_mapping_torch.sim import world as W
    cfg = _lifelong_world_config()
    world, doors = W.corridor_course(768, cfg.grid.resolution_m,
                                     corridor_w_m=3.2)
    goal_script = [(0, 15.0, 0.0), (130, -15.0, 0.9), (520, 15.0, 0.0)]
    events = [FaultEvent(step=240, kind="memory_pressure", value=0.7,
                         duration=150),
              FaultEvent(step=330, kind="spill_corrupt", value=2.0),
              FaultEvent(step=500, kind="spill_corrupt", value=2.0)]
    mark = flight_recorder.mark()
    _cuda.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rep = run_lifelong_mission(cfg, world, doors, events, LIFELONG_STEPS,
                               seed=seed, n_robots=1,
                               checkpoint_dir=tempfile.mkdtemp(
                                   prefix="lifelong_"),
                               goal_script=goal_script)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    degrades = [e for e in flight_recorder.events_since(mark)
                if e["kind"] == "world_spill_corrupt"]
    window_bytes = (8 * 32) ** 2 * 4
    series = rep.world_series
    t = cfg.serving.tile_cells
    r0, c0 = series[-1]["origin_tile"]
    truth = world[r0 * t:r0 * t + 256, c0 * t:c0 * t + 256]
    known = np.abs(rep.grid) > 0.5
    out = {"phase": "lifelong_world",
           "config": "tests/test_world.py corridor soak config, "
                     "planner.enabled=False", "steps": LIFELONG_STEPS,
           "wall_s": wall, "steps_per_s": LIFELONG_STEPS / wall,
           "peak_device_window_bytes": rep.peak_device_window_bytes(),
           "window_bytes_series": sorted({s["device_window_bytes"]
                                          for s in series}),
           "distance_m": rep.distance_traveled_m,
           "origins": len({tuple(s["origin_tile"]) for s in series}),
           "max_away_tiles": max(s["away_tiles"] for s in series),
           "max_spill_tiles": max(s["spill_tiles"] for s in series),
           "plan_log": [d for _, d in rep.plan_log],
           "spill_corrupt_degrades": len(degrades),
           "known_cells": int(known.sum()),
           "sign_agreement": float(((rep.grid > 0.5)
                                    == (truth > 0.5))[known].mean()),
           "launches": dict(_cuda.LAUNCHES)}
    emit(out)
    check(out["peak_device_window_bytes"] == window_bytes
          and out["window_bytes_series"] == [window_bytes],
          f"lifelong world: the device window grew {out}")
    dists = [s["distance_m"] for s in series]
    check(dists == sorted(dists) and rep.distance_traveled_m > 8.0,
          f"lifelong world: distance did not grow {out}")
    check(any("memory_pressure" in d for d in out["plan_log"])
          and any("clear: memory_pressure" in d for d in out["plan_log"]),
          f"lifelong world: memory_pressure did not fire and clear {out}")
    check(any("spill_corrupt" in d and "tile(s)" in d
              for d in out["plan_log"]),
          f"lifelong world: spill_corrupt rotted no spilled tile {out}")
    check(degrades, "lifelong world: no rotted tile was read back")
    check(out["origins"] >= 2 and out["max_spill_tiles"] > 0,
          f"lifelong world: the window never spilled {out}")
    return out


# ---------------------------------------------------------------------------
# The obs tier's device half and the staged restart warm-up
# ---------------------------------------------------------------------------

#: The coldstart phase: the stack phase's mission with the dispatch
#: profiler and the warm-restart tier armed, a cache wipe at step 30 for
#: 20 steps and the mapper killed at step 80, 120 steps.
COLDSTART_STEPS = 120
COLDSTART_WIPE = (30, 20)
COLDSTART_KILL = 80
COLDSTART_GUARD = 20                 # the recompile guard's last steps
COLDSTART_TOP = 8                    # entry points shown by dispatch time
COLDSTART_INERT_STEPS = 40


def _coldstart_config(root: str):
    import dataclasses
    from jax_mapping_torch.config import (ColdStartConfig, DevProfConfig,
                                          SlamConfig)
    cfg = SlamConfig()
    return cfg.replace(
        obs=dataclasses.replace(cfg.obs,
                                devprof=DevProfConfig(enabled=True)),
        cold_start=ColdStartConfig(enabled=True, cache_dir=root))


class ProfilerCost:
    """The dispatch profiler's own bookkeeping (its per-call lookup and
    record) while the context is open: host time in it, calls, and — while
    `count_syncs` is set — the host syncs made inside it, counted by
    PyTorch's CUDA sync debug mode around each of those calls only (the
    mode in force outside is restored after each)."""

    def __init__(self, torch, prof):
        self.torch, self.prof = torch, prof
        self.syncs = self.calls = self.sync_calls = 0
        self.s = 0.0
        self.count_syncs = False

    def _count(self, fn):
        def counted(*args, **kwargs):
            self.calls += 1
            if not self.count_syncs:
                t0 = time.perf_counter()
                try:
                    return fn(*args, **kwargs)
                finally:
                    self.s += time.perf_counter() - t0
            win = SyncWindow(self.torch)
            try:
                with win:
                    t0 = time.perf_counter()
                    try:
                        return fn(*args, **kwargs)
                    finally:
                        self.s += time.perf_counter() - t0
            finally:
                self.syncs += win.syncs
                self.sync_calls += 1
        return counted

    def __enter__(self):
        self.prof._fresh = self._count(self.prof._fresh)
        self.prof._record = self._count(self.prof._record)
        return self

    def __exit__(self, *exc):
        del self.prof._fresh, self.prof._record


def _sim_clock(st, cfg):
    """Stamps from a simulated clock, one control period a step (the
    mapper's estimates follow stamp intervals; ROADMAP C). Returns the
    patched modules' previous `time` attributes."""
    import types
    from jax_mapping_torch.bridge import brain as _brain
    from jax_mapping_torch.bridge import sim_node as _sim_node
    clock = [1000.0]
    saved = [(m, m.time) for m in (_brain, _sim_node)]
    for m, _ in saved:
        m.time = types.SimpleNamespace(monotonic=lambda: clock[0])
    step = st.sim.step

    def stepped():
        clock[0] += 1.0 / cfg.robot.control_rate_hz
        step()
    st.sim.step = stepped
    return saved


def _inert_drive(torch, devprof: bool, seed: int, steps: int):
    """tiny_config(2) on the card for `steps` steps with simulated-clock
    stamps: (grid, estimates, truth) on the host, and the steps' wall s."""
    import dataclasses
    from jax_mapping_torch.bridge.launch import launch_sim_stack
    from jax_mapping_torch.config import DevProfConfig, tiny_config
    from jax_mapping_torch.sim import world as W
    cfg = tiny_config(2)
    cfg = cfg.replace(obs=dataclasses.replace(
        cfg.obs, devprof=DevProfConfig(enabled=devprof)))
    world, _doors = W.rooms_with_doors(96, cfg.grid.resolution_m, seed=1)
    st = launch_sim_stack(cfg, world, n_robots=2, seed=seed, device=DEV)
    saved = _sim_clock(st, cfg)
    try:
        st.brain.start_exploring()
        t0 = time.perf_counter()
        st.run_steps(steps)
        torch.cuda.synchronize()
        return (st.mapper.shared_grid.cpu(),
                torch.stack([s.pose for s in st.mapper.states]).cpu(),
                st.sim.truth_poses().copy(), time.perf_counter() - t0)
    finally:
        for m, t in saved:
            m.time = t
        st.shutdown()


def phase_coldstart(torch, seed: int, stack_out: dict):
    """The slice at full width: `launch_sim_stack(SlamConfig(), STACK_WORLD,
    n_robots=8, checkpoint_dir, http_port=0)` with `obs.devprof` and
    `cold_start` armed (the build cache in a fresh directory), the stack
    phase's operator goal, 120 steps under a FaultPlan: `cache_wipe` at
    step 30 for 20 steps and `kill_node jax_mapper` at step 80 — the
    mapper killed mid-mission and restarted from its checkpoint through
    the staged warm-up, whose `warmup_hook` probes `/status` and `/tiles`
    inside the window. Counts are zeroed before the steps and read after;
    the warm-up's launches are counted apart. Prints steps/s beside
    `stack`'s, host syncs of mapper ticks 10-12 beside `stack`'s and those
    inside the profiler's own bookkeeping (must be 0), the top entry
    points by dispatch time, recompiles over the last 20 steps (must be
    0), the card's memory watermarks, the warm-up reports, the restart's
    wall ms and the ms from the kill to the first fused scan after it,
    the probes, the cache's counts, the cost ledger of the top entry
    points with its budget cross-check, and the K1/K2/K3/K5 launches.
    Then the bit-inert check: tiny_config(2) for 40 steps on the card,
    devprof on against off, must give bit-equal grids and estimates.
    Ends with `save_compile_snapshots()` for `coldstart_resume`."""
    import json
    from jax_mapping_torch.bridge.launch import launch_sim_stack
    from jax_mapping_torch.bridge.messages import Pose2D
    from jax_mapping_torch.obs.ledger import CostLedger
    from jax_mapping_torch.obs.recorder import flight_recorder
    from jax_mapping_torch.ops import _cuda
    from jax_mapping_torch.resilience.faultplan import FaultEvent, FaultPlan
    td = tempfile.mkdtemp(prefix="coldstart_")
    root = os.path.join(td, "cache")
    cfg = _coldstart_config(root)
    world = _stack_world(cfg.grid.resolution_m)
    mark = flight_recorder.mark()
    t0 = time.perf_counter()
    st = launch_sim_stack(cfg, world, n_robots=STACK_ROBOTS, seed=seed,
                          checkpoint_dir=td, http_port=0, device=DEV)
    torch.cuda.synchronize()
    launch_s = time.perf_counter() - t0
    check(st.device.type == "cuda" and st.mapper.shared_grid.is_cuda,
          "the coldstart stack is not on the card")
    check(st.devprof is not None and st.devprof.installed
          and st.compile_cache is not None and st.compile_cache.enabled,
          "the coldstart stack armed no profiler or no build cache")
    launch_warmup = st.warmup.snapshot()["report"]
    probes = []

    def probe(stack):
        t0 = time.perf_counter()
        s = json.loads(stack.api.handle("/status")[2])
        t = json.loads(stack.api.handle("/tiles?since=-1")[2])
        probes.append({"route_states": [s.get("state"), t.get("state")],
                       "tiles_epoch": t.get("epoch"),
                       "n_tiles": len(t.get("tiles", [])),
                       "warmup_state": stack.warmup.state(),
                       "ms": (time.perf_counter() - t0) * 1e3})
    st.warmup_hook = probe
    restart_ms, ckpt_ms = [], []
    st._restart_mapper_staged = _timed(st._restart_mapper_staged,
                                       restart_ms)
    # The supervisor's auto-checkpoints (every 50 steps; the stack phase
    # has no checkpoint_dir), timed to split them from the steps.
    st.supervisor.attach_checkpointer(_timed(st.save_auto_checkpoint,
                                             ckpt_ms))
    wipe_at, wipe_steps = COLDSTART_WIPE
    plan = FaultPlan([FaultEvent(step=wipe_at, kind="cache_wipe",
                                 duration=wipe_steps),
                      FaultEvent(step=COLDSTART_KILL, kind="kill_node",
                                 name="jax_mapper")], seed=seed)
    st.attach_fault_plan(plan)
    st.brain.start_exploring()
    st.bus.publisher("/goal_pose").publish(Pose2D(*STACK_GOAL))
    m0 = st.mapper
    mapper_tick = m0.tick
    syncs = []

    def counted_tick():
        if st._steps_run not in STACK_SYNC_TICKS:
            return mapper_tick()
        with SyncWindow(torch) as win:
            mapper_tick()
        syncs.append(win.syncs)
    m0.tick = counted_tick
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    t_kill = t_fuse = None
    step_ms = []
    with ProfilerCost(torch, st.devprof) as own, \
            StageSamples("mapper.tick") as ticks:
        t0 = time.perf_counter()
        for k in range(COLDSTART_STEPS):
            if k == COLDSTART_STEPS - COLDSTART_GUARD:
                guard_before = st.devprof.recompiles()
            if k == COLDSTART_KILL:
                t_kill = time.perf_counter()
            own.count_syncs = k in STACK_SYNC_TICKS
            ts = time.perf_counter()
            st.run_steps(1)
            step_ms.append((time.perf_counter() - ts) * 1e3)
            if t_kill is not None and t_fuse is None \
                    and st.mapper is not m0 and st.mapper.n_scans_fused:
                torch.cuda.synchronize()
                t_fuse = time.perf_counter()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    guard_after = st.devprof.recompiles()
    grew = {fn: [guard_before.get(fn, 0), n]
            for fn, n in guard_after.items()
            if n > guard_before.get(fn, 0)}
    wu = st.warmup.snapshot()
    warm_launches = dict(wu["report"].get("launches", {}))
    for k, v in launch_warmup.get("launches", {}).items():
        warm_launches[k] = warm_launches.get(k, 0) + v
    mission = {k: v - warm_launches.get(k, 0) for k, v in launches.items()}
    snap = st.devprof.snapshot()
    top = sorted(snap, key=lambda n: -snap[n]["total_ms"])[:COLDSTART_TOP]
    events = flight_recorder.events_since(mark)
    epochs = [e for e in events if e["kind"] == "restart_epoch"]
    cache = st.compile_cache.status()
    t1 = time.perf_counter()
    ledger = CostLedger(st.devprof)
    costs = ledger.collect()
    ledger_s = time.perf_counter() - t1
    violations = ledger.cross_check()
    new = st.mapper
    out = {"phase": "coldstart", "config": "SlamConfig() + obs.devprof + "
           "cold_start", "world": STACK_WORLD, "robots": STACK_ROBOTS,
           "steps": COLDSTART_STEPS,
           "faults": [list(e) for e in plan.log],
           "launch_s": launch_s, "wall_s": wall,
           "steps_per_s": COLDSTART_STEPS / wall,
           "steps_per_s_without_checkpoints_and_restart":
               COLDSTART_STEPS / (wall - (sum(ckpt_ms) + sum(restart_ms))
                                  / 1e3),
           "checkpoint_ms": ckpt_ms,
           "stack_steps_per_s": stack_out["steps_per_s"],
           "step_ms": _p50_p90(step_ms),
           "mapper_tick_ms": _p50_p90(ticks.ms[1:]),
           "stack_mapper_tick_ms": stack_out["mapper_tick_ms"],
           "host_syncs_per_mapper_tick": syncs,
           "stack_host_syncs_per_mapper_tick": [
               s["tick"] for s in stack_out["host_syncs_per_mapper_tick"]],
           "sync_ticks": list(STACK_SYNC_TICKS),
           "profiler_own_syncs": own.syncs,
           "profiler_own_sync_calls": own.sync_calls,
           "profiler_calls": own.calls,
           "profiler_ms_per_step": own.s * 1e3 / COLDSTART_STEPS,
           "top_dispatch": {n: snap[n] for n in top},
           "entry_points_dispatched": len(snap),
           "recompiles_last_steps": grew,
           "recompile_guard_steps": COLDSTART_GUARD,
           "recompiles_total": sum(st.devprof.recompiles().values()),
           "memory": st.devprof.memory_stats(),
           "peak_bytes": torch.cuda.max_memory_allocated(),
           "launch_warmup": launch_warmup,
           "restart_warmup": {k: wu["report"].get(k) for k in (
               "n_in_process", "n_prewarmed", "n_aot", "n_errors",
               "warm_s", "readiness_violations", "errors", "launches")},
           "restart_ms": restart_ms,
           "restart_ms_without_probe": [
               r - sum(p["ms"] for p in probes) for r in restart_ms],
           "kill_to_first_fuse_ms": (None if t_fuse is None
                                     else (t_fuse - t_kill) * 1e3),
           "probes": probes,
           "restart_epochs": epochs,
           "cache_counts": cache["counts"], "wipe_refs": cache["wipe_refs"],
           "fingerprint": cache["fingerprint"],
           "ledger_s": ledger_s,
           "ledger_entries": sum(len(v) for v in costs.values()),
           "ledger_top": {n: [{k: e.get(k) for k in (
               "signature", "flops", "bytes_accessed", "aten_ops",
               "kernels", "error")} for e in costs.get(n, [])]
               for n in top},
           "ledger_errors": {n: [e["error"] for e in es if "error" in e]
                             for n, es in costs.items()
                             if any("error" in e for e in es)},
           "budget_violations": violations,
           "launches": launches, "launches_mission": mission,
           "launches_warmup": warm_launches,
           "scans_fused_after_restart": new.n_scans_fused,
           "restart_epoch": new.restart_epoch}
    check(bool(torch.isfinite(new.shared_grid).all()),
          "coldstart grid non-finite")
    check(len(probes) == 1 and probes[0]["route_states"]
          == ["warming", "warming"] and probes[0]["tiles_epoch"] == 0
          and probes[0]["n_tiles"] > 0,
          f"the warming window did not serve epoch 0 with tiles: {probes}")
    check(len(epochs) == 1 and epochs[0]["resumed_from_checkpoint"]
          and new.restart_epoch == 1 and new.n_scans_fused > 0,
          f"the restart did not resume from the checkpoint and tick "
          f"on: {epochs}, fused {new.n_scans_fused}")
    check(not grew, f"steady-state recompiles over the last "
          f"{COLDSTART_GUARD} steps: {grew}")
    check(own.syncs == 0 and own.sync_calls > 0,
          f"the profiler's bookkeeping made {own.syncs} host syncs")
    check(cache["wipe_refs"] == 0 and cache["counts"].get("wipes") == 1
          and cache["counts"].get("files_wiped", 0) > 0,
          f"the cache_wipe window left {cache}")
    check(out["memory"] is not None and all(
        v["bytes_in_use"] > 0 for v in out["memory"].values()),
        f"no memory watermarks on the card: {out['memory']}")
    for name in ("sensor_model_delta", "sensor_model_raster",
                 "label_prop", "costfield_relax"):
        check(mission[name] > 0,
              f"kernel {name} never launched on the coldstart path")
    check(wu["report"]["n_errors"] == 0,
          f"the restart's warm-up failed: {wu['report'].get('errors')}")

    saved = st.save_compile_snapshots()
    st.shutdown()
    # Bit-inert: the profiler armed changes nothing the mission computes.
    off = _inert_drive(torch, False, seed, COLDSTART_INERT_STEPS)
    on = _inert_drive(torch, True, seed, COLDSTART_INERT_STEPS)
    inert = {"steps": COLDSTART_INERT_STEPS,
             "grid_equal": bool(torch.equal(off[0], on[0])),
             "estimates_equal": bool(torch.equal(off[1], on[1])),
             "truth_equal": bool((off[2] == on[2]).all()),
             "wall_s_off": off[3], "wall_s_on": on[3]}
    out["bit_inert"] = inert
    out["snapshots"] = saved
    emit(out)
    check(all(inert[k] for k in ("grid_equal", "estimates_equal",
                                 "truth_equal")),
          f"devprof is not bit-inert on the card: {inert}")
    check(saved["n_saved"] > 0,
          f"no manifest saved: {saved}")
    return out, {"dir": td, "root": root, "cfg": cfg}


def coldstart_child(torch, cfg_path: str, ckpt_dir: str, out_npy: str,
                    seed: int) -> int:
    """One `coldstart_resume` process: launch the coldstart stack on its
    cache root (the launch-time warm-up pre-warms the root's manifest),
    build every kernel library (found in a warm root, built by nvcc in a
    cold one), kill and restart the mapper from the coldstart phase's
    checkpoint through the staged warm-up, save the resumed grid, then
    step until a scan is fused. Prints one JSON line."""
    import numpy as np
    from jax_mapping_torch.bridge.launch import launch_sim_stack
    from jax_mapping_torch.config import SlamConfig
    from jax_mapping_torch.ops import _cuda
    with open(cfg_path) as f:
        cfg = SlamConfig.from_json(f.read())
    world = _stack_world(cfg.grid.resolution_m)
    st = launch_sim_stack(cfg, world, n_robots=STACK_ROBOTS, seed=seed,
                          checkpoint_dir=ckpt_dir, device=DEV)
    launch_warmup = st.warmup.snapshot()["report"]
    build_s = _cuda.build_all()
    st.kill_node("jax_mapper")
    st.restart_mapper()
    torch.cuda.synchronize()
    np.save(out_npy, st.mapper.merged_grid().cpu().numpy())
    st.brain.start_exploring()
    steps = 0
    while st.mapper.n_scans_fused == 0 and steps < 20:
        st.run_steps(1)
        steps += 1
    torch.cuda.synchronize()
    t_fuse = time.time()
    cache = st.compile_cache.status()
    emit({"first_fuse_wall": t_fuse, "steps_to_fuse": steps,
          "scans_fused": st.mapper.n_scans_fused,
          "builds": cache["counts"].get("builds", 0),
          "builds_found": cache["counts"].get("builds_found", 0),
          "build_s": build_s, "fingerprint": cache["fingerprint"],
          "launch_warmup": {k: launch_warmup.get(k) for k in (
              "n_in_process", "n_prewarmed", "n_aot", "n_errors", "warm_s",
              "readiness_violations", "errors", "launches")},
          "restart_warmup": st.warmup.snapshot()["report"]})
    st.shutdown()
    return 0


def phase_coldstart_resume(torch, seed: int, cs: dict) -> dict:
    """A resume in a fresh process, cold and warm: two processes of this
    script (`--coldstart-child`), each launching the coldstart stack from
    the coldstart phase's checkpoint, resuming, pre-warming and fusing one
    scan. Cold: an empty cache root, so nvcc builds every library.
    Warm: the coldstart phase's root, so they are found and the
    manifest's signatures pre-warm as `aot`. Seconds from each process's
    start to its first fused scan, libraries built, the warm-up reports;
    the two resumed grids must be bit-equal."""
    import dataclasses
    import numpy as np
    runs = {}
    for label, root in (("cold", os.path.join(cs["dir"], "cold_cache")),
                        ("warm", cs["root"])):
        cfg = cs["cfg"].replace(cold_start=dataclasses.replace(
            cs["cfg"].cold_start, cache_dir=root))
        cfg_path = os.path.join(cs["dir"], f"{label}.json")
        with open(cfg_path, "w") as f:
            f.write(cfg.to_json())
        npy = os.path.join(cs["dir"], f"{label}_resumed.npy")
        spawn = time.time()
        r = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--coldstart-child",
             cfg_path, cs["dir"], npy, "--seed", str(seed)],
            capture_output=True, text=True, timeout=600)
        if r.returncode != 0:
            raise Failed(f"coldstart_resume {label} process failed: "
                         f"{r.stderr[-3000:]}")
        child = json.loads(r.stdout.strip().splitlines()[-1])
        child["seconds_to_first_fuse"] = child.pop("first_fuse_wall") - spawn
        runs[label] = child
    grids = {k: np.load(os.path.join(cs["dir"], f"{k}_resumed.npy"))
             for k in runs}
    out = {"phase": "coldstart_resume", "runs": runs,
           "resumed_grids_equal": bool(np.array_equal(grids["cold"],
                                                      grids["warm"])),
           "resumed_occupied_cells": int((grids["warm"] > 0.5).sum())}
    emit(out)
    from jax_mapping_torch.ops import _cuda
    n_libs = len(_cuda.SOURCES)
    check(runs["cold"]["builds"] == n_libs,
          f"the cold process built {runs['cold']['builds']} libraries, "
          f"not {n_libs}")
    check(runs["warm"]["builds"] == 0,
          f"the warm process built {runs['warm']['builds']} libraries")
    check(runs["warm"]["launch_warmup"]["n_aot"] > 0,
          "the warm process pre-warmed no manifest signature")
    check(out["resumed_grids_equal"] and out["resumed_occupied_cells"] > 0,
          "the cold and warm processes resumed different maps")
    for label, run in runs.items():
        check(run["scans_fused"] > 0, f"the {label} process fused no scan")
    return out


#: The tenancy control plane's mission (phase_tenancy_plane): 8 robots a
#: tenant, tenants A-D of the default SlamConfig on rooms_world(4096,
#: 0.05, seed=1 + t); ticks after each step of the script.
PLANE_TENANTS = ("A", "B", "C", "D")
PLANE_TICKS = {"abc": 6, "abcd": 6, "suspend_b": 4, "resume_b": 4}
#: Ticks the quarantined tenant waits for its probe, at most (the
#: default readmit_probe_ticks is 8).
PLANE_PROBE_TICKS = 10
PLANE_AFTER_CRASH_TICKS = 2


def _plane_solo(torch, cfg, state, world, seed: int, n: int):
    """A tenant's solo oracle: `fleet_step` from its admitted state for n
    ticks, its noise from a generator seeded as the plane seeds it."""
    from jax_mapping_torch.models import fleet as FL
    g = torch.Generator().manual_seed(seed)
    for _ in range(n):
        state, _d = FL.fleet_step(cfg, state, cfg.grid.resolution_m, world,
                                  generator=g)
    return state


class _PlaneSyncs:
    """Host syncs of one `plane.step(1)`, split into those inside its
    `megabatch_tick` call and the plane's own."""

    def __init__(self, torch):
        self.torch = torch
        self.rows = []

    def step(self, plane) -> None:
        from jax_mapping_torch.tenancy import megabatch as MB
        torch, orig, marks = self.torch, MB.megabatch_tick, []

        def marked(*a, **k):
            marks.append(len(win))
            try:
                return orig(*a, **k)
            finally:
                marks.append(len(win))
        with SyncWindow(torch) as win:
            MB.megabatch_tick = marked
            try:
                plane.step(1)
            finally:
                MB.megabatch_tick = orig
        flags = [_is_sync(w) for w in win.records]
        inside = sum(flags[marks[0]:marks[1]])
        self.rows.append({"megabatch_tick": inside,
                          "plane_own": sum(flags) - inside})


def phase_tenancy_plane(torch, seed: int):
    """The tenancy control plane's path, the plane as a stack serves
    it: `launch_sim_stack` of the default SlamConfig with
    TenancyConfig(enabled=True, lane_health=True, journal=True), a
    checkpoint dir, http_port=0, 8 robots on the stack phase's world.
    The plane admits tenants A-D (missions of the default config, mission
    t on rooms_world(4096, 0.05, seed=1 + t), robots near walls): A, B, C
    (bucket 3), 6 ticks; D (bucket 6), 6 ticks; B suspended (bucket 3),
    4 ticks; B resumed, 4 ticks; a FaultPlan poisons C for 3 plan steps
    (quarantine), ticks until C's probe readmits it; the plan's
    `controlplane_crash` rebuilds the plane from its journal; 2 ticks; D
    evicted with a checkpoint. Checks: A, B (across its suspension), C
    (its good ticks) and D each bit-equal to its solo `fleet_step` run
    with its own generator's normals, which is what each co-tenant of C
    would be in a no-fault twin; the crash restores all four with every
    epoch advanced; a `/tiles?tenant=A` delta client resyncs across it
    and its mosaic equals A's map; /status.tenancy counts the script;
    the plane adds no host sync to `megabatch_tick`'s. Counts are zeroed
    before the first admission and read after the eviction; the
    admission pre-warms' launches are counted apart."""
    import json as _json
    import numpy as np
    from jax_mapping_torch.bridge.launch import launch_sim_stack
    from jax_mapping_torch.config import SlamConfig, TenancyConfig
    from jax_mapping_torch.io.checkpoint import load_checkpoint
    from jax_mapping_torch.models import fleet as FL
    from jax_mapping_torch.ops import _cuda
    from jax_mapping_torch.ops import grid as G
    from jax_mapping_torch.resilience import warmup as WU
    from jax_mapping_torch.resilience.faultplan import FaultEvent, FaultPlan
    from jax_mapping_torch.serving.client import DeltaMapClient
    from jax_mapping_torch.tenancy import controlplane as CP
    cfg = SlamConfig().replace(tenancy=TenancyConfig(
        enabled=True, lane_health=True, journal=True))
    ckdir = tempfile.mkdtemp(prefix="tenancy_plane_")
    st = launch_sim_stack(cfg, _stack_world(cfg.grid.resolution_m),
                          n_robots=STACK_ROBOTS, http_port=0, seed=seed,
                          checkpoint_dir=ckdir)
    plane = st.tenancy
    check(plane is not None and plane.device.type == "cuda"
          and st.api.tenancy is plane, "tenancy_plane: no plane on the card")
    states, worlds = _tenant_missions(torch, cfg, len(PLANE_TENANTS), seed)
    init = dict(zip(PLANE_TENANTS, states))
    wmap = dict(zip(PLANE_TENANTS, worlds))
    seeds = {t: seed + 300 + i for i, t in enumerate(PLANE_TENANTS)}
    good = {t: 0 for t in PLANE_TENANTS}     # ticks each solo run takes
    tick_ms, admissions, warm = {}, [], {}
    syncs = _PlaneSyncs(torch)
    orig_prewarm = WU.StagedWarmup.prewarm

    def counted_prewarm(self, *a, **k):
        rep = orig_prewarm(self, *a, **k)
        for name, v in rep["launches"].items():
            warm[name] = warm.get(name, 0) + v
        return rep

    def admit(tid):
        n0 = plane.n_prewarms
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plane.admit(tid, wmap[tid], seed=seeds[tid], state=init[tid])
        torch.cuda.synchronize()
        admissions.append({"tenant": tid, "op": "admit",
                           "bucket": plane.status()["bucket_capacity"],
                           "prewarmed": plane.n_prewarms > n0,
                           "ms": (time.perf_counter() - t0) * 1e3})

    def tick(n, live, count_syncs=False):
        for k in range(n):
            cap = int(plane.live_batch().active.shape[0])
            t0 = time.perf_counter()
            if count_syncs and 1 <= k <= 3:
                syncs.step(plane)
            else:
                plane.step(1)
            torch.cuda.synchronize()
            tick_ms.setdefault(cap, []).append(
                (time.perf_counter() - t0) * 1e3)
            for t in live:
                good[t] += 1

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _cuda.reset_launches()
    WU.StagedWarmup.prewarm = counted_prewarm
    try:
        for t in "ABC":
            admit(t)
        tick(PLANE_TICKS["abc"], "ABC", count_syncs=True)
        admit("D")
        tick(PLANE_TICKS["abcd"], "ABCD", count_syncs=True)
        plane.suspend("B")
        bucket_suspended = plane.status()["bucket_capacity"]
        tick(PLANE_TICKS["suspend_b"], "ACD")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plane.resume("B")
        torch.cuda.synchronize()
        admissions.append({"tenant": "B", "op": "resume",
                           "bucket": plane.status()["bucket_capacity"],
                           "prewarmed": False,
                           "ms": (time.perf_counter() - t0) * 1e3})
        tick(PLANE_TICKS["resume_b"], "ABCD")
        client = DeltaMapClient(f"http://127.0.0.1:{st.api.port}",
                                route="/tiles?tenant=A")
        client.poll()
        epoch_before = client.epoch
        # The fault script: C poisoned for 3 plan steps from step 0;
        # the crash once C is back.
        plan = FaultPlan([FaultEvent(step=0, kind="tenant_poison",
                                     name="C", duration=3)])
        quarantined_at = readmitted_at = None
        for k in range(3 + PLANE_PROBE_TICKS):
            plan.apply(st, k)
            tick(1, "ABD")
            life = plane.tenant_lifecycle("C")
            if life == "quarantined" and quarantined_at is None:
                quarantined_at = k
            if quarantined_at is not None and life == "active":
                readmitted_at = k
                break
        check(quarantined_at is not None and readmitted_at is not None,
              f"tenancy_plane: C quarantined at {quarantined_at}, "
              f"readmitted at {readmitted_at}")
        status_before = _json.loads(st.api.handle("/status")[2])["tenancy"]
        epochs_before = {t: plane.epoch(t) for t in PLANE_TENANTS}
        t_ck, t_rs = [], []
        orig_ckpt, orig_restore = plane.checkpoint_all, CP.TenantControlPlane.restore
        plane.checkpoint_all = lambda: _timed(orig_ckpt, t_ck)()

        def timed_restore(self):
            return _timed(lambda: orig_restore(self), t_rs)()
        CP.TenantControlPlane.restore = timed_restore
        try:
            crash = FaultPlan([FaultEvent(step=0,
                                          kind="controlplane_crash")])
            crash.apply(st, 0)
        finally:
            CP.TenantControlPlane.restore = orig_restore
        old, plane = plane, st.tenancy
        check(plane is not old and st.api.tenancy is plane,
              "tenancy_plane: the crash did not swap the plane")
        restored = {t: plane.tenant_lifecycle(t) for t in PLANE_TENANTS}
        epochs_after = {t: plane.epoch(t) for t in PLANE_TENANTS}
        del old
        tick(PLANE_AFTER_CRASH_TICKS, "ABCD")
        client.poll()
        mosaic_equal = bool(np.array_equal(
            client.image(0), G.to_gray(cfg.grid, plane.tenant_grid("A"))
            .cpu().numpy()))
        states_now = {t: plane.tenant_state(t) for t in "ABC"}
        path = plane.evict("D", checkpoint=True)
        status_after = _json.loads(st.api.handle("/status")[2])["tenancy"]
    finally:
        WU.StagedWarmup.prewarm = orig_prewarm
    torch.cuda.synchronize()
    launches = dict(_cuda.LAUNCHES)
    peak = torch.cuda.max_memory_allocated()
    like = FL.init_fleet_state(cfg, device=DEV,
                               radius_uniforms=torch.zeros(
                                   cfg.fleet.n_robots))
    d_final, _cfg = load_checkpoint(path, like)
    states_now["D"] = d_final
    equal = {}
    for t in PLANE_TENANTS:
        solo = _plane_solo(torch, cfg, init[t], wmap[t], seeds[t], good[t])
        equal[t] = _tree_equal(torch, states_now[t], solo)
        del solo
    st.shutdown()
    plane_launches = {k: v - warm.get(k, 0) for k, v in launches.items()}
    out = {
        "phase": "tenancy_plane",
        "config": "SlamConfig(), TenancyConfig(enabled, lane_health, "
                  "journal)", "robots_per_tenant": cfg.fleet.n_robots,
        "admissions": admissions,
        "tick_ms_by_bucket": {str(b): _p50_p90(v) | {"n": len(v)}
                              for b, v in sorted(tick_ms.items())},
        "bucket_after_suspend": bucket_suspended,
        "c_quarantined_at_plan_step": quarantined_at,
        "c_readmitted_at_plan_step": readmitted_at,
        "checkpoint_all_ms": t_ck[0] if t_ck else None,
        "restore_ms": t_rs[0] if t_rs else None,
        "restored": restored, "epochs_before": epochs_before,
        "epochs_after": epochs_after,
        "client": {"epoch_before": epoch_before, "epoch_after": client.epoch,
                   "n_epoch_resyncs": client.n_epoch_resyncs,
                   "mosaic_equal_live": mosaic_equal},
        "solo_ticks": good, "bit_equal_solo": equal,
        "host_syncs_per_tick": syncs.rows,
        "launches": plane_launches, "launches_warmup": warm,
        "peak_bytes": peak,
        "status_before_crash": {k: status_before[k] for k in (
            "n_active", "n_suspended", "n_evicted", "n_admitted",
            "n_suspended", "n_resumed", "n_quarantined", "n_prewarms",
            "bucket_capacity", "warmed_buckets")},
        "status_after_evict": {k: status_after[k] for k in (
            "n_active", "n_evicted", "n_admitted", "bucket_capacity")},
        "evict_checkpoint": os.path.basename(path)}
    emit(out)
    check(all(equal.values()), f"tenancy_plane: tenants off their solo "
          f"runs: {equal}")
    check(all(v == "active" for v in restored.values()),
          f"tenancy_plane: restore {restored}")
    check(all(epochs_after[t] > epochs_before[t] for t in PLANE_TENANTS),
          "tenancy_plane: an epoch did not advance across the crash")
    check(client.n_epoch_resyncs == 1 and mosaic_equal,
          "tenancy_plane: the /tiles?tenant=A client did not resync")
    sb = status_before
    check((sb["n_admitted"], sb["n_suspended"], sb["n_resumed"],
           sb["n_quarantined"], sb["n_active"], sb["bucket_capacity"])
          == (4, 1, 1, 1, 4, 6), f"tenancy_plane: /status {sb}")
    check((status_after["n_active"], status_after["n_evicted"],
           status_after["bucket_capacity"]) == (3, 1, 3),
          f"tenancy_plane: /status after evict {status_after}")
    check(bucket_suspended == 3, "tenancy_plane: no compaction on suspend")
    check(all(r["plane_own"] == 0 for r in syncs.rows),
          f"tenancy_plane: the plane added host syncs {syncs.rows}")
    for name in ("sensor_model_delta", "sensor_model_raster", "label_prop",
                 "costfield_relax"):
        check(plane_launches.get(name, 0) > 0,
              f"tenancy_plane: {name} never launched")
    return out


#: The LD06 wire path (phase_ld06_wire): 8 robots' rotations, then
#: mapper ticks of one rotation per robot, then two bursts of 16 (a
#: window of `fleet.batch_scans` scans: `_step_window`, K5).
LD06_ROBOTS = 8
LD06_SCHEDULE = (1,) * 12 + (16, 16)
LD06_STEP_M = 0.03                   # a robot's travel between rotations
LD06_DT_S = 0.1                      # between rotations' stamps


def _ld06_drive(torch, cfg, seed: int):
    """The rotations: poses (n, R, 3) on the card, each robot driving
    straight from a pose near a wall and turning 0.02 rad a rotation, and
    their raycast (n, R, beams) on the host."""
    from jax_mapping_torch.sim import lidar
    res = cfg.grid.resolution_m
    world = torch.as_tensor(_stack_world(res), device=DEV)
    gen = torch.Generator().manual_seed(seed + 17)
    start = _poses_near_walls(torch, cfg, world, LD06_ROBOTS, gen)
    n = sum(LD06_SCHEDULE) + 1
    k = torch.arange(n, dtype=torch.float32, device=DEV)[:, None]
    th0 = start[:, 2][None]
    poses = torch.stack([start[:, 0][None] + LD06_STEP_M * k * torch.cos(th0),
                         start[:, 1][None] + LD06_STEP_M * k * torch.sin(th0),
                         th0 + 0.02 * k], -1)
    n_samples = int(cfg.scan.range_max_m / (res * 0.5))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scans = lidar.simulate_scans(cfg.scan, world, res, n_samples,
                                 poses.reshape(-1, 3))
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    host = scans[:, :cfg.scan.n_beams].cpu().numpy().reshape(
        n, LD06_ROBOTS, -1)
    return poses.cpu().numpy(), host, ms


def _ld06_mapper(torch, cfg, start):
    """The port's `ros_launch` live stack (mapper, planner, TF) on the
    card, idle executor; every chain anchored at its row of `start`."""
    from jax_mapping_torch import ros_launch
    stack = ros_launch._launch_live_stack(cfg, n_robots=LD06_ROBOTS,
                                          device=DEV, realtime=False)
    p = torch.as_tensor(start, device=stack.mapper.device)
    m = stack.mapper
    for i, s in enumerate(m.states):
        m.states[i] = s._replace(pose=p[i])
    return stack


def phase_ld06_wire(torch, seed: int):
    """A real LD06's wire path: the port's `simulate_scans`
    on the card for 8 robots on the stack phase's world, each rotation
    through `encode_packets` into wire bytes, the port's C++ parser
    (scans/s through it alone), and one `Ld06IngestNode` a robot
    publishing onto the bus of the port's `ros_launch` live stack, whose
    mapper runs on the card; scripted odometry on the bus, stamps from a
    simulated clock. Mapper ticks take one rotation a robot, then two
    bursts of 16 (`_step_window`, K5). Counts are zeroed before the ticks
    and read after: K1 and K5 must launch. Checks: decoded ranges within
    0.01 m of the raycast on >= 90% of the beams the raycast hit (the JAX
    package's test_native check; a beam whose decoded angle rounds into
    its neighbour's bin takes the neighbour's range at a wall's edge);
    the card grid and poses bit-equal to a second live stack's mapper fed
    the decoded messages directly."""
    from types import SimpleNamespace
    import numpy as np
    from jax_mapping_torch.bridge import ld06_node as LN
    from jax_mapping_torch.bridge.brain import robot_ns
    from jax_mapping_torch.bridge.messages import (Header, Odometry,
                                                   Pose2D, Twist)
    from jax_mapping_torch.config import SlamConfig
    from jax_mapping_torch.native import Ld06Parser, encode_packets
    from jax_mapping_torch.ops import _cuda
    cfg = SlamConfig()
    R = LD06_ROBOTS
    poses, ranges, raycast_ms = _ld06_drive(torch, cfg, seed)
    n_rot = poses.shape[0]
    t0 = time.perf_counter()
    wires = [[encode_packets(ranges[j, i].astype(np.float64),
                             timestamp_ms=int(100 * j))
              for i in range(R)] for j in range(n_rot)]
    encode_ms = (time.perf_counter() - t0) * 1e3
    parser = Ld06Parser(n_beams=cfg.scan.n_beams)
    n_parsed = 0
    t0 = time.perf_counter()
    for j in range(n_rot):
        for i in range(R):
            parser.feed(wires[j][i])
            while parser.take_scan() is not None:
                n_parsed += 1
    parse_s = time.perf_counter() - t0
    stamps = [LD06_DT_S * (j + 1) for j in range(n_rot)]

    def odometry(bus, j):
        for i in range(R):
            x, y, th = (float(v) for v in poses[j, i])
            bus.publisher(f"{robot_ns(i, R)}odom").publish(Odometry(
                header=Header(stamp=stamps[j], frame_id="odom"),
                pose=Pose2D(x, y, th),
                twist=Twist(linear_x=0.0, angular_z=0.0)))

    stack = _ld06_mapper(torch, cfg, poses[0])
    clock = SimpleNamespace(t=0.0)
    real_time = LN.time
    LN.time = SimpleNamespace(monotonic=lambda: clock.t)
    pending = [[b""] for _ in range(R)]
    captured = []
    nodes = []
    for i in range(R):
        def transport(box=pending[i]):
            data, box[0] = box[0], b""
            return data
        ns = robot_ns(i, R)
        nodes.append(LN.Ld06IngestNode(cfg.scan, stack.bus, transport,
                                       topic=f"{ns}scan",
                                       frame_id=f"{ns}base_laser",
                                       realtime=False))
        stack.bus.subscribe(f"{ns}scan", callback=lambda m, i=i:
                            captured.append((i, m)))
    m = stack.mapper
    tick_ms, fed = [], [0]

    def feed_rotation():
        """Rotation j onto the wire; the parser completes rotation j - 1,
        published at its stamp after its odometry."""
        j = fed[0]
        if j > 0:
            clock.t = stamps[j - 1]
            odometry(stack.bus, j - 1)
        for i in range(R):
            pending[i][0] = wires[j][i]
            nodes[i].poll()
        fed[0] += 1

    try:
        feed_rotation()
        torch.cuda.synchronize()
        _cuda.reset_launches()
        for n in LD06_SCHEDULE:
            for _ in range(n):
                feed_rotation()
            t0 = time.perf_counter()
            m.tick()
            torch.cuda.synchronize()
            tick_ms.append((time.perf_counter() - t0) * 1e3)
        launches = dict(_cuda.LAUNCHES)
    finally:
        LN.time = real_time
    n_pub = sum(nd.n_scans_published for nd in nodes)
    # Decoded against the raycast: message k of robot i is rotation k.
    per_robot = {i: [msg for r, msg in captured if r == i] for i in range(R)}
    close, valid_rc, n_valid = 0, 0, 0
    for i in range(R):
        for j, msg in enumerate(per_robot[i]):
            want = ranges[j, i]
            got = np.asarray(msg.ranges)
            ok = got > 0
            n_valid += int(ok.sum())
            close += int((np.abs(got[ok] - want[ok]) <= 0.01).sum())
            valid_rc += int((want > 0).sum())
    # The twin: the same messages straight onto another live stack.
    twin = _ld06_mapper(torch, cfg, poses[0])
    k = 0
    for j, n in enumerate(LD06_SCHEDULE):
        for _ in range(n):
            odometry(twin.bus, k)
            for i in range(R):
                twin.bus.publisher(f"{robot_ns(i, R)}scan").publish(
                    per_robot[i][k])
            k += 1
        twin.mapper.tick()
    torch.cuda.synchronize()
    grid_equal = bool(torch.equal(m.merged_grid(), twin.mapper.merged_grid()))
    poses_equal = all(bool(torch.equal(a.pose, b.pose))
                      for a, b in zip(m.states, twin.mapper.states))
    occupied = int((m.merged_grid() > cfg.grid.occ_threshold).sum())
    stack.shutdown()
    twin.shutdown()
    out = {"phase": "ld06_wire", "robots": R, "rotations": n_rot,
           "schedule": list(LD06_SCHEDULE),
           "raycast_ms": raycast_ms, "encode_ms": encode_ms,
           "parser_scans_per_s": n_parsed / parse_s if parse_s else None,
           "parser_scans": n_parsed, "scans_published": n_pub,
           "mapper_tick_ms": _p50_p90(tick_ms), "tick_ms": tick_ms,
           "decoded_within_1cm_of_valid": close / max(valid_rc, 1),
           "decoded_nonzero_of_valid": n_valid / max(valid_rc, 1),
           "grid_equal_direct_feed": grid_equal,
           "poses_equal_direct_feed": poses_equal,
           "occupied_cells": occupied, "launches": launches}
    emit(out)
    check(n_pub == R * sum(LD06_SCHEDULE),
          f"ld06_wire: {n_pub} scans published")
    check(close >= 0.9 * valid_rc,
          f"ld06_wire: decoded ranges off the raycast ({close} of "
          f"{valid_rc} valid beams within 1 cm)")
    check(grid_equal and poses_equal,
          "ld06_wire: the wire-fed mapper differs from the direct feed")
    check(launches.get("sensor_model_delta", 0) > 0
          and launches.get("window_apply", 0) > 0,
          f"ld06_wire: K1/K5 did not launch {launches}")
    return out


#: The analysis phase's watched stack: tiny_config(2) on
#: rooms_with_doors(96, seed=1), this many steps, watched and unwatched.
ANALYSIS_STEPS = 30
#: Seconds the phase may take (its static pass, the two stacks and the
#: compile budget's subprocess).
ANALYSIS_LIMIT_S = 60.0


def _a1_spans(findings) -> dict:
    """path -> [(line, end_line)] of every A1 finding, found or baselined:
    the lines the checker says sync."""
    out: dict = {}
    for f in findings:
        if f.checker == "A1-host-sync":
            out.setdefault(f.path, []).append((f.line, f.end_line or f.line))
    return out


def _helper_spans(registry) -> dict:
    """path -> [(first, last line)] of the bodies of the sync helpers A1
    summarises: a call to one is a sync site at its caller."""
    out: dict = {}
    for key in registry.sync_helpers:
        mod, func, _cls = registry.by_symbol[key]
        out.setdefault(mod.path, []).append((func.lineno, func.end_lineno))
    return out


def sync_sites(spans: dict, helpers: dict) -> dict:
    """Every host sync of SYNC_LOG held against the A1 checker. A sync's
    site is its innermost frame under jax_mapping_torch/ (`path:line`),
    or its innermost frame outside torch and warnings when the stack has
    none. The sync is flagged when its site lies on a line A1 reports,
    or, where the site lies in a sync helper's body, when the frame that
    called the helper does (the one level of calls A1 models). A sync
    that only some outer package frame's A1 line covers is counted apart
    (`outer_only`): it is not flagged. Returns {site: {"n", "flagged",
    "outer_only", "stack"}}."""
    def rel(fn):
        return os.path.relpath(fn, HERE).replace(os.sep, "/")

    def on(spans_of, fn, ln):
        return any(a <= ln <= b for a, b in spans_of.get(rel(fn), ()))

    pkg = os.path.join(HERE, "jax_mapping_torch") + os.sep
    sites: dict = {}
    for rec in SYNC_LOG:
        idx = [i for i, (fn, _ln) in enumerate(rec.stack)
               if fn.startswith(pkg)]
        flagged = outer = False
        if idx:
            fn, ln = rec.stack[idx[-1]]
            key = "%s:%d" % (rel(fn), ln)
            flagged = on(spans, fn, ln) or (
                idx[-1] > 0 and on(helpers, fn, ln)
                and on(spans, *rec.stack[idx[-1] - 1]))
            outer = not flagged and any(on(spans, *rec.stack[i])
                                        for i in idx[:-1])
        else:
            outside = [(fn, ln) for fn, ln in rec.stack
                       if "/torch/" not in fn
                       and not fn.endswith("warnings.py")]
            key = "%s:%d" % (rel(outside[-1][0]), outside[-1][1]) \
                if outside else "?"
        s = sites.setdefault(key, {
            "n": 0, "flagged": 0, "outer_only": 0,
            "stack": ["%s:%d" % (rel(rec.stack[i][0]), rec.stack[i][1])
                      for i in idx]})
        s["n"] += 1
        s["flagged"] += flagged
        s["outer_only"] += outer
    return sites


def _sync_hook_cost(torch, depth: int, n: int = 200,
                    rounds: int = 3) -> dict:
    """Microseconds per sync of a loop of `n` `.item()` calls at a stack
    `depth` frames deep, in a SyncWindow and in a plain
    `warnings.catch_warnings(record=True)` window under the same sync
    debug mode, alternating for `rounds` rounds (medians): what the
    stack capture adds to a time taken inside a window. The loop's syncs
    are taken back out of SYNC_LOG."""
    import traceback
    import warnings
    x = torch.ones((), device=DEV)

    def here():
        return len(list(traceback.walk_stack(sys._getframe(1))))

    def loop():
        t = time.perf_counter()
        for _ in range(n):
            x.item()
        return time.perf_counter() - t

    def at(k, fn):
        return fn() if k <= 0 else at(k - 1, fn)

    def plain():
        with warnings.catch_warnings(record=True):
            warnings.simplefilter("always")
            mode = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("warn")
            try:
                return at(depth - here(), loop)
            finally:
                torch.cuda.set_sync_debug_mode(mode)

    def hooked():
        n0 = len(SYNC_LOG)
        with SyncWindow(torch):
            dt = at(depth - here(), loop)
        del SYNC_LOG[n0:]
        return dt

    times = {"plain": [], "window": []}
    for _ in range(rounds):
        times["plain"].append(plain())
        times["window"].append(hooked())
    return {k: statistics.median(v) / n * 1e6 for k, v in times.items()}


def _analysis_stack(torch, seed: int, watched: bool) -> dict:
    """tiny_config(2) on the card with its HTTP API, a /tiles client and a
    /status poller on threads of their own, ANALYSIS_STEPS steps with
    simulated-clock stamps; when `watched`, under LockWatch (the bus, the
    brain's and the mapper's state locks, each node's callback lock) and
    RaceWatch (the protection map's groups of the mapper, the grid tile
    store and the event channel). Returns the brain's poses, and the
    watches' edges and reports."""
    import threading
    import urllib.request
    import numpy as np
    from jax_mapping_torch.analysis.lockwatch import LockWatch
    from jax_mapping_torch.analysis.protection import groups_by_class
    from jax_mapping_torch.analysis.racewatch import RaceWatch
    from jax_mapping_torch.bridge.launch import launch_sim_stack
    from jax_mapping_torch.config import tiny_config
    from jax_mapping_torch.serving.client import DeltaMapClient
    from jax_mapping_torch.sim import world as W
    cfg = tiny_config(2)
    world, _doors = W.rooms_with_doors(96, cfg.grid.resolution_m, seed=1)
    st = launch_sim_stack(cfg, world, n_robots=2, seed=seed, device=DEV,
                          http_port=0)
    saved = _sim_clock(st, cfg)
    lw, rw = LockWatch(), RaceWatch()
    stop, errors, polls = threading.Event(), [], [0, 0]
    base = f"http://127.0.0.1:{st.api.port}"

    def tiles():
        client = DeltaMapClient(base)
        while not stop.is_set():
            try:
                client.poll()
                polls[0] += 1
            except Exception as e:                    # noqa: BLE001
                errors.append(f"/tiles: {e}")
            stop.wait(0.05)

    def status():
        while not stop.is_set():
            try:
                urllib.request.urlopen(f"{base}/status", timeout=10).read()
                polls[1] += 1
            except Exception as e:                    # noqa: BLE001
                errors.append(f"/status: {e}")
            stop.wait(0.05)

    threads = [threading.Thread(target=tiles), threading.Thread(
        target=status)]
    try:
        if watched:
            lw.watch(st.bus, "_lock")
            lw.watch(st.brain, "_state_lock")
            lw.watch(st.mapper, "_state_lock")
            for node in (st.sim, st.brain, st.mapper):
                lw.watch(node, "_cb_lock", name=f"Node._cb_lock@{node.name}")
            by = groups_by_class()
            rw.watch_object(st.mapper, by["MapperNode"][0], name="mapper")
            rw.watch_object(st.api.serving.map_store, by["TileStore"][0],
                            name="grid-store")
            rw.watch_object(st.api.serving.events, by["EventChannel"][0],
                            name="events")
        for t in threads:
            t.start()
        st.brain.start_exploring()
        st.run_steps(ANALYSIS_STEPS)
        st.mapper.publish_map()
        torch.cuda.synchronize()
    finally:
        stop.set()
        for t in threads:
            t.join(timeout=30)
        rw.unwatch_all()
        lw.unwatch_all()
        for m, t in saved:
            m.time = t
        poses = np.array(st.brain.poses)
        st.shutdown()
    check(not errors, f"analysis: HTTP clients failed: {errors[:3]}")
    return {"poses": poses, "edges": lw.edges(), "cycle": lw.cycle(),
            "reports": [r.message for r in rw.reports()],
            "fields": {k: v.state for k, v in rw.field_states().items()},
            "polls": polls}


def phase_analysis(torch, seed: int) -> dict:
    """The port's analysis tier on the card: the static pass over the
    package with its baseline (exit 0), every host sync the earlier
    phases' sync windows recorded held against A1, LockWatch and
    RaceWatch over a short stack against an unwatched one, and the
    compile budget's check in a fresh process."""
    import numpy as np
    from jax_mapping_torch.analysis import core as AC
    from jax_mapping_torch.analysis.lock_discipline import (
        LockGraph, build_lock_graph)
    t0 = time.perf_counter()
    mods = AC.load_package_modules()
    checkers = AC.all_checkers()
    res = AC.analyze_modules(mods, AC.Baseline.load(
        AC.default_baseline_path()), checkers)
    t_static = time.perf_counter() - t0
    by_checker = collections.Counter(f.checker for f in res.all_findings)
    # The A checkers share one registry: the first one's is A1's.
    sites = sync_sites(_a1_spans(res.all_findings),
                       _helper_spans(checkers[0].registry(mods)))
    unflagged = sorted(k for k, v in sites.items() if v["flagged"] < v["n"])
    outer_only = sorted(k for k, v in sites.items() if v["outer_only"])
    n_records = len(SYNC_LOG)
    depth = int(statistics.median(len(r.stack) for r in SYNC_LOG)) \
        if SYNC_LOG else 0
    hook_us = _sync_hook_cost(torch, depth)
    out_dir = os.path.join(HERE, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "analysis_syncs.json"), "w") as f:
        json.dump(sites, f, indent=0, sort_keys=True)

    plain = _analysis_stack(torch, seed, watched=False)
    watched = _analysis_stack(torch, seed, watched=True)
    static = build_lock_graph(mods).edge_set()
    observed = watched["edges"]
    reversed_ = sorted(f"{a} -> {b}" for a, b in observed
                       if (b, a) in static)
    union_cycles = LockGraph(edges={e: None for e in static | observed}
                             ).sccs()

    t1 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        out_json = os.path.join(tmp, "budget.json")
        r = subprocess.run(
            [sys.executable, "-m", "jax_mapping_torch.analysis.compilebudget",
             "--check", "--device", "cuda", "-o", out_json],
            capture_output=True, text=True, cwd=HERE, timeout=300)
        budget = json.load(open(out_json)) if os.path.exists(out_json) \
            else {}
    t_budget = time.perf_counter() - t1
    measured = budget.get("measured", {})
    seconds = time.perf_counter() - t0
    emit({"phase": "analysis", "files": res.n_files,
          "findings_by_checker": dict(sorted(by_checker.items())),
          "new_findings": len(res.findings),
          "baselined": len(res.baselined),
          "unused_suppressions": len(res.unused_suppressions),
          "static_s": round(t_static, 2),
          "sync_records": n_records,
          "sync_sites": len(sites),
          "sync_sites_flagged": len(sites) - len(unflagged),
          "unflagged_sites": unflagged,
          "outer_frame_only_sites": outer_only,
          "sync_stack_depth_median": depth,
          "sync_us_window": hook_us["window"],
          "sync_us_plain_window": hook_us["plain"],
          "lock_edges_static": len(static),
          "lock_edges_observed": sorted(f"{a} -> {b}" for a, b in observed),
          "lock_edges_reversed": reversed_,
          "lock_cycle": watched["cycle"],
          "lock_union_cycles": union_cycles,
          "races": watched["reports"],
          "race_fields": len(watched["fields"]),
          "http_polls": watched["polls"],
          "poses_equal_unwatched": bool(np.array_equal(
              plain["poses"], watched["poses"])),
          "compile_budget_rc": r.returncode,
          "compile_budget_violations": budget.get("violations"),
          "compile_budget_over_1": {k: v for k, v in sorted(
              measured.items()) if v > 1},
          "compile_budget_entry_points": len(measured),
          "compile_budget_s": round(t_budget, 1),
          "seconds": round(seconds, 1)})
    check(not res.findings, "analysis: the static pass has new findings: "
          + "; ".join(f.format().splitlines()[0] for f in res.findings[:5]))
    check(not unflagged, f"analysis: {len(unflagged)} host-sync site(s) "
          f"A1 does not report: {unflagged[:10]}")
    check(SYNC_LOG, "analysis: no sync window recorded a sync")
    check(observed and not reversed_ and watched["cycle"] is None
          and not union_cycles,
          "analysis: the observed lock order contradicts the static graph")
    check(not watched["reports"], f"analysis: races {watched['reports']}")
    check(watched["fields"], "analysis: RaceWatch saw no field")
    check(min(watched["polls"]) > 0, "analysis: a client never polled")
    check(np.array_equal(plain["poses"], watched["poses"]),
          "analysis: the watched stack's poses differ from the unwatched")
    check(r.returncode == 0, f"analysis: compilebudget --check exit "
          f"{r.returncode}: {r.stdout[-1500:]} {r.stderr[-1500:]}")
    check(seconds <= ANALYSIS_LIMIT_S,
          f"analysis: {seconds:.1f} s over its {ANALYSIS_LIMIT_S} s")
    return {"sites": len(sites), "unflagged": unflagged}


def phase_ab(parent: str, seed: int) -> dict:
    """K1-K7, exact_bfs' frontier costs and 30 steps of the mission stack
    of the tree `parent` and of this one, timed in turns (parent, change,
    change, parent) on this card, each run in a process of its own that
    imports that tree's package."""
    runs = []
    for label, tree in (("parent", parent), ("change", HERE),
                        ("change", HERE), ("parent", parent)):
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--kernel-times",
             os.path.abspath(tree), "--seed", str(seed)],
            capture_output=True, text=True, timeout=600)
        if out.returncode != 0:
            raise Failed(f"kernel times of {tree} failed: "
                         f"{out.stderr[-2000:]}")
        runs.append(dict(json.loads(out.stdout.strip().splitlines()[-1]),
                         label=label))
    summary = {}
    for row in runs[0]["ms"]:
        by = {lab: [r["ms"][row] for r in runs if r["label"] == lab]
              for lab in ("parent", "change")}
        summary[row] = {f"{lab}_ms": statistics.median(v)
                        for lab, v in by.items()}
        for lab in ("parent", "change"):
            d = [r["device_ms"][row] for r in runs if r["label"] == lab]
            summary[row][f"{lab}_device_ms"] = (
                None if None in d else statistics.median(d))
        summary[row]["runs_ms"] = [r["ms"][row] for r in runs]
        summary[row]["runs_device_ms"] = [r["device_ms"][row] for r in runs]
        summary[row]["speedup"] = (summary[row]["parent_ms"]
                                   / summary[row]["change_ms"])
    out = {"phase": "ab", "order": [r["label"] for r in runs],
           "packages": [r["package"] for r in runs], "rows": summary,
           "sass_instructions": {r["label"]: r["sass_instructions"]
                                 for r in runs}}
    emit(out)
    return out


KERNEL_ROWS = (
    ("sensor_model_delta", "jax_mapping_torch/csrc/sensor_model.cu",
     "jax_mapping/ops/sensor_kernel.py:376"),
    ("sensor_model_raster", "jax_mapping_torch/csrc/sensor_model.cu",
     "jax_mapping/ops/sensor_kernel.py:376"),
    ("label_prop", "jax_mapping_torch/csrc/label_prop.cu",
     "jax_mapping/ops/frontier.py:198"),
    ("costfield_relax", "jax_mapping_torch/csrc/costfield_relax.cu",
     "jax_mapping/ops/costfield.py:115"),
    ("window_delta", "jax_mapping_torch/csrc/window_fuse.cu",
     "jax_mapping/ops/sensor_kernel.py:309"),
    ("window_apply", "jax_mapping_torch/csrc/window_fuse.cu",
     "jax_mapping/ops/fuse_kernel.py:222"),
    ("voxel_image", "jax_mapping_torch/csrc/voxel_model.cu",
     "jax_mapping/ops/voxel_kernel.py:274"),
    ("voxel_summed", "jax_mapping_torch/csrc/voxel_model.cu",
     "jax_mapping/ops/voxel_kernel.py:331"),
    ("match_correlate", "jax_mapping_torch/csrc/match_correlate.cu",
     "jax_mapping/ops/scan_match.py:211"),
)

#: The kernel-check row each kernel's line reports: K4/K5 at the mapper's
#: window of W - 1 = 15 scans, K6 at one voxel tick's 8 images, K7 at the
#: bench's 32-image window, K8 summed over the fleet's `match_batch`.
_LINE_ROW = {"window_delta": "window_delta_b15",
             "window_apply": "window_apply_b15",
             "voxel_image": "voxel_image_b8",
             "voxel_summed": "voxel_summed_window_b32",
             "match_correlate": "match_correlate_b8"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ticks", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ab", metavar="PARENT_TREE",
                    help="only time K1-K7 of PARENT_TREE (an "
                    "unpacked checkout) against this tree, in turns")
    ap.add_argument("--kernel-times", metavar="TREE",
                    help=argparse.SUPPRESS)    # one turn of --ab
    ap.add_argument("--coldstart-child", nargs=3,
                    metavar=("CFG", "CKPT_DIR", "OUT_NPY"),
                    help=argparse.SUPPRESS)    # one coldstart_resume process
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(HERE, "jax_mapping_torch", "csrc")):
        print("chip_smoke: jax_mapping_torch/ is not beside this script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, args.kernel_times or HERE)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if args.kernel_times:
        emit(kernel_times(torch, args.seed))
        return 0
    bind_ledger()
    if args.coldstart_child:
        return coldstart_child(torch, *args.coldstart_child, args.seed)
    if args.ab:
        try:
            phase_device(torch)
            phase_ab(args.ab, args.seed)
        except Failed as e:
            print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
            return 1
        return 0

    from jax_mapping_torch.config import SlamConfig
    t_start = time.perf_counter()
    try:
        phase_device(torch)
        phase_build()
        cfg = SlamConfig()
        world = _world(cfg, torch.device("cuda"), torch)
        st, fleet = phase_fleet(torch, cfg, world, args.ticks, args.seed)
        phase_stages(torch, cfg, st, world)
        phase_profile(torch, cfg, st, world, args.seed)
        mapped = phase_refuse(torch, cfg, world, args.seed)
        publisher = _Publisher(torch, cfg)
        mapper = phase_mapper(torch, cfg, args.seed, on_tick=publisher.tick)
        phase_publish(torch, cfg, publisher, mapped)
        _plan, planned = phase_planner(torch, cfg, publisher.grid,
                                       publisher.poses, publisher.last)
        _modes, exact_rec = phase_fleet_modes(torch, cfg, publisher.grid,
                                              args.seed)
        new_paths = {
            "recovery": phase_recovery(torch, cfg, args.seed)[0],
            "rendezvous": phase_rendezvous(torch, cfg, args.seed)[0],
            "fuse_paths": phase_fuse_paths(torch, cfg, publisher.grid,
                                           args.seed)[0]}
        new_paths["tenancy"], tenancy, tenancy_out, option_recs = \
            phase_tenancy(torch, cfg, args.seed)
        new_paths["stack"], stack_out, stack_rec = phase_stack(
            torch, args.seed)
        new_paths["stack_depth"], depth_out, depth_rec, depth_k6 = \
            phase_stack_depth(torch, args.seed)
        new_paths["serving"], serving_out, serving_rec = phase_serving(
            torch, args.seed, depth_out["steps_per_s"])
        new_paths["scenario"], scenario_out, scenario_rec = \
            phase_scenario(torch, args.seed)
        new_paths["world"], world_out, world_rec, world_k1 = phase_world(
            torch, args.seed)
        world_par, world_k1_global = phase_world_parity(torch, args.seed)
        phase_lifelong_world(torch, args.seed)
        new_paths["world_parity"] = {
            "per": "two store walks",
            "k1_launches_by_batch": world_par["k1_launches_by_batch"]}
        phase_window(torch, cfg)
        vstate = phase_voxel(torch, cfg)
        bench = phase_voxel_bench(torch, cfg)
        phase_voxel_region(torch, cfg, vstate)
        rows = phase_kernels(torch, cfg, world, mapped, args.seed, fleet,
                             mapper, (vstate, bench, vstate["out"]),
                             (publisher.grid, publisher, planned), new_paths,
                             tenancy, stack_rec,
                             (world_rec, list(world_k1.items())
                              + list(world_k1_global.items())),
                             {"recs": {"exact_bfs": exact_rec,
                                       "tenant_exact_bfs":
                                           option_recs["exact_bfs"],
                                       "stack_depth": depth_rec,
                                       "serving": serving_rec,
                                       "scenario": scenario_rec},
                              "k6": depth_k6,
                              "k6_launches_per_step":
                                  depth_out["launches"]["voxel_image"]
                                  / STACK_STEPS})
        voxel_launches = vstate["out"]["launches"]
        voxel_summed_launches = bench["launches"]["voxel_summed"]
        del mapped, world, st, vstate, bench, publisher, planned, tenancy
        del stack_rec, world_rec, world_k1, world_k1_global
        del exact_rec, option_recs, depth_rec, depth_k6, serving_rec
        del scenario_rec
        phase_parity(torch, args.seed)
        phase_slam_parity(torch, args.seed)
        phase_voxel_parity(torch, args.seed)
        phase_stack_parity(torch, args.seed)
        phase_scenario_parity(torch, args.seed)
        sharded, sharded_launches = phase_sharded(torch, SlamConfig(),
                                                  fleet, args.seed)
        sharded_kernel_rows(torch, SlamConfig(), args.seed, fleet, mapper,
                            sharded["k1_launches_by_batch"], rows)
        phase_sharded_parity(torch, args.seed)
        phase_dryrun(torch)
        phase_sharded_ranks(torch, args.seed)
        phase_replay(torch, args.seed)
        coldstart_out, cs = phase_coldstart(torch, args.seed, stack_out)
        phase_coldstart_resume(torch, args.seed, cs)
        plane_out = phase_tenancy_plane(torch, args.seed)
        ld06_out = phase_ld06_wire(torch, args.seed)
        phase_analysis(torch, args.seed)
        # The mission stack's modules the phases above did not import.
        import jax_mapping_torch.demo  # noqa: F401
        import jax_mapping_torch.resilience  # noqa: F401
        import jax_mapping_torch.obs  # noqa: F401
        check("jax" not in sys.modules and "jax_mapping" not in sys.modules,
              "JAX was imported")
    except Failed as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1

    # Launches come from each kernel's main-path run: the fleet ticks for
    # K1-K3 and K8, the mapper ticks for K5, the fused_fusion=False windows for K4,
    # the voxel ticks for K6, the bench's voxel window for K7.
    launches = {**fleet["launches"],
                "window_apply": mapper["launches"]["window_apply"],
                "window_delta": mapper[
                    "launches_fused_fusion_false_3_windows"]["window_delta"],
                "voxel_image": voxel_launches["voxel_image"],
                "voxel_summed": voxel_summed_launches}
    kernels = []
    for name, src, replaces in KERNEL_ROWS:
        r = rows[_LINE_ROW.get(name, name)]
        kernels.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"],
            # No single PyTorch call computes any of these functions.
            "library_ms": None})
        if name in FLEET_KERNELS + ("match_correlate",):
            kernels[-1]["launches_tenancy"] = sum(
                run["launches"][name]
                for run in tenancy_out["runs"].values())
        kernels[-1]["launches_stack"] = stack_out["launches"][name]
        kernels[-1]["launches_stack_burst"] = \
            stack_out["burst"]["launches"][name]
        kernels[-1]["launches_world"] = world_out["launches"][name]
        kernels[-1]["launches_stack_depth"] = depth_out["launches"][name]
        kernels[-1]["launches_sharded"] = sharded_launches[name]
        kernels[-1]["launches_serving"] = serving_out["launches"][name]
        kernels[-1]["launches_scenario"] = scenario_out["launches"][name]
        kernels[-1]["launches_coldstart"] = \
            coldstart_out["launches_mission"][name]
        kernels[-1]["launches_warmup"] = \
            coldstart_out["launches_warmup"].get(name, 0)
        kernels[-1]["launches_tenancy_plane"] = \
            plane_out["launches"].get(name, 0)
        kernels[-1]["launches_tenancy_plane_warmup"] = \
            plane_out["launches_warmup"].get(name, 0)
        kernels[-1]["launches_ld06"] = ld06_out["launches"].get(name, 0)
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    emit({"seconds": time.perf_counter() - t_start})
    emit({"kernels": kernels})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
