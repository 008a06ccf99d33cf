"""Serving load generator: N concurrent synthetic clients against a
live `launch_sim_stack`.

Port of the JAX package's `serving/loadgen.py` on the port's stack (on
the CUDA card unless the caller passes `device="cpu"`). It is a module
and a CPU test here, not a benchmark: nothing in the port writes its
record to a benchmark file.

The question this answers with numbers: what does one polling map
client COST, whole-PNG versus tiled-delta? The baseline mode is the
reference's management plane exactly — `GET /map-image` every poll
period, full body every time (the pre-serving contract: no conditional
GET, the 1 s PNG cache saves encode work but never bytes). The delta
mode is the serving subsystem's protocol — one initial `/tiles`
snapshot, then `?since=<revision>` polls that carry only changed tiles.
An extra SSE listener rides along to exercise the `/map-events` push
channel under the same load.

Reported per mode: bytes/client/sec (steady-state: the delta clients'
initial snapshot is amortized out and reported separately), request
latency p50/p99, and the server-side PNG-cache hit-rate.

Smoke mode (`tests/test_torch_serving.py::test_loadgen_smoke`) runs the
same harness on the tiny config for a few seconds.
"""

from __future__ import annotations

import json
import threading
import time
import urllib.request
from typing import List, Optional

import numpy as np


class ClientStats:
    """One synthetic client's accounting (single-thread writer).

    Request latencies land BOTH in the raw list (exact percentiles at
    bench scale) and in the registry's fixed log-bucket histogram
    machinery (`obs/pipeline.FixedHistogram`, the HIST_EDGES_S grid
    every histogram in the repo shares) — the suite JSON reports the
    bucket counts so two runs compare bucket-for-bucket, the ROADMAP
    serving-scale-out contract ("per-percentile latency histograms")."""

    def __init__(self, mode: str):
        from jax_mapping_torch.obs.pipeline import FixedHistogram
        self.mode = mode
        self.bytes_total = 0
        self.snapshot_bytes = 0
        self.latencies_s: List[float] = []
        self.latency_hist = FixedHistogram()
        #: Client-observed revision ages (ms) from the Server-Timing
        #: freshness headers (delta clients only).
        self.revision_ages_ms: List[float] = []
        self.n_polls = 0
        self.n_tiles = 0
        self.errors: List[str] = []

    def observe_latency(self, dt_s: float) -> None:
        self.latencies_s.append(dt_s)
        self.latency_hist.observe(dt_s)


def _percentile(xs: List[float], p: float) -> Optional[float]:
    if not xs:
        return None
    return float(np.percentile(np.asarray(xs), p))


def _png_poller(base: str, stop: threading.Event, poll_s: float,
                stats: ClientStats) -> None:
    """The reference's polling client: full PNG body every period."""
    while not stop.is_set():
        t0 = time.monotonic()
        try:
            with urllib.request.urlopen(base + "/map-image",
                                        timeout=10) as r:
                body = r.read()
            stats.bytes_total += len(body)
            stats.observe_latency(time.monotonic() - t0)
            stats.n_polls += 1
        except Exception as e:     # noqa: BLE001 — survey, don't crash
            stats.errors.append(f"{type(e).__name__}: {e}")
        stop.wait(poll_s)


def _delta_poller(base: str, stop: threading.Event, poll_s: float,
                  stats: ClientStats) -> None:
    """The serving client: snapshot once, then revision deltas."""
    from jax_mapping_torch.serving.client import DeltaMapClient
    client = DeltaMapClient(base)
    while not stop.is_set():
        t0 = time.monotonic()
        try:
            # Full-res consumer: level 0 only (the overview pyramid is
            # for zoomed-out dashboards, which would poll a coarse
            # level INSTEAD — mixed-level polling pays for both).
            body = client.poll(level=0)
            stats.observe_latency(time.monotonic() - t0)
            stats.n_polls += 1
            stats.n_tiles += len(body["tiles"])
        except Exception as e:     # noqa: BLE001
            stats.errors.append(f"{type(e).__name__}: {e}")
        stop.wait(poll_s)
    stats.bytes_total = client.bytes_received
    stats.snapshot_bytes = client.snapshot_bytes
    stats.revision_ages_ms = list(client.revision_ages_ms)


def _sse_listener(base: str, stop: threading.Event,
                  stats: ClientStats) -> None:
    """One push-channel client: reconnecting SSE reads until stopped."""
    while not stop.is_set():
        try:
            req = urllib.request.Request(
                base + "/map-events?timeout_s=2")
            with urllib.request.urlopen(req, timeout=10) as r:
                for line in r:
                    stats.bytes_total += len(line)
                    if line.startswith(b"data:"):
                        stats.n_polls += 1
                    if stop.is_set():
                        break
        except Exception as e:     # noqa: BLE001
            stats.errors.append(f"{type(e).__name__}: {e}")
            stop.wait(0.2)


def serving_bench_config():
    """The benchmark's default stack: a mid-size 512^2 grid (CPU-fast,
    but with enough explored area that a whole-map PNG costs real
    bytes) over the tiny config's scan/matcher shapes, 8x8 serving
    tiles. The tiny 256^2 test config compresses to a few hundred
    bytes of PNG — at that size whole-map polling is artificially
    cheap and the comparison says nothing about the 4096^2 target."""
    import dataclasses
    from jax_mapping_torch.config import GridConfig, ServingConfig, tiny_config

    cfg = tiny_config()
    return dataclasses.replace(
        cfg,
        grid=GridConfig(size_cells=512, patch_cells=128, max_range_m=3.0,
                        align_rows=8, align_cols=8),
        serving=ServingConfig(tile_cells=64, pyramid_levels=3,
                              event_wait_max_s=5.0))


def run_serving_benchmark(cfg=None, *, n_clients: int = 8,
                          duration_s: float = 8.0,
                          poll_period_s: float = 0.1,
                          steps_per_burst: int = 5,
                          publish_every_bursts: int = 3,
                          warmup_steps: int = 150,
                          world_cells: int = 440,
                          n_planks: int = 18,
                          n_robots: int = 2, seed: int = 3,
                          out_path: Optional[str] = None,
                          device=None) -> dict:
    """Boot a sim stack, drive it, hammer it with concurrent clients.

    Returns (and with `out_path` writes) the run's record. The stack
    steps in bursts on a driver thread — faster than real time, like
    the deterministic tests — publishing `/map` every few bursts so the
    whole-PNG route's stamp advances the way a live deployment's would.
    `warmup_steps` run BEFORE any client connects: the first steps pay
    the kernel builds, which are a boot cost, not a serving cost.
    """
    from jax_mapping_torch.bridge.launch import launch_sim_stack
    from jax_mapping_torch.sim import world as W

    if cfg is None:
        cfg = serving_bench_config()
    world = W.plank_course(world_cells, cfg.grid.resolution_m,
                           n_planks=n_planks, seed=seed)
    stack = launch_sim_stack(cfg, world, n_robots=n_robots, http_port=0,
                             realtime=False, seed=seed, device=device)
    # Steady-state serving scenario: a MATURE map being incrementally
    # updated, not a blank boot. Seed the known walls as a map prior
    # (the localization-bootstrap path) so the whole-PNG baseline
    # carries the real map's content from the first poll — a Thymio
    # covers ~3 mm per tick, so a blank-boot bench would compare
    # serving costs on a nearly-empty map no deployment would run.
    # Exploration still changes the map every tick (free-space carving
    # around each robot) — exactly the delta traffic under test.
    n = cfg.grid.size_cells
    off = (n - world.shape[0]) // 2
    prior = np.zeros((n, n), np.float32)
    prior[off:off + world.shape[0], off:off + world.shape[1]] = \
        np.where(np.asarray(world) > 0.5, 2.0, 0.0)
    stack.mapper.seed_map_prior(prior)
    base = f"http://127.0.0.1:{stack.api.port}"
    stop = threading.Event()
    steps_run = [0]

    # Warm up OUTSIDE the measured window: build the kernels and give
    # the map real content before the first client byte (boot cost, not
    # serving cost).
    stack.brain.start_exploring()
    stack.run_steps(warmup_steps)
    stack.mapper.publish_map()
    if stack.api.serving is not None:
        stack.api.serving.map_store.refresh()

    def _drive():
        bursts = 0
        while not stop.is_set():
            stack.run_steps(steps_per_burst)
            steps_run[0] += steps_per_burst
            bursts += 1
            if bursts % publish_every_bursts == 0:
                stack.mapper.publish_map()
            # Pace the sim so client polls interleave with map growth
            # instead of racing a CPU-bound step loop for the GIL.
            stop.wait(0.05)

    driver = threading.Thread(target=_drive, name="loadgen-driver")
    driver.start()

    n_png = max(1, n_clients // 2)
    n_delta = max(1, n_clients - n_png)
    png_stats = [ClientStats("png") for _ in range(n_png)]
    delta_stats = [ClientStats("delta") for _ in range(n_delta)]
    sse_stats = ClientStats("sse")
    threads = [threading.Thread(target=_png_poller,
                                args=(base, stop, poll_period_s, s))
               for s in png_stats]
    threads += [threading.Thread(target=_delta_poller,
                                 args=(base, stop, poll_period_s, s))
                for s in delta_stats]
    threads += [threading.Thread(target=_sse_listener,
                                 args=(base, stop, sse_stats))]
    t0 = time.monotonic()
    for t in threads:
        t.start()
    time.sleep(duration_s)
    stop.set()
    for t in threads:
        t.join(timeout=15.0)
    driver.join(timeout=15.0)
    elapsed = time.monotonic() - t0

    api = stack.api
    map_image_requests = api.route_requests.get("/map-image", 0)
    png_hits = api.png_cache_hits.get("map", 0)
    serving_stats = api.serving.stats() if api.serving is not None else {}
    stack.shutdown()

    def _mode_summary(stats_list: List[ClientStats]) -> dict:
        from jax_mapping_torch.obs.pipeline import FixedHistogram
        lats = [x for s in stats_list for x in s.latencies_s]
        ages = [x for s in stats_list for x in s.revision_ages_ms]
        total = sum(s.bytes_total for s in stats_list)
        snap = sum(s.snapshot_bytes for s in stats_list)
        n = len(stats_list)
        # Mode-aggregate fixed log-bucket histogram (per-client hists
        # fold bucketwise — same HIST_EDGES_S grid everywhere).
        agg = FixedHistogram()
        for s in stats_list:
            for k, c in enumerate(s.latency_hist.buckets):
                agg.buckets[k] += c
            agg.total_s += s.latency_hist.total_s
            agg.count += s.latency_hist.count
        out = {
            "n_clients": n,
            "polls": sum(s.n_polls for s in stats_list),
            "bytes_total": total,
            "snapshot_bytes": snap,
            "bytes_per_client_per_sec": round(total / n / elapsed, 1),
            "steady_bytes_per_client_per_sec": round(
                (total - snap) / n / elapsed, 1),
            "latency_p50_ms": (None if not lats else round(
                _percentile(lats, 50) * 1e3, 2)),
            "latency_p90_ms": (None if not lats else round(
                _percentile(lats, 90) * 1e3, 2)),
            "latency_p99_ms": (None if not lats else round(
                _percentile(lats, 99) * 1e3, 2)),
            "latency_histogram": {
                "edges_s": list(agg.summary()["edges_s"]),
                "buckets": agg.summary()["buckets"],
                "count": agg.count,
                "sum_s": round(agg.total_s, 6),
                "hist_p50_ms": agg.percentile_ms(50),
                "hist_p90_ms": agg.percentile_ms(90),
                "hist_p99_ms": agg.percentile_ms(99),
            },
            "errors": sorted({e for s in stats_list for e in s.errors}),
        }
        if ages:
            # Client-observed staleness (Server-Timing freshness
            # headers, delta mode): bytes say what serving costs, this
            # says how fresh the map the client holds actually is.
            out["revision_age_ms"] = {
                "n": len(ages),
                "p50": round(_percentile(ages, 50), 2),
                "p90": round(_percentile(ages, 90), 2),
                "p99": round(_percentile(ages, 99), 2),
                "max": round(max(ages), 2),
            }
        return out

    png = _mode_summary(png_stats)
    delta = _mode_summary(delta_stats)
    steady_delta = delta["steady_bytes_per_client_per_sec"]
    reduction = (None if not steady_delta else round(
        png["bytes_per_client_per_sec"] / steady_delta, 1))
    result = {
        "metric": "map_serving_bytes_per_client",
        "suite": "serving",
        "duration_s": round(elapsed, 2),
        "sim_steps": steps_run[0],
        "poll_period_s": poll_period_s,
        "grid_cells": cfg.grid.size_cells,
        "tile_cells": cfg.serving.tile_cells,
        "whole_png_polling": png,
        "tiled_delta": delta,
        "sse_push": {
            "events_received": sse_stats.n_polls,
            "bytes_total": sse_stats.bytes_total,
            "errors": sorted(set(sse_stats.errors)),
        },
        "bytes_reduction_factor": reduction,
        "png_cache_hit_rate": (None if not map_image_requests else round(
            png_hits / map_image_requests, 3)),
        "serving": serving_stats,
    }
    if out_path:
        with open(out_path, "w") as f:
            json.dump(result, f, indent=2, sort_keys=True)
    return result
