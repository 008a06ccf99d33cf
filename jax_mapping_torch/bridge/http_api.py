"""HTTP control/observability API (stdlib http.server; no Flask dependency).

Port of the JAX package's `bridge/http_api.py`, with the same routes,
JSON bodies, headers, ETags and Prometheus family names: the wire format
is the contract, so either package's `DeltaMapClient` and the same
dashboards read either package's server. The handlers' device work (the
tile store's gray image, pyramid and tile hashes, the `/save-map`
threshold) runs on the stack's device; PNG encoding is host zlib.

With the obs tier armed (a `Tracer` on the bus, the `pipeline` ledger
and the `slo` engine, all set by launch when `cfg.obs.enabled`): every
handler but `/trace` runs inside an `http:<route>` span, `GET /trace`
serves the span ring as Chrome-trace events, `/status` carries
`pipeline` and `slo`, serving responses carry the `Server-Timing`
revision age, and `/metrics` adds the pipeline, `jax_mapping_slo_*` and
span-count families. Without it `/trace` answers 404, as the JAX server
does with tracing off.

With the dispatch profiler (`devprof`, set by launch when
`cfg.obs.devprof.enabled`): `/status.perf` carries the per-entry-point
dispatch accounting, the recompile counters, the card's memory
watermarks (None on the CPU) and the cost ledger collected so far (a
handler never collects), and `/metrics` adds
`jax_mapping_device_dispatch_total`, `jax_mapping_device_dispatch_seconds`,
`jax_mapping_jit_recompiles_total` and, on the card,
`jax_mapping_device_memory_bytes`. With the warm-restart tier, launch
sets `coldstart_status` (`/status.cold_start`), and a staged restart's
warming window stamps `/status` and `/tiles` with `state=warming`. The
tenancy control plane (`tenancy`, set by launch when
`cfg.tenancy.enabled`) serves `/status.tenancy`, `/tiles?tenant=` and the
`jax_mapping_tenant_*` families.

Re-creates the reference's management plane (SURVEY.md §1 L4) with both
variants' routes merged:

* `GET|POST /start`, `GET|POST /stop` — flip `is_exploring`
  (the reference's `server/.../main.py:227-239`);
  stop also forces motors off (pi variant, `pi/src/.../main.py:320-326`).
  GET stays accepted here — deliberately, unlike /save /load below — for
  parity with the reference's documented `curl :5000/start` workflow
  (Flask GET routes): these flip a recoverable flag, while /load
  irreversibly replaces map state.
* `GET /status` — JSON connection/exploring/pose (`pi/src/.../main.py:332-341`).
* `GET /map-image` — latest `/map` as a grayscale PNG, 127 unknown / 255
  free / 0 occupied, flipped to image coords (`server/.../main.py:241-279`).
  The reference declared a 1 s PNG cache but never wrote it (`last_png`
  dead code, `:56-57` vs `:248-249` — SURVEY.md Appendix B); here the cache
  actually works.
* `GET /frontiers` — JSON frontier targets + assignment (new capability).
* `GET /voxel-image` — grayscale height-map PNG of the 3D voxel map
  (BASELINE configs[4]; 404 unless the stack runs with depth_cam).
* `GET /metrics` — framework counters in Prometheus text format, now
  including per-route request counters and a request-latency histogram
  (`jax_mapping_http_request_seconds`).
* `GET /tiles?since=<revision>[&level=k]` — the serving subsystem's
  delta protocol (serving/tiles.py): only the tiles whose content
  changed since the client's revision, as base64 PNGs in a JSON
  manifest, with a quadtree overview pyramid. `GET /voxel-tiles` is the
  height-map twin. 404 when `ServingConfig.enabled` is False.
* `GET /map-events` — SSE push stream of map-revision events
  (`?mode=poll&since=R` long-polls one JSON event instead); per-client
  bounded queues with drop-to-latest backpressure, every wait capped by
  `ServingConfig.event_wait_max_s` (the bounded-wait contract of the
  503-degraded path, applied to push).
* Every map route answers conditional GETs: `ETag` keyed on map stamp /
  voxel fusion key / tile revision, `If-None-Match` hit -> 304 with an
  empty body (pollers stop paying full-PNG bodies for unchanged maps).
* `POST /save[?name=x]`, `POST /load[?name=x]` — checkpoint / restore the
  live SLAM state (grid, poses, graphs, scan rings) through
  `io.checkpoint`. The capability slam_toolbox exposes as its
  serialization service (`enable_interactive_mode`, slam_config.yaml:32)
  but the reference never invokes — here a restart resumes the map
  instead of losing it. Names are basenames inside `checkpoint_dir`
  (no path traversal); load refuses config-drifted checkpoints. POST
  only: GET /load would let a link prefetcher or stray
  browser request silently replace the running map; GET answers 405.
* `POST /save-map[?name=x]` — export the live map in the ROS map_server
  format (map.pgm + map.yaml, the map_saver_cli artifact) for external
  consumers; `demo --map-prior` re-imports it (io/rosmap.py).
* `POST /goal?x=..&y=..[&robot=N]` — navigation goal dispatch without
  RViz: the HTTP twin of the SetGoal tool, published through the same
  bus topics the adapter uses (one goal ingress). 400 on malformed,
  out-of-range, non-finite, or out-of-map input.
* `POST /goal/cancel[?robot=N]` — clear a manual goal (the escape hatch
  RViz lacks); the robot reverts to frontier exploration.

Served threaded like the reference (Flask's threaded dev server); shutdown
uses the pi variant's graceful `make_server`/`shutdown` pattern
(`pi/src/.../main.py:364-380`).
"""

from __future__ import annotations

import json
import os
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Callable, Dict, Optional, Tuple
from urllib.parse import parse_qs, urlparse

import numpy as np

from jax_mapping_torch.bridge import png as png_codec
from jax_mapping_torch.bridge.bus import Bus
from jax_mapping_torch.bridge.messages import FrontierArray, OccupancyGrid
from jax_mapping_torch.bridge.qos import qos_map
from jax_mapping_torch.resilience.health import LockTimeout


class MapApiServer:
    """Bind handlers to framework state and serve.

    `brain` needs `start_exploring()`, `stop_exploring()`, `status()` (the
    ThymioBrain surface); map and frontier payloads arrive over the bus.
    """

    def __init__(self, bus: Bus, brain=None, host: str = "127.0.0.1",
                 port: int = 5000, png_cache_s: float = 1.0,
                 extra_status: Optional[Callable[[], dict]] = None,
                 mapper=None, checkpoint_dir: str = "checkpoints",
                 voxel_mapper=None, planner=None, health=None,
                 supervisor=None, recovery=None, devprof=None,
                 lock_timeout_s: Optional[float] = 2.0,
                 socket_timeout_s: Optional[float] = 30.0,
                 pipeline=None, slo=None):
        self.bus = bus
        self.brain = brain
        self.mapper = mapper
        self.voxel_mapper = voxel_mapper
        self.planner = planner
        self.checkpoint_dir = checkpoint_dir
        self.png_cache_s = png_cache_s
        self.extra_status = extra_status
        #: Degraded-mode plumbing (resilience/): FleetHealth and the
        #: Supervisor ride along on /status and /metrics; lock_timeout_s
        #: bounds every node-lock wait a handler makes (expiry -> 503
        #: {"state": "degraded"} instead of a hung worker thread).
        self.health = health
        self.supervisor = supervisor
        #: Estimator guardrails (recovery/manager.py): watchdog states,
        #: quarantine/relocalization counters, anti-stuck ladder and
        #: frontier blacklist ride along on /status and /metrics.
        self.recovery = recovery
        #: Dispatch profiler (obs/devprof.py): per-entry-point dispatch
        #: accounting, recompile counters, memory watermarks and the
        #: collected-so-far cost ledger ride along on /status (`perf`)
        #: and /metrics (`jax_mapping_device_*`). The ledger exports what
        #: collect() already gathered — a handler never collects.
        self.devprof = devprof
        self.cost_ledger = None
        if devprof is not None:
            from jax_mapping_torch.obs.ledger import CostLedger
            self.cost_ledger = CostLedger(devprof)
        #: Pipeline latency ledger (obs/pipeline.py) or None: serving
        #: routes stamp first-client-delivery waypoints and answer
        #: with `Server-Timing`-style revision-age headers — SERVER
        #: monotonic deltas, so a client measures observed staleness
        #: without trusting any cross-host wall clock.
        self.pipeline = pipeline
        #: Freshness SLO engine (obs/slo.py) or None: `/status.slo` +
        #: `jax_mapping_slo_*` metric families ride along.
        self.slo = slo
        self.lock_timeout_s = lock_timeout_s
        #: Staged warm-up window: while a supervisor restart
        #: restores+pre-warms the mapper, serving keeps answering from
        #: the OLD node's last epoch and /status + /tiles stamp
        #: `state=warming` — availability over freshness, made visible.
        #: Set-once-per-window by the restarting thread
        #: (launch.restart_mapper), read bare by handler threads (the
        #: lock-free flag convention: a boolean read can only be one
        #: window edge stale).
        self.warming = False
        #: /status `cold_start` provider wired by launch when the
        #: warm-restart tier is armed (cache counters, warm-pool stats,
        #: warm-up report).
        self.coldstart_status: Optional[Callable[[], dict]] = None
        #: Mission multi-tenancy control plane
        #: (tenancy/controlplane.TenantControlPlane) wired by launch
        #: when TenancyConfig.enabled: `/status.tenancy`,
        #: `jax_mapping_tenant_*` metrics, and per-tenant
        #: `/tiles?tenant=` delta sessions. Set-once before serving,
        #: read bare by handler threads (the lock-free flag
        #: convention).
        self.tenancy = None
        self.n_degraded_responses = 0
        self._lock = threading.Lock()
        #: Request statistics lock: ThreadingHTTPServer runs one worker
        #: thread per connection, and `n_requests += 1` is a read-
        #: modify-write — handler threads racing on it under-count.
        #: Every request counter (totals, per-route, degraded, 304s,
        #: the latency histogram) mutates under THIS dedicated lock so
        #: stats can never contend with the map/frontier state lock.
        self._stats_lock = threading.Lock()
        self._latest_map: Optional[OccupancyGrid] = None
        self._latest_frontiers: Optional[FrontierArray] = None
        # The 1 s PNG cache, implemented for real this time — one policy
        # for every PNG route (see _cached_png).
        self._png_cache: Dict[str, tuple] = {}
        self.png_cache_hits: Dict[str, int] = {}
        self.n_requests = 0
        self.n_png_cache_hits = 0
        self.n_304_responses = 0
        #: Per-route request counters + request-latency histogram
        #: (Prometheus `jax_mapping_http_request_seconds` buckets) —
        #: without these, a serving regression on one route hides
        #: inside the process-wide total.
        self.route_requests: Dict[str, int] = {}
        self._lat_buckets_s = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                               0.5, 1.0, 2.5, 5.0)
        self._lat_counts = [0] * (len(self._lat_buckets_s) + 1)
        self._lat_sum_s = 0.0
        self._lat_n = 0
        #: Tiled delta serving (serving/): built when the attached
        #: mapper's config enables it. ServingConfig.enabled=False (or
        #: no mapper) leaves this None — /tiles, /voxel-tiles and
        #: /map-events answer 404, exact pre-serving behavior.
        self.serving = None
        self._shutting_down = threading.Event()
        if mapper is not None and \
                getattr(mapper.cfg, "serving", None) is not None and \
                mapper.cfg.serving.enabled:
            from jax_mapping_torch.serving import MapServing
            self.serving = MapServing(mapper.cfg.serving, mapper=mapper,
                                      voxel_mapper=voxel_mapper,
                                      pipeline=pipeline)
            mapper.add_revision_listener(self.serving.on_map_revision)

        #: The /metrics exposition, declared once (obs/registry.py):
        #: collectors close over this server and read live state at
        #: render time; registration order is the historical document
        #: order (byte-compatible refactor of the hand-built assembly).
        self._registry = self._build_metrics_registry()

        bus.subscribe("/map", qos_map, callback=self._map_cb)
        bus.subscribe("/frontiers", callback=self._frontiers_cb)

        api = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):    # silence per-request spam
                pass

            # Per-connection socket timeout (StreamRequestHandler
            # honors the class attribute): a stalled client cannot pin
            # a worker thread forever.
            timeout = socket_timeout_s

            def _dispatch(self, method):
                t0 = time.monotonic()
                extra = {}
                try:
                    res = api.handle(self.path, method=method,
                                     headers=self.headers)
                    status, ctype, body = res[0], res[1], res[2]
                    if len(res) > 3 and res[3]:
                        extra = res[3]
                except LockTimeout as e:
                    # Bounded-wait contract: a wedged node lock answers
                    # 503 degraded, not a hung worker thread.
                    with api._stats_lock:
                        api.n_degraded_responses += 1
                    status, ctype, body = 503, "application/json", \
                        json.dumps({"state": "degraded",
                                    "error": str(e)}).encode()
                except Exception as e:            # noqa: BLE001
                    status, ctype, body = 500, "application/json", json.dumps(
                        {"error": str(e)}).encode()
                api._record_request(self.path, time.monotonic() - t0,
                                    status)
                self.send_response(status)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                for k, v in extra.items():
                    self.send_header(k, v)
                if status == 405:
                    self.send_header("Allow", "POST")
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):
                # The SSE stream writes incrementally and owns its
                # socket until the bounded deadline — it cannot go
                # through the buffered one-body _dispatch path.
                route = self.path.split("?")[0].rstrip("/") or "/"
                qs = self.path.partition("?")[2]
                if route == "/map-events" and api.serving is not None \
                        and "mode=poll" not in qs:
                    api._serve_sse(self)
                    return
                self._dispatch("GET")

            def do_POST(self):
                # Drain any request body so keep-alive clients don't
                # desync the connection.
                n = int(self.headers.get("Content-Length") or 0)
                if n:
                    self.rfile.read(n)
                self._dispatch("POST")

        self.server = ThreadingHTTPServer((host, port), Handler)
        self.port = self.server.server_address[1]
        self._thread: Optional[threading.Thread] = None

    # -- restart surface (launch.restart_mapper) -----------------------------

    def set_warming(self, warming: bool) -> None:
        """Open/close the staged warm-up serving window (the restart
        path's availability contract: answer stale, say so)."""
        self.warming = bool(warming)

    def rebind_mapper(self, mapper) -> None:
        """Swap the API onto a restarted MapperNode. The serving bundle
        is REBUILT around the new node — its tile-store snapshot
        closures and revision listener captured the old one, and a bare
        attribute swap would keep serving the destroyed node's final
        map forever. The event channel is carried over so connected
        /map-events clients keep their streams; the new mapper's
        `restart_epoch` (stamped into every /tiles response + ETag)
        tells delta clients to resync full instead of treating the
        resumed, possibly-older revision as a protocol violation."""
        self.mapper = mapper
        if self.serving is not None:
            from jax_mapping_torch.serving import MapServing
            old = self.serving
            self.serving = MapServing(mapper.cfg.serving, mapper=mapper,
                                      voxel_mapper=self.voxel_mapper,
                                      events=old.events,
                                      pipeline=self.pipeline)
            # The voxel provider did NOT restart: carry its store over
            # like the event channel — a fresh store would re-hash and
            # re-encode every voxel tile for nothing (and reset its
            # serving counters).
            if old.voxel_store is not None:
                self.serving.voxel_store = old.voxel_store
            mapper.add_revision_listener(self.serving.on_map_revision)

    # -- bus callbacks ------------------------------------------------------

    def _map_cb(self, msg: OccupancyGrid) -> None:
        with self._lock:
            self._latest_map = msg

    def _frontiers_cb(self, msg: FrontierArray) -> None:
        with self._lock:
            self._latest_frontiers = msg

    # -- request statistics -------------------------------------------------

    #: Routes the per-route counter tracks individually; anything else
    #: aggregates under "other" so hostile paths can't grow label
    #: cardinality without bound.
    _KNOWN_ROUTES = frozenset((
        "/", "/start", "/stop", "/status", "/map-image", "/voxel-image",
        "/frontiers", "/metrics", "/save", "/load", "/goal",
        "/goal/cancel", "/save-map", "/tiles", "/voxel-tiles",
        "/map-events", "/trace"))

    def _record_request(self, path: str, elapsed_s: float,
                        status: int = 200) -> None:
        """One request's bookkeeping (any worker thread): total,
        per-route counter, latency histogram, 304 count — all under the
        dedicated stats lock (the unsynchronized `n_requests += 1` of
        the pre-serving handler lost increments under thread races)."""
        route = path.split("?")[0].rstrip("/") or "/"
        if route not in self._KNOWN_ROUTES:
            route = "other"
        with self._stats_lock:
            self.n_requests += 1
            self.route_requests[route] = \
                self.route_requests.get(route, 0) + 1
            if status == 304:
                self.n_304_responses += 1
            for k, le in enumerate(self._lat_buckets_s):
                if elapsed_s <= le:
                    self._lat_counts[k] += 1
                    break
            else:
                self._lat_counts[-1] += 1
            self._lat_sum_s += elapsed_s
            self._lat_n += 1

    @staticmethod
    def _etag_hit(headers, etag: str) -> bool:
        """RFC 7232 weak comparison, enough for our self-issued tags."""
        if headers is None:
            return False
        inm = headers.get("If-None-Match")
        if not inm:
            return False
        return etag in [v.strip() for v in inm.split(",")] or \
            inm.strip() == "*"

    # -- request handling ---------------------------------------------------

    def _dead_node_guard(self, route: str) -> Optional[Tuple[int, str, bytes]]:
        """503 degraded for routes whose backing node the supervisor has
        declared dead: /save against a dead mapper would checkpoint a
        frozen (possibly mid-crash) snapshot, /load and /goal would
        mutate state nobody is serving. Read-only routes keep answering
        — the cached map is exactly what an operator debugging the
        outage wants to see."""
        if self.supervisor is None:
            return None
        # /stop is deliberately NOT guarded: the safe-stop escape hatch
        # must work regardless of what the supervisor believes.
        needs = {"/save": "jax_mapper", "/load": "jax_mapper",
                 "/save-map": "jax_mapper", "/goal": "thymio_brain",
                 "/goal/cancel": "thymio_brain", "/start": "thymio_brain"}
        node = needs.get(route)
        if node is not None and not self.supervisor.is_alive(node):
            with self._stats_lock:
                self.n_degraded_responses += 1
            return 503, "application/json", json.dumps(
                {"state": "degraded",
                 "error": f"{node} is down (supervisor restart pending); "
                          f"{route} unavailable"}).encode()
        return None

    def handle(self, path: str, method: str = "GET",
               headers=None) -> Tuple:
        """Route a request; returns (status, content-type, body) or
        (status, content-type, body, extra-headers-dict). When causal
        tracing is armed the whole handler runs inside an `http:<route>`
        span, so goal publishes and checkpoint mutations made from HTTP
        chain under the request that caused them."""
        tracer = getattr(self.bus, "tracer", None)
        if tracer is None:
            return self._handle(path, method, headers)
        route = path.split("?")[0].rstrip("/") or "/"
        if route == "/trace":
            # The trace poller must not trace ITSELF: a span per poll
            # would advance the ring every request, so the /trace ETag
            # (keyed on the span seq) could never 304.
            return self._handle(path, method, headers)
        if route not in self._KNOWN_ROUTES:
            # Collapse like _record_request does: the tracer keys its
            # seq table by span name, so raw client-controlled paths
            # would grow it without bound.
            route = "other"
        with tracer.span(f"http:{route}"):
            return self._handle(path, method, headers)

    def _handle(self, path: str, method: str = "GET",
                headers=None) -> Tuple:
        route = path.split("?")[0].rstrip("/") or "/"
        dead = self._dead_node_guard(route)
        if dead is not None:
            return dead
        if route == "/start":
            if self.brain is not None:
                self.brain.start_exploring()
            return 200, "application/json", \
                json.dumps({"status": "exploration started"}).encode()
        if route == "/stop":
            if self.brain is not None:
                self.brain.stop_exploring()
            return 200, "application/json", \
                json.dumps({"status": "exploration stopped"}).encode()
        if route == "/status":
            body = (self.brain.status(lock_timeout_s=self.lock_timeout_s)
                    if self.brain is not None else {})
            if self.warming:
                # Staged warm-up window: everything below is the PRIOR
                # epoch's picture, served instead of blocking while the
                # restarted mapper restores + pre-warms.
                body["state"] = "warming"
            if self.coldstart_status is not None:
                try:
                    body["cold_start"] = self.coldstart_status()
                except Exception:        # noqa: BLE001 — export only
                    pass
            if self.health is not None:
                # The whole degraded-mode picture in one glance: driver
                # link, per-robot OK/no_lidar/dead ladder, health clock.
                body["health"] = self.health.snapshot()
            if self.supervisor is not None:
                body["supervisor"] = self.supervisor.status()
            if self.recovery is not None:
                # The estimator-guardrail picture: per-robot watchdog
                # state/score, quarantine + relocalization progress,
                # anti-stuck ladder modes, live blacklist entries.
                body["recovery"] = self.recovery.snapshot()
                if self.mapper is not None:
                    body["recovery"]["n_scans_quarantined"] = \
                        self.mapper.n_scans_quarantined
                    body["recovery"]["n_relocalizations"] = \
                        self.mapper.n_relocalizations
            if self.mapper is not None:
                # Mapping-pipeline health alongside the brain's motion
                # fields — from the attached nodes directly, so every
                # stack with a mapper (sim, ros, rosbag-replay) gets the
                # operator's one-glance health check.
                body["n_scans_fused"] = self.mapper.n_scans_fused
                body["n_loops_closed"] = self.mapper.n_loops_closed
                if getattr(self.mapper, "cfg", None) is not None \
                        and self.mapper.cfg.decay.enabled:
                    # Map-healing observability (scenario engine): pass
                    # count + restart epoch, the lock-free counter
                    # convention.
                    body["decay"] = {
                        "n_passes": self.mapper.n_decay_passes,
                        "restart_epoch": self.mapper.restart_epoch,
                    }
                if hasattr(self.mapper, "match_stats"):
                    # Branch-and-bound matcher work accounting (last
                    # key match's candidate count + prune ratio).
                    body["match"] = self.mapper.match_stats()
                if hasattr(self.mapper, "frontier_stats"):
                    fs = self.mapper.frontier_stats()
                    if fs is not None:
                        # Incremental frontier pipeline: crop bbox,
                        # last recompute latency, tile-cache hit rate
                        # (ops/frontier_incremental.py).
                        body["frontier"] = fs
                calib = self.mapper.calibration()
                if calib is not None:
                    # Live odometry-scale re-measurement of the
                    # hand-calibrated SPEED_COEFF (report.pdf §III.D).
                    body["odom_calibration"] = calib
                if hasattr(self.mapper, "world_status"):
                    ws = self.mapper.world_status()
                    if ws is not None:
                        # Bounded-memory world (world/store.py): window
                        # origin/offset, eviction + rehydration
                        # counters, governor rung, spill-tier health.
                        body["world"] = ws
            if self.voxel_mapper is not None:
                body["n_images_fused"] = self.voxel_mapper.n_images_fused
                body["n_depth_keyframes"] = \
                    self.voxel_mapper.n_keyframes_stored
                body["n_voxel_refuses"] = self.voxel_mapper.n_refuses
            if self.planner is not None:
                body["n_plans"] = self.planner.n_plans
                body["plan_reachable"] = self.planner.last_reachable
                if self.planner.reachable_by_robot:
                    body["plan_reachable_by_robot"] = {
                        str(k): v for k, v in
                        self.planner.reachable_by_robot.items()}
            if self.devprof is not None:
                # Device-side performance picture (`/status.perf`):
                # dispatch attribution, live recompile counters, the
                # card's memory watermarks (None on the CPU) and the
                # cost-ledger entries collected so far.
                body["perf"] = {
                    "dispatch": self.devprof.snapshot(),
                    "recompiles": self.devprof.recompiles(),
                    "memory": self.devprof.memory_stats(),
                    "cost_ledger": self.cost_ledger.snapshot(),
                    "cost_ledger_uncollected":
                        self.cost_ledger.n_uncollected(),
                }
            if self.tenancy is not None:
                # Mission multi-tenancy picture: per-tenant lifecycle
                # state, serving (epoch, revision) namespaces, bucket
                # capacity/occupancy and pad waste, admit/evict/
                # pre-warm counters (tenancy/controlplane.py).
                body["tenancy"] = self.tenancy.status()
            if self.pipeline is not None:
                # Freshness pipeline picture: pending/completed
                # revisions, windowed scan→served p99, last
                # install/delivery ticks (obs/pipeline.py).
                body["pipeline"] = self.pipeline.status()
            if self.slo is not None:
                # The freshness-budget picture (`/status.slo`): per
                # objective value vs threshold, fast/slow burn rates,
                # firing state, and the recent alert transitions.
                body["slo"] = self.slo.status()
            if self.extra_status is not None:
                body.update(self.extra_status())
            return 200, "application/json", json.dumps(body).encode()
        if route == "/map-image":
            return self._map_image(headers)
        if route == "/voxel-image":
            return self._voxel_image(headers)
        if route == "/tiles":
            return self._tiles(path, headers, source="grid")
        if route == "/voxel-tiles":
            return self._tiles(path, headers, source="voxel-height")
        if route == "/map-events":
            # The SSE variant is intercepted in the handler (it streams);
            # reaching here means ?mode=poll — one bounded long-poll.
            return self._map_events_poll(path)
        if route == "/frontiers":
            return self._frontiers()
        if route == "/metrics":
            return 200, "text/plain", self._metrics().encode()
        if route == "/trace":
            return self._trace(path, headers)
        if route in ("/save", "/load"):
            # Mutations are POST-only: GET /load from a link
            # prefetcher would silently replace the running map.
            if method != "POST":
                return 405, "application/json", json.dumps(
                    {"error": f"{route} requires POST "
                              f"(curl -X POST ...{route})"}).encode()
            return self._checkpoint(route, path)
        if route == "/goal":
            # Navigation goal dispatch without RViz: POST /goal?x=..&y=..
            # [&robot=N] — the HTTP twin of the SetGoal tool, addressed
            # like the namespaced goal topics. POST-only: a goal MOVES a
            # robot.
            if method != "POST":
                return 405, "application/json", json.dumps(
                    {"error": "/goal requires POST "
                              "(curl -X POST '.../goal?x=1&y=2')"}).encode()
            return self._set_goal(path)
        if route == "/goal/cancel":
            # The escape hatch RViz lacks: clear a manual goal (e.g. an
            # unreachable one) and let the robot go back to exploring.
            if method != "POST":
                return 405, "application/json", json.dumps(
                    {"error": "/goal/cancel requires POST"}).encode()
            if self.brain is None:
                return 404, "application/json", json.dumps(
                    {"error": "no brain attached"}).encode()
            q = parse_qs(urlparse(path).query)
            try:
                robot = int(q.get("robot", ["0"])[0])
            except (ValueError, IndexError):
                return 400, "application/json", json.dumps(
                    {"error": "robot must be an integer"}).encode()
            if not 0 <= robot < self.brain.n_robots:
                return 400, "application/json", json.dumps(
                    {"error": f"robot {robot} out of range"}).encode()
            had = self.brain.cancel_goal(robot)
            return 200, "application/json", json.dumps(
                {"status": "goal cancelled" if had else "no goal set",
                 "robot": robot}).encode()
        if route == "/save-map":
            # Writes to disk -> POST-only, same stance as /save.
            if method != "POST":
                return 405, "application/json", json.dumps(
                    {"error": "/save-map requires POST "
                              "(curl -X POST .../save-map)"}).encode()
            return self._save_rosmap(path)
        return 404, "application/json", \
            json.dumps({"error": f"no route {route}"}).encode()

    def _checkpoint(self, route: str, path: str) -> Tuple[int, str, bytes]:
        if self.mapper is None:
            return 404, "application/json", json.dumps(
                {"error": "no mapper attached"}).encode()
        from jax_mapping_torch.io.checkpoint import (load_checkpoint,
                                                     save_checkpoint)
        q = parse_qs(urlparse(path).query)
        name = os.path.basename(q.get("name", ["slam_state"])[0]) or \
            "slam_state"
        fp = os.path.join(self.checkpoint_dir, name + ".npz")
        if name.endswith((".voxel", ".voxelkf", ".prior", ".world")):
            # Reserved: checkpoint "x"'s sidecars live at "x.voxel.npz" /
            # "x.voxelkf.npz" / "x.prior.npz" / "x.world.npz"; a
            # checkpoint NAMED with any of those suffixes would collide
            # with them.
            return 400, "application/json", json.dumps(
                {"error": "checkpoint names ending in '.voxel', "
                          "'.voxelkf', '.prior' or '.world' are "
                          "reserved for sidecars"}).encode()
        # The LOGICAL config is what checkpoints record: in windowed
        # mode `mapper.cfg` is the window-sized derivation, and two
        # stacks with different logical extents share a window shape —
        # only the full config pins the world geometry the window
        # origin is anchored to. full_cfg == cfg when not windowed.
        cfg_json = getattr(self.mapper, "full_cfg",
                           self.mapper.cfg).to_json()
        if route == "/save":
            os.makedirs(self.checkpoint_dir, exist_ok=True)
            states = self.mapper.snapshot_states()
            save_checkpoint(fp, states, config_json=cfg_json)
            body = {"status": "saved", "path": fp, "robots": len(states)}
            from jax_mapping_torch.io.checkpoint import (
                clear_world_sidecar, save_world_sidecar)
            world = getattr(self.mapper, "world", None)
            if world is not None:
                try:
                    body["world_path"] = save_world_sidecar(
                        fp, world.checkpoint_payload(),
                        config_json=cfg_json)
                except ValueError as e:
                    body["world_error"] = str(e)
            else:
                # A stale window manifest from an earlier windowed save
                # under this name would re-anchor a later windowed
                # resume at a dead origin.
                clear_world_sidecar(fp)
            prior = self.mapper.map_prior()
            from jax_mapping_torch.io.checkpoint import (
                clear_prior_sidecar, save_prior_sidecar)
            if prior is not None:
                try:
                    body["prior_path"] = save_prior_sidecar(
                        fp, prior, config_json=cfg_json)
                except ValueError as e:
                    # Same contract as the voxel sidecar: the main
                    # checkpoint IS saved; report the sidecar problem.
                    body["prior_error"] = str(e)
            else:
                # A stale sidecar from an earlier save under this name
                # would resurrect the OLD environment's prior on /load —
                # exactly what restore_states' clear contract prevents.
                # (Sentinel-checked: never deletes a non-sidecar file.)
                clear_prior_sidecar(fp)
            if self.voxel_mapper is not None:
                from jax_mapping_torch.io.checkpoint import (
                    save_keyframe_sidecar, save_voxel_sidecar)
                try:
                    body["voxel_path"] = save_voxel_sidecar(
                        fp, self.voxel_mapper.snapshot_grid(),
                        config_json=cfg_json)
                    # Keyframe ring alongside, so post-/load closures can
                    # still repair the 3D map (the 2D scan ring's
                    # persistence, in 3D).
                    body["keyframe_path"] = save_keyframe_sidecar(
                        fp, self.voxel_mapper.snapshot_keyframes(),
                        config_json=cfg_json)
                except ValueError as e:
                    body["voxel_error"] = str(e)
            return 200, "application/json", json.dumps(body).encode()
        if not os.path.exists(fp):
            return 404, "application/json", json.dumps(
                {"error": f"no checkpoint {fp}"}).encode()
        states, saved_cfg_json = load_checkpoint(
            fp, self.mapper.checkpoint_template())
        from jax_mapping_torch.config import configs_equivalent
        if saved_cfg_json is not None and \
                not configs_equivalent(saved_cfg_json, cfg_json):
            return 409, "application/json", json.dumps(
                {"error": "checkpoint config differs from the running "
                          "config; refusing to load"}).encode()
        # World-window sidecar (bounded-memory world): validate BEFORE
        # any restore mutates live state, same contract as the voxel
        # sidecar. A windowed checkpoint loaded into a non-windowed
        # stack already 409'd above (the state shapes differ).
        world = getattr(self.mapper, "world", None)
        world_payload = None
        if world is not None:
            from jax_mapping_torch.io.checkpoint import load_world_sidecar
            try:
                world_payload = load_world_sidecar(
                    fp, running_config_json=cfg_json)
            except ValueError as e:
                return 409, "application/json", json.dumps(
                    {"error": f"world sidecar: {e}"}).encode()
        # Validate + read the 3D sidecar BEFORE any restore mutates live
        # state: a bad sidecar must 409 with everything untouched, not
        # leave the server half-restored.
        vgrid = None
        vkf = None
        if self.voxel_mapper is not None:
            from jax_mapping_torch.io.checkpoint import (
                load_keyframe_sidecar, load_voxel_sidecar,
                voxel_sidecar_path)
            try:
                vgrid = load_voxel_sidecar(
                    fp, self.voxel_mapper.snapshot_grid(),
                    running_config_json=cfg_json)
                vkf = load_keyframe_sidecar(
                    fp, running_config_json=cfg_json)
                if vkf is not None:
                    self.voxel_mapper.validate_keyframes(vkf)
            except ValueError as e:
                return 409, "application/json", json.dumps(
                    {"error": f"voxel sidecar: {e}"}).encode()
        from jax_mapping_torch.io.checkpoint import load_prior_sidecar
        try:
            prior = load_prior_sidecar(
                fp, self._G_empty(),
                running_config_json=cfg_json)
        except ValueError as e:
            return 409, "application/json", json.dumps(
                {"error": f"prior sidecar: {e}"}).encode()
        # No anchor poses: the /load contract is a server restart with
        # robots holding still, so checkpoint poses are still valid.
        # map_prior=None CLEARS a live prior — the checkpoint is the
        # source of truth now.
        if world is not None and world_payload is not None:
            # Re-anchor BEFORE the state install: the checkpointed
            # window grids are content AT the checkpointed origin, and
            # the install's revision bump + full dirty mark then serve
            # the re-anchored mosaic in one step.
            world.restore_payload(world_payload)
        self.mapper.restore_states(states, map_prior=prior)
        body = {"status": "loaded", "path": fp, "robots": len(states)}
        if world is not None and world_payload is not None:
            from jax_mapping_torch.io.checkpoint import world_sidecar_path
            body["world_path"] = world_sidecar_path(fp)
            body["world_origin_tile"] = [int(v) for v in
                                         world_payload["origin_tile"]]
        if prior is not None:
            from jax_mapping_torch.io.checkpoint import prior_sidecar_path
            body["prior_path"] = prior_sidecar_path(fp)
        if vgrid is not None:
            self.voxel_mapper.restore_grid(vgrid)
            body["voxel_path"] = voxel_sidecar_path(fp)
            if vkf is not None:
                # AFTER restore_grid (which clears the ring) and AFTER
                # restore_states (generations bumped): the graphs these
                # keyframes anchor to are exactly the restored ones.
                self.voxel_mapper.restore_keyframes(vkf)
                body["keyframes_restored"] = int(len(vkf["robot"]))
        return 200, "application/json", json.dumps(body).encode()

    def _set_goal(self, path: str) -> Tuple[int, str, bytes]:
        if self.brain is None:
            return 404, "application/json", json.dumps(
                {"error": "no brain attached"}).encode()
        from jax_mapping_torch.bridge.brain import robot_ns
        from jax_mapping_torch.bridge.messages import Pose2D
        q = parse_qs(urlparse(path).query)
        import math as _math
        try:
            x = float(q["x"][0])
            y = float(q["y"][0])
            robot = int(q.get("robot", ["0"])[0])
        except (KeyError, ValueError, IndexError):
            return 400, "application/json", json.dumps(
                {"error": "need numeric x and y (optional integer "
                          "robot)"}).encode()
        if not (_math.isfinite(x) and _math.isfinite(y)):
            # float('nan')/'inf' parse fine; the brain ingress also
            # rejects them, but the HTTP caller deserves a 400.
            return 400, "application/json", json.dumps(
                {"error": "x and y must be finite"}).encode()
        if self.mapper is not None:
            # An out-of-grid goal would clip to the border cell and plan
            # "reachable" toward a place that does not exist; refuse
            # with the valid extent so the caller can correct
            # (GridConfig.contains_m — the shared goal-ingress
            # predicate; x/y are already finite here, so a False means
            # out of extent).
            g = self.mapper.cfg.grid
            if not g.contains_m(x, y):
                ox, oy = g.origin_m
                span = g.extent_m
                return 400, "application/json", json.dumps(
                    {"error": f"goal outside the map extent "
                              f"[{ox}, {ox + span}) x [{oy}, {oy + span})"}
                ).encode()
        n = self.brain.n_robots
        if not 0 <= robot < n:
            return 400, "application/json", json.dumps(
                {"error": f"robot {robot} out of range (fleet of {n})"}
            ).encode()
        # Through the same bus topic the adapter and RViz use — ONE goal
        # ingress path, not a side channel.
        topic = "/goal_pose" if robot == 0 else \
            robot_ns(robot, n) + "goal_pose"
        self.bus.publisher(topic).publish(Pose2D(x, y, 0.0))
        return 200, "application/json", json.dumps(
            {"status": "goal set", "robot": robot,
             "x": x, "y": y}).encode()

    def _G_empty(self):
        """Template grid for the prior sidecar's shape/dtype check."""
        from jax_mapping_torch.ops import grid as G
        return G.empty_grid(self.mapper.cfg.grid, self.mapper.device)

    def _save_rosmap(self, path: str) -> Tuple[int, str, bytes]:
        """POST /save-map?name=x -> checkpoint_dir/x.pgm + x.yaml in the
        ROS map_server format (the `map_saver_cli` artifact; the
        reference ecosystem's portable map interchange). Unlike /save,
        this is the LOSSY export every external consumer reads — npz
        checkpoints remain the lossless resume path."""
        if self.mapper is None:
            return 404, "application/json", json.dumps(
                {"error": "no mapper attached"}).encode()
        from jax_mapping_torch.io import rosmap
        q = parse_qs(urlparse(path).query)
        name = os.path.basename(q.get("name", ["map"])[0]) or "map"
        g = self.mapper.cfg.grid
        # Threshold directly: the export edge's {-1, 0, 100} trichotomy
        # (occupancy_from_logodds semantics) without a message detour.
        lo = self.mapper.merged_grid().cpu().numpy()
        occ = np.full(lo.shape, -1, np.int8)
        occ[lo <= g.free_threshold] = 0
        occ[lo >= g.occ_threshold] = 100
        os.makedirs(self.checkpoint_dir, exist_ok=True)
        pgm, yaml = rosmap.save_map(
            os.path.join(self.checkpoint_dir, name),
            occ, g.resolution_m, g.origin_m)
        return 200, "application/json", json.dumps(
            {"status": "saved", "pgm": pgm, "yaml": yaml}).encode()

    def _map_image(self, headers=None) -> Tuple:
        with self._lock:
            msg = self._latest_map
        if msg is None:
            # Reference guard (`server/.../main.py:244-245`).
            return 404, "application/json", \
                json.dumps({"error": "map not yet available"}).encode()
        # Conditional GET keyed on the map stamp: a poller holding the
        # current ETag pays a 304 header instead of the full PNG body —
        # the byte-saving half of the cache even before the tile path.
        etag = f'W/"map-{msg.header.stamp}"'
        # Revision-age header on the whole-PNG route too: the legacy
        # polling client measures the same server-monotonic staleness
        # the tile clients do (the /map message trails the live grid
        # by up to a publish period — the age reports the newest
        # INSTALLED revision, the freshness a poller could have).
        timing = self._timing_header(None)
        if self._etag_hit(headers, etag):
            return 304, "image/png", b"", {"ETag": etag, **timing}
        data = self._cached_png(
            "map", msg.header.stamp,
            lambda: png_codec.encode_gray(msg.as_image_array()))
        return 200, "image/png", data, {"ETag": etag, **timing}

    def _voxel_image(self, headers=None) -> Tuple:
        """Grayscale height-map PNG of the 3D voxel map (0 = unmapped
        column, brighter = taller top surface) — the /map-image analog
        for the BASELINE configs[4] pipeline, with the same cache policy
        (keyed on fusion progress: re-encoding an unchanged grid for a
        polling UI is the exact waste the map-image cache exists for)."""
        if self.voxel_mapper is None:
            return 404, "application/json", json.dumps(
                {"error": "no voxel mapper attached (run the stack with "
                          "depth_cam enabled)"}).encode()
        key = (self.voxel_mapper.n_images_fused,
               self.voxel_mapper.map_revision)
        etag = f'W/"voxel-{key[0]}-{key[1]}"'
        if self._etag_hit(headers, etag):
            return 304, "image/png", b"", {"ETag": etag}
        data = self._cached_png(
            "voxel", key,
            lambda: png_codec.encode_gray(
                self.voxel_mapper.height_map_image()))
        return 200, "image/png", data, {"ETag": etag}

    # -- serving: tiled delta distribution (serving/) ------------------------

    def _tiles(self, path: str, headers, source: str) -> Tuple:
        """GET /tiles?since=<revision>[&level=k] — the delta protocol:
        refresh the tile store to the mapper's revision, then return
        ONLY the tiles stamped newer than the client's `since` as
        base64 PNGs in a JSON manifest. since=-1 (or omitted) is the
        initial full snapshot. ETag on the store revision, so a poller
        that is already current pays a 304."""
        q = parse_qs(urlparse(path).query)
        tenant = q.get("tenant", [None])[0]
        if tenant is not None:
            # Per-tenant delta session (tenancy/): the tenant's OWN
            # (epoch, revision) namespace replaces the mapper's — a
            # resumed mission's epoch bump invalidates pre-suspend
            # ETags exactly like a supervisor restart does for the
            # shared map, and co-tenant churn never touches it.
            if self.tenancy is None:
                return 404, "application/json", json.dumps(
                    {"error": "no tenant control plane attached "
                              "(TenancyConfig.enabled=False)"}).encode()
            try:
                store = self.tenancy.tile_store(tenant)
            except (KeyError, ValueError) as e:
                return 404, "application/json", json.dumps(
                    {"error": str(e)}).encode()
            source = f"tenant:{tenant}"
        else:
            if self.serving is None:
                return 404, "application/json", json.dumps(
                    {"error": "serving disabled "
                              "(ServingConfig.enabled=False)"}).encode()
            store = self.serving.store(source)
            if store is None:
                return 404, "application/json", json.dumps(
                    {"error": f"no {source} tile store (run the stack "
                              "with the producing mapper "
                              "attached)"}).encode()
        try:
            since = int(q.get("since", ["-1"])[0])
            level = int(q["level"][0]) if "level" in q else None
        except (ValueError, IndexError):
            return 400, "application/json", json.dumps(
                {"error": "since and level must be integers"}).encode()
        try:
            store.refresh()
        except (KeyError, ValueError) as e:
            # A tenant evicted between store lookup and refresh: its
            # snapshot has no state to serve anymore.
            return 404, "application/json", json.dumps(
                {"error": str(e)}).encode()
        rev, entries, meta = store.tiles_since(since, level)
        # Restart epoch in body AND ETag: a supervisor restart-resume
        # (or a tenant evict→re-admit) legitimately re-serves an older
        # revision; clients key cache validity on (epoch, revision),
        # not revision alone — a stale pre-restart ETag can never 304
        # against the resumed store. Read AFTER the refresh on both
        # paths: an epoch captured before it could stamp fresh content
        # with the PRIOR epoch and match a stale client's ETag.
        if tenant is not None:
            try:
                epoch = self.tenancy.epoch(tenant)
            except KeyError:
                return 404, "application/json", json.dumps(
                    {"error": f"unknown tenant {tenant!r}"}).encode()
        else:
            epoch = self.serving.epoch(source)
        # The warming flag is part of the REPRESENTATION (body and ETag
        # must agree — the /trace doctrine): a poller current on the
        # steady-state tag still learns the window opened, and a cached
        # warming body can never 304 past the window's end. The
        # quarantine stamp follows the same doctrine: a quarantined
        # tenant keeps serving its frozen last-good revision, but the
        # body and tag both say so — a client current on the healthy
        # tag re-fetches once and learns the state, and a cached
        # quarantined body can never 304 past the re-admission (whose
        # epoch bump changes the tag anyway).
        warming = self.warming
        quarantined = (tenant is not None
                       and self.tenancy.tenant_lifecycle(tenant)
                       == "quarantined")
        suffix = ('-warming' if warming else '') + \
            ('-quarantined' if quarantined else '')
        # Bounded-memory world: the eviction epoch rides the ETag so a
        # validator can never 304 across an eviction-state flip whose
        # content change is exactly "these tiles became markers".
        wepoch = getattr(store, "evicted_epoch", 0)
        if wepoch:
            suffix += f"-w{wepoch}"
        etag = f'W/"{source}-e{epoch}-r{rev}{suffix}"'
        # First-client-delivery waypoint + Server-Timing revision age:
        # a 304 confirms freshness exactly as a body does (the client
        # HOLDS the revision), so both answers stamp and both carry
        # the age header. Grid + tenant surfaces only — they own the
        # freshness chain; the voxel overview rides outside it.
        timing = {}
        if self.pipeline is not None and rev >= 0 \
                and (tenant is not None or source == "grid"):
            # Epoch threaded through: a restart/re-admission resets
            # the ledger's delivered mark so the staleness objective
            # tracks the NEW epoch's numbering instead of going blind
            # until it outgrows the old mark.
            self.pipeline.delivered(rev, tenant=tenant or "",
                                    epoch=epoch)
            timing = self._timing_header(rev, tenant=tenant or "")
        if self._etag_hit(headers, etag):
            return 304, "application/json", b"", \
                {"ETag": etag, **timing}
        body = dict(meta)
        body.update({"revision": rev, "since": since, "epoch": epoch,
                     "tiles": entries})
        if warming:
            # Staged warm-up: these tiles are the PRIOR epoch's content
            # (the restarted node hasn't entered service yet) — valid,
            # stamped, and explicitly stale.
            body["state"] = "warming"
        if quarantined:
            # Containment: the frozen last-good revision of a
            # quarantined tenant — valid, stamped, and explicitly not
            # advancing until a re-admission probe passes.
            body["state"] = "quarantined"
        return 200, "application/json", json.dumps(body).encode(), \
            {"ETag": etag, **timing}

    def _timing_header(self, revision: Optional[int],
                       tenant: str = "") -> Dict[str, str]:
        """`Server-Timing: rev;desc=..., age;dur=<ms>` for a response
        serving `revision` (None = the newest installed): the age is a
        SERVER monotonic delta since the revision's install, so a
        client measures observed staleness without clock trust. Empty
        when no ledger is armed or the revision predates it — better
        no header than a fabricated age."""
        if self.pipeline is None:
            return {}
        age = self.pipeline.revision_age_ms(revision, tenant=tenant)
        if age is None:
            return {}
        rev_desc = "latest" if revision is None else str(revision)
        return {"Server-Timing":
                f'rev;desc="{rev_desc}", age;dur={age:.1f}'}

    def _map_events_poll(self, path: str) -> Tuple[int, str, bytes]:
        """GET /map-events?mode=poll&since=R[&wait_s=S] — bounded
        long-poll: answers as soon as the map revision exceeds `since`
        (immediately when it already does), or after the capped wait
        with `timed_out: true`. The worker thread's wait is bounded by
        `ServingConfig.event_wait_max_s` — the 503-degraded path's
        bounded-wait contract, applied to push."""
        if self.serving is None or self.mapper is None:
            return 404, "application/json", json.dumps(
                {"error": "serving disabled"}).encode()
        q = parse_qs(urlparse(path).query)
        try:
            since = int(q.get("since", ["-1"])[0])
            wait_s = float(q.get("wait_s", ["10"])[0])
        except (ValueError, IndexError):
            return 400, "application/json", json.dumps(
                {"error": "since must be an integer, wait_s a "
                          "number"}).encode()
        wait_s = max(0.0, min(wait_s, self.serving.cfg.event_wait_max_s))
        # Subscribe BEFORE the current-revision check (the _serve_sse
        # order): an event fanned out between a check and a later
        # subscribe would be missed and the poll would ride out its
        # whole capped wait for an advance that already happened.
        sub = self.serving.events.subscribe()
        try:
            current = self.mapper.serving_revision()
            if current > since:
                return 200, "application/json", json.dumps(
                    {"map": "grid", "revision": current,
                     "timed_out": False}).encode(), \
                    self._timing_header(current)
            deadline = time.monotonic() + wait_s
            while not self._shutting_down.is_set():
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                ev = sub.next(min(0.5, remaining))
                if ev is not None and int(ev.get("revision", -1)) > since:
                    rev = int(ev["revision"])
                    return 200, "application/json", json.dumps(
                        {"map": "grid", "revision": rev,
                         "timed_out": False}).encode(), \
                        self._timing_header(rev)
        finally:
            self.serving.events.unsubscribe(sub)
        current = self.mapper.serving_revision()
        return 200, "application/json", json.dumps(
            {"map": "grid", "revision": current,
             "timed_out": True}).encode(), self._timing_header(current)

    def _serve_sse(self, handler) -> None:
        """GET /map-events — Server-Sent Events stream of map-revision
        advances, written directly on the handler's socket.

        Backpressure and bounds: each client owns ONE bounded queue
        (drop-to-latest on overflow — revisions are cumulative, old
        events carry no information the newest doesn't), the stream
        lifetime is capped by `event_wait_max_s` (clients reconnect,
        standard SSE), the per-connection socket timeout covers stalled
        writes, and shutdown closes every subscription — a slow client
        can never pin server memory or a worker thread."""
        self._record_request(handler.path, 0.0)
        q = parse_qs(urlparse(handler.path).query)
        try:
            since = int(q.get("since", ["-1"])[0])
            max_s = float(q.get("timeout_s",
                                [str(self.serving.cfg.event_wait_max_s)])[0])
        except (ValueError, IndexError):
            since, max_s = -1, self.serving.cfg.event_wait_max_s
        max_s = max(0.0, min(max_s, self.serving.cfg.event_wait_max_s))
        sub = self.serving.events.subscribe()
        try:
            handler.send_response(200)
            handler.send_header("Content-Type", "text/event-stream")
            handler.send_header("Cache-Control", "no-cache")
            handler.send_header("Connection", "close")
            for k, v in self._timing_header(None).items():
                # Stream-start revision age (the newest installed):
                # SSE headers go out once; per-event freshness rides
                # the revision numbers in the events themselves.
                handler.send_header(k, v)
            handler.end_headers()
            last_sent = since
            current = (self.mapper.serving_revision()
                       if self.mapper is not None else -1)
            if current > last_sent:
                handler.wfile.write(
                    b"event: map\ndata: " + json.dumps(
                        {"map": "grid", "revision": current}).encode()
                    + b"\n\n")
                last_sent = current
            deadline = time.monotonic() + max_s
            while not self._shutting_down.is_set():
                remaining = deadline - time.monotonic()
                if remaining <= 0:
                    break
                ev = sub.next(min(0.5, remaining))
                if ev is None:
                    handler.wfile.write(b": keepalive\n\n")
                    continue
                rev = int(ev.get("revision", -1))
                if rev <= last_sent:
                    continue       # drop-to-latest may reorder history
                handler.wfile.write(
                    b"event: map\ndata: "
                    + json.dumps({"map": ev.get("map", "grid"),
                                  "revision": rev}).encode() + b"\n\n")
                last_sent = rev
        except (BrokenPipeError, ConnectionResetError, OSError):
            pass                   # client went away: nothing to salvage
        finally:
            self.serving.events.unsubscribe(sub)

    def _cached_png(self, name: str, key, render: Callable[[], bytes]
                    ) -> bytes:
        """ONE cache policy for every PNG route (map, voxel): serve the
        cached bytes while the content key matches within png_cache_s;
        render outside the lock (a worst-case race costs one redundant
        encode, never a stale serve — the key check gates every hit).
        Hits count both per-route (`png_cache_hits` dict) and in the
        historical total `n_png_cache_hits`."""
        now = time.monotonic()
        with self._lock:
            ent = self._png_cache.get(name)
            if ent is not None and now - ent[1] < self.png_cache_s \
                    and ent[2] == key:
                self.n_png_cache_hits += 1
                self.png_cache_hits[name] = \
                    self.png_cache_hits.get(name, 0) + 1
                return ent[0]
        data = render()
        with self._lock:
            self._png_cache[name] = (data, time.monotonic(), key)
        return data

    def _trace(self, path: str, headers=None) -> Tuple:
        """GET /trace?since=<seq> — the tracer's span ring as Chrome-
        trace/Perfetto events, incrementally: only spans whose monotone
        `seq` stamp exceeds `since` (omitted/0 = everything still in
        the ring), plus `next` to pass as the following poll's `since`.
        404 when tracing is off (`ObsConfig.enabled=False`).

        The ETag is the span-ring head seq, read BEFORE the span content
        (a reverse order could stamp newer spans with an older seq), and
        the returned window is capped at that seq so body and ETag
        agree; an empty window costs a 304 header."""
        tracer = getattr(self.bus, "tracer", None)
        if tracer is None:
            return 404, "application/json", json.dumps(
                {"error": "tracing disabled (ObsConfig.enabled=False)"}
            ).encode()
        from jax_mapping_torch.obs.export import chrome_events
        q = parse_qs(urlparse(path).query)
        try:
            since = int(q.get("since", ["0"])[0])
        except (ValueError, IndexError):
            return 400, "application/json", json.dumps(
                {"error": "since must be an integer span seq"}).encode()
        head = tracer.last_seq()           # revision BEFORE content
        etag = f'W/"trace-{head}-s{since}"'
        if self._etag_hit(headers, etag):
            return 304, "application/json", b"", {"ETag": etag}
        spans = [s for s in tracer.spans_since(since)
                 if s["seq"] <= head]
        return 200, "application/json", json.dumps(
            {"traceEvents": chrome_events(spans),
             "next": spans[-1]["seq"] if spans else since}).encode(), \
            {"ETag": etag}

    def _frontiers(self) -> Tuple[int, str, bytes]:
        with self._lock:
            fr = self._latest_frontiers
        if fr is None:
            return 404, "application/json", \
                json.dumps({"error": "frontiers not yet available"}).encode()
        body = {
            "targets_xy": np.asarray(fr.targets_xy).tolist(),
            "sizes": np.asarray(fr.sizes).tolist(),
            "assignment": np.asarray(fr.assignment).tolist(),
        }
        return 200, "application/json", json.dumps(body).encode()

    def _metrics(self) -> str:
        return self._registry.render()

    def _build_metrics_registry(self):
        """Declare the `/metrics` exposition (obs/registry.py).

        Registration order IS exposition order and every value keeps
        its historical format string, so the registry reproduces the
        hand-assembled pre-obs document BYTE-for-byte for every family
        that existed before it (pinned by tests/test_obs.py +
        test_scenarios.py) — dashboards and scrape configs survive the
        refactor. New families (bus subscription health, stage-latency
        histograms, obs counters) append after the historical tail.
        Collectors returning None omit their family — the conditional-
        subsystem pattern (`if self.brain is not None: lines += ...`)
        as data."""
        from jax_mapping_torch.obs.registry import (
            Family, MetricsRegistry, histogram_samples, summary_samples)
        reg = MetricsRegistry()
        reg.family("jax_mapping_http_requests_total", "counter",
                   lambda: [("", str(self.n_requests))])
        reg.family("jax_mapping_png_cache_hits_total", "counter",
                   lambda: [("", str(self.n_png_cache_hits))])

        def brain_families():
            if self.brain is None:
                return None
            st = self.brain.status(lock_timeout_s=self.lock_timeout_s)
            return (
                Family("jax_mapping_brain_ticks_total", "counter",
                       (("", str(st.get("ticks", 0))),)),
                Family("jax_mapping_brain_io_errors_total", "counter",
                       (("", str(st.get("io_errors", 0))),)),
                Family("jax_mapping_brain_connected", "gauge",
                       (("", str(int(bool(st.get("connected"))))),)),
            )
        reg.add_source(brain_families)

        def health_families():
            if self.health is None:
                return None
            # Degraded-mode ladder as gauges: ok=0 no_lidar=1 dead=2
            # per robot (estimator_diverged=3 — a distinct severity,
            # not a silence rung), driver ok=0 offline=1 recovering=2 —
            # thresholdable without string parsing.
            snap = self.health.snapshot()
            rank = {"ok": 0, "no_lidar": 1, "dead": 2,
                    "estimator_diverged": 3,
                    "offline": 1, "recovering": 2}
            return (
                Family("jax_mapping_health_robot_state", "gauge",
                       tuple((f'{{robot="{i}"}}', str(rank.get(s, 0)))
                             for i, s in enumerate(snap["robots"]))),
                Family("jax_mapping_health_driver_state", "gauge",
                       (("", str(rank.get(snap["driver"], 0))),)),
                Family("jax_mapping_health_transitions_total", "counter",
                       (("", str(snap["n_transitions"])),)),
            )
        reg.add_source(health_families)

        def supervisor_families():
            if self.supervisor is None:
                return None
            sup = self.supervisor.status()
            return (
                Family("jax_mapping_supervisor_dead_nodes", "gauge",
                       (("", str(len(sup["dead"]))),)),
                Family("jax_mapping_supervisor_restarts_total", "counter",
                       (("", str(sum(sup["restarts"].values()))),)),
                Family("jax_mapping_supervisor_checkpoints_total",
                       "counter", (("", str(sup["checkpoints"])),)),
            )
        reg.add_source(supervisor_families)

        def match_families():
            # Branch-and-bound matcher work accounting (SlamDiag
            # match_candidates/prune_ratio): evaluations the last key
            # match scored per robot, and the fraction pruned off the
            # exhaustive sweep.
            if self.mapper is None \
                    or not hasattr(self.mapper, "match_stats"):
                return None
            ms = self.mapper.match_stats()
            return (
                Family("jax_mapping_match_candidates", "gauge",
                       tuple((f'{{robot="{i}"}}', str(c))
                             for i, c in enumerate(ms["candidates"]))),
                Family("jax_mapping_match_prune_ratio", "gauge",
                       tuple((f'{{robot="{i}"}}', str(r))
                             for i, r in enumerate(ms["prune_ratio"]))),
            )
        reg.add_source(match_families)

        def frontier_families():
            # Incremental frontier publish pipeline
            # (ops/frontier_incremental.py): recompute-vs-skip split,
            # tile coarse-mask cache traffic, live crop size.
            fs = (self.mapper.frontier_stats()
                  if self.mapper is not None
                  and hasattr(self.mapper, "frontier_stats") else None)
            if fs is None:
                return None
            # Recompute latency is NOT a hand-built gauge here any
            # more: the pipeline records each
            # recompute into the `frontier.recompute` stage, so it
            # reports through the one stage mechanism — the
            # `jax_mapping_stage_frontier_recompute_ms` summary and
            # `..._seconds` fixed log-bucket histogram families below.
            # `/status.frontier.last_recompute_ms` keeps the one-glance
            # number.
            return [
                Family("jax_mapping_frontier_recompute_total", "counter",
                       (("", str(fs["n_recomputes"])),)),
                Family("jax_mapping_frontier_skip_total", "counter",
                       (("", str(fs["n_skips"])),)),
                Family("jax_mapping_frontier_cache_hits_total", "counter",
                       (("", str(fs["cache_hits"])),)),
                Family("jax_mapping_frontier_cache_misses_total",
                       "counter", (("", str(fs["cache_misses"])),)),
                Family("jax_mapping_frontier_crop_cells", "gauge",
                       (("", str(fs["crop_cells"])),)),
            ]
        reg.add_source(frontier_families)

        def planner_families():
            if self.planner is None \
                    or not hasattr(self.planner, "n_overlay_rebuilds"):
                return None
            return (
                Family("jax_mapping_planner_overlay_rebuilds_total",
                       "counter",
                       (("", str(self.planner.n_overlay_rebuilds)),)),
                Family("jax_mapping_planner_overlay_reuses_total",
                       "counter",
                       (("", str(self.planner.n_overlay_reuses)),)),
            )
        reg.add_source(planner_families)

        def recovery_families():
            if self.recovery is None:
                return None
            rec = self.recovery.snapshot()
            wd = rec["watchdog"]
            fams = [
                Family("jax_mapping_recovery_estimator_score", "gauge",
                       tuple((f'{{robot="{i}"}}', str(s))
                             for i, s in enumerate(wd["scores"]))),
                Family("jax_mapping_recovery_diverge_events_total",
                       "counter", (("", str(wd["n_diverge_events"])),)),
                Family("jax_mapping_recovery_readmits_total", "counter",
                       (("", str(wd["n_readmits"])),)),
                Family("jax_mapping_recovery_reloc_attempts_total",
                       "counter",
                       (("", str(rec["relocalization"]["n_attempts"])),)),
                Family("jax_mapping_recovery_reloc_verified_total",
                       "counter",
                       (("", str(rec["relocalization"]["n_verified"])),)),
                Family("jax_mapping_recovery_stuck_detections_total",
                       "counter",
                       (("", str(rec["antistuck"]["n_stuck_detections"])),
                        )),
                Family("jax_mapping_recovery_blacklisted_total",
                       "counter",
                       (("", str(rec["blacklist"]["n_blacklisted"])),)),
            ]
            pc = rec["relocalization"].get("pyramid_cache")
            if pc is not None:
                # Revision-keyed pyramid cache feeding the pruned
                # wide-window relocalizer (ops/pyramid.PyramidCache).
                fams += [
                    Family("jax_mapping_match_pyramid_cache_hits_total",
                           "counter", (("", str(pc["n_hits"])),)),
                    Family("jax_mapping_match_pyramid_cache_misses_total",
                           "counter", (("", str(pc["n_misses"])),)),
                    Family("jax_mapping_match_pyramid_cache_hit_rate",
                           "gauge", (("", f"{pc['hit_rate']:.4f}"),)),
                ]
            return fams
        reg.add_source(recovery_families)

        def http_stats_families():
            # Request-serving telemetry: per-route counters + the
            # latency histogram, snapshotted under the stats lock ONCE
            # so the exposition is internally consistent (bucket counts
            # sum to _count).
            with self._stats_lock:
                routes = dict(self.route_requests)
                lat_counts = list(self._lat_counts)
                lat_sum = self._lat_sum_s
                lat_n = self._lat_n
                n_304 = self.n_304_responses
            return (
                Family("jax_mapping_http_requests_by_route_total",
                       "counter",
                       tuple((f'{{route="{r}"}}', str(n))
                             for r, n in sorted(routes.items()))),
                Family("jax_mapping_http_request_seconds", "histogram",
                       tuple(histogram_samples(
                           self._lat_buckets_s, lat_counts, lat_sum,
                           lat_n))),
                Family("jax_mapping_http_not_modified_total", "counter",
                       (("", str(n_304)),)),
            )
        reg.add_source(http_stats_families)

        def serving_families():
            if self.serving is None:
                return None
            # Tile-store + event-channel health: hit-rates and
            # backpressure drops for the delta-serving path.
            sstats = self.serving.stats()
            fams = []
            for src in ("grid", "voxel"):
                st = sstats.get(src)
                if st is None:
                    continue
                fams += [
                    Family(f"jax_mapping_serving_{src}_revision", "gauge",
                           (("", str(st["revision"])),)),
                    Family(f"jax_mapping_serving_{src}_tiles_encoded"
                           "_total", "counter",
                           (("", str(st["n_tiles_encoded"])),)),
                    Family(f"jax_mapping_serving_{src}_tiles_clean"
                           "_total", "counter",
                           (("", str(st["n_tiles_clean_skipped"])),)),
                    Family(f"jax_mapping_serving_{src}_hint_missed"
                           "_total", "counter",
                           (("", str(st["n_hint_missed"])),)),
                ]
            ev = sstats["events"]
            fams += [
                Family("jax_mapping_serving_event_clients", "gauge",
                       (("", str(ev["n_clients"])),)),
                Family("jax_mapping_serving_events_total", "counter",
                       (("", str(ev["n_events"])),)),
                Family("jax_mapping_serving_events_dropped_total",
                       "counter", (("", str(ev["n_dropped"])),)),
            ]
            return fams
        reg.add_source(serving_families)

        def world_families():
            # Bounded-memory world (world/store.py): the governor rung
            # + pressure, tier occupancies, eviction/rehydration and
            # integrity counters — the memory-chaos observables.
            if self.mapper is None \
                    or not hasattr(self.mapper, "world_status"):
                return None
            ws = self.mapper.world_status()
            if ws is None:
                return None
            gov = ws.get("governor", {})
            fams = [
                Family("jax_mapping_world_shifts_total", "counter",
                       (("", str(ws["shifts"])),)),
                Family("jax_mapping_world_evictions_total", "counter",
                       (("", str(ws["evictions"])),)),
                Family("jax_mapping_world_rehydrated_host_total",
                       "counter", (("", str(ws["rehydrated_host"])),)),
                Family("jax_mapping_world_rehydrated_disk_total",
                       "counter", (("", str(ws["rehydrated_disk"])),)),
                Family("jax_mapping_world_tiles_lost_total", "counter",
                       (("", str(ws["lost_tiles"])),)),
                Family("jax_mapping_world_corrupt_spills_total",
                       "counter", (("", str(ws["corrupt_spills"])),)),
                Family("jax_mapping_world_host_tiles", "gauge",
                       (("", str(ws["host_tiles"])),)),
                Family("jax_mapping_world_away_tiles", "gauge",
                       (("", str(ws["away_tiles"])),)),
                Family("jax_mapping_world_device_window_bytes", "gauge",
                       (("", str(ws["device_window_bytes"])),)),
                Family("jax_mapping_world_governor_rung", "gauge",
                       (("", str(gov.get("rung", 0))),)),
                Family("jax_mapping_world_governor_pressure", "gauge",
                       (("", str(gov.get("pressure", 0.0))),)),
                Family("jax_mapping_world_governor_refused_total",
                       "counter", (("", str(gov.get("refused", 0))),)),
            ]
            spill = ws.get("spill")
            if spill is not None:
                fams += [
                    Family("jax_mapping_world_spill_tiles", "gauge",
                           (("", str(spill["tiles"])),)),
                    Family("jax_mapping_world_spill_corrupt_reads_total",
                           "counter",
                           (("", str(spill["corrupt_reads"])),)),
                ]
            return fams
        reg.add_source(world_families)

        def degraded_samples():
            with self._stats_lock:
                return [("", str(self.n_degraded_responses))]
        reg.family("jax_mapping_http_degraded_responses_total", "counter",
                   degraded_samples)
        reg.family("jax_mapping_bus_partition_dropped_total", "counter",
                   lambda: [("", str(self.bus.n_partition_dropped))])

        def global_counter_families():
            # Process-wide registry (utils/profiling.py): event counters
            # fed by the mapper/brain loops.
            from jax_mapping_torch.utils import global_metrics
            return tuple(
                Family("jax_mapping_" + name.replace(".", "_") + "_total",
                       "counter", (("", str(val)),))
                for name, val in
                sorted(global_metrics.counters.snapshot().items()))
        reg.add_source(global_counter_families)

        def stage_families():
            # Valid exposition: the summary family carries only
            # _sum/_count; derived series are their own gauges.
            from jax_mapping_torch.utils import global_metrics
            fams = []
            for name, st_ in sorted(
                    global_metrics.stages.snapshot().items()):
                base = "jax_mapping_stage_" + name.replace(".", "_")
                fams += [
                    Family(f"{base}_ms", "summary",
                           tuple(summary_samples(st_["count"],
                                                 st_["sum_ms"]))),
                    Family(f"{base}_ms_mean", "gauge",
                           (("", f"{st_['mean_ms']:.3f}"),)),
                    Family(f"{base}_ms_ewma", "gauge",
                           (("", f"{st_['ewma_ms']:.3f}"),)),
                    Family(f"{base}_ms_max", "gauge",
                           (("", f"{st_['max_ms']:.3f}"),)),
                ]
            return fams
        reg.add_source(stage_families)

        # ---- new FAMILY SOURCES (obs tier) register after the
        # historical ones, so their families render after the
        # historical tail. (Names/types/formats of historical families
        # are byte-compatible; the stage block above is NOT a frozen
        # prefix — it renders sorted over whatever stages have been
        # recorded, and the new always-on stages (brain.tick, ...)
        # interleave into that sort, exactly as a newly-recorded stage
        # always did pre-obs.) ----------------------------------------

        def bus_families():
            # Per-subscription bus health by topic:
            # the drop counters bridge/bus.py always recorded but never
            # exported, plus live queue depth — a silently lossy or
            # backed-up topic becomes a dashboard fact.
            stats = self.bus.subscription_stats()
            if not stats:
                return None
            return (
                Family("jax_mapping_bus_subscription_queue_depth",
                       "gauge",
                       tuple((f'{{topic="{t}"}}', str(s["queue_depth"]))
                             for t, s in stats.items())),
                Family("jax_mapping_bus_subscription_received_total",
                       "counter",
                       tuple((f'{{topic="{t}"}}', str(s["n_received"]))
                             for t, s in stats.items())),
                Family("jax_mapping_bus_subscription_dropped_total",
                       "counter",
                       tuple((f'{{topic="{t}"}}', str(s["n_dropped"]))
                             for t, s in stats.items())),
            )
        reg.add_source(bus_families)

        def stage_histogram_families():
            # Fixed log-bucket latency histograms per stage
            # (utils/profiling.HIST_EDGES_S): mapper tick, match, fuse,
            # publish_frontiers, serving snapshot, ... — every stage
            # gets the same bucket grid so runs compare bucket-for-
            # bucket.
            from jax_mapping_torch.utils import global_metrics
            return tuple(
                Family("jax_mapping_stage_" + name.replace(".", "_")
                       + "_seconds", "histogram",
                       tuple(histogram_samples(
                           h["edges_s"], h["buckets"], h["sum_s"],
                           h["count"])))
                for name, h in sorted(
                    global_metrics.stages.histograms().items()))
        reg.add_source(stage_histogram_families)

        def obs_families():
            from jax_mapping_torch.obs.recorder import flight_recorder
            rs = flight_recorder.stats()
            fams = [
                Family("jax_mapping_obs_recorder_events_total", "counter",
                       (("", str(rs["n_events"])),)),
                Family("jax_mapping_obs_recorder_dumps_total", "counter",
                       (("", str(rs["n_dumps"])),)),
            ]
            tracer = getattr(self.bus, "tracer", None)
            if tracer is not None:
                fams.append(Family("jax_mapping_obs_trace_spans_total",
                                   "counter",
                                   (("", str(tracer.last_seq())),)))
            return fams
        reg.add_source(obs_families)

        def devprof_families():
            # Dispatch attribution (obs/devprof.py): call counts and
            # host-time histograms per entry point (one family sliced by
            # fn label, the HIST_EDGES_S grid), recompile counters, and
            # the card's memory watermarks (family omitted on the CPU).
            if self.devprof is None:
                return None
            from jax_mapping_torch.obs.registry import (
                labeled_histogram_samples)
            hists = self.devprof.histograms()
            recs = self.devprof.recompiles()
            fams = [
                Family("jax_mapping_device_dispatch_total", "counter",
                       tuple((f'{{fn="{fn}"}}', str(h["count"]))
                             for fn, h in hists.items())),
                Family("jax_mapping_device_dispatch_seconds",
                       "histogram",
                       tuple(s for fn, h in hists.items()
                             for s in labeled_histogram_samples(
                                 f'fn="{fn}"', h["edges_s"],
                                 h["buckets"], h["sum_s"],
                                 h["count"])),
                       "Host time a call of each entry point: the "
                       "enqueue of its device work plus any host sync "
                       "inside it, not device time."),
                Family("jax_mapping_jit_recompiles_total", "counter",
                       tuple((f'{{fn="{fn}"}}', str(n))
                             for fn, n in recs.items())),
            ]
            mem = self.devprof.memory_stats()
            if mem is not None:
                fams.append(Family(
                    "jax_mapping_device_memory_bytes", "gauge",
                    tuple((f'{{device="{d}",stat="{k}"}}', str(v))
                          for d, stats in mem.items()
                          for k, v in sorted(stats.items()))))
            return fams
        reg.add_source(devprof_families)

        def checkpoint_fallback_samples():
            # Which retention slot checkpoint loads actually resumed
            # from: a silent .prev / .genNNNNNN
            # rescue becomes a dashboard fact. All slots always report
            # (absent label != zero counter).
            from jax_mapping_torch.io.checkpoint import fallback_counts
            return [(f'{{slot="{slot}"}}', str(n))
                    for slot, n in sorted(fallback_counts().items())]
        reg.family("jax_mapping_checkpoint_fallback_total", "counter",
                   checkpoint_fallback_samples)

        def tenancy_families():
            # Mission multi-tenancy (tenancy/): active/suspended/
            # evicted tenant counts, bucket capacity/occupancy and the
            # pad-slot waste fraction — ONE consistent control-plane
            # status snapshot per render. Whole block omitted when no
            # control plane is attached.
            cp = self.tenancy
            if cp is None:
                return None
            return cp.metric_families()
        reg.add_source(tenancy_families)

        def pipeline_families():
            # Freshness pipeline (obs/pipeline.py): per-hop fixed
            # log-bucket latency histograms (ONE family sliced by
            # hop/tenant labels — the devprof labeled-family idiom)
            # plus the end-to-end scan→served family. Host-mapper
            # series carry no tenant label; tenant namespaces slice
            # with `tenant="<id>"` (the tenancy serving namespaces).
            if self.pipeline is None:
                return None
            from jax_mapping_torch.obs.registry import (
                labeled_histogram_samples)
            hists = self.pipeline.histograms()
            hop_samples = []
            e2e_samples = []
            for (hop, tenant), h in sorted(hists.items()):
                if hop == "scan_to_served":
                    labels = f'tenant="{tenant}"' if tenant else None
                    if labels is None:
                        e2e_samples += histogram_samples(
                            h["edges_s"], h["buckets"], h["sum_s"],
                            h["count"])
                    else:
                        e2e_samples += labeled_histogram_samples(
                            labels, h["edges_s"], h["buckets"],
                            h["sum_s"], h["count"])
                    continue
                labels = f'hop="{hop}"' + \
                    (f',tenant="{tenant}"' if tenant else "")
                hop_samples += labeled_histogram_samples(
                    labels, h["edges_s"], h["buckets"], h["sum_s"],
                    h["count"])
            st = self.pipeline.status()
            fams = [
                Family("jax_mapping_pipeline_hop_seconds", "histogram",
                       tuple(hop_samples)),
                Family("jax_mapping_scan_to_served_seconds",
                       "histogram", tuple(e2e_samples)),
                Family("jax_mapping_pipeline_revisions_completed"
                       "_total", "counter",
                       (("", str(st["completed_revisions"])),)),
                Family("jax_mapping_pipeline_revisions_pending",
                       "gauge",
                       (("", str(st["pending_revisions"])),)),
                Family("jax_mapping_pipeline_revisions_evicted_total",
                       "counter",
                       (("", str(st["evicted_revisions"])),)),
            ]
            return fams
        reg.add_source(pipeline_families)

        def slo_families():
            # Freshness SLO engine (obs/slo.py): firing state, burn rates
            # and alert counters per objective — one consistent engine
            # snapshot per render.
            if self.slo is None:
                return None
            return self.slo.metric_families()
        reg.add_source(slo_families)

        return reg

    # -- lifecycle ----------------------------------------------------------

    def serve_thread(self) -> threading.Thread:
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        daemon=True, name="http-api")
        self._thread.start()
        return self._thread

    def shutdown(self) -> None:
        # Wake every SSE/long-poll wait first: their worker threads are
        # daemons, but the bounded loops should exit promptly rather
        # than ride out their deadlines against a closing socket.
        self._shutting_down.set()
        if self.serving is not None:
            self.serving.events.close_all()
        # server.shutdown() blocks until the serve_forever loop acknowledges
        # — calling it when the loop never started would hang forever.
        if self._thread is not None:
            self.server.shutdown()
        self.server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
