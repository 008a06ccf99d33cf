"""Pipeline latency ledger: per-revision freshness waypoints.

A copy of the JAX package's `obs/pipeline.py` (pure Python): the ledger
is built at launch when `cfg.obs.enabled`, and `FixedHistogram` also
serves `serving/loadgen.py`.

The question a production operator asks of a mapping service is not
"how fast is one dispatch" (obs/devprof.py answers that) but *how stale
is the map a client is looking at, and is that within budget?* —
end-to-end, across the queueing, fusion, encoding and serving hops the
per-stage timers each see only a slice of. The ledger stamps every map
revision's waypoints as they happen:

    scan enqueued   (mapper._scan_cb, the oldest scan of the step)
      → installed   (mapper._finish_step: evidence in the shared grid,
                     map_revision bumped)
      → notified    (mapper tick end: revision fanned to listeners —
                     the /map-events nudge)
      → encoded     (serving/tiles.TileStore commit: tiles re-encoded
                     at or past the revision)
      → delivered   (the first /tiles response that confirms a client
                     holds the revision — a 304 confirms exactly as a
                     body does)

and folds the hop latencies into fixed log-bucket histograms
(`utils/profiling.HIST_EDGES_S`, the stage-histogram doctrine: every
histogram in the repo shares one bucket grid so runs compare
bucket-for-bucket) plus the end-to-end `scan_to_served` family — all
exported on `/metrics`, with per-tenant slicing via the tenancy serving
namespaces (a tenant's revisions stamp under its own label).

All timestamps are the SERVER's `time.perf_counter()` — revision ages
served to clients (the `Server-Timing`-style header on /tiles) are
server monotonic deltas, never cross-host wall clocks, so a client
measures observed staleness without trusting anyone's wall clock.

A revision that is never individually served is not lost: serving any
NEWER revision completes every older pending one (a client that holds
revision N+1 is at least as fresh as N — freshness is cumulative, the
drop-to-latest event-channel argument). Completed revisions land in a
bounded record ring (`records()`) that flight-recorder dumps carry as a
`pipeline` section and `python -m jax_mapping.obs critical-path` walks
to report which hop dominated each revision's scan→served path.

Constructed only when `ObsConfig.enabled` (the Tracer gate): disabled
means no ledger object exists anywhere — bit-exact, host-side-only
either way. Pure stdlib + the profiling bucket grid; no jax import.
"""

from __future__ import annotations

import bisect
import collections
import threading
import time
from typing import Dict, List, Optional, Tuple

from jax_mapping_torch.utils.profiling import HIST_EDGES_S

#: Hop names, pipeline order. `scan_to_served` is the end-to-end family
#: (enqueue → first client delivery), reported alongside but not a hop.
HOPS: Tuple[str, ...] = ("fuse", "notify", "encode", "deliver")

#: Volatile fields of a completed-revision record: wall durations and
#: everything derived from them (which hop dominated is a timing fact).
#: `python -m jax_mapping.obs critical-path A B` diffs two same-seed
#: runs' records with these ignored on top of obs/diff.VOLATILE_FIELDS
#: — the deterministic structure (revision, tick, tenant) must match.
RECORD_VOLATILE: Tuple[str, ...] = ("hops_ms", "total_ms", "critical")


class FixedHistogram:
    """One fixed log-bucket latency histogram (HIST_EDGES_S grid) with
    bucket-based percentile estimation — the registry's histogram
    machinery as a standalone accumulator, for recorders that live
    outside the process-wide StageTimer (per-hop ledger slices, the
    loadgen's per-client request latencies). NOT thread-safe: callers
    guard it (the ledger under its `_lock`; loadgen stats are
    single-writer per client thread)."""

    __slots__ = ("buckets", "total_s", "count")

    def __init__(self) -> None:
        self.buckets = [0] * (len(HIST_EDGES_S) + 1)
        self.total_s = 0.0
        self.count = 0

    def observe(self, dt_s: float) -> None:
        self.buckets[bisect.bisect_left(HIST_EDGES_S, dt_s)] += 1
        self.total_s += dt_s
        self.count += 1

    def percentile_ms(self, p: float) -> Optional[float]:
        """Bucket-resolved percentile (upper-edge estimate, the
        conservative read a log-bucket histogram supports; the
        overflow bucket reports the last edge). None when empty."""
        if self.count == 0:
            return None
        rank = max(1, -(-self.count * p // 100))       # ceil
        cum = 0
        for k, n in enumerate(self.buckets):
            cum += n
            if cum >= rank:
                edge = HIST_EDGES_S[min(k, len(HIST_EDGES_S) - 1)]
                return edge * 1e3
        return HIST_EDGES_S[-1] * 1e3

    def summary(self) -> dict:
        return {"edges_s": HIST_EDGES_S, "buckets": list(self.buckets),
                "sum_s": self.total_s, "count": self.count}


class PipelineLedger:
    """Per-revision waypoint stamps → hop histograms + e2e samples.

    Thread contract: every stamp mutator and reader serializes on ONE
    `_lock` (racewatch-gated — see analysis/protection.py): stamps
    arrive from the mapper tick thread (installed/notified), HTTP
    worker threads (encoded via TileStore refresh, delivered on /tiles
    responses) and the tenancy stepping thread at once. All work per
    stamp is a few dict ops — orders of magnitude off the <5% tick
    overhead gate (BENCH_OBS_r03).
    """

    def __init__(self, pending_cap: int = 512, sample_window: int = 512,
                 record_cap: int = 1024, age_cap: int = 1024):
        self._lock = threading.Lock()
        #: (tenant, revision) -> waypoint stamp dict, insertion-ordered
        #: (revisions are monotone per tenant).
        self._pending: Dict[Tuple[str, int], dict] = {}
        self._pending_cap = pending_cap
        #: (hop, tenant) -> FixedHistogram; hop "scan_to_served" is the
        #: end-to-end family.
        self._hists: Dict[Tuple[str, str], FixedHistogram] = {}
        #: tenant -> bounded deque of completed e2e latencies (ms) —
        #: the SLO engine's p99 window.
        self._samples: Dict[str, collections.deque] = {}
        self._sample_window = sample_window
        self._records: collections.deque = collections.deque(
            maxlen=record_cap)
        #: tenant -> bounded {revision: install perf_counter} for the
        #: Server-Timing revision-age header (served revisions may long
        #: outlive their pending entry).
        self._ages: Dict[str, "collections.OrderedDict"] = {}
        self._age_cap = age_cap
        self._tick = 0
        #: tenant -> highest revision already notify-/encode-stamped:
        #: the per-tick `notified()` call skips the (bounded but large)
        #: pending scan when nothing new installed since the last one.
        self._notified_rev: Dict[str, int] = {}
        self._encoded_rev: Dict[str, int] = {}
        self._last_install_tick: Dict[str, int] = {}
        #: tenant -> (tick, revision) of the newest client-confirmed
        #: delivery (a 304 on the current revision counts: the client
        #: HAS it).
        self._last_delivered: Dict[str, Tuple[int, int]] = {}
        #: tenant -> serving epoch of the newest delivery: an epoch
        #: advance (supervisor restart, tenant re-admission) restarts
        #: revision numbering BELOW the old delivered mark, and
        #: without this reset the staleness objective would read
        #: negative — i.e. be blind — until the new epoch's revisions
        #: outgrew the old epoch's mark.
        self._delivered_epoch: Dict[str, int] = {}
        #: Write witness for racewatch (every mutator bumps it under
        #: `_lock`) and the one-glance stamp-volume number.
        self.n_stamps = 0
        self.n_completed = 0
        self.n_evicted = 0

    # -- stamping (mapper tick / tenancy step / HTTP threads) ----------------

    def note_tick(self, tick: int) -> None:
        """The mapper's deterministic step clock — stamps taken off the
        tick thread (deliveries) carry the tick current at that
        moment."""
        with self._lock:
            self._tick = int(tick)
            self.n_stamps += 1

    def installed(self, revision: int, enq_t: Optional[float] = None,
                  tick: Optional[int] = None, tenant: str = "",
                  ingest: bool = True) -> None:
        """Evidence installed + revision bumped. `enq_t` is the OLDEST
        fused scan's enqueue stamp (worst-case freshness); tenancy
        installs have no scan hop and pass None. `ingest=False` marks
        a content mutation that is NOT sensor ingest (a decay pass):
        it stamps the revision's age/waypoints but must not advance
        the SLO engine's ingest-stall clock — a healing pass running
        through a scan-path outage would otherwise mask the very
        silence the `max_silent_ticks` guard exists to catch (caught
        live by the verify drive: the alert flapped mid-partition on
        every decay cadence)."""
        now = time.perf_counter()
        with self._lock:
            self.n_stamps += 1
            t = int(tick) if tick is not None else self._tick
            self._pending[(tenant, int(revision))] = {
                "enq": enq_t, "install": now, "notify": None,
                "encode": None, "tick": t}
            if ingest:
                self._last_install_tick[tenant] = t
            ages = self._ages.setdefault(tenant,
                                         collections.OrderedDict())
            ages[int(revision)] = now
            # Re-inserting an existing key (a restarted epoch replays
            # old revision numbers) updates the value IN PLACE without
            # reordering — move it to the tail explicitly, or
            # `revision_age_ms(None)` (the newest-install read behind
            # /map-image and SSE headers) would keep returning the OLD
            # epoch's max revision with its pre-restart stamp forever,
            # and the LRU eviction below would evict the new epoch's
            # live keys while retaining the stale tail.
            ages.move_to_end(int(revision))
            while len(ages) > self._age_cap:
                ages.popitem(last=False)
            if enq_t is not None:
                self._observe("fuse", tenant, now - enq_t)
            # Bound the pending table: a mission nobody serves must not
            # grow host memory through the ledger watching it.
            while len(self._pending) > self._pending_cap:
                self._pending.pop(next(iter(self._pending)))
                self.n_evicted += 1

    def notified(self, revision: int, tenant: str = "") -> None:
        """Revision fanned out to listeners (mapper tick end) — marks
        every pending revision at or below it. High-water-marked: the
        mapper calls this every tick, and re-scanning the pending
        table when nothing new installed would make the idle-tick cost
        proportional to the table size."""
        now = time.perf_counter()
        with self._lock:
            self.n_stamps += 1
            # Skip ONLY the exact idle repeat (the every-tick call with
            # no new install). An equality check, not <=: a restarted
            # epoch legitimately restarts revision numbering below the
            # old mark and must scan again (already-stamped entries are
            # skipped individually).
            if revision == self._notified_rev.get(tenant):
                return
            self._notified_rev[tenant] = int(revision)
            for (tn, rev), ent in self._pending.items():
                if tn == tenant and rev <= revision \
                        and ent["notify"] is None:
                    ent["notify"] = now
                    self._observe("notify", tenant,
                                  max(0.0, now - ent["install"]))

    def encoded(self, revision: int, tenant: str = "") -> None:
        """Tile store committed a refresh at `revision`: every pending
        revision at or below it is now re-encoded (or superseded by
        newer content — freshness-equivalent either way)."""
        now = time.perf_counter()
        with self._lock:
            self.n_stamps += 1
            if revision == self._encoded_rev.get(tenant):
                return                  # exact idle repeat (see above)
            self._encoded_rev[tenant] = int(revision)
            for (tn, rev), ent in self._pending.items():
                if tn == tenant and rev <= revision \
                        and ent["encode"] is None:
                    ent["encode"] = now
                    base = ent["notify"] if ent["notify"] is not None \
                        else ent["install"]
                    self._observe("encode", tenant,
                                  max(0.0, now - base))

    def delivered(self, revision: int, tenant: str = "",
                  epoch: Optional[int] = None) -> None:
        """A client response confirmed the client holds `revision`
        (body or 304): completes every pending revision at or below it
        — the first delivery is each one's freshness endpoint.
        `epoch` is the serving restart epoch the response was stamped
        with (when the caller knows it): an advance RESETS the
        delivered mark, since the new epoch's smaller revision numbers
        are the freshest content there is. The exact idle repeat (the
        steady 304-poll case: same epoch, same revision, nothing
        pending) returns without scanning the pending table — the
        per-REQUEST path must not pay an O(pending) walk under the
        lock the mapper tick contends for."""
        now = time.perf_counter()
        with self._lock:
            self.n_stamps += 1
            if epoch is not None \
                    and epoch != self._delivered_epoch.get(tenant):
                self._delivered_epoch[tenant] = int(epoch)
                self._last_delivered.pop(tenant, None)
            mark = self._last_delivered.get(tenant)
            if mark is not None and revision == mark[1]:
                return
            done = sorted(k for k in self._pending
                          if k[0] == tenant and k[1] <= revision)
            for key in done:
                ent = self._pending.pop(key)
                base = ent["encode"] or ent["notify"] or ent["install"]
                hops = {"fuse": (None if ent["enq"] is None else
                                 (ent["install"] - ent["enq"]) * 1e3)}
                hops["notify"] = (
                    None if ent["notify"] is None else
                    max(0.0, ent["notify"] - ent["install"]) * 1e3)
                hops["encode"] = (
                    None if ent["encode"] is None else
                    max(0.0, ent["encode"]
                        - (ent["notify"] or ent["install"])) * 1e3)
                hops["deliver"] = max(0.0, now - base) * 1e3
                self._observe("deliver", tenant, max(0.0, now - base))
                start = ent["enq"] if ent["enq"] is not None \
                    else ent["install"]
                total_ms = max(0.0, now - start) * 1e3
                if ent["enq"] is not None:
                    self._observe("scan_to_served", tenant,
                                  max(0.0, now - ent["enq"]))
                    self._samples.setdefault(
                        tenant, collections.deque(
                            maxlen=self._sample_window)
                    ).append(total_ms)
                present = {h: v for h, v in hops.items()
                           if v is not None}
                self.n_completed += 1
                self._records.append({
                    "revision": key[1], "tenant": tenant,
                    "tick": ent["tick"],
                    "hops_ms": {h: round(v, 3)
                                for h, v in present.items()},
                    "total_ms": round(total_ms, 3),
                    "critical": max(present, key=present.get)})
            prev = self._last_delivered.get(tenant)
            if prev is None or revision >= prev[1]:
                self._last_delivered[tenant] = (self._tick,
                                                int(revision))

    def _observe(self, hop: str, tenant: str, dt_s: float) -> None:
        """Caller holds `_lock` (every mutator does; racewatch-gated)."""
        self._hists.setdefault((hop, tenant),
                               FixedHistogram()).observe(dt_s)

    # -- reading (SLO engine / HTTP exports / Server-Timing) -----------------

    def revision_age_ms(self, revision: Optional[int] = None,
                        tenant: str = "") -> Optional[float]:
        """Server-monotonic age of `revision`'s install (None = the
        newest installed revision) in milliseconds — the Server-Timing
        header's `age;dur=` value. None when the revision predates the
        ledger (a restore-resumed revision, a pre-obs epoch): better no
        header than a fabricated age."""
        now = time.perf_counter()
        with self._lock:
            ages = self._ages.get(tenant)
            if not ages:
                return None
            if revision is None:
                return (now - ages[next(reversed(ages))]) * 1e3
            best = None
            for rev, t in ages.items():
                if rev <= revision and (best is None or rev > best[0]):
                    best = (rev, t)
            return None if best is None else (now - best[1]) * 1e3

    def p99_ms(self, tenant: str = "") -> Optional[float]:
        """p99 over the sliding window of completed scan→served
        samples (exact over the bounded window, not bucket-resolved:
        the SLO threshold compare deserves the real value)."""
        with self._lock:
            win = self._samples.get(tenant)
            if not win:
                return None
            xs = sorted(win)
        return xs[max(0, -(-len(xs) * 99 // 100) - 1)]

    def last_install_tick(self, tenant: str = "") -> Optional[int]:
        with self._lock:
            return self._last_install_tick.get(tenant)

    def last_delivered(self, tenant: str = ""
                       ) -> Optional[Tuple[int, int]]:
        """(tick, revision) of the newest client-confirmed delivery."""
        with self._lock:
            return self._last_delivered.get(tenant)

    def histograms(self) -> Dict[Tuple[str, str], dict]:
        """(hop, tenant) -> histogram summary — the /metrics source."""
        with self._lock:
            return {k: h.summary() for k, h in self._hists.items()}

    def records(self, n: Optional[int] = None) -> List[dict]:
        """Completed-revision records, oldest first (bounded ring) —
        the flight-dump `pipeline` section / critical-path input."""
        with self._lock:
            out = [dict(r) for r in self._records]
        return out if n is None else out[-n:]

    def status(self) -> dict:
        """One-glance `/status.pipeline` summary."""
        with self._lock:
            pending = len(self._pending)
            samples = {t: len(w) for t, w in self._samples.items()}
            last_inst = dict(self._last_install_tick)
            last_del = dict(self._last_delivered)
            n_completed, n_evicted = self.n_completed, self.n_evicted
        out = {
            "pending_revisions": pending,
            "completed_revisions": n_completed,
            "evicted_revisions": n_evicted,
            "samples_windowed": samples,
            "last_install_tick": last_inst,
            "last_delivered": {t: {"tick": v[0], "revision": v[1]}
                               for t, v in last_del.items()},
        }
        p99 = self.p99_ms()
        if p99 is not None:
            out["scan_to_served_p99_ms"] = round(p99, 3)
        return out
