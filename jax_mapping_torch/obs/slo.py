"""Freshness SLO engine: declarative objectives, burn-rate alerting.

A copy of the JAX package's `obs/slo.py` (stdlib only): the same burn
windows and transitions, recorded into the port's flight recorder.

Takes the `SloObjective` tuple declared in `ObsConfig.slo` and
evaluates it IN-PROCESS once per mapper tick over the pipeline latency
ledger (obs/pipeline.py) and the mapper's revision counter — no scrape
loop, no external alertmanager: the stack that serves the map also
knows, live, whether it is meeting its freshness budget.

Alert policy is the classic multi-window burn rate: each objective
keeps a FAST and a SLOW sliding window of per-tick breach bits; the
alert FIRES when both windows exceed their budget fractions (the fast
window says "it is burning right now", the slow window says "long
enough to matter — not one hiccup") and CLEARS when the fast window
recovers. Everything is clocked in TICKS with FIXED window sizes as
burn denominators, so two same-seed runs — including chaos runs, where
a seeded FaultPlan partition window starves the scan path — fire and
clear at the IDENTICAL step: the chaos-determinism contract extended
to alerting. (Wall-latency breach predicates like `tick_deadline_ms`
are inherently host-speed-dependent; the determinism contract covers
the tick-clocked predicates the chaos drills use.)

Fired/cleared transitions are flight-recorded (`slo_alert` events with
the objective name and tick — the postmortem stream shows WHEN the
budget broke relative to the fault windows around it), exported on
`/status.slo` and the `jax_mapping_slo_*` metric families, and
surfaced in `MissionReport.slo_alerts`.

Constructed only when `ObsConfig.enabled` AND objectives are declared
— absent both, no engine object exists anywhere (bit-exact, the
ObsConfig doctrine). Pure stdlib; no torch import.
"""

from __future__ import annotations

import collections
import threading
from typing import List, Optional, Sequence, Tuple


class _ObjectiveState:
    __slots__ = ("cfg", "fast", "slow", "n_fast", "n_slow", "firing",
                 "value", "n_fired", "n_cleared", "breach_ticks",
                 "last_fire_tick", "last_clear_tick", "silent_ticks")

    def __init__(self, cfg):
        self.cfg = cfg
        self.fast = collections.deque(maxlen=max(1,
                                                 cfg.fast_window_ticks))
        self.slow = collections.deque(maxlen=max(1,
                                                 cfg.slow_window_ticks))
        self.n_fast = 0
        self.n_slow = 0
        self.firing = False
        self.value: Optional[float] = None
        self.silent_ticks: Optional[int] = None
        self.n_fired = 0
        self.n_cleared = 0
        self.breach_ticks = 0
        self.last_fire_tick: Optional[int] = None
        self.last_clear_tick: Optional[int] = None

    def label(self) -> str:
        return self.cfg.name or self.cfg.metric


class SloEngine:
    """Evaluate declared objectives once per tick; fire/clear alerts.

    Thread contract: `evaluate` runs on the mapper tick thread; the
    HTTP plane reads `status()`/`metric_families()` from worker
    threads — all state mutates and reads under ONE `_lock`
    (racewatch-gated, analysis/protection.py).
    """

    def __init__(self, objectives: Sequence, pipeline=None,
                 tenant: str = ""):
        self._lock = threading.Lock()
        self._objs: List[_ObjectiveState] = [
            _ObjectiveState(o) for o in objectives]
        #: The pipeline ledger the freshness predicates read (may be
        #: None: freshness objectives then never breach — nothing to
        #: measure — while tick_deadline_ms still works).
        self.pipeline = pipeline
        self.tenant = tenant
        #: Bounded alert history: (tick, objective label, state).
        self._alerts: collections.deque = collections.deque(maxlen=256)
        self.n_evaluations = 0

    # -- evaluation (mapper tick thread) -------------------------------------

    def evaluate(self, tick: int, tick_ms: Optional[float] = None,
                 map_revision: Optional[int] = None) -> None:
        """One evaluation step. `tick` is the mapper's deterministic
        step clock; `tick_ms` the just-finished tick's wall duration;
        `map_revision` the mapper's current revision counter."""
        transitions: List[Tuple[int, str, str]] = []
        with self._lock:
            self.n_evaluations += 1
            for st in self._objs:
                breach = self._measure(st, tick, tick_ms, map_revision)
                st.breach_ticks += int(breach)
                if len(st.fast) == st.fast.maxlen:
                    st.n_fast -= st.fast[0]
                st.fast.append(int(breach))
                st.n_fast += int(breach)
                if len(st.slow) == st.slow.maxlen:
                    st.n_slow -= st.slow[0]
                st.slow.append(int(breach))
                st.n_slow += int(breach)
                burn_fast = st.n_fast / st.fast.maxlen
                burn_slow = st.n_slow / st.slow.maxlen
                if not st.firing and burn_fast >= st.cfg.fast_burn \
                        and burn_slow >= st.cfg.slow_burn:
                    st.firing = True
                    st.n_fired += 1
                    st.last_fire_tick = tick
                    transitions.append((tick, st.label(), "firing"))
                elif st.firing and burn_fast < st.cfg.fast_burn:
                    st.firing = False
                    st.n_cleared += 1
                    st.last_clear_tick = tick
                    transitions.append((tick, st.label(), "clear"))
            self._alerts.extend(transitions)
        # Flight-record OUTSIDE our lock (the B2 discipline: no foreign
        # code under a lock); fields are deterministic (tick, name,
        # state) so same-seed recorder streams stay diffable to zero.
        if transitions:
            from jax_mapping_torch.obs.recorder import flight_recorder
            for t, name, state in transitions:
                flight_recorder.record("slo_alert", objective=name,
                                       state=state, tick=t)

    def _measure(self, st: _ObjectiveState, tick: int,
                 tick_ms: Optional[float],
                 map_revision: Optional[int]) -> bool:
        """One objective's breach bit for this tick (caller holds
        `_lock`; the ledger has its own)."""
        cfg = st.cfg
        st.silent_ticks = None
        if cfg.metric == "scan_to_served_p99_ms":
            p99 = None if self.pipeline is None \
                else self.pipeline.p99_ms(self.tenant)
            st.value = p99
            breach = p99 is not None and p99 > cfg.threshold
            if cfg.max_silent_ticks > 0 and self.pipeline is not None:
                li = self.pipeline.last_install_tick(self.tenant)
                if li is not None:
                    st.silent_ticks = tick - li
                    if st.silent_ticks > cfg.max_silent_ticks:
                        # Ingest stall: no scan has reached the map for
                        # longer than the budget — the failure mode a
                        # completed-sample p99 is blind to (a partition
                        # produces no samples at all).
                        breach = True
            return breach
        if cfg.metric == "tile_staleness_revs":
            if map_revision is None:
                st.value = None
                return False
            last = None if self.pipeline is None \
                else self.pipeline.last_delivered(self.tenant)
            served_rev = 0 if last is None else last[1]
            st.value = float(map_revision - served_rev)
            return st.value > cfg.threshold
        if cfg.metric == "tick_deadline_ms":
            st.value = tick_ms
            return tick_ms is not None and tick_ms > cfg.threshold
        # Unknown metric: declared config is validated at construction
        # by the config tests; refuse to guess at runtime.
        st.value = None
        return False

    # -- exports (HTTP threads / missions) -----------------------------------

    def alerts(self) -> List[Tuple[int, str, str]]:
        """Bounded (tick, objective, state) transition history."""
        with self._lock:
            return list(self._alerts)

    def firing(self) -> List[str]:
        with self._lock:
            return [st.label() for st in self._objs if st.firing]

    def status(self) -> dict:
        """`/status.slo`: the whole freshness-budget picture."""
        with self._lock:
            objs = []
            for st in self._objs:
                d = {
                    "name": st.label(),
                    "metric": st.cfg.metric,
                    "threshold": st.cfg.threshold,
                    "value": (None if st.value is None
                              else round(st.value, 3)),
                    "burn_fast": round(st.n_fast / st.fast.maxlen, 4),
                    "burn_slow": round(st.n_slow / st.slow.maxlen, 4),
                    "windows_ticks": [st.fast.maxlen, st.slow.maxlen],
                    "firing": st.firing,
                    "n_fired": st.n_fired,
                    "n_cleared": st.n_cleared,
                    "breach_ticks": st.breach_ticks,
                    "last_fire_tick": st.last_fire_tick,
                    "last_clear_tick": st.last_clear_tick,
                }
                if st.silent_ticks is not None:
                    d["silent_ticks"] = st.silent_ticks
                objs.append(d)
            return {"objectives": objs,
                    "n_evaluations": self.n_evaluations,
                    "alerts": list(self._alerts)[-16:]}

    def metric_families(self):
        """`jax_mapping_slo_*` families for the /metrics registry —
        ONE consistent snapshot per render (the tenancy pattern)."""
        from jax_mapping_torch.obs.registry import Family
        with self._lock:
            rows = [(st.label(), st) for st in self._objs]
            fams = [
                Family("jax_mapping_slo_firing", "gauge",
                       tuple((f'{{objective="{n}"}}',
                              str(int(st.firing))) for n, st in rows)),
                Family("jax_mapping_slo_burn_rate_fast", "gauge",
                       tuple((f'{{objective="{n}"}}',
                              f"{st.n_fast / st.fast.maxlen:.4f}")
                             for n, st in rows)),
                Family("jax_mapping_slo_burn_rate_slow", "gauge",
                       tuple((f'{{objective="{n}"}}',
                              f"{st.n_slow / st.slow.maxlen:.4f}")
                             for n, st in rows)),
                Family("jax_mapping_slo_breach_ticks_total", "counter",
                       tuple((f'{{objective="{n}"}}',
                              str(st.breach_ticks)) for n, st in rows)),
                Family("jax_mapping_slo_alerts_fired_total", "counter",
                       tuple((f'{{objective="{n}"}}', str(st.n_fired))
                             for n, st in rows)),
                Family("jax_mapping_slo_alerts_cleared_total",
                       "counter",
                       tuple((f'{{objective="{n}"}}', str(st.n_cleared))
                             for n, st in rows)),
            ]
        return fams
