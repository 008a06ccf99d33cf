"""Per-tenant lane-health hysteresis ladder: healthy -> suspect -> QUARANTINED.

Port of the JAX package's `tenancy/lanehealth.py`, host Python. The
megabatch's device health word (`megabatch.HEALTH_*` bits, computed in
`megabatch_step`) says what a lane produced this tick; this ladder says
what to do about it, with the `recovery/watchdog.EstimatorWatchdog`
semantics lifted from robots to tenants:

* one flagged tick demotes healthy -> SUSPECT;
* `quarantine_persist_ticks` CONSECUTIVE flagged ticks declare
  QUARANTINED (the caller then freezes the lane with the pad lanes'
  `active=False` select, an exact no-op for co-tenants);
* a clean tick returns suspect -> healthy, but no word leaves
  quarantine (a frozen lane produces no fresh evidence): re-admission
  goes only through a verified probe, `probe_due` scheduling a bounded
  number of them on the deterministic tick clock and `note_probe`
  recording the verdict.

The ladder takes no lock: its owner serialises the calls. `transitions`
is the assertion surface, as `EstimatorWatchdog.transitions` is.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from jax_mapping_torch.config import TenancyConfig

#: Ladder states (per tenant).
HEALTHY = "healthy"
SUSPECT = "suspect"
QUARANTINED = "quarantined"


class _LaneHealth:
    __slots__ = ("state", "streak", "last_word", "n_flagged",
                 "quarantined_tick", "probes_used")

    def __init__(self):
        self.state = HEALTHY
        self.streak = 0
        self.last_word = 0
        self.n_flagged = 0
        self.quarantined_tick: Optional[int] = None
        self.probes_used = 0


class LaneHealthLadder:
    """Fold per-tick health words into per-tenant containment state."""

    def __init__(self, cfg: TenancyConfig):
        self.cfg = cfg
        self._lanes: Dict[str, _LaneHealth] = {}
        #: (tick, tenant, old_state, new_state) — the guardrail-test
        #: assertion surface; deterministic across same-seed runs.
        self.transitions: List[tuple] = []
        self.n_quarantines = 0
        self.n_readmits = 0
        self.n_probes = 0

    def _lane(self, tid: str) -> _LaneHealth:
        lane = self._lanes.get(tid)
        if lane is None:
            lane = self._lanes[tid] = _LaneHealth()
        return lane

    def observe(self, tid: str, word: int, tick: int) -> Optional[str]:
        """One tick's health word for `tid`. Returns QUARANTINED when
        THIS observation declares it (the caller then freezes the
        lane), else None. Quarantined lanes ignore further words —
        their lane is frozen, the word describes nothing new."""
        lane = self._lane(tid)
        if lane.state == QUARANTINED:
            return None
        if word == 0:
            lane.streak = 0
            lane.last_word = 0
            if lane.state == SUSPECT:
                lane.state = HEALTHY
                self.transitions.append((tick, tid, SUSPECT, HEALTHY))
            return None
        lane.streak += 1
        lane.last_word = word
        lane.n_flagged += 1
        if lane.state == HEALTHY:
            lane.state = SUSPECT
            self.transitions.append((tick, tid, HEALTHY, SUSPECT))
        if lane.streak >= max(1, self.cfg.quarantine_persist_ticks):
            lane.state = QUARANTINED
            lane.quarantined_tick = tick
            lane.probes_used = 0
            self.n_quarantines += 1
            self.transitions.append((tick, tid, SUSPECT, QUARANTINED))
            return QUARANTINED
        return None

    def probe_due(self, tid: str, tick: int) -> bool:
        """True when the deterministic probe schedule owes `tid` a
        re-admission probe at `tick`: every `readmit_probe_ticks`
        plane ticks after the quarantine declaration, at most
        `max_readmit_probes` times — the bounded budget that keeps a
        NaN-poisoned lane from buying a solo dispatch forever."""
        lane = self._lanes.get(tid)
        if lane is None or lane.state != QUARANTINED:
            return False
        if lane.probes_used >= max(0, self.cfg.max_readmit_probes):
            return False
        cadence = max(1, self.cfg.readmit_probe_ticks)
        elapsed = tick - (lane.quarantined_tick or 0)
        return elapsed > 0 and elapsed % cadence == 0

    def note_probe(self, tid: str, ok: bool, tick: int) -> bool:
        """Record one probe verdict. ok=True readmits (HEALTHY, clean
        streak — the watchdog `readmit` semantics) and returns True;
        the caller then re-activates the lane and bumps the tenant's
        epoch. ok=False burns one unit of the probe budget."""
        lane = self._lane(tid)
        self.n_probes += 1
        if not ok:
            lane.probes_used += 1
            return False
        lane.state = HEALTHY
        lane.streak = 0
        lane.last_word = 0
        lane.quarantined_tick = None
        lane.probes_used = 0
        self.n_readmits += 1
        self.transitions.append((tick, tid, QUARANTINED, HEALTHY))
        return True

    def mark_quarantined(self, tid: str, tick: int) -> None:
        """Re-assert a quarantine without fresh evidence (a restored
        quarantined tenant resumes its probe schedule from the restoring
        clock instead of coming back healthy)."""
        lane = self._lane(tid)
        if lane.state == QUARANTINED:
            return
        old = lane.state
        lane.state = QUARANTINED
        lane.quarantined_tick = tick
        lane.probes_used = 0
        self.transitions.append((tick, tid, old, QUARANTINED))

    def state(self, tid: str) -> str:
        lane = self._lanes.get(tid)
        return HEALTHY if lane is None else lane.state

    def forget(self, tid: str) -> None:
        """Drop a tenant's ladder entry (eviction): a later re-admission
        of the same id starts with a clean bill of health."""
        self._lanes.pop(tid, None)

    def quarantined(self) -> List[str]:
        return sorted(t for t, lane in self._lanes.items()
                      if lane.state == QUARANTINED)

    def snapshot(self) -> dict:
        """The ladder's state as a plain dict (per lane, the counters
        and the last 32 transitions)."""
        return {
            "lanes": {
                tid: {"state": lane.state, "streak": lane.streak,
                      "last_word": lane.last_word,
                      "n_flagged": lane.n_flagged,
                      "probes_used": lane.probes_used}
                for tid, lane in sorted(self._lanes.items())},
            "n_quarantines": self.n_quarantines,
            "n_readmits": self.n_readmits,
            "n_probes": self.n_probes,
            "transitions": list(self.transitions)[-32:],
        }
