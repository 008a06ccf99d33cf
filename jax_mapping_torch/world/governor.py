"""Memory-pressure governor for the sliding-window world store.

The device window is constant-size by construction (the bounded-memory
contract); what can still grow without bound is the HOST side — the
LRU of evicted tiles and its disk spill. The governor owns that
budget: watermark-driven eviction cadence plus a load-shed ladder that
degrades retention gracefully instead of letting the host OOM.

Rungs (exported on `/status.world.governor` + the
`jax_mapping_world_governor_rung` gauge):

  0  normal      — LRU below the high watermark; overflow spills the
                   coldest tile to disk (or drops it with no disk tier).
  1  shrink      — above `host_high_watermark`: the retention ring
                   shrinks (spill cadence accelerates until occupancy
                   is back under the high watermark).
  2  coarsen     — above `host_critical_watermark`: spilled tiles are
                   additionally downsampled by `retention_coarsen`
                   (lossy, bounded; rehydrate upsamples).
  3  refuse      — at/over the effective budget: NEW evictions are
                   refused admission — the tile is dropped and will
                   re-enter as unknown (degrade, never die).

Synthetic pressure (the `memory_pressure` FaultPlan kind) composes
WORST-OF across overlapping holds: each named hold contributes a
squeeze fraction, the effective budget is scaled by the max active
squeeze, and clearing one hold re-reads the remainder — the
refcount-composition doctrine of the partition/weather kinds.
"""

from __future__ import annotations

import threading
from typing import Dict

from jax_mapping_torch.config import WorldConfig

RUNG_NAMES = ("normal", "shrink", "coarsen", "refuse")


class MemoryGovernor:
    """Watermark ladder over the host evicted-tile budget."""

    def __init__(self, cfg: WorldConfig):
        self.cfg = cfg
        self._lock = threading.Lock()
        #: name -> squeeze fraction in (0, 1); worst-of composes.
        self._pressure: Dict[str, float] = {}
        self.rung = 0
        self.n_spills = 0
        self.n_drops = 0
        self.n_coarsened = 0
        self.n_refused = 0
        self.n_rung_changes = 0

    # -- synthetic pressure (FaultPlan memory_pressure) -------------------

    def hold_pressure(self, name: str, squeeze: float) -> None:
        """Arm one named squeeze hold; overlapping holds compose
        worst-of (max), the partition-refcount doctrine."""
        with self._lock:
            self._pressure[name] = float(squeeze)

    def release_pressure(self, name: str) -> None:
        with self._lock:
            self._pressure.pop(name, None)

    def pressure(self) -> float:
        with self._lock:
            return max(self._pressure.values(), default=0.0)

    # -- budget math -------------------------------------------------------

    def effective_budget(self) -> int:
        """Host tile budget after the worst active squeeze; never
        below one tile (a zero budget would divide the watermarks)."""
        return max(1, int(self.cfg.host_tile_budget
                          * (1.0 - self.pressure())))

    def target_resident(self) -> int:
        """Rung >= 1 shed target: back under the high watermark."""
        return max(1, int(self.effective_budget()
                          * self.cfg.host_high_watermark))

    def observe(self, resident_tiles: int) -> int:
        """Fold one occupancy sample into the ladder; returns the rung
        the caller must act at for THIS admission."""
        budget = self.effective_budget()
        occ = resident_tiles / budget
        if occ >= 1.0:
            rung = 3
        elif occ >= self.cfg.host_critical_watermark:
            rung = 2
        elif occ >= self.cfg.host_high_watermark:
            rung = 1
        else:
            rung = 0
        if rung != self.rung:
            self.n_rung_changes += 1
            self.rung = rung
        return rung

    def status(self) -> dict:
        # ONE lock region for the hold snapshot; the effective budget
        # recomputes from that same snapshot instead of re-entering the
        # lock via effective_budget() (which would pair a second
        # pressure reading with the first — the C2 tear class).
        with self._lock:
            holds = dict(self._pressure)
        pressure = max(holds.values(), default=0.0)
        eff = max(1, int(self.cfg.host_tile_budget * (1.0 - pressure)))
        return {
            "rung": self.rung,
            "rung_name": RUNG_NAMES[self.rung],
            "pressure": round(pressure, 4),
            "pressure_holds": len(holds),
            "budget_tiles": self.cfg.host_tile_budget,
            "effective_budget_tiles": eff,
            "spills": self.n_spills,
            "drops": self.n_drops,
            "coarsened": self.n_coarsened,
            "refused": self.n_refused,
            "rung_changes": self.n_rung_changes,
        }
