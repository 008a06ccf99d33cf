"""Scripted mutable world geometry: doors that open/close, moving crowds.

A copy of the JAX package's `scenarios/dynamics.py` (host numpy): the
composed world is computed on the host exactly as there, so both packages
compose bit-equal worlds at every step; the sim node uploads it to its
device when it changes.

Everything the stack simulated before this module assumed ONE immutable
ground-truth bitmap. `WorldDynamics` makes the world itself scriptable
the way `resilience/faultplan.py` makes faults scriptable: the composed
world at step `t` is a PURE function of (base world, the set of held
door closures, the set of active crowds, t, seed) — no hidden state, so
two same-seed scenario runs raycast bit-identical scans.

Boundaries:

* `FaultPlan` world kinds (`door_close`, `crowd`) call
  `SimNode.set_door` / `SimNode.set_crowd`, which delegate here — the
  same existing-boundary doctrine as every other fault kind (no
  monkeypatching; the scenario path exercises the code a real dynamic
  world would).
* `SimNode.step` asks `world_if_changed(step)` each tick and re-uploads
  the composed bitmap only when geometry actually changed (a door
  toggled, a crowd moved). With nothing attached or nothing active the
  sim's hot path is byte-identical to the static-world stack.

Crowd paths are deterministic orbits: each crowd id gets a seeded
anchor, orbit radius, angular rate and phase from
`default_rng((seed, _CROWD_SALT, cid))`; its centre at step t follows
from t alone. An orbit (rather than a random walk) means the blob
KEEPS MOVING every step — the decaying mapper must both map it and
heal the trail it abandons.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, Iterable, List, Optional, Tuple

import numpy as np

from jax_mapping_torch.sim.world import stamp_disc

_CROWD_SALT = 0x5EED


@dataclasses.dataclass(frozen=True)
class DoorSpec:
    """One door: the half-open cell rectangle [r0, r1) x [c0, c1) a
    closure fills with wall. The BASE world carries the door OPEN (the
    generator's gap); `door_close` scenario windows occupy it."""

    name: str
    r0: int
    r1: int
    c0: int
    c1: int

    def __post_init__(self):
        if self.r1 <= self.r0 or self.c1 <= self.c0:
            raise ValueError(f"door {self.name!r}: empty rectangle "
                             f"({self.r0},{self.r1})x({self.c0},{self.c1})")


class WorldDynamics:
    """Composes the live ground-truth world from scripted mutations.

    Thread-safety: mutators (FaultPlan boundary) and the composer
    (SimNode.step) run on the deterministic step clock in stepped
    stacks, but realtime stacks drive `SimNode.step` from an executor
    thread — `_lock` keeps the door/crowd registries and the change
    flag consistent either way (leaf lock: nothing is called out under
    it)."""

    def __init__(self, base_world: np.ndarray, res_m: float,
                 doors: Iterable = (), seed: int = 0):
        self.base = np.array(np.asarray(base_world, bool), copy=True)
        self.res_m = float(res_m)
        self.seed = int(seed)
        self.doors: Dict[str, DoorSpec] = {}
        for d in doors:
            spec = d if isinstance(d, DoorSpec) else DoorSpec(**d)
            if spec.name in self.doors:
                raise ValueError(f"duplicate door name {spec.name!r}")
            n = self.base.shape[0]
            if not (0 <= spec.r0 < spec.r1 <= n
                    and 0 <= spec.c0 < spec.c1 <= self.base.shape[1]):
                raise ValueError(f"door {spec.name!r} rectangle outside "
                                 f"the {self.base.shape} world")
            self.doors[spec.name] = spec
        self._lock = threading.Lock()
        #: door name -> closed flag (FaultPlan refcounts windows; this
        #: layer only sees the composed boolean).
        self._door_closed: Dict[str, bool] = {}
        #: crowd id -> radius_m of the active blob.
        self._crowds: Dict[int, float] = {}
        #: Geometry changed since the last compose (doors/crowds
        #: toggled). Crowds additionally force a recompose every step
        #: (they move).
        self._dirty = True
        self.n_recomposes = 0

    # -- mutation boundary (SimNode.set_door / set_crowd) --------------------

    def set_door(self, name: str, closed: bool) -> None:
        if name not in self.doors:
            raise ValueError(f"unknown door {name!r} "
                             f"(registered: {sorted(self.doors)})")
        with self._lock:
            if self._door_closed.get(name, False) != bool(closed):
                self._door_closed[name] = bool(closed)
                self._dirty = True

    def set_crowd(self, cid: int, radius_m: Optional[float]) -> None:
        """Activate crowd `cid` with blob radius `radius_m`, or remove
        it (None). FaultPlan composes overlapping windows by worst
        (max radius) before calling here."""
        with self._lock:
            if radius_m is None:
                if self._crowds.pop(int(cid), None) is not None:
                    self._dirty = True
            elif self._crowds.get(int(cid)) != float(radius_m):
                self._crowds[int(cid)] = float(radius_m)
                self._dirty = True

    # -- deterministic crowd paths -------------------------------------------

    def crowd_center(self, cid: int, step: int) -> Tuple[float, float]:
        """(row, col) of crowd `cid`'s centre at step `step`: a seeded
        orbit, pure in (seed, cid, step)."""
        n = self.base.shape[0]
        rng = np.random.default_rng((self.seed, _CROWD_SALT, int(cid)))
        margin = max(4.0, 0.15 * n)
        anchor_r = rng.uniform(margin, n - margin)
        anchor_c = rng.uniform(margin, n - margin)
        orbit = rng.uniform(0.06 * n, 0.18 * n)
        rate = rng.uniform(0.05, 0.15) * rng.choice((-1.0, 1.0))
        phase = rng.uniform(0.0, 2.0 * np.pi)
        a = phase + rate * step
        return (float(anchor_r + orbit * np.sin(a)),
                float(anchor_c + orbit * np.cos(a)))

    # -- composition ---------------------------------------------------------

    def world_at(self, step: int) -> np.ndarray:
        """The composed ground-truth world at step `step` (fresh
        array; the base is never mutated)."""
        with self._lock:
            closed = [self.doors[n] for n, c in self._door_closed.items()
                      if c]
            crowds = sorted(self._crowds.items())
            self._dirty = False
            self.n_recomposes += 1
        w = self.base.copy()
        for d in closed:
            w[d.r0:d.r1, d.c0:d.c1] = True
        for cid, radius_m in crowds:
            row, col = self.crowd_center(cid, step)
            stamp_disc(w, row, col, radius_m / self.res_m)
        return w

    def world_if_changed(self, step: int) -> Optional[np.ndarray]:
        """`world_at(step)` when geometry differs from the last compose
        (a toggle landed, or any crowd is active — crowds move every
        step), else None — the SimNode hot-path gate that keeps a
        quiet scenario from re-uploading an unchanged world."""
        with self._lock:
            quiet = not self._dirty and not self._crowds
        if quiet:
            return None
        return self.world_at(step)

    def snapshot(self) -> dict:
        """Scenario observability (one dict for /status-style export
        and test assertions)."""
        with self._lock:
            return {
                "doors": dict(self._door_closed),
                "crowds": dict(self._crowds),
                "n_recomposes": self.n_recomposes,
            }


def doors_from_dicts(doors: Iterable[dict]) -> List[DoorSpec]:
    """Normalize the world generators' plain-dict door reports."""
    return [d if isinstance(d, DoorSpec) else DoorSpec(**d)
            for d in doors]
