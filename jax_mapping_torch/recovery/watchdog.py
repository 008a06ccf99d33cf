"""Divergence watchdog: per-robot estimator health from the SlamDiag stream.

A copy of the JAX package's `recovery/watchdog.py` (host Python; it
imports only the config). The watchdog folds each robot's per-scan
observations into one score with hysteresis, so a robot whose matcher
quietly diverges (wheel slip, a miscalibrated lidar, ghost returns) is
declared lost instead of fusing garbage into the shared map.

Score: an EWMA of per-observation badness

    bad = agreement_weight * min(1, (1 - agreement) / deficit_scale)
        + match_weight     * (1 - matched)     [key steps only]
        + cov_weight       * min(1, cov_trace / cov_scale_m2)

observed at full scan cadence: key steps carry the SlamDiag's pre-fusion
agreement and the match telemetry; sub-gate steps sample
`models.slam.scan_agreement` at the post-step pose. The match term is
charged only after `min_keyscans` key observations (an empty map rejects
legitimately at bootstrap).

Hysteresis: `diverge_persist_steps` consecutive observations at or above
`diverge_threshold` declare DIVERGED. There is no score-based exit: a
quarantined robot's steps are not run, so re-admission comes only from a
verified relocalization (`readmit`). The JAX package also writes the
re-admission to its flight recorder; the port has no such recorder yet.

Threading: a leaf lock (no method calls out while holding it).
"""

from __future__ import annotations

import threading
from typing import List, Optional

from jax_mapping_torch.config import RecoveryConfig

#: Watchdog states (per robot).
HEALTHY = "healthy"
DIVERGED = "diverged"


class EstimatorWatchdog:
    """Fold SlamDiag observations into per-robot divergence state."""

    def __init__(self, cfg: RecoveryConfig, n_robots: int):
        self.cfg = cfg
        self.n_robots = n_robots
        self._lock = threading.Lock()
        self._score = [0.0] * n_robots
        self._streak = [0] * n_robots          # consecutive over-threshold
        self._n_obs = [0] * n_robots
        self._n_key_obs = [0] * n_robots       # match-term grace clock
        self._state = [HEALTHY] * n_robots
        #: (n_obs at transition, robot, old, new).
        self.transitions: List[tuple] = []
        self.n_diverge_events = 0
        self.n_readmits = 0

    def observe(self, robot: int, key: bool, matched: bool,
                agreement: float,
                cov_trace: Optional[float] = None) -> bool:
        """One per-scan observation; returns True when this observation
        DECLARES divergence (the caller then quarantines + notifies
        FleetHealth). `key` says a match actually ran this step (the
        match term is only meaningful there); cov_trace None = no
        accepted match (the covariance carries no information; the
        match term already charges for the rejection)."""
        c = self.cfg
        deficit = 1.0 - min(1.0, max(0.0, agreement))
        scale = max(c.agreement_deficit_scale, 1e-6)
        bad = c.agreement_weight * min(1.0, deficit / scale)
        with self._lock:
            self._n_obs[robot] += 1
            if key:
                self._n_key_obs[robot] += 1
                if not matched \
                        and self._n_key_obs[robot] > c.min_keyscans:
                    bad += c.match_weight
                if matched and cov_trace is not None \
                        and c.cov_scale_m2 > 0.0:
                    bad += c.cov_weight * min(1.0,
                                              cov_trace / c.cov_scale_m2)
            self._score[robot] = (c.score_decay * self._score[robot]
                                  + (1.0 - c.score_decay) * bad)
            if self._state[robot] == DIVERGED:
                return False
            if self._score[robot] >= c.diverge_threshold:
                self._streak[robot] += 1
            else:
                self._streak[robot] = 0
            if self._streak[robot] >= c.diverge_persist_steps:
                self._state[robot] = DIVERGED
                self.n_diverge_events += 1
                self.transitions.append(
                    (self._n_obs[robot], robot, HEALTHY, DIVERGED))
                return True
            return False

    def observe_rejected(self, robot: int) -> bool:
        """A step the mapper rejected outright (the low-agreement
        do-no-harm floor): maximum badness — the evidence was garbage by
        the mapper's own judgement."""
        return self.observe(robot, key=True, matched=False,
                            agreement=0.0)

    def readmit(self, robot: int) -> None:
        """Verified re-anchor: back to HEALTHY with a clean score (the
        old score described the pre-relocalization chain)."""
        readmitted = False
        with self._lock:
            if self._state[robot] == DIVERGED:
                self.n_readmits += 1
                readmitted = True
                self.transitions.append(
                    (self._n_obs[robot], robot, DIVERGED, HEALTHY))
            self._state[robot] = HEALTHY
            self._score[robot] = 0.0
            self._streak[robot] = 0
        if readmitted:
            # Recorded after the lock releases: the DIVERGED->HEALTHY
            # edge closes the story the divergence dump opened.
            from jax_mapping_torch.obs.recorder import flight_recorder
            flight_recorder.record("watchdog_readmit", robot=robot)

    # -- readers -------------------------------------------------------------

    def is_diverged(self, robot: int) -> bool:
        with self._lock:
            return self._state[robot] == DIVERGED

    def states(self) -> List[str]:
        with self._lock:
            return list(self._state)

    def scores(self) -> List[float]:
        with self._lock:
            return list(self._score)

    def snapshot(self) -> dict:
        """The /status export."""
        with self._lock:
            return {
                "states": list(self._state),
                "scores": [round(s, 4) for s in self._score],
                "n_observations": list(self._n_obs),
                "n_diverge_events": self.n_diverge_events,
                "n_readmits": self.n_readmits,
            }
