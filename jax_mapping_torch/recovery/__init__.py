"""Estimator guardrails: divergence watchdog, relocalization, anti-stuck.

Port of the JAX package's `recovery` package:

* `watchdog`    EstimatorWatchdog: per-robot health score with hysteresis
                over the SlamDiag stream.
* `relocalize`  wide-window relocalization against the shared map (kernel
                K1 rasterises every candidate), verified by a streak of
                consistent matches before re-entry.
* `antistuck`   AntiStuckLadder + FrontierBlacklist: stuck detection and
                escalating recoveries.
* `manager`     RecoveryManager, the one handle that holds them.

Everything but the relocalizer's matches is host Python and
deterministic.
"""

from jax_mapping_torch.recovery.antistuck import (  # noqa: F401
    BACKUP, MONITOR, ROTATE, RUNGS, AntiStuckLadder, FrontierBlacklist,
)
from jax_mapping_torch.recovery.manager import RecoveryManager  # noqa: F401
from jax_mapping_torch.recovery.relocalize import (  # noqa: F401
    Relocalizer, relocalize_match,
)
from jax_mapping_torch.recovery.watchdog import (  # noqa: F401
    DIVERGED, HEALTHY, EstimatorWatchdog,
)
