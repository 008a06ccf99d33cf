"""Fleet supervision and graceful degradation.

* `health`     — FleetHealth, the shared degraded-mode state machine
                 (per-robot OK/NO_LIDAR/DEAD ladder, driver link state)
                 plus the HTTP plane's bounded-lock primitives.
* `supervisor` — Supervisor node: heartbeat monitoring, exponential-
                 backoff restart policy, auto-checkpoint cadence.
* `faultplan`  — FaultEvent/FaultPlan: scripted, seeded, reproducible
                 multi-fault missions injected at existing boundaries.
* `warmup`     — StagedWarmup: the staged restart path — restore,
                 pre-warm the entry points in priority order through the
                 io/compile_cache.py tiers, readiness-gate against the
                 compile budget, and only then re-admit the node.
"""

from jax_mapping_torch.resilience.health import (  # noqa: F401
    DEAD, DRIVER_OFFLINE, DRIVER_OK, DRIVER_RECOVERING,
    ESTIMATOR_DIVERGED, NO_LIDAR, OK,
    FleetHealth, LockTimeout, acquire_bounded,
)
from jax_mapping_torch.resilience.supervisor import (  # noqa: F401
    Heartbeater, Supervisor, beat,
)
from jax_mapping_torch.resilience.faultplan import (  # noqa: F401
    KINDS, MEMORY_KINDS, SENSOR_KINDS, TENANT_KINDS, WORLD_KINDS,
    FaultEvent, FaultPlan, random_plan,
)
from jax_mapping_torch.resilience.warmup import (  # noqa: F401
    StagedWarmup, warmup_order,
)
