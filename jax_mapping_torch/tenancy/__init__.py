"""Mission multi-tenancy: many independent missions on one card.

Port of the JAX package's `tenancy` package, in part:

* `megabatch`   TenantBatch (missions stacked along a leading, bucketed
                tenant axis), `megabatch_step` / `megabatch_tick` (one
                launch chain a tick for every mission, closure ticks
                through the solo `fleet_step`) and the lane-health word.
* `lanehealth`  LaneHealthLadder: healthy -> suspect -> quarantined
                hysteresis over the health words, host Python.

The control plane (admission, suspension, eviction, checkpoints) and its
journal are not ported yet (ROADMAP A.9).
"""

from jax_mapping_torch.tenancy.lanehealth import (  # noqa: F401
    HEALTHY, QUARANTINED, SUSPECT, LaneHealthLadder,
)
from jax_mapping_torch.tenancy.megabatch import (  # noqa: F401
    EXACT_BUCKETS, HEALTH_MATCH_FLOOR, HEALTH_NONFINITE, HEALTH_POSE_JUMP,
    TenantBatch, bucket_capacity, lane_health_host, lane_state,
    make_tenant_batch, megabatch_step, megabatch_tick, stack_states,
    windowed_mission_config,
)
