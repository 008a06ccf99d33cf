"""Mission multi-tenancy: many independent missions on one card.

Port of the JAX package's `tenancy` package, in part:

* `megabatch`   TenantBatch (missions stacked along a leading, bucketed
                tenant axis), `megabatch_step` / `megabatch_tick` (one
                launch chain a tick for every mission, closure ticks
                through the solo `fleet_step`) and the lane-health word.
* `lanehealth`  LaneHealthLadder: healthy -> suspect -> quarantined
                hysteresis over the health words, host Python.
* `journal`     ControlJournal: the append-only CRC-per-record lifecycle
                journal and its compaction snapshot (a copy of the JAX
                package's, byte for byte).
* `controlplane` TenantControlPlane: admit / suspend / resume / evict,
                bucket growth and compaction, the admission pre-warm,
                per-tenant serving namespaces, lane-health quarantine,
                checkpoints and crash restore; one CPU generator per
                tenant draws its noise.
"""

from jax_mapping_torch.tenancy.lanehealth import (  # noqa: F401
    HEALTHY, QUARANTINED, SUSPECT, LaneHealthLadder,
)
from jax_mapping_torch.tenancy.journal import (  # noqa: F401
    ControlJournal, read_registry,
)
from jax_mapping_torch.tenancy.megabatch import (  # noqa: F401
    EXACT_BUCKETS, HEALTH_MATCH_FLOOR, HEALTH_NONFINITE, HEALTH_POSE_JUMP,
    TenantBatch, bucket_capacity, lane_health_host, lane_state,
    make_tenant_batch, megabatch_step, megabatch_tick, stack_states,
    windowed_mission_config,
)
from jax_mapping_torch.tenancy.controlplane import (  # noqa: F401
    MEGABATCH_ENTRY, AdmissionRejected, TenantControlPlane,
)
