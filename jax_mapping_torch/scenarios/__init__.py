"""Scenarios: the rendezvous fleet merge.

Port of the JAX package's `scenarios` package, as far as the rendezvous
merge: two fleets with unknown relative origin detect their map overlap,
verify the implied rigid transform by streak, and merge grids and pose
graphs into one world (`rendezvous`).
"""

from jax_mapping_torch.scenarios.rendezvous import (  # noqa: F401
    RendezvousMerger, merge_fleets, merged_frontier_assignment,
    se2_apply, se2_from_pair, transform_state,
)
