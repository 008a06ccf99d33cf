"""Bounded-memory robocentric world store (`WorldConfig.windowed`).

`store.WorldStore`: a fixed-budget device window over the logical tile
lattice (a shift rolls the window; leaving tiles go to a host LRU and a
CRC-stamped disk spill, and come back when the window re-covers them);
`governor.MemoryGovernor`: the host budget's watermark ladder;
`spill.SpillStore`: the append-only CRC-framed disk tier.
`windowed=False` builds none of them."""

from jax_mapping_torch.world.governor import MemoryGovernor  # noqa: F401
from jax_mapping_torch.world.spill import SpillStore  # noqa: F401
from jax_mapping_torch.world.store import (  # noqa: F401
    WorldStore, window_slam_config,
)
