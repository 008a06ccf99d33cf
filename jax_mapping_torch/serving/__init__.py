"""Tiled delta map distribution: the serving subsystem.

Port of the JAX package's `serving/`, with the same wire format:

* `tiles.TileStore`: revision-keyed tile cache with a quadtree overview
  pyramid; re-encodes only tiles whose content hash, computed on the
  grid's device (`ops/grid.tile_hashes`), changed.
* `events.EventChannel`: fan-out push of map-revision events with
  per-client bounded queues and drop-to-latest backpressure.
* `tiles.MapServing`: the bundle the HTTP plane mounts (2D map store,
  the voxel height map's store, the event channel).
* `client.DeltaMapClient`: reference client applying tile deltas to a
  local mosaic and enforcing revision monotonicity.
* `loadgen`: concurrent synthetic clients against a live
  `launch_sim_stack`.
"""

from jax_mapping_torch.serving.events import EventChannel, EventSubscription
from jax_mapping_torch.serving.tiles import MapServing, TileStore

__all__ = ["EventChannel", "EventSubscription", "MapServing", "TileStore"]
