"""Carry fleet and single-robot SLAM state between the JAX package and
the port.

`fleet_state_from_numpy` reads a JAX-package `FleetState` whose leaves
are numpy arrays (or any object with the same attribute layout: `sim`
with `poses` and `wheel_speeds`, `graphs` with the `PoseGraph` fields, and
the top-level arrays) and builds the port's `FleetState` on a device. The
JAX state's PRNG key is dropped: the port takes its random draws as
inputs. `fleet_state_to_numpy` goes back to a port `FleetState` of numpy
arrays, the layout a test compares against the JAX side.
`slam_state_from_numpy` / `slam_state_to_numpy` do the same for a JAX
`SlamState` (its `graph` is one unbatched `PoseGraph`, as in the port).
`tenant_batch_from_numpy` / `tenant_batch_to_numpy` carry a JAX
`TenantBatch` (its states with a leading tenant axis).
`fleet_sim_state_from_numpy` carries the simulated fleet of a JAX
`bridge.sim_node.SimNode` (`sim.sim_state`: poses and wheel speeds; its
PRNG key is dropped), the other half of a JAX mission stack's state
beside its mapper's `snapshot_states()`.
`sharded_state_from_numpy` cuts one rank's shard out of the global view
of a JAX `parallel.fleet_sharded.ShardedFleetState` (its per-robot keys
are dropped), and `sharded_state_to_numpy` gathers a mesh's shards back
into that global view.
"""

from __future__ import annotations

import numpy as np
import torch

from jax_mapping_torch.models.fleet import FleetState
from jax_mapping_torch.models.slam import SlamState
from jax_mapping_torch.ops.posegraph import PoseGraph
from jax_mapping_torch.parallel import fleet_sharded as FS
from jax_mapping_torch.parallel.mesh import gather_rows
from jax_mapping_torch.sim.thymio import FleetSimState
from jax_mapping_torch.tenancy.megabatch import TenantBatch

_DTYPES = {np.dtype(np.float32): torch.float32,
           np.dtype(np.float64): torch.float32,
           np.dtype(np.int32): torch.int32,
           np.dtype(np.int64): torch.int32,
           np.dtype(np.bool_): torch.bool}


def _t(a, device) -> torch.Tensor:
    # np.ascontiguousarray would turn a 0-d leaf into shape (1,).
    a = np.asarray(a)
    if not a.flags.c_contiguous:
        a = a.copy(order="C")
    return torch.as_tensor(a, dtype=_DTYPES[a.dtype], device=device)


def fleet_sim_state_from_numpy(tree, device) -> FleetSimState:
    """A JAX FleetSimState with numpy leaves -> the port's."""
    return FleetSimState(poses=_t(tree.poses, device),
                         wheel_speeds=_t(tree.wheel_speeds, device))


def fleet_state_from_numpy(tree, device) -> FleetState:
    """A JAX FleetState with numpy leaves -> the port's FleetState."""
    g = tree.graphs
    return FleetState(
        sim=fleet_sim_state_from_numpy(tree.sim, device),
        est_poses=_t(tree.est_poses, device),
        grid=_t(tree.grid, device),
        exploring=_t(tree.exploring, device),
        last_key_poses=_t(tree.last_key_poses, device),
        graphs=PoseGraph(*(_t(getattr(g, f), device)
                           for f in PoseGraph._fields)),
        scan_rings=_t(tree.scan_rings, device),
        n_loops=_t(tree.n_loops, device),
        t=_t(tree.t, device),
    )


def fleet_state_to_numpy(state: FleetState) -> FleetState:
    """The port's FleetState -> the same structure with numpy leaves."""
    def n(x):
        return x.detach().cpu().numpy()

    return FleetState(
        sim=FleetSimState(*(n(x) for x in state.sim)),
        est_poses=n(state.est_poses), grid=n(state.grid),
        exploring=n(state.exploring),
        last_key_poses=n(state.last_key_poses),
        graphs=PoseGraph(*(n(x) for x in state.graphs)),
        scan_rings=n(state.scan_rings), n_loops=n(state.n_loops),
        t=n(state.t))


def slam_state_from_numpy(tree, device) -> SlamState:
    """A JAX SlamState with numpy leaves -> the port's SlamState."""
    g = tree.graph
    return SlamState(
        grid=_t(tree.grid, device), pose=_t(tree.pose, device),
        last_key_pose=_t(tree.last_key_pose, device),
        graph=PoseGraph(*(_t(getattr(g, f), device)
                          for f in PoseGraph._fields)),
        scan_ring=_t(tree.scan_ring, device),
        n_loops=_t(tree.n_loops, device),
        n_keyscans=_t(tree.n_keyscans, device))


def slam_state_to_numpy(state: SlamState) -> SlamState:
    """The port's SlamState -> the same structure with numpy leaves."""
    def n(x):
        return x.detach().cpu().numpy()

    return SlamState(
        grid=n(state.grid), pose=n(state.pose),
        last_key_pose=n(state.last_key_pose),
        graph=PoseGraph(*(n(x) for x in state.graph)),
        scan_ring=n(state.scan_ring), n_loops=n(state.n_loops),
        n_keyscans=n(state.n_keyscans))


def tenant_batch_from_numpy(tree, device) -> TenantBatch:
    """A JAX TenantBatch with numpy leaves (`states` a FleetState with a
    leading tenant axis, `worlds`, `keys`, `active`) -> the port's."""
    keys = np.asarray(tree.keys).astype(np.int64)
    return TenantBatch(
        states=fleet_state_from_numpy(tree.states, device),
        worlds=_t(tree.worlds, device), keys=torch.as_tensor(
            keys, device=device), active=_t(tree.active, device))


def tenant_batch_to_numpy(batch: TenantBatch) -> TenantBatch:
    """The port's TenantBatch -> the same structure with numpy leaves."""
    def n(x):
        return x.detach().cpu().numpy()

    return TenantBatch(states=fleet_state_to_numpy(batch.states),
                       worlds=n(batch.worlds), keys=n(batch.keys),
                       active=n(batch.active))


def sharded_state_from_numpy(tree, coord, mesh_shape, device
                             ) -> "FS.ShardedFleetState":
    """The shard of mesh coordinate coord = (fleet index, space index) of
    a (n_fleet, n_space) mesh, from a JAX ShardedFleetState's global view
    with numpy leaves: its R / n_fleet robots (graphs and rings too), its
    slab of N / n_space grid rows, `t` replicated."""
    (f, s), (n_fleet, n_space) = coord, mesh_shape

    def robots(a):
        a = np.asarray(a)
        n = a.shape[0] // n_fleet
        return _t(a[f * n:(f + 1) * n], device)

    grid = np.asarray(tree.grid)
    rows = grid.shape[0] // n_space
    g = tree.graphs
    return FS.ShardedFleetState(
        **{k: robots(getattr(tree, k)) for k in FS.FLEET_FIELDS},
        grid=_t(grid[s * rows:(s + 1) * rows], device),
        graphs=PoseGraph(*(robots(getattr(g, k))
                           for k in PoseGraph._fields)),
        t=_t(tree.t, device))


def sharded_state_to_numpy(state: "FS.ShardedFleetState", mesh
                           ) -> "FS.ShardedFleetState":
    """The global view of a mesh's shards, with numpy leaves, on every
    rank: robot leaves gathered along 'fleet', the grid along 'space'
    (collectives: every rank of the mesh must call it)."""
    def n(x, axis):
        return gather_rows(x, mesh, axis).detach().cpu().numpy()

    return FS.ShardedFleetState(
        **{k: n(getattr(state, k), "fleet") for k in FS.FLEET_FIELDS},
        grid=n(state.grid, "space"),
        graphs=PoseGraph(*(n(x, "fleet") for x in state.graphs)),
        t=state.t.detach().cpu().numpy())
