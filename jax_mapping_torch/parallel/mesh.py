"""The ('fleet', 'space') mesh over the ranks of a process group.

Axes, as in the JAX package's `parallel/mesh.py`:
  'fleet' — robots are data-parallel: sensing, matching, patch
            classification and the explorer policy never communicate;
            the map contributions merge with one all_reduce.
  'space' — the occupancy grid is split into row slabs: each rank owns a
            horizontal slab of the world (halo-free: the inverse sensor
            model is cell-local, so a slab evaluates any robot's patch
            restricted to its own rows).

The layout is row-major, rank = fleet index x n_space + space index, as
JAX's `reshape(n_fleet, n_space)` of its device list. The helpers at the
end give a rank's index along an axis, the axis's size and its process
group, the three things the sharded steps read of a mesh.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from jax_mapping_torch._util import resolve_device

AXES = ("fleet", "space")


def factor_devices(n: int) -> tuple[int, int]:
    """Split n devices into (fleet, space) as square-ish as possible,
    preferring more fleet parallelism (robot count usually exceeds the
    useful number of grid slabs)."""
    best = (n, 1)
    for space in range(1, int(math.isqrt(n)) + 1):
        if n % space == 0:
            best = (n // space, space)
    return best


def backend_for(device_type: str) -> str:
    """The process group backend of a device type: nccl for the card's
    tensors (and gloo for CPU tensors beside them, so that one process can
    hold a card mesh and a CPU mesh), gloo alone on the CPU."""
    return "cpu:gloo,cuda:nccl" if device_type == "cuda" else "gloo"


def ensure_process_group(device_type: str) -> None:
    """A single process needs no environment: without a process group,
    bring up a world-size-1 group over a local store, so that a 1 x 1
    mesh works in a plain `python -m` run as JAX's `make_mesh()` does on
    one device."""
    if dist.is_initialized():
        return
    dist.init_process_group(backend_for(device_type), store=dist.HashStore(),
                            rank=0, world_size=1)


def make_mesh(n_fleet: Optional[int] = None, n_space: Optional[int] = None,
              device_type: Optional[str] = None) -> DeviceMesh:
    """A ('fleet', 'space') DeviceMesh over every rank of the process group
    (brought up at world size 1 when there is none). device_type None is
    the CUDA card, raising without one; "cpu" when asked."""
    device_type = resolve_device(device_type).type
    ensure_process_group(device_type)
    n = dist.get_world_size()
    if n_fleet is None and n_space is None:
        n_fleet, n_space = factor_devices(n)
    elif n_fleet is None:
        n_fleet = n // n_space
    elif n_space is None:
        n_space = n // n_fleet
    if n_fleet * n_space != n:
        raise ValueError(
            f"mesh {n_fleet}x{n_space} != {n} devices available")
    if device_type == "cuda":
        # Each rank's card before the mesh's communicators come up: the
        # node-local rank's, as a launcher numbers them (ranks sharing one
        # card all take card 0).
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return mesh_from_layout(device_type,
                            torch.arange(n).reshape(n_fleet, n_space))


def mesh_from_layout(device_type: str, ranks: torch.Tensor) -> DeviceMesh:
    """A DeviceMesh with the ('fleet', 'space') axes over a 2-D rank
    layout."""
    return DeviceMesh(device_type, ranks, mesh_dim_names=AXES)


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.size(AXES.index(axis))


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's index along `axis` (JAX's `lax.axis_index`)."""
    return mesh.get_coordinate()[AXES.index(axis)]


def axis_group(mesh: DeviceMesh, axis: str):
    """The process group of this rank's row along `axis`."""
    return mesh.get_group(axis)


def gather_rows(x: torch.Tensor, mesh: DeviceMesh, axis: str
                ) -> torch.Tensor:
    """The axis's shards of x stacked along dim 0 in axis order (JAX's
    `all_gather(..., tiled=True)` on axis 0). Bool tensors travel as
    uint8."""
    n = axis_size(mesh, axis)
    src = x.to(torch.uint8) if x.dtype == torch.bool else x
    out = src.new_empty((n * src.shape[0], *src.shape[1:]))
    dist.all_gather_into_tensor(out, src.contiguous(),
                                group=axis_group(mesh, axis))
    return out.to(torch.bool) if x.dtype == torch.bool else out


def all_sum(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """x summed over the axis (JAX's `psum`), in place; returns x."""
    dist.all_reduce(x, group=axis_group(mesh, axis))
    return x
