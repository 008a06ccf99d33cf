"""Multi-host bring-up: the process group and the hybrid mesh.

Port of the JAX package's `parallel/distributed.py`, on
`torch.distributed`:

  * `DistConfig.from_env()` — coordinator, process count and process id
    from the `JAX_MAPPING_COORDINATOR` / `_NUM_PROCESSES` / `_PROCESS_ID`
    names the JAX package reads, falling back to torch's launcher names
    (`MASTER_ADDR:MASTER_PORT`, `WORLD_SIZE`, `RANK`, as torchrun sets
    them);
  * `initialize()` — idempotent `init_process_group` (nccl on the card,
    gloo on the CPU), a no-op at one process so that every entry point can
    call it unconditionally;
  * `hybrid_fleet_mesh()` — a ('fleet', 'space') mesh whose 'fleet' axis
    spans hosts and whose 'space' axis stays inside a host: the fleet
    axis communicates once a step (the all_reduce of the map deltas),
    while the space axis gathers the matcher's context inside the step's
    critical path, so it must stay on the host's own links.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Optional

import torch
import torch.distributed as dist

from jax_mapping_torch.parallel.mesh import (backend_for, factor_devices,
                                             make_mesh, mesh_from_layout)


@dataclasses.dataclass(frozen=True)
class DistConfig:
    """Process-group wiring."""

    coordinator_address: Optional[str] = None   # "host:port"
    num_processes: int = 1
    process_id: int = 0

    @staticmethod
    def from_env(env=None) -> "DistConfig":
        """JAX_MAPPING_COORDINATOR / _NUM_PROCESSES / _PROCESS_ID, falling
        back to torch's launcher names (MASTER_ADDR:MASTER_PORT,
        WORLD_SIZE, RANK)."""
        e = os.environ if env is None else env

        def pick(*names, default=None):
            for n in names:
                if e.get(n):
                    return e[n]
            return default

        coord = pick("JAX_MAPPING_COORDINATOR")
        if coord is None and e.get("MASTER_ADDR"):
            coord = e["MASTER_ADDR"] + (f":{e['MASTER_PORT']}"
                                        if e.get("MASTER_PORT") else "")
        nproc = int(pick("JAX_MAPPING_NUM_PROCESSES", "WORLD_SIZE",
                         default="1"))
        pid = int(pick("JAX_MAPPING_PROCESS_ID", "RANK", default="0"))
        return DistConfig(coordinator_address=coord, num_processes=nproc,
                          process_id=pid)


def initialize(cfg: Optional[DistConfig] = None,
               device: Optional[str] = None) -> bool:
    """Bring up the process group; returns True if multi-process.

    Idempotent; a single-process config is a no-op. `device` "cpu" takes
    gloo, anything else (None: the card) nccl. A multi-process config
    without a coordinator raises: degrading to independent processes
    would skip the fleet's map merge and every process would build its
    own divergent map with no error."""
    cfg = cfg or DistConfig.from_env()
    if cfg.num_processes <= 1:
        return False
    if cfg.coordinator_address is None:
        raise ValueError(
            f"num_processes={cfg.num_processes} but no coordinator address "
            f"set (JAX_MAPPING_COORDINATOR / MASTER_ADDR)")
    if dist.is_initialized():
        return True
    dist.init_process_group(
        backend_for("cpu" if device == "cpu" else "cuda"),
        init_method=f"tcp://{cfg.coordinator_address}",
        world_size=cfg.num_processes, rank=cfg.process_id)
    return True


def hybrid_layout(n_hosts: int, space_per_host: int,
                  local_ranks: int) -> torch.Tensor:
    """The (n_hosts * local_ranks / space_per_host, space_per_host) rank
    layout of a hybrid mesh: ranks are numbered host-major (a launcher
    gives host h ranks h * local_ranks ...), so each 'space' row is a run
    of one host's ranks and the 'fleet' axis crosses hosts."""
    if local_ranks % space_per_host:
        raise ValueError(f"{local_ranks} local devices not divisible by "
                         f"space_per_host={space_per_host}")
    fleet_per_host = local_ranks // space_per_host
    return torch.arange(n_hosts * local_ranks).reshape(
        n_hosts * fleet_per_host, space_per_host)


def hybrid_fleet_mesh(n_hosts: Optional[int] = None,
                      space_per_host: Optional[int] = None,
                      local_ranks: Optional[int] = None,
                      device_type: Optional[str] = None):
    """('fleet', 'space') mesh with fleet across hosts and space within a
    host. `local_ranks` is the rank count of one host (None: torchrun's
    LOCAL_WORLD_SIZE, else the whole world). One host degrades to the
    local factoring (`make_mesh`)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    if local_ranks is None:
        local_ranks = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if n_hosts is None:
        n_hosts = max(1, world // local_ranks)
    if n_hosts <= 1:
        return make_mesh(device_type=device_type)
    if space_per_host is None:
        _, space_per_host = factor_devices(local_ranks)
    layout = hybrid_layout(n_hosts, space_per_host, local_ranks)
    if layout.numel() != world:
        raise ValueError(f"{n_hosts} hosts x {local_ranks} ranks != world "
                         f"size {world}")
    from jax_mapping_torch._util import resolve_device
    return mesh_from_layout(resolve_device(device_type).type, layout)
