"""The sharded 3D voxel fuse: the grid split into Y slabs along 'space'.

Port of the JAX package's `parallel/voxel_sharded.py`. The voxel model is
voxel-local (a per-voxel computation and one depth-image lookup), so each
rank evaluates every image restricted to its own (Z, Y / n_space, X)
slab: no halo and no exchange along 'space'. The depth images are small
and replicated; 'fleet' (when > 1) splits the image batch, and one
all_reduce along 'fleet' merges the batch shards' slab deltas, after
which the slab is clipped once (the window semantics of a batch fuse).

The engine is chosen once, from the config, as the JAX package chooses
it: `voxel_kernel.region_supported` for the slab's (Y / n_space, X)
region selects the region route (`voxel_kernel.region_delta`, kernel K7
on the card, its plain version on the CPU); otherwise the images'
`voxel.classify_region` deltas are summed in b order. A failure never
changes the engine.
"""

from __future__ import annotations

from typing import Callable

import torch

from jax_mapping_torch.config import DepthCamConfig, VoxelConfig
from jax_mapping_torch.ops import voxel as V
from jax_mapping_torch.ops import voxel_kernel as VKK
from jax_mapping_torch.parallel.fleet_sharded import mesh_device
from jax_mapping_torch.parallel.mesh import all_sum, axis_index, axis_size


def slab_rows(vox: VoxelConfig, mesh) -> int:
    """Y rows of one rank's slab; raises when 'space' does not divide
    the grid's Y extent."""
    n_space = axis_size(mesh, "space")
    if vox.size_y_cells % n_space:
        raise ValueError(
            f"size_y_cells={vox.size_y_cells} not divisible by the "
            f"'space' axis ({n_space})")
    return vox.size_y_cells // n_space


def init_sharded_voxel_grid(vox: VoxelConfig, mesh) -> torch.Tensor:
    """This rank's all-unknown (Z, Y / n_space, X) slab."""
    return torch.zeros((vox.size_z_cells, slab_rows(vox, mesh),
                        vox.size_x_cells), dtype=torch.float32,
                       device=mesh_device(mesh))


def uses_region_kernel(vox: VoxelConfig, cam: DepthCamConfig, mesh) -> bool:
    """The engine `make_voxel_fuse_step` takes on this mesh: True for the
    region route (K7), False for the classify_region sum."""
    return VKK.region_supported(vox, cam, slab_rows(vox, mesh),
                                vox.size_x_cells)


def make_voxel_fuse_step(vox: VoxelConfig, cam: DepthCamConfig, mesh
                         ) -> Callable[[torch.Tensor, torch.Tensor,
                                        torch.Tensor], torch.Tensor]:
    """This rank's fuse: (grid_slab, depths_b, poses_b) -> grid_slab.

    depths_b (B, H, W) and poses_b (B, 3) [x, y, yaw] are the whole
    batch, the same on every rank; B must divide by the 'fleet' axis,
    and this rank fuses its fleet shard's B / n_fleet images."""
    V._check_patch_coverage(vox, cam)
    n_fleet = axis_size(mesh, "fleet")
    rows = slab_rows(vox, mesh)
    y0 = axis_index(mesh, "space") * rows
    f = axis_index(mesh, "fleet")
    use_kernel = uses_region_kernel(vox, cam, mesh)

    def fuse(grid: torch.Tensor, depths_b: torch.Tensor,
             poses_b: torch.Tensor) -> torch.Tensor:
        B = depths_b.shape[0]
        if B % n_fleet:
            raise ValueError(
                f"batch {B} not divisible by the 'fleet' axis ({n_fleet})")
        b = B // n_fleet
        depths = depths_b[f * b:(f + 1) * b].contiguous()
        poses = poses_b[f * b:(f + 1) * b].contiguous()
        if use_kernel:
            delta = VKK.region_delta(vox, cam, depths, poses, y0, rows,
                                     vox.size_x_cells)
        else:
            delta = torch.zeros_like(grid)
            for depth, pose in zip(depths, poses):
                pos, R = V.camera_pose(pose[0], pose[1], pose[2], cam)
                delta = delta + V.classify_region(
                    vox, cam, depth, pos, R, y0, 0, rows, vox.size_x_cells)
        delta = all_sum(delta.contiguous(), mesh, "fleet")
        return torch.clamp(grid + delta, vox.logodds_min, vox.logodds_max)

    return fuse
