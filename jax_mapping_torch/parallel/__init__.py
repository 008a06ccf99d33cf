"""The multi-rank mesh on `torch.distributed`: a ('fleet', 'space') mesh
of processes, the sharded fleet step and the Y-slab voxel fuse.

Port of the JAX package's `parallel/`. There one program traces a global
view over a device mesh and XLA inserts the collectives; here a rank is a
process that holds only its own shard and issues the collectives itself:
robots split along 'fleet' (their map contributions merge with one
all_reduce), the grid split in row slabs along 'space' (the matcher's
context comes from one all_gather). `python -m
jax_mapping_torch.parallel.dryrun` drives it end to end.
"""
