"""The plain reference of the fleet tick: a frozen copy of the port's
plain PyTorch paths (`models/fleet.py` and what it calls, with kernels
K1-K5 replaced by their plain versions), in float32 with TF32 off.

It imports nothing of `jax_mapping_torch`, and it takes from the program
only the state it is asked to step from, which the benchmark hands it
with the same seed-made world and wheel noise that the program got.
`_util.PRECISION` switches the matcher's correlations to bfloat16 for
the control."""
