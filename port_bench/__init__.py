"""The benchmark of `jax_mapping_torch` on one NVIDIA H100.

`python3 -m port_bench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>` runs one cell of the repository's `BENCHMARK.json` from
the root of a checkout and prints one JSON result line. The harness
finds a cell's configuration, traffic mix, entry and per-layer metrics by
name under `configs/`, `traffic/`, `entries/` and `metrics/`;
`reference/` is a frozen plain copy of the fleet tick that decides
`correct`. Nothing here imports JAX or the JAX package.
"""
