"""frontier.device_ms_per_tick: device time a tick launched inside
frontiers, their clusters, the cost-to-go fields and the assignment (the
union of the spans of the device work launched while the host was inside
these functions), over the profiled ticks."""

from port_bench.harness import readers

RANGES = {"frontier": [
    "jax_mapping_torch.ops.frontier:compute_frontiers",
    "jax_mapping_torch.ops.costfield:cost_fields"]}


def read(run):
    return readers.range_ms_per_tick(run, "frontier")
