"""match.device_ms_per_tick: device time a tick launched inside the batched
correlative scan matcher (the union of the spans of the device work
launched while the host was inside these functions), over the profiled
ticks."""

from port_bench.harness import readers

RANGES = {"match": [
    "jax_mapping_torch.ops.scan_match:match_batch"]}


def read(run):
    return readers.range_ms_per_tick(run, "match")
