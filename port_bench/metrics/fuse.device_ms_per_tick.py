"""fuse.device_ms_per_tick: device time a tick launched inside the masked
log-odds fusion, the loop closure's re-fuse included (the union of the
spans of the device work launched while the host was inside these
functions), over the profiled ticks."""

from port_bench.harness import readers

RANGES = {"fuse": [
    "jax_mapping_torch.ops.grid:fuse_scans_masked"]}


def read(run):
    return readers.range_ms_per_tick(run, "fuse")
