"""sim.device_ms_per_tick: device time a tick launched inside simulated
LiDAR, IR proximity and the robots' motion (the union of the spans of
the device work launched while the host was inside these functions),
over the profiled ticks."""

from port_bench.harness import readers

RANGES = {"sim": [
    "jax_mapping_torch.sim.lidar:simulate_scans",
    "jax_mapping_torch.sim.lidar:ir_proximity",
    "jax_mapping_torch.sim.thymio:step_fleet"]}


def read(run):
    return readers.range_ms_per_tick(run, "sim")
