"""match.key_share: the share of the matcher's scans whose result the
state keeps, in %: 100 x `tick.scans_fused` / `tick.scans_matched`, the
port's own counters (`utils/profiling.py::global_metrics`), over every
fleet and megabatch tick of the run's process (the warm-up's few ticks
among them). The tick matches every robot's scan; only a robot that keys
a scan keeps the match and fuses the scan."""


def read(run):
    from jax_mapping_torch.utils.profiling import global_metrics
    counts = global_metrics.counters
    matched = counts.get("tick.scans_matched")
    if not matched:
        return None
    return 100.0 * counts.get("tick.scans_fused") / matched
