"""roofline.sensor_model: kernel K1 (the inverse sensor model, in delta
and raster mode) at `ops/sensor_kernel.py::scan_deltas` and
`scan_rasters`: the least time of each call's work over the device time
the calls launched, in %."""

from port_bench.harness import costs, readers

RANGES = {"k.sensor_model": [
    "jax_mapping_torch.ops.sensor_kernel:scan_deltas",
    "jax_mapping_torch.ops.sensor_kernel:scan_rasters"]}


def _capture(args, kwargs):
    grid_cfg, scan_cfg, ranges_b, poses_b, origins_rc = args[:5]
    return (grid_cfg.patch_cells, grid_cfg.resolution_m, grid_cfg.origin_m,
            grid_cfg.max_range_m, int(ranges_b.shape[1]), poses_b.clone(),
            origins_rc.clone())


CAPTURE = {"k.sensor_model": _capture}


def read(run):
    return readers.roofline(run, "k.sensor_model",
                            lambda c: costs.sensor_model_cost(*c))
