"""roofline.cost_fields: kernel K3 (min-plus cost-field sweeps) at
`ops/costfield.py::sweeps`: the least time of each call's work over the
device time the calls launched, in %."""

from port_bench.harness import costs, readers

RANGES = {"k.cost_fields": ["jax_mapping_torch.ops.costfield:sweeps"]}


def _capture(args, kwargs):
    blocked, init, n_sweeps = args[:3]
    return tuple(blocked.shape), tuple(init.shape), int(n_sweeps)


CAPTURE = {"k.cost_fields": _capture}


def read(run):
    return readers.roofline(run, "k.cost_fields",
                            lambda c: costs.relax_cost(*c))
