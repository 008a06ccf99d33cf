"""roofline.frontier_labels: kernel K2 (frontier component labels) at
`ops/frontier.py::label_prop`, 2 * iters + 1 sweeps a call: the least
time of each call's work over the device time the calls launched, in %."""

from port_bench.harness import costs, readers

RANGES = {"k.frontier_labels": ["jax_mapping_torch.ops.frontier:label_prop"]}


def _capture(args, kwargs):
    mask, _seed, iters = args[:3]
    return tuple(mask.shape), 2 * int(iters) + 1


CAPTURE = {"k.frontier_labels": _capture}


def read(run):
    return readers.roofline(run, "k.frontier_labels",
                            lambda c: costs.label_prop_cost(*c))
