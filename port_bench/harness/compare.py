"""How far the program's outputs lie from the reference's.

Both sides' outputs are trees of NamedTuples with the same field names.
Every leaf is compared, and each leaf's gap goes to one number by what
the leaf is:

* `grid_gap`: the log-odds map, the largest absolute difference;
* `scan_gap_m`: the key-scan rings (the simulated LiDAR ranges of every
  key scan), in metres;
* `pose_gap_m`: poses, graph nodes and edges, frontier targets and
  centroids, pose errors (metres, and radians for headings);
* `value_gap`: every other float leaf, relative: |a - b| / max(1, |b|);
* `mismatches`: the integer and boolean leaves (key gate, acceptance,
  loop closures, graph counts and validity, frontier labels and the
  assignment, wheel targets, lane health words), elements that differ.

A non-finite value where the reference has a finite one is an infinite
gap, and NaN against NaN counts as a gap too.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import torch

NUMBERS = ("pose_gap_m", "grid_gap", "scan_gap_m", "value_gap",
           "mismatches")

_POSE_LEAVES = ("poses", "est_poses", "last_key_poses", "edge_meas",
                "pose_err", "targets", "centroids", "pose")


def leaves(tree, path: str = "") -> Iterator[Tuple[str, object]]:
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name, sub in zip(tree._fields, tree):
            yield from leaves(sub, f"{path}.{name}" if path else name)
    else:
        yield path, tree


def kind(path: str, leaf: torch.Tensor) -> str:
    last = path.rsplit(".", 1)[-1]
    if not leaf.is_floating_point():
        return "mismatches"
    if last == "grid":
        return "grid_gap"
    if last == "scan_rings":
        return "scan_gap_m"
    if last in _POSE_LEAVES and not path.startswith("policy"):
        return "pose_gap_m"
    return "value_gap"


def gaps(program, reference) -> Dict[str, float]:
    """The five numbers of `NUMBERS` for one pair of trees."""
    out = {k: 0.0 for k in NUMBERS}
    a_leaves = dict(leaves(program))
    for path, b in leaves(reference):
        a = a_leaves.get(path)
        if not torch.is_tensor(b):
            continue
        k = kind(path, b)
        if a is None or tuple(a.shape) != tuple(b.shape) \
                or a.dtype != b.dtype:
            out["mismatches"] += max(1, b.numel())
            continue
        a = a.detach().to(b.device)
        if k == "mismatches":
            out[k] += int((a != b).sum())
            continue
        a64, b64 = a.double(), b.double()
        d = (a64 - b64).abs()
        both_inf = torch.isinf(a64) & torch.isinf(b64) & (a64 == b64)
        d = torch.where(both_inf, torch.zeros_like(d), d)
        d = torch.where(torch.isnan(d), torch.full_like(d, float("inf")), d)
        if k == "value_gap":
            scale = torch.clamp_min(b64.abs(), 1.0)
            scale = torch.where(torch.isinf(scale), torch.ones_like(scale),
                                scale)
            d = d / scale
        if d.numel():
            out[k] = max(out[k], float(d.max()))
    return out


def _map(fn, tree):
    if isinstance(tree, tuple):
        return type(tree)(*(_map(fn, x) for x in tree)) \
            if hasattr(tree, "_fields") else tuple(_map(fn, x) for x in tree)
    return fn(tree)


def host_like(tree, pinned: bool):
    """Empty host tensors shaped as the tensor leaves of `tree` (page-
    locked where `pinned`, so that a copy into them does not hold the
    host); other leaves are kept as they are."""
    return _map(lambda x: torch.empty(x.shape, dtype=x.dtype,
                                      pin_memory=pinned)
                if torch.is_tensor(x) else x, tree)


def copy_into(dst, src) -> None:
    """Copy every tensor leaf of `src` into `dst` (a `host_like` tree),
    without waiting for the device: the copies run in stream order, and
    the host reads `dst` only after a synchronisation."""
    if isinstance(src, tuple):
        for d, s in zip(dst, src):
            copy_into(d, s)
    elif torch.is_tensor(src):
        dst.copy_(src, non_blocking=True)


def to_device(tree, device):
    """`tree` with its tensor leaves on `device`."""
    return _map(lambda x: x.to(device) if torch.is_tensor(x) else x, tree)


def worst(readings) -> Dict[str, float]:
    """Each number's largest value over several comparisons."""
    out = {k: 0.0 for k in NUMBERS}
    for r in readings:
        for k in NUMBERS:
            out[k] = max(out[k], r[k])
    return out


def as_reference(tree, ref_types: dict):
    """Rebuild a program tree with the reference's NamedTuple types, by
    type name (the same field names on both sides); leaves are shared."""
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        cls = ref_types[type(tree).__name__]
        return cls(*(as_reference(x, ref_types) for x in tree))
    return tree
