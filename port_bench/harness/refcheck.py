"""Stepping the plain reference from the program's kept states, and the
control: the reference with the matcher's correlations in bfloat16, the
precision a later change to the matcher would be tempted by, below the
configuration's float32 with TF32 off."""

from __future__ import annotations

from collections import namedtuple

from port_bench.harness import compare

Out = namedtuple("Out", "state diag")


def reference_types(R) -> dict:
    """The reference's NamedTuple types by name."""
    mods = (R["fleet"], R["thymio"], R["posegraph"], R["explorer"],
            R["frontier"], R["scan_match"])
    types = {}
    for m in mods:
        for name in dir(m):
            obj = getattr(m, name)
            if isinstance(obj, type) and issubclass(obj, tuple) \
                    and hasattr(obj, "_fields"):
                types[name] = obj
    types["Out"] = Out
    return types


def load_reference(run):
    """The reference's modules and its SlamConfig for this cell."""
    import importlib
    from port_bench.harness.driver import build_config
    names = ("config", "fleet", "thymio", "posegraph", "explorer",
             "frontier", "scan_match", "health", "_util")
    R = {n: importlib.import_module(f"port_bench.reference.{n}")
         for n in names}
    return R, build_config(R["config"], run.config)


def step_reference(R, rcfg, pre, res, world, normals, types,
                   control: bool = False):
    """One reference tick from a program state, in full float32 or, with
    `control`, with the matcher's correlations in bfloat16."""
    R["_util"].PRECISION["bf16"] = bool(control)
    try:
        st, diag = R["fleet"].fleet_step(
            rcfg, compare.as_reference(pre, types), res, world,
            wheel_normals=normals)
    finally:
        R["_util"].PRECISION["bf16"] = False
    return st, diag


def control_gaps(R, rcfg, pre, res, world, normals, types, ref) -> dict:
    """The control's numbers against the reference's tick `ref`."""
    return compare.gaps(Out(*step_reference(R, rcfg, pre, res, world,
                                            normals, types, True)), ref)
