"""The reference against the port at `tiny_config` on the CPU: from the
same seed-made inputs, every leaf of every tick's state and diagnostics
is equal, and so is the initial state."""

import pytest
import torch

from port_bench.bench_checks import tinybench
from port_bench.harness import compare, worlds
from port_bench.harness.refcheck import Out, reference_types
from port_bench.harness.driver import build_config


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 9])
def test_reference_equals_port_tick_by_tick(seed):
    import importlib
    from jax_mapping_torch import config as PC
    from jax_mapping_torch.models import fleet as FL
    R = {n: importlib.import_module(f"port_bench.reference.{n}")
         for n in ("config", "fleet", "thymio", "posegraph", "explorer",
                   "frontier", "scan_match")}
    spec = tinybench.CONFIGS["tiny2"]
    cfg, rcfg = build_config(PC, spec), build_config(R["config"], spec)
    types = reference_types(R)
    g = torch.Generator().manual_seed(seed)
    u = torch.rand(2, generator=g)
    world = torch.as_tensor(worlds.rooms_wide_doors(256, 0.05, 1.0, seed))
    st = FL.init_fleet_state(cfg, device="cpu", radius_uniforms=u)
    ref = R["fleet"].init_fleet_state(rcfg, device="cpu", radius_uniforms=u)
    assert compare.gaps(st, ref) == {k: 0.0 for k in compare.NUMBERS}
    for _ in range(4):
        n = torch.randn((2, 2), generator=g)
        st2, d2 = FL.fleet_step(cfg, st, 0.05, world, wheel_normals=n)
        r2, rd = R["fleet"].fleet_step(rcfg, compare.as_reference(st, types),
                                       0.05, world, wheel_normals=n)
        assert compare.gaps(Out(st2, d2), Out(r2, rd)) == \
            {k: 0.0 for k in compare.NUMBERS}
        st = st2


def test_gaps_sort_leaves_by_kind():
    from collections import namedtuple
    T = namedtuple("T", "grid scan_rings est_poses costs is_key")
    a = T(torch.zeros(3), torch.zeros(2), torch.zeros(2), torch.ones(2),
          torch.tensor([True, False]))
    b = T(torch.tensor([0.0, 0.5, 0.0]), torch.tensor([0.0, 0.25]),
          torch.tensor([0.125, 0.0]), torch.tensor([1.0, 4.0]),
          torch.tensor([True, True]))
    g = compare.gaps(a, b)
    assert g == {"grid_gap": 0.5, "scan_gap_m": 0.25, "pose_gap_m": 0.125,
                 "value_gap": 0.75, "mismatches": 1}
    nan = T(torch.full((3,), float("nan")), *b[1:])
    assert compare.gaps(nan, b)["grid_gap"] == float("inf")
