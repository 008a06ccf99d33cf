"""The port's stage spans and tick counters on a tiny fleet on the CPU.

`utils.profiling.span` is a no-op unless a profiler records; under one,
the fleet and megabatch ticks leave their stages in the exported trace,
nested as the tick runs them, and neither tick's numbers move. The tick
counters (`global_metrics.counters`) count what the tick matched and
fused, from values the host already holds."""

import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from jax_mapping_torch.config import tiny_config
from jax_mapping_torch.models import fleet as FL
from jax_mapping_torch.sim import world as W
from jax_mapping_torch.tenancy import megabatch as MB
from jax_mapping_torch.utils import global_metrics, span
from tests.torch_threads import one_intra_op_thread  # noqa: F401

CFG = tiny_config(2)
RES = CFG.grid.resolution_m
WORLD = torch.as_tensor(W.plank_course(256, RES, n_planks=8, seed=0))
STAGES = ("tick.sim", "tick.frontier", "tick.policy", "tick.motion",
          "tick.match", "tick.fuse", "tick.graph", "tick.finish")


@pytest.fixture(scope="module")
def mission():
    """A tiny fleet three ticks in, robot 0 due to key a scan on the
    next tick; two lanes of it for the megabatch; the next tick's
    normals."""
    g = torch.Generator().manual_seed(0)
    s = FL.init_fleet_state(CFG, device="cpu", generator=g)
    for _ in range(3):
        s, _ = FL.fleet_step(CFG, s, RES, WORLD,
                             wheel_normals=torch.randn((2, 2), generator=g))
    last_key = s.last_key_poses.clone()
    last_key[0] = 1e9
    s = s._replace(last_key_poses=last_key)
    batch = MB.make_tenant_batch([s, s], [WORLD, WORLD], [0, 1])
    return s, batch, torch.randn((2, 2), generator=g)


def _fleet(mission):
    s, _, normals = mission
    return FL.fleet_step(CFG, s, RES, WORLD, wheel_normals=normals)


def _mega(mission):
    _, batch, normals = mission
    return MB.megabatch_tick(CFG, batch, RES,
                             wheel_normals=torch.stack([normals, -normals]))


def _leaves(tree):
    if isinstance(tree, tuple):
        return [x for t in tree for x in _leaves(t)]
    return [torch.as_tensor(tree)]


def _traced(fn, path):
    """fn() under a CPU profiler started and stopped by hand; the
    result and the exported trace's annotations (name, start, end)."""
    p = profile(activities=[ProfilerActivity.CPU])
    p.start()
    out = fn()
    p.stop()
    p.export_chrome_trace(str(path))
    ev = json.loads(path.read_text())["traceEvents"]
    return out, [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in ev
                 if e.get("cat") == "user_annotation"]


def _inside(spans, inner, outer) -> bool:
    """Every `inner` span lies inside some `outer` span."""
    outs = [(s, e) for n, s, e in spans if n == outer]
    ins = [(s, e) for n, s, e in spans if n == inner]
    return bool(ins) and all(any(os <= s and e <= oe for os, oe in outs)
                             for s, e in ins)


def test_span_off_never_enters_record_function(mission, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("record_function entered with no profiler")

    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    assert span("tick.match") is span("tick.fuse")      # the shared no-op
    _fleet(mission)
    _mega(mission)


@pytest.mark.parametrize("tick", [_fleet, _mega], ids=["fleet", "mega"])
def test_outputs_bit_equal_under_a_profiler(mission, tick, tmp_path):
    plain = _leaves(tick(mission))
    traced, spans = _traced(lambda: tick(mission), tmp_path / "t.json")
    assert spans
    traced = _leaves(traced)
    assert len(plain) == len(traced)
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)


def test_fleet_trace_holds_the_stages_nested(mission, tmp_path):
    _, spans = _traced(lambda: _fleet(mission), tmp_path / "t.json")
    for stage in STAGES + ("tick.loop",):
        assert _inside(spans, stage, "fleet.tick"), stage
    for part in ("match.field", "match.search", "match.refine"):
        assert _inside(spans, part, "tick.match"), part
    for part in ("frontier.labels", "frontier.clusters", "frontier.costs",
                 "frontier.assign"):
        assert _inside(spans, part, "tick.frontier"), part


def test_megabatch_trace_holds_the_stages_nested(mission, tmp_path):
    reruns = global_metrics.counters.get("megabatch.lanes_rerun")
    _, spans = _traced(lambda: _mega(mission), tmp_path / "t.json")
    for stage in STAGES + ("megabatch.read",):
        assert _inside(spans, stage, "megabatch.tick"), stage
    assert _inside(spans, "match.search", "tick.match")
    # No lane had a closure candidate: nothing re-ran through fleet_step.
    assert global_metrics.counters.get("megabatch.lanes_rerun") == reruns
    assert not {"megabatch.rerun", "fleet.tick"} & {n for n, _, _ in spans}


def test_tick_counters_count_matched_and_fused_scans(mission):
    c = global_metrics.counters
    before = c.snapshot()

    def grew(name):
        return c.get(name) - before.get(name, 0)

    _, diag = _fleet(mission)
    assert grew("fleet.ticks") == 1
    assert grew("tick.scans_matched") == CFG.fleet.n_robots
    assert grew("tick.scans_fused") == int(diag.is_key.sum())
    assert int(diag.is_key.sum()) > 0
    _, mdiag, _ = _mega(mission)
    assert grew("megabatch.ticks") == 1
    assert grew("tick.scans_matched") == 3 * CFG.fleet.n_robots
    assert grew("tick.scans_fused") == int(diag.is_key.sum()) + \
        int(mdiag.is_key.sum())
    assert grew("tick.loop_attempts") == grew("tick.loops_closed") == 0
