"""The metric arithmetic: the rate over the whole window, the p95 over
every tick, the union of spans, the idle gaps, the rooflines' counts
against PERF.md's `bound` column, and the range readers."""

from types import SimpleNamespace

import pytest
import torch

from port_bench.harness import costs, readers, stats
from port_bench.harness.trace import TraceReading


def test_rate_is_over_the_whole_window():
    assert stats.rate(960, 12.0) == 80.0


def test_p95_is_over_every_tick():
    ms = list(range(1, 101))
    assert stats.p95(ms) == pytest.approx(95.05)
    assert stats.p95([7.0]) == 7.0
    assert stats.p95([1.0] * 94 + [100.0] * 6) == 100.0


def test_union_counts_overlaps_once():
    assert stats.union_length([(0, 2), (1, 3), (5, 6)]) == 4
    assert stats.union_length([(0, 10), (2, 3)]) == 10
    assert stats.union_length([]) == 0


def test_gaps_are_the_uncovered_parts():
    assert stats.gaps([(1, 2), (4, 5)], 0, 6) == [(0, 1), (2, 4), (5, 6)]
    assert stats.gaps([(0, 6)], 0, 6) == []


def _full_range_poses(B, P, res):
    """B poses at the centre of their own 640-cell (32 m) patch on the
    default grid: the cells within 12 m are the disc's."""
    origin = torch.zeros((B, 2), dtype=torch.int32)
    c = (P / 2) * res - 0.5 * 4096 * res
    poses = torch.tensor([[c, c, 0.0]] * B)
    return poses, origin


@pytest.mark.parametrize("B, bound_ms", [(168, 0.0823), (64, 0.0313),
                                         (392, 0.1920), (21, 0.0103)])
def test_k1_bound_matches_perf_md(B, bound_ms):
    P, res = 640, 0.05
    poses, origins = _full_range_poses(B, P, res)
    nbytes, ops = costs.sensor_model_cost(P, res, (-102.4, -102.4), 12.0,
                                          512, poses, origins)
    assert costs.least_seconds(nbytes, ops) * 1e3 == pytest.approx(
        bound_ms, rel=5e-3)
    assert nbytes / costs.PEAK_BYTES_PER_S > ops / costs.PEAK_F32_FLOPS


def test_k1_counts_cells_within_range():
    P, res = 640, 0.05
    poses, origins = _full_range_poses(1, P, res)
    cells = costs.model_cells(P, res, (-102.4, -102.4), 12.0, poses,
                              origins)
    disc = 3.141592653589793 * (12.0 / res) ** 2
    assert cells == pytest.approx(disc, rel=2e-3)


@pytest.mark.parametrize("shape, sweeps, bound_ms", [
    ((256, 256), 49, 0.00043), ((3, 256, 256), 49, 0.00129)])
def test_k2_bound_matches_perf_md(shape, sweeps, bound_ms):
    assert costs.least_seconds(*costs.label_prop_cost(shape, sweeps)) \
        * 1e3 == pytest.approx(bound_ms, rel=1e-2)


@pytest.mark.parametrize("mask, init, sweeps, bound_ms", [
    ((1024, 1024), (1, 1024, 1024), 1025, 0.2727),
    ((256, 256), (1, 256, 256), 257, 0.00427),
    ((256, 256), (8, 256, 256), 257, 0.0342)])
def test_k3_bound_matches_perf_md(mask, init, sweeps, bound_ms):
    assert costs.least_seconds(*costs.relax_cost(mask, init, sweeps)) \
        * 1e3 == pytest.approx(bound_ms, rel=1e-2)


def _run(reading, ticks=4, captures=None):
    return SimpleNamespace(reading=reading, profiled_ticks=ticks,
                           captures=captures or {})


def test_range_reader_is_union_per_tick_and_none_without_spans():
    r = TraceReading(window_s=1.0, busy_s=0.5,
                     range_spans={"match": [(0, 1000), (500, 3000)],
                                  "fuse": []},
                     range_seconds={"match": 0.0035})
    assert readers.range_ms_per_tick(_run(r), "match") == pytest.approx(
        3.0 / 4)
    assert readers.range_ms_per_tick(_run(r), "fuse") is None
    assert readers.range_ms_per_tick(_run(None), "match") is None


def test_roofline_is_least_over_measured_and_never_zero_for_nothing():
    r = TraceReading(window_s=1.0, busy_s=0.5, range_spans={"k": [(0, 1)]},
                     range_seconds={"k": 2e-6})
    run = _run(r, captures={"k": [1, 1]})
    v = readers.roofline(run, "k", lambda c: (3.35e6, 0))   # 1 us each
    assert v == pytest.approx(100.0)
    assert readers.roofline(_run(r), "k", lambda c: (1, 1)) is None
