"""Reading the port's own spans from a profiler trace
(`harness/spans.py`): device work by launch correlation, the device's
idle time inside a span, the idle inside an entry span that no stage
explains, the copies and syncs by span; and the key-share reader."""

import json
from types import SimpleNamespace

import pytest

from port_bench.bench_checks.test_bench_trace_read import _x
from port_bench.harness import spans as S
from port_bench.harness import trace
from port_bench.harness.registry import Registry

#: One profiled tick: a harness window and tick range, the program's
#: spans, four launches (one into each matcher part, a copy in the
#: fusion) and a synchronising call in the fusion.
HARNESS = [
    _x("user_annotation", "pb:window", 0, 1000),
    _x("user_annotation", "pb:tick", 10, 900),
    _x("user_annotation", "pb:match", 20, 380),
]
PROGRAM = [
    _x("user_annotation", "fleet.tick", 12, 878),
    _x("user_annotation", "tick.match", 20, 380),
    _x("user_annotation", "match.field", 25, 35),
    _x("user_annotation", "match.search", 60, 140),
    _x("user_annotation", "match.refine", 200, 190),
    _x("user_annotation", "tick.fuse", 400, 100),
    _x("user_annotation", "other.thread", 0, 1000, tid=2),
]
WORK = [
    _x("cuda_runtime", "cudaLaunchKernel", 30, 5, correlation=1),
    _x("cuda_runtime", "cudaLaunchKernel", 70, 5, correlation=2),
    _x("cuda_runtime", "cudaLaunchKernel", 210, 5, correlation=3),
    _x("cuda_runtime", "cudaMemcpyAsync", 410, 5, correlation=4),
    _x("cuda_runtime", "cudaStreamSynchronize", 420, 50),
    _x("kernel", "field", 100, 50, tid=7, correlation=1),
    _x("kernel", "search", 150, 150, tid=7, correlation=2),
    _x("kernel", "refine", 320, 60, tid=7, correlation=3),
    _x("gpu_memcpy", "Memcpy DtoH (Device -> Pinned)", 450, 10, tid=7,
       correlation=4),
]


def _write(tmp_path, events, name="t.json"):
    p = tmp_path / name
    p.write_text(json.dumps({"traceEvents": events}))
    return str(p)


def test_span_device_work_idle_and_waits_by_hand(tmp_path):
    r = S.read_spans(_write(tmp_path, HARNESS + PROGRAM + WORK))
    assert "other.thread" not in r.host
    # Device ms a tick: the union of each span's launches.
    assert S.device_ms_per_tick(r, "match.field", 1) == pytest.approx(0.05)
    assert S.device_ms_per_tick(r, "match.search", 1) == \
        pytest.approx(0.15)
    assert S.device_ms_per_tick(r, "match.refine", 1) == \
        pytest.approx(0.06)
    assert S.device_ms_per_tick(r, "tick.match", 2) == pytest.approx(0.13)
    assert S.device_ms_per_tick(r, "tick.frontier", 1) is None
    # Idle (0-100, 300-320, 380-450, 460-1000) inside tick.match
    # (20-400): 80 + 20 + 20 us.
    assert S.idle_ms_per_tick(r, ["tick.match"], 1) == pytest.approx(0.12)
    # Inside fleet.tick (12-890) but no stage span: 12-20 and 500-890.
    assert S.unstaged_idle_ms_per_tick(r, 1) == pytest.approx(0.398)
    assert r.waits == {"tick.fuse": {"DtoH": 1, "HtoD": 0, "sync": 1}}


def test_program_spans_change_no_field_of_the_harness_reading(tmp_path):
    names = ["tick", "match"]
    bare = trace.read_trace(_write(tmp_path, HARNESS + WORK, "a.json"),
                            names)
    both = trace.read_trace(_write(tmp_path, HARNESS + PROGRAM + WORK,
                                   "b.json"), names)
    assert bare.range_spans == both.range_spans
    assert (bare.window_s, bare.busy_s, bare.range_seconds,
            bare.device_ops) == (both.window_s, both.busy_s,
                                 both.range_seconds, both.device_ops)
    assert [s for _, s in bare.idle_gaps] == [s for _, s in both.idle_gaps]


def test_a_trace_without_program_spans_reads_nothing(tmp_path):
    r = S.read_spans(_write(tmp_path, HARNESS + WORK))
    assert r.host == {} and r.device == {}
    assert S.device_ms_per_tick(r, "match.field", 1) is None
    assert S.unstaged_idle_ms_per_tick(r, 1) is None
    assert S.read_spans(_write(tmp_path, PROGRAM, "c.json")) is None


def test_key_share_reads_the_port_counters(monkeypatch):
    from jax_mapping_torch.utils import profiling
    read = Registry().metric("match.key_share").read
    counts = profiling.Counters()
    monkeypatch.setattr(profiling.global_metrics, "counters", counts)
    assert read(SimpleNamespace()) is None          # no tick counted
    counts.inc("tick.scans_matched", 16)
    counts.inc("tick.scans_fused", 6)
    assert read(SimpleNamespace()) == pytest.approx(37.5)
