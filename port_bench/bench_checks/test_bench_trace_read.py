"""Reading a profiler trace: device work belongs to the harness ranges
the launching thread was inside (by correlation id, not by name), busy
time is the union over streams, and the idle gaps are named by what the
host was in."""

import json

import pytest

from port_bench.harness import trace


def _x(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def test_attribution_busy_and_gaps(tmp_path):
    ev = [
        _x("user_annotation", "pb:window", 0, 1000),
        _x("user_annotation", "pb:tick", 10, 900),
        _x("user_annotation", "pb:match", 20, 100),
        _x("cuda_runtime", "cudaLaunchKernel", 30, 5, correlation=1),
        _x("cuda_runtime", "cudaLaunchKernel", 200, 5, correlation=2),
        _x("cpu_op", "aten::item", 400, 300),
        _x("kernel", "conv", 100, 200, tid=7, correlation=1),
        _x("kernel", "fold", 250, 100, tid=8, correlation=2),
        _x("kernel", "Buffer Flush", 900, 50, tid=7),
    ]
    p = tmp_path / "t.json"
    p.write_text(json.dumps({"traceEvents": ev}))
    r = trace.read_trace(str(p), ["tick", "match"])
    assert r.window_s == pytest.approx(1e-3)
    assert r.busy_s == pytest.approx(250e-6)       # (100, 350)
    assert r.range_spans["match"] == [(100.0, 300.0)]
    assert sorted(r.range_spans["tick"]) == [(100.0, 300.0), (250.0, 350.0)]
    assert r.range_seconds["tick"] == pytest.approx(300e-6)
    assert r.device_ops[0] == ("conv", pytest.approx(200e-6))
    name, secs = r.idle_gaps[0]
    assert secs == pytest.approx(650e-6) and name == "tick/aten::item"


def test_no_device_work_reads_nothing(tmp_path):
    p = tmp_path / "t.json"
    p.write_text(json.dumps([_x("user_annotation", "pb:window", 0, 10)]))
    assert trace.read_trace(str(p), ["tick"]) is None
