"""Finding a cell's pieces by name, and a cell whose configuration and
traffic exist only in a test."""

import json

import pytest

from port_bench.bench_checks import tinybench
from port_bench.harness.registry import PKG, Registry


def test_every_cell_resolves_by_name():
    reg = Registry()
    for w in reg.bench["workloads"]:
        cell = reg.cell(w["name"])
        assert cell.config["entry"]
        assert reg.entry(cell.config["entry"]).Entry
        names = [m["name"] for m in cell.end_to_end + cell.per_layer]
        assert "setup_s" in names
        for n in names:
            assert callable(reg.metric(n).read)


def test_missing_piece_names_the_file(tmp_path):
    reg = tinybench.write(tmp_path)
    with pytest.raises(FileNotFoundError, match="configs/nope.json"):
        reg.config("nope")


def test_cell_defined_only_in_a_test_runs(tmp_path):
    reg = tinybench.write(tmp_path)
    assert not (PKG / "configs" / "tiny2.json").exists()
    out = tinybench.run(reg, "tiny2.rooms", seed=2 ** 31 + 17)
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"robot_scans_per_s", "tick_p95_ms",
                                   "setup_s"}
    assert list(out)[-1] == "checks"
    json.dumps(out)


def test_same_seed_same_inputs(tmp_path):
    from port_bench.harness.inputs import make_inputs
    t = tinybench.TRAFFIC["tinyrooms"]
    a = make_inputs(t, 2 ** 31 + 5, 2, 3)
    b = make_inputs(t, 2 ** 31 + 5, 2, 3)
    c = make_inputs(t, 2 ** 31 + 6, 2, 3)
    assert (a.worlds[1] == b.worlds[1]).all()
    assert a.normals.equal(b.normals) and a.uniforms.equal(b.uniforms)
    assert a.check_at == b.check_at
    assert all(0 <= x < 0.9 for x in a.check_at)
    assert not a.normals.equal(c.normals)
    assert a.normals.shape == c.normals.shape
    assert not (a.worlds[0] == c.worlds[0]).all()   # floors from the seed
