"""BENCHMARK.json against the rules its driver holds it to: keys, names
and units, lengths, bounds, paths, and a reader file for every metric."""

import json
import re

import pytest

from port_bench.harness.registry import PKG, REPO, Registry

BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")

KEYS = {
    "top": {"command", "paths", "run_seconds", "configs", "workloads",
            "end_to_end", "per_layer"},
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_are_exactly_the_contract():
    assert set(BENCH) == KEYS["top"]
    for section in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in BENCH[section]:
            extra = set(e) - KEYS[section]
            if section in ("end_to_end", "per_layer"):
                extra -= {"workloads"}
            assert set(e) >= KEYS[section] and not extra, (section, e)


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end",
                                     "per_layer"])
def test_names_and_units_use_the_allowed_characters(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
        for k in ("config", "traffic"):
            if k in e:
                assert NAME.match(e[k])
        for k in ("why", "layer", "source"):
            if k in e:
                assert _line(e[k]), (k, e[k])
        for k in e.get("reduced", []):
            assert NAME.match(k)


def test_command_paths_and_files():
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert 1 <= BENCH["run_seconds"] <= 51
    assert isinstance(BENCH["run_seconds"], int)
    for c in BENCH["configs"]:
        assert c["file"].startswith("port_bench/")
        spec = json.loads((REPO / c["file"]).read_text())
        assert spec["source"] == c["source"] and spec["reduced"] == \
            c["reduced"]
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_bounds_and_metric_rules():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e


def test_every_cell_reports_setup_another_and_a_layer():
    reg = Registry()
    configs = {c["name"] for c in BENCH["configs"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        pairs.add((w["config"], w["traffic"]))
        cell = reg.cell(w["name"])
        e2e = [m["name"] for m in cell.end_to_end]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer
        for m in cell.per_layer:
            assert m["moves"] in e2e
    assert len(pairs) == len(BENCH["workloads"])
    assert {w["config"] for w in BENCH["workloads"]} == configs


def test_every_metric_has_its_reader_file():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert (PKG / "metrics" / f"{m['name']}.py").is_file(), m["name"]


def test_no_reduced_key_is_a_width():
    for c in BENCH["configs"]:
        for k in c["reduced"]:
            assert not k.endswith(("_dim", "_rank", "_size", "_cells")), k
