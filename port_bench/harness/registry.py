"""Find a cell's pieces by name.

A cell (an entry of `workloads` in `BENCHMARK.json`) names a
configuration and a traffic mix. Each lives in a file of its own,
`configs/<name>.json` and `traffic/<name>.json`; the configuration names
the entry that drives it, `entries/<entry>.py`; each per-layer metric is
`metrics/<name>.py`. The files are looked up in the search roots in
order (the package's own folder first), so a later cell, configuration,
traffic mix or metric is a new file and a new entry, never an edit.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Dict, List, Optional, Sequence

PKG = Path(__file__).resolve().parent.parent
REPO = PKG.parent


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    spec: dict = field(default_factory=dict)


def _find(roots: Sequence[Path], sub: str, name: str, ext: str) -> Path:
    for r in roots:
        p = Path(r) / sub / f"{name}{ext}"
        if p.is_file():
            return p
    raise FileNotFoundError(f"no {sub}/{name}{ext} under "
                            f"{[str(r) for r in roots]}")


class Registry:
    """`BENCHMARK.json` and the search roots of its pieces."""

    def __init__(self, bench_file: Optional[Path] = None,
                 roots: Sequence[Path] = ()):
        self.bench_file = Path(bench_file or REPO / "BENCHMARK.json")
        self.roots = [Path(r) for r in roots] + [PKG]
        self.bench = json.loads(self.bench_file.read_text())
        self._modules: Dict[str, object] = {}

    def workload(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in {self.bench_file}")

    def reports(self, metric: dict, cell: str) -> bool:
        """Whether `cell` reports `metric`: the cells its `workloads`
        key lists; without one, every cell (per-layer metrics: every
        cell that reports the end-to-end metric they move)."""
        if "workloads" in metric:
            return cell in metric["workloads"]
        if "moves" in metric:
            moved = [m for m in self.bench["end_to_end"]
                     if m["name"] == metric["moves"]]
            return bool(moved) and self.reports(moved[0], cell)
        return True

    def cell(self, name: str) -> Cell:
        w = self.workload(name)
        return Cell(
            name=name,
            config=self.config(w["config"]),
            traffic=self.traffic(w["traffic"]),
            end_to_end=[m for m in self.bench["end_to_end"]
                        if self.reports(m, name)],
            per_layer=[m for m in self.bench["per_layer"]
                       if self.reports(m, name)],
            spec=w)

    def config(self, name: str) -> dict:
        return json.loads(_find(self.roots, "configs", name, ".json")
                          .read_text())

    def traffic(self, name: str) -> dict:
        return json.loads(_find(self.roots, "traffic", name, ".json")
                          .read_text())

    def entry(self, name: str):
        return self._load(_find(self.roots, "entries", name, ".py"),
                          f"port_bench_entry_{name}")

    def metric(self, name: str):
        return self._load(_find(self.roots, "metrics", name, ".py"),
                          "port_bench_metric_" + name.replace(".", "_"))

    def _load(self, path: Path, modname: str):
        """Import a file by path, once (metric names hold dots, so they
        are not importable module names)."""
        key = str(path)
        if key not in self._modules:
            spec = importlib.util.spec_from_file_location(modname, path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._modules[key] = mod
        return self._modules[key]
