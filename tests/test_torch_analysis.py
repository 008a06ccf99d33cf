"""The JAX package's lock and snapshot checkers over the port.

`python -m jax_mapping.analysis.cli` (it imports no JAX) runs the
lock-order (B1), callback-lock (B2), unguarded-write (B3),
revision-order (C1) and snapshot-tear (C2) checkers over
`jax_mapping_torch`. Its protection map (`analysis/protection.py`) names
lock groups by class, so the port's `MapperNode`, `ThymioBrain`,
`WorldStore`, `MemoryGovernor` and `SpillStore` are held to the groups of
their JAX counterparts. The port may have no finding except those whose
(checker, symbol) the JAX package's own baseline accepts in the
counterpart file; C findings are never baselined there.
"""

import json
import subprocess
import sys

from tests.torch_jaxref import REPO

CHECKERS = ("B1-lock-order", "B2-callback-lock", "B3-unguarded-write",
            "C1-revision-order", "C2-snapshot-tear")


def _analyze(*paths) -> dict:
    args = [sys.executable, "-m", "jax_mapping.analysis.cli",
            "--no-baseline", "--format", "json"]
    for c in CHECKERS:
        args += ["--checker", c]
    r = subprocess.run(args + [str(p) for p in paths], capture_output=True,
                       text=True, cwd=str(REPO), timeout=120)
    assert r.returncode in (0, 1), r.stderr[-2000:]
    return json.loads(r.stdout)


def _accepted() -> set:
    """(checker, path, symbol) the JAX baseline accepts, with the path
    moved to the port's package."""
    with open(REPO / "jax_mapping" / "analysis" / "baseline.json") as f:
        sup = json.load(f)["suppressions"]
    return {(s["checker"], s["path"].replace("jax_mapping/",
                                             "jax_mapping_torch/", 1),
             s["symbol"]) for s in sup}


def test_port_has_only_the_findings_the_reference_accepts():
    report = _analyze("jax_mapping_torch")
    assert report["files"] >= 60
    found = {(f["checker"], f["path"], f["symbol"])
             for f in report["findings"]}
    assert found <= _accepted(), sorted(found - _accepted())
    assert not [f for f in report["findings"]
                if f["checker"].startswith("C")]
    # The two single-writer sites the reference also accepts.
    assert found == {
        ("B3-unguarded-write", "jax_mapping_torch/bridge/brain.py",
         "ThymioBrain._update_loop_body"),
        ("B3-unguarded-write", "jax_mapping_torch/bridge/mapper.py",
         "MapperNode._odom_motion")}


def test_snapshot_checker_holds_the_world_store_to_its_group(tmp_path):
    """The guard covers the port's `WorldStore`: a copy whose `status`
    reads the host LRU and the away-set in two lock sections is a C2
    error."""
    src = (REPO / "jax_mapping_torch" / "world" / "store.py").read_text()
    one = ("        with self._lock:\n"
           "            host = len(self._host)\n"
           "            away = len(self._away)\n")
    torn = ("        with self._lock:\n"
            "            host = len(self._host)\n"
            "        with self._lock:\n"
            "            away = len(self._away)\n")
    assert src.count(one) == 1
    (tmp_path / "store.py").write_text(src.replace(one, torn))
    report = _analyze(tmp_path / "store.py")
    assert [(f["checker"], f["symbol"]) for f in report["findings"]] == \
        [("C2-snapshot-tear", "WorldStore.status")]
