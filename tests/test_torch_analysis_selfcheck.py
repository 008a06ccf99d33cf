"""The port passes its own static analysis (`jax_mapping_torch.analysis`).

The counterpart of the JAX package's `tests/test_analysis_selfcheck.py`:
`python -m jax_mapping_torch.analysis jax_mapping_torch/` over the
committed `analysis/baseline.json` reports zero new findings, every
suppression still matches and carries a note that says why the site
syncs (or writes), no C finding is baselined, the protection map names
real classes, locks and fields, the CLI keeps its exit-code contract, the
compile budget's entries above one variant carry notes and the cost
ledger covers the budget, and the static lock graph is consistent with
the lock order a live CPU `launch_sim_stack` exercises. Parity: the
port's copies of B1-B3, C1 and C2 give the JAX package's findings, key
for key, over both packages (JAX's CLI runs in a subprocess, as in
`tests/test_torch_analysis.py`; this file imports nothing of JAX).
"""

import ast
import json
import os
import subprocess
import sys

import numpy as np
import pytest

from jax_mapping_torch.analysis import astutil
from jax_mapping_torch.analysis.core import (
    Baseline, all_checkers, analyze_modules, analyze_paths,
    default_baseline_path, load_package_modules, load_paths,
)
from jax_mapping_torch.analysis.lock_discipline import (LockGraph,
                                                        build_lock_graph)
from jax_mapping_torch.analysis.lockwatch import LockWatch
from tests import torch_budget_run
from tests.torch_jaxref import REPO, clean_cpu_env

PARITY = ("B1-lock-order", "B2-callback-lock", "B3-unguarded-write",
          "C1-revision-order", "C2-snapshot-tear")


@pytest.fixture(scope="module")
def package_modules():
    mods = load_package_modules()
    assert len(mods) > 100, "package discovery looks broken"
    return mods


class _Replay:
    """A checker that hands back one checker's findings over the package
    from the module's single full analysis."""

    def __init__(self, checker_id, findings):
        self.id = checker_id
        self._findings = findings

    def run(self, modules):
        return list(self._findings)


@pytest.fixture(scope="module")
def package_findings(package_modules):
    """Every checker's findings over the package, from one analysis."""
    out = {c.id: [] for c in all_checkers()}
    for f in analyze_modules(package_modules).findings:
        out[f.checker].append(f)
    return out


def _replays(package_findings):
    return [_Replay(cid, fs) for cid, fs in package_findings.items()]


@pytest.fixture(scope="module")
def package_result(package_modules, package_findings):
    """The full analysis of the package with the committed baseline."""
    return analyze_modules(package_modules,
                           Baseline.load(default_baseline_path()),
                           _replays(package_findings))


@pytest.fixture
def cli_main(monkeypatch, package_modules, package_findings):
    """`cli.main` over the package with the checkers' findings replayed
    from the module's one analysis: flags, baseline handling, output and
    exit codes run as they are (`test_module_entry_point_runs` runs the
    whole CLI, analysis included, in a fresh process)."""
    from jax_mapping_torch.analysis import cli
    monkeypatch.setattr(cli, "load_package_modules", lambda: package_modules)
    monkeypatch.setattr(cli, "all_checkers",
                        lambda: _replays(package_findings))
    return cli.main


# ---------------------------------------------------------------- the gate

def test_package_passes_static_analysis(package_result):
    assert not package_result.findings, (
        "new static-analysis findings (fix them, or baseline a deliberate "
        "site WITH a note in analysis/baseline.json):\n"
        + "\n".join(f.format() for f in package_result.findings))


def test_baseline_has_no_unused_suppressions(package_result):
    assert not package_result.unused_suppressions, (
        "stale baseline suppressions:\n"
        + "\n".join(str(s) for s in package_result.unused_suppressions))


def test_baseline_entries_carry_justifications():
    base = Baseline.load(default_baseline_path())
    missing = [s for s in base.suppressions if not s.get("note")]
    assert not missing, f"baseline entries without a note: {missing}"


def test_baseline_paths_all_exist(package_modules):
    analyzed = {m.path for m in package_modules}
    base = Baseline.load(default_baseline_path())
    missing = {s["path"] for s in base.suppressions} - analyzed
    assert not missing, f"baseline references deleted files: {missing}"


def test_c_family_findings_are_fixed_never_baselined():
    base = Baseline.load(default_baseline_path())
    banned = [s for s in base.suppressions
              if s["checker"].startswith("C")]
    assert not banned, f"C-family suppressions are forbidden: {banned}"


def test_no_suppressions_in_analysis_modules():
    base = Baseline.load(default_baseline_path())
    banned = [s for s in base.suppressions
              if s["path"].startswith("jax_mapping_torch/analysis/")]
    assert not banned, banned


def test_baseline_holds_the_reference_single_writer_sites():
    """The two B3 single-writer sites the JAX package also accepts, and
    no other B entry."""
    base = Baseline.load(default_baseline_path())
    b = {(s["checker"], s["path"], s["symbol"]) for s in base.suppressions
         if s["checker"].startswith("B")}
    assert b == {
        ("B3-unguarded-write", "jax_mapping_torch/bridge/brain.py",
         "ThymioBrain._update_loop_body"),
        ("B3-unguarded-write", "jax_mapping_torch/bridge/mapper.py",
         "MapperNode._odom_motion")}


def test_checker_ids_are_unique_and_complete():
    ids = [c.id for c in all_checkers()]
    assert len(ids) == len(set(ids))
    assert set(ids) == {"A1-host-sync", "A2-entry-hygiene",
                        "A3-dtype-drift", "A4-impure-entry",
                        "B1-lock-order", "B2-callback-lock",
                        "B3-unguarded-write", "C1-revision-order",
                        "C2-snapshot-tear", "C3-device-view",
                        "C4-shape-churn"}


def test_importing_analysis_loads_no_jax():
    """Every module of the port's analysis package imports without `jax`
    or `jax_mapping`; the static checkers need no torch either."""
    code = ("import importlib, pkgutil, sys\n"
            "import jax_mapping_torch.analysis as P\n"
            "for m in pkgutil.iter_modules(P.__path__):\n"
            "    importlib.import_module(P.__name__ + '.' + m.name)\n"
            "bad = sorted(k for k in sys.modules if k == 'jax' or "
            "k.startswith(('jax.', 'jax_mapping.')) or k == 'jax_mapping')\n"
            "print(bad)\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, cwd=str(REPO), timeout=120)
    assert r.returncode == 0, r.stderr[-2000:]
    assert r.stdout.strip() == "[]"


# ------------------------------------------------------------ the CLI

def test_cli_runs_clean_with_committed_baseline(cli_main, capsys):
    assert cli_main([]) == 0
    assert "0 new finding(s)" in capsys.readouterr().out


def test_cli_no_baseline_mode_surfaces_accepted_sites(cli_main, capsys):
    assert cli_main(["--no-baseline"]) == 1
    out = capsys.readouterr().out
    assert "A1-host-sync" in out and "B3-unguarded-write" in out


def test_cli_rejects_unknown_checker_id(cli_main):
    assert cli_main(["--checker", "Z9-not-a-checker"]) == 2


def test_cli_corrupt_baseline_is_usage_error_not_findings(cli_main,
                                                         tmp_path):
    bad = tmp_path / "bad.json"
    bad.write_text("{not json")
    assert cli_main(["--baseline", str(bad)]) == 2
    assert cli_main(["--write-baseline", "--baseline", str(bad)]) == 2
    assert bad.read_text() == "{not json"
    wrong = tmp_path / "v99.json"
    wrong.write_text('{"version": 99, "suppressions": []}')
    assert cli_main(["--baseline", str(wrong)]) == 2


def test_cli_github_format_annotations(cli_main, capsys):
    assert cli_main(["--format", "github"]) == 0
    out = capsys.readouterr().out
    assert "::error" not in out and "::warning" not in out
    assert cli_main(["--format", "github", "--no-baseline",
                     "--checker", "B3-unguarded-write"]) == 1
    out = capsys.readouterr().out
    assert "::warning file=jax_mapping_torch/bridge/" in out
    assert ",line=" in out and ",title=B3-unguarded-write" in out


def test_write_baseline_merges_notes_and_out_of_scope_entries(cli_main,
                                                             tmp_path):
    """A scoped --write-baseline keeps the entries it could not re-observe
    verbatim; an unscoped rewrite keeps every site and every note."""
    import shutil

    tmp = str(tmp_path / "baseline.json")
    shutil.copy(default_baseline_path(), tmp)
    with open(default_baseline_path()) as f:
        before = json.load(f)["suppressions"]

    def key(s):
        return (s["checker"], s["path"], s.get("symbol", ""),
                s.get("code", ""))
    assert cli_main(["--write-baseline", "--baseline", tmp,
                     "--checker", "B1-lock-order"]) == 0
    with open(tmp) as f:
        after = json.load(f)["suppressions"]
    assert {key(s) for s in after} >= {key(s) for s in before}
    notes = {key(s): s.get("note") for s in after}
    assert all(notes[key(s)] == s["note"] for s in before)
    assert cli_main(["--write-baseline", "--baseline", tmp]) == 0
    with open(tmp) as f:
        rewritten = json.load(f)["suppressions"]
    assert {key(s) for s in rewritten} == {key(s) for s in before}
    assert all(s.get("note") for s in rewritten)


def test_single_file_keys_match_committed_baseline():
    """A one-file run anchors its keys at the package parent, reports no
    new finding and claims no suppression is stale."""
    pkg = REPO / "jax_mapping_torch"
    target = str(pkg / "bridge" / "brain.py")
    [mod] = load_paths([target])
    assert mod.path == "jax_mapping_torch/bridge/brain.py"
    assert mod.dotted == "jax_mapping_torch.bridge.brain"
    res = analyze_paths([target], baseline_path=default_baseline_path(),
                        checkers=[c for c in all_checkers()
                                  if c.id.startswith("B")])
    assert not res.findings, "\n".join(f.format() for f in res.findings)
    assert not res.unused_suppressions


def test_scoped_checker_run_does_not_report_foreign_unused(
        package_modules):
    from jax_mapping_torch.analysis.lock_discipline import LockOrderChecker
    res = analyze_modules(package_modules,
                          Baseline.load(default_baseline_path()),
                          checkers=[LockOrderChecker()])
    assert res.findings == [] and res.unused_suppressions == []


def test_module_entry_point_runs():
    """`python -m jax_mapping_torch.analysis` mirrors the console script,
    over the package and on its exit-code contract."""
    r = subprocess.run(
        [sys.executable, "-m", "jax_mapping_torch.analysis",
         "--list-checkers"], capture_output=True, text=True, timeout=120,
        cwd=str(REPO))
    assert r.returncode == 0, r.stderr
    assert "A1-host-sync" in r.stdout and "C4-shape-churn" in r.stdout
    r = subprocess.run(
        [sys.executable, "-m", "jax_mapping_torch.analysis",
         "--checker", "B3-unguarded-write", "jax_mapping_torch/"],
        capture_output=True, text=True, timeout=120, cwd=str(REPO))
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "0 new finding(s), 2 baselined" in r.stdout


# ------------------------------------------------------ protection map

def test_protection_map_matches_code(package_modules):
    """Every lock-protection declaration names a real class of the port,
    its real lock attributes, and fields assigned in that class."""
    from jax_mapping_torch.analysis.protection import REPO_PROTECTION
    classes = {}
    for mod in package_modules:
        for cls in astutil.collect_classes(mod):
            classes[cls.name] = cls
    for grp in REPO_PROTECTION:
        cls = classes.get(grp.cls)
        assert cls is not None, f"protection map names missing {grp.cls}"
        assert grp.lock_attr in cls.lock_attrs, \
            f"{grp.cls} does not own lock {grp.lock_attr}"
        for extra in grp.extra_locks:
            assert extra in cls.lock_attrs, \
                f"{grp.cls} does not own extra lock {extra}"
        assigned = set()
        for meth in cls.methods.values():
            for node in ast.walk(meth):
                if isinstance(node, ast.Attribute) \
                        and isinstance(node.ctx, ast.Store):
                    attr = astutil._self_attr(node)
                    if attr:
                        assigned.add(attr)
        missing = grp.all_fields - assigned
        assert not missing, f"{grp.cls} never assigns {missing}"


def test_protection_map_covers_the_port_groups():
    """The control plane's, the tracer's, the SLO engine's, the pipeline
    ledger's and the event channel's groups are in the port's map."""
    from jax_mapping_torch.analysis.protection import groups_by_class
    by = groups_by_class()
    for cls in ("TenantControlPlane", "Tracer", "SloEngine",
                "PipelineLedger", "EventChannel", "EventSubscription",
                "MapperNode", "TileStore", "WorldStore"):
        assert cls in by, cls


# ------------------------------------------------------ compile budget

def test_compile_budget_entries_above_one_carry_notes():
    from jax_mapping_torch.analysis.compilebudget import (
        Budget, default_budget_path)
    budget = Budget.load(default_budget_path())
    assert budget.entries, "committed budget is empty"
    noteless = [e["name"] for e in budget.entries
                if e["max"] > 1 and not e.get("note")]
    assert not noteless, noteless
    assert all(e["max"] >= 1 for e in budget.entries)
    assert default_budget_path().endswith(
        os.path.join("jax_mapping_torch", "analysis",
                     "compile_budget.json"))


def test_cost_ledger_covers_compile_budget(tmp_path_factory):
    """The canonical scenario under the dispatch profiler, in a fresh
    process: every budgeted entry point dispatched within its maximum and
    costed (the run `test_torch_devprof.py` also reads)."""
    r, doc = torch_budget_run.cost_ledger_run(tmp_path_factory)
    assert r.returncode == 0, r.stderr[-3000:]
    assert doc["violations"] == []
    from jax_mapping_torch.analysis.compilebudget import (
        Budget, default_budget_path)
    over, unknown, stale = Budget.load(default_budget_path()).check(
        doc["measured"])
    assert over == [] and stale == []
    assert set(doc["ledger"]) >= {e["name"] for e in Budget.load(
        default_budget_path()).entries}


def test_compilebudget_cli_refusals(tmp_path):
    """Exit 2 before any scenario: a corrupt or missing budget, and the
    default `--device cuda` without a card."""
    env = clean_cpu_env()
    env["PYTHONPATH"] = str(REPO)
    bad = tmp_path / "bad.json"
    bad.write_text("{oops")
    base = [sys.executable, "-m", "jax_mapping_torch.analysis.compilebudget"]

    def refused(args):
        r = subprocess.run(base + args, capture_output=True, text=True,
                           cwd=str(REPO), env=env, timeout=120)
        assert r.returncode == 2, (args, r.stdout, r.stderr[-2000:])
        return r
    refused(["--check", "--budget", str(bad)])
    refused(["--check", "--budget", str(tmp_path / "missing.json")])
    # Where a card is present `--measure` runs the scenario on it: the
    # smoke's analysis phase covers that side.
    import torch
    if not torch.cuda.is_available():
        assert "no CUDA device" in refused(["--measure"]).stderr


# ---------------------------------------- static graph vs live stack

def _live_stack(n_robots: int, seed: int):
    from jax_mapping_torch.bridge.launch import launch_sim_stack
    from jax_mapping_torch.config import tiny_config
    from jax_mapping_torch.sim import world as W
    cfg = tiny_config()
    world = W.empty_arena(64, cfg.grid.resolution_m)
    return launch_sim_stack(cfg, world, n_robots=n_robots, http_port=None,
                            seed=seed, device="cpu")


def test_static_lock_graph_is_acyclic(package_modules):
    found = {f"{cls.name}.{attr}"
             for mod in package_modules
             for cls in astutil.collect_classes(mod)
             for attr in cls.lock_attrs}
    assert {"Bus._lock", "Node._cb_lock", "ThymioBrain._state_lock",
            "MapperNode._state_lock", "Subscription._lock"} <= found, found
    assert build_lock_graph(package_modules).sccs() == []


def test_lockwatch_validates_static_graph_on_live_stack(package_modules):
    """The port's live CPU stack under recording locks: no runtime cycle,
    no observed edge reverses a static one, and the union is acyclic."""
    st = _live_stack(2, seed=3)
    watch = LockWatch()
    try:
        watch.watch(st.bus, "_lock")
        watch.watch(st.brain, "_state_lock")
        watch.watch(st.mapper, "_state_lock")
        for node in (st.sim, st.brain, st.mapper):
            watch.watch(node, "_cb_lock", name=f"Node._cb_lock@{node.name}")
        st.brain.start_exploring()
        st.run_steps(12)
    finally:
        watch.unwatch_all()
        st.shutdown()
    observed = watch.edges()
    assert observed, "no lock nesting observed — the watch is broken"
    assert watch.cycle() is None
    static = build_lock_graph(package_modules).edge_set()
    for a, b in observed:
        assert (b, a) not in static, (a, b)
    assert LockGraph(edges={e: None for e in static | observed}).sccs() \
        == []


def test_lockwatch_poses_match_unwatched_run():
    def run(watched: bool):
        st = _live_stack(1, seed=7)
        watch = LockWatch()
        try:
            if watched:
                watch.watch(st.bus, "_lock")
                watch.watch(st.brain, "_state_lock")
            st.brain.start_exploring()
            st.run_steps(8)
            return np.array(st.brain.poses)
        finally:
            watch.unwatch_all()
            st.shutdown()

    np.testing.assert_array_equal(run(False), run(True))


# --------------------------------------------------- parity with JAX

def _jax_findings(tree: str) -> set:
    """JAX's CLI (`--no-baseline`, B1-B3/C1/C2) over `tree`, in a fresh
    process: {(checker, path, line, symbol, message, code)}."""
    args = [sys.executable, "-m", "jax_mapping.analysis.cli",
            "--no-baseline", "--format", "json"]
    for c in PARITY:
        args += ["--checker", c]
    r = subprocess.run(args + [tree], capture_output=True, text=True,
                       cwd=str(REPO), env=clean_cpu_env(), timeout=300)
    assert r.returncode in (0, 1), r.stderr[-2000:]
    return {(f["checker"], f["path"], f["line"], f["symbol"], f["message"],
             f["code"]) for f in json.loads(r.stdout)["findings"]}


def _port_findings(tree: str) -> set:
    res = analyze_modules(load_paths([str(REPO / tree)]), None,
                          [c for c in all_checkers() if c.id in PARITY])
    return {(f.checker, f.path, f.line, f.symbol, f.message, f.code)
            for f in res.findings}


@pytest.mark.parametrize("tree", ["jax_mapping", "jax_mapping_torch"])
def test_lock_and_snapshot_checkers_match_jax(tree):
    """The port's B1-B3, C1 and C2 give exactly JAX's findings: the same
    keys, lines and messages, over either package."""
    ours, theirs = _port_findings(tree), _jax_findings(tree)
    assert ours == theirs, (sorted(ours - theirs), sorted(theirs - ours))
    assert theirs, "JAX's checkers found nothing: the comparison is empty"
