"""Checker framework: source modules, findings, baseline, driver.

A copy of the JAX package's `analysis/core.py` on the port's names: the
package anchor, dotted names and the default baseline are the port's.

Design notes:

* Checkers are whole-program passes (`run(modules) -> findings`), not
  per-file visitors — the entry-point registry (which functions are
  marked `_util.entry_point`, with which static arguments) and the lock
  graph both need the full module set before any site can be judged.
* Finding identity is ``(checker, path, symbol, code)`` — the stripped
  source line, NOT the line number. Baselines keyed on line numbers
  churn on every unrelated edit above the site; keying on the enclosing
  symbol plus the code text survives moves and stays unique enough in
  practice (two identical flagged lines in one function are the same
  accepted idiom).
* The baseline is a committed JSON file of accepted findings. The gate
  (tests/test_torch_analysis_selfcheck.py) fails on any NON-baselined
  finding; unused suppressions are reported so the baseline ratchets
  down rather than silently rotting.
"""

from __future__ import annotations

import ast
import json
import os
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

#: Directories never analyzed (generated, vendored, caches).
SKIP_DIRS = {"__pycache__", "build", ".git"}


@dataclass(frozen=True)
class Finding:
    checker: str       #: checker id, e.g. "A1-host-sync"
    severity: str      #: "error" | "warning"
    path: str          #: posix path relative to the analysis root
    line: int          #: 1-based line of the flagged site
    symbol: str        #: dotted symbol inside the module ("" = module level)
    message: str
    code: str = ""     #: stripped source of the flagged line
    #: last line of the flagged expression (a call spread over lines):
    #: a runtime frame anywhere in [line, end_line] is this site.
    end_line: int = 0

    @property
    def key(self) -> Tuple[str, str, str, str]:
        return (self.checker, self.path, self.symbol, self.code)

    def format(self) -> str:
        sym = f" [{self.symbol}]" if self.symbol else ""
        return (f"{self.path}:{self.line}: {self.severity}: "
                f"{self.checker}: {self.message}{sym}\n"
                f"    {self.code}")


class SourceModule:
    """One parsed source file: AST + line access + dotted module name."""

    def __init__(self, path: str, source: str, dotted: str):
        self.path = path                     # relative, posix separators
        self.source = source
        self.dotted = dotted          # e.g. "jax_mapping_torch.ops.grid"
        self.tree = ast.parse(source, filename=path)
        self._lines = source.splitlines()

    @classmethod
    def from_source(cls, source: str, path: str = "snippet.py",
                    dotted: Optional[str] = None) -> "SourceModule":
        """In-memory module — the fixture-test entry point."""
        if dotted is None:
            dotted = path[:-3].replace("/", ".") if path.endswith(".py") \
                else path
        return cls(path, source, dotted)

    def line(self, lineno: int) -> str:
        if 1 <= lineno <= len(self._lines):
            return self._lines[lineno - 1].strip()
        return ""

    def finding(self, checker: str, severity: str, node: ast.AST,
                symbol: str, message: str) -> Finding:
        lineno = getattr(node, "lineno", 0)
        return Finding(checker=checker, severity=severity, path=self.path,
                       line=lineno, symbol=symbol, message=message,
                       code=self.line(lineno),
                       end_line=getattr(node, "end_lineno", None) or lineno)


class Baseline:
    """Committed accepted-findings list; see `analysis/baseline.json`."""

    def __init__(self, suppressions: Optional[List[dict]] = None):
        self.suppressions = list(suppressions or [])
        self._keys = {(s["checker"], s["path"], s.get("symbol", ""),
                       s.get("code", "")) for s in self.suppressions}
        self._hits: set = set()

    @classmethod
    def load(cls, path: str) -> "Baseline":
        with open(path) as f:
            data = json.load(f)
        if data.get("version") != 1:
            raise ValueError(f"{path}: unsupported baseline version "
                             f"{data.get('version')!r}")
        return cls(data.get("suppressions", []))

    def matches(self, finding: Finding) -> bool:
        if finding.key in self._keys:
            self._hits.add(finding.key)
            return True
        return False

    def unused(self) -> List[dict]:
        """Suppressions that matched nothing this run — ratchet these out."""
        return [s for s in self.suppressions
                if (s["checker"], s["path"], s.get("symbol", ""),
                    s.get("code", "")) not in self._hits]

    @staticmethod
    def dump(findings: Iterable[Finding], path: str,
             notes: Optional[Dict[Tuple, str]] = None,
             keep: Iterable[dict] = ()) -> None:
        """Write a baseline accepting `findings` (--write-baseline).
        `notes` maps finding keys to justification strings; `keep`
        carries forward existing suppressions this run could not have
        re-observed (out-of-scope paths/checkers), so a scoped rewrite
        never silently deletes them."""
        sups = []
        seen = set()
        for s in keep:
            key = (s["checker"], s["path"], s.get("symbol", ""),
                   s.get("code", ""))
            if key not in seen:
                seen.add(key)
                sups.append(dict(s))
        for f in sorted(findings, key=lambda f: (f.path, f.line, f.checker)):
            if f.key in seen:
                continue
            seen.add(f.key)
            entry = {"checker": f.checker, "path": f.path,
                     "symbol": f.symbol, "code": f.code}
            note = (notes or {}).get(f.key)
            if note:
                entry["note"] = note
            sups.append(entry)
        sups.sort(key=lambda s: (s["path"], s["checker"],
                                 s.get("symbol", "")))
        with open(path, "w") as fh:
            json.dump({"version": 1, "suppressions": sups}, fh, indent=1)
            fh.write("\n")


@dataclass
class AnalysisResult:
    findings: List[Finding] = field(default_factory=list)   # non-baselined
    baselined: List[Finding] = field(default_factory=list)
    unused_suppressions: List[dict] = field(default_factory=list)
    n_files: int = 0

    @property
    def all_findings(self) -> List[Finding]:
        return sorted(self.findings + self.baselined,
                      key=lambda f: (f.path, f.line, f.checker))


# -- discovery ---------------------------------------------------------------

def _dotted_name(relpath: str) -> str:
    mod = relpath[:-3] if relpath.endswith(".py") else relpath
    mod = mod.replace("\\", "/")
    if mod.endswith("/__init__"):
        mod = mod[: -len("/__init__")]
    return mod.replace("/", ".")


def _package_anchor(file_abs: str) -> Optional[str]:
    """Parent of the topmost package directory containing `file_abs`
    (walking up while `__init__.py` exists), or None outside any
    package. Anchoring here makes baseline keys like
    `jax_mapping_torch/bridge/planner.py` come out identical whether the
    CLI was handed the package dir, a subdir, one file, or `.`."""
    d = os.path.dirname(file_abs)
    top = None
    while os.path.isfile(os.path.join(d, "__init__.py")):
        top = d
        parent = os.path.dirname(d)
        if parent == d:
            break
        d = parent
    return os.path.dirname(top) if top else None


def load_paths(paths: Sequence[str],
               root: Optional[str] = None) -> List[SourceModule]:
    """Collect .py files under `paths`. Each module's key path is made
    relative to `root` when given, else to the file's package anchor
    (see `_package_anchor`), else to the parent of the common path of
    `paths` — so `jax-mapping-torch-lint jax_mapping_torch/`,
    `jax-mapping-torch-lint jax_mapping_torch/bridge/planner.py` and
    `jax-mapping-torch-lint .` all yield `jax_mapping_torch/...` keys
    that match the committed baseline regardless of cwd."""
    abspaths = [os.path.abspath(p) for p in paths]
    common = os.path.commonpath(abspaths)
    fallback_root = os.path.dirname(common)
    files: List[str] = []
    for p in abspaths:
        if os.path.isfile(p):
            files.append(p)
            continue
        for dirpath, dirnames, filenames in os.walk(p):
            dirnames[:] = [d for d in sorted(dirnames)
                           if d not in SKIP_DIRS]
            files.extend(os.path.join(dirpath, f)
                         for f in sorted(filenames) if f.endswith(".py"))
    modules = []
    for f in files:
        base = root if root is not None \
            else (_package_anchor(f) or fallback_root)
        rel = os.path.relpath(f, base).replace(os.sep, "/")
        with open(f, encoding="utf-8") as fh:
            src = fh.read()
        modules.append(SourceModule(rel, src, _dotted_name(rel)))
    return modules


def load_package_modules() -> List[SourceModule]:
    """The port's package — what the self-check gates. Located from this
    file (no import of the package itself, whose `__init__` loads torch)."""
    pkg_dir = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return load_paths([pkg_dir], root=os.path.dirname(pkg_dir))


def default_baseline_path() -> str:
    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "baseline.json")


# -- driver ------------------------------------------------------------------

def all_checkers() -> List:
    """The registered checker passes, in report order. The A family and
    the C checkers that need the entry-point registry share one registry
    build, the B family one class-walk per module set (`_SharedRegistry`
    / `_SharedWalk`)."""
    from jax_mapping_torch.analysis import (device_views, lock_discipline,
                                            revision_order, shape_churn,
                                            snapshot_tear, torch_hazards)
    registry = torch_hazards._SharedRegistry()
    walk = lock_discipline._SharedWalk()
    return [torch_hazards.HostSyncChecker(registry),
            torch_hazards.EntryHygieneChecker(registry),
            torch_hazards.DtypeDriftChecker(registry),
            torch_hazards.ImpureEntryChecker(registry),
            lock_discipline.LockOrderChecker(walk),
            lock_discipline.CallbackUnderLockChecker(walk),
            lock_discipline.UnguardedWriteChecker(walk),
            revision_order.RevisionOrderChecker(),
            snapshot_tear.SnapshotTearChecker(),
            device_views.DeviceViewMutationChecker(registry),
            shape_churn.ShapeChurnChecker(registry)]


def analyze_modules(modules: Sequence[SourceModule],
                    baseline: Optional[Baseline] = None,
                    checkers: Optional[Sequence] = None) -> AnalysisResult:
    res = AnalysisResult(n_files=len(modules))
    active = list(checkers) if checkers is not None else all_checkers()
    for checker in active:
        for f in checker.run(list(modules)):
            if baseline is not None and baseline.matches(f):
                res.baselined.append(f)
            else:
                res.findings.append(f)
    res.findings.sort(key=lambda f: (f.path, f.line, f.checker))
    res.baselined.sort(key=lambda f: (f.path, f.line, f.checker))
    if baseline is not None:
        # A suppression is only provably stale when this run COULD have
        # re-observed it: its checker ran, and the run had full
        # cross-module context (every baselined file analyzed — the A
        # checkers build a package-wide entry-point registry, so a subset
        # run finds strictly less and would report valid entries as
        # stale). Deleted-but-still-baselined files are caught by the
        # gate's path-existence check, not here.
        ids = {c.id for c in active}
        analyzed = {m.path for m in modules}
        full_context = {s["path"] for s in baseline.suppressions} \
            <= analyzed
        if full_context:
            res.unused_suppressions = [s for s in baseline.unused()
                                       if s["checker"] in ids]
    return res


def analyze_paths(paths: Sequence[str],
                  baseline_path: Optional[str] = None,
                  checkers: Optional[Sequence] = None) -> AnalysisResult:
    baseline = Baseline.load(baseline_path) if baseline_path else None
    return analyze_modules(load_paths(paths), baseline, checkers)
