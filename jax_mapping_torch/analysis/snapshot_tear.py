"""C2 — snapshot tears: correlated state read across separate lock regions.

The hazard (the historical `publish_frontiers` pose/grid tear): a
pure-reader function assembles a "snapshot" of correlated
state — robot poses, the shared grid, the map revision — but takes the
guarding lock *twice*, reading part of the snapshot in each region. A
writer scheduled between the two regions produces a pose/grid pairing
that never existed; every downstream consumer of the pair (frontier
assignment, serving, checkpoints) silently computes on it.

Which fields are "correlated" is a design fact the code cannot express
syntactically, so it comes from the committed lock-protection map
(`analysis/protection.py`). For each declared `LockGroup` the checker
examines every method of the owning class:

* **atomic sections** are (a) top-level ``with self.<lock>:`` regions
  (Condition attributes constructed over the lock alias to it) and
  (b) calls to same-class methods that transitively acquire the lock —
  the callee's internal region is a section of the CALLER's timeline
  (exactly how the historical tear hid: ``merged_grid()`` locks
  internally, so the caller looked lock-free).
* methods that **write** any group field (directly or through called
  sections) are exempt: read-compute-reinstall paths re-read the group
  to *validate* against their base snapshot (the mapper/voxel CAS
  idiom), which is the tear *defense*, not the tear.
* a finding is two sections A before B where A reads part of the group
  and B reads a group field A did not — B's read cannot be consistent
  with A's. Re-reading the *same* fields (staleness re-check) passes.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from jax_mapping_torch.analysis import astutil as A
from jax_mapping_torch.analysis.core import Finding, SourceModule
from jax_mapping_torch.analysis.lock_discipline import _lock_aliases
from jax_mapping_torch.analysis.protection import (LockGroup, REPO_PROTECTION,
                                             groups_by_class)


class _MethodSummary:
    """Per-method group-field access summary, transitive over self-calls."""

    def __init__(self, cls: "A.ClassInfo", lock_attr: str,
                 fields: Set[str], aliases: Dict[str, str]):
        self.cls = cls
        self.lock_attr = lock_attr
        self.fields = fields
        self.aliases = aliases
        self._acquires: Dict[str, bool] = {}
        self._reads: Dict[str, Set[str]] = {}
        self._writes: Dict[str, Set[str]] = {}

    def _field_accesses(self, node: ast.AST) -> Tuple[Set[str], Set[str]]:
        reads: Set[str] = set()
        writes: Set[str] = set()
        for n in ast.walk(node):
            if isinstance(n, ast.Attribute):
                attr = A._self_attr(n)
                if attr in self.fields:
                    if isinstance(n.ctx, ast.Store):
                        writes.add(attr)
                    else:
                        reads.add(attr)
            elif isinstance(n, (ast.Assign, ast.AugAssign)):
                targets = n.targets if isinstance(n, ast.Assign) \
                    else [n.target]
                for t in targets:
                    if isinstance(t, ast.Subscript):
                        attr = A._self_attr(t.value)
                        if attr in self.fields:
                            writes.add(attr)      # self.f[...] = mutation
        return reads, writes

    def _summarize(self, name: str, seen: Set[str]) -> None:
        if name in self._reads or name in seen \
                or name not in self.cls.methods:
            self._reads.setdefault(name, set())
            self._writes.setdefault(name, set())
            self._acquires.setdefault(name, False)
            return
        seen.add(name)
        meth = self.cls.methods[name]
        reads, writes = self._field_accesses(meth)
        acquires = any(
            self.aliases.get(A._self_attr(i.context_expr)) == self.lock_attr
            for n in ast.walk(meth) if isinstance(n, ast.With)
            for i in n.items)
        for callee in A.self_calls(meth):
            if callee == name:
                continue
            self._summarize(callee, seen)
            reads |= self._reads.get(callee, set())
            writes |= self._writes.get(callee, set())
            acquires = acquires or self._acquires.get(callee, False)
        self._reads[name] = reads
        self._writes[name] = writes
        self._acquires[name] = acquires

    def reads(self, name: str) -> Set[str]:
        self._summarize(name, set())
        return self._reads.get(name, set())

    def writes(self, name: str) -> Set[str]:
        self._summarize(name, set())
        return self._writes.get(name, set())

    def acquires(self, name: str) -> bool:
        self._summarize(name, set())
        return self._acquires.get(name, False)


class SnapshotTearChecker:
    id = "C2-snapshot-tear"

    def __init__(self, protection: Optional[Sequence[LockGroup]] = None):
        self._by_class = groups_by_class(
            REPO_PROTECTION if protection is None else protection)

    def run(self, modules: List[SourceModule]) -> Iterable[Finding]:
        findings: List[Finding] = []
        for mod in modules:
            for cls in A.collect_classes(mod):
                for grp in self._by_class.get(cls.name, ()):
                    if grp.lock_attr not in cls.lock_attrs:
                        continue
                    findings += self._check_class(mod, cls, grp)
        return findings

    def _check_class(self, mod: SourceModule, cls: "A.ClassInfo",
                     grp: LockGroup) -> List[Finding]:
        fields = set(grp.all_fields)
        aliases = _lock_aliases(cls)
        summary = _MethodSummary(cls, grp.lock_attr, fields, aliases)
        findings: List[Finding] = []
        for name, meth in cls.methods.items():
            if name == "__init__":
                continue
            sections = self._sections(meth, cls, grp, aliases, summary)
            if not sections:
                continue
            if any(w for _, _, w in sections) or \
                    self._writes_outside(meth, fields):
                continue                     # CAS/install path: exempt
            seen_reads: Set[str] = set()
            for node, reads, _w in sections:
                fresh = reads - seen_reads
                if seen_reads and fresh:
                    findings.append(mod.finding(
                        self.id, "error", node, f"{cls.name}.{name}",
                        f"snapshot tear: correlated field(s) "
                        f"{sorted(fresh)} of lock group "
                        f"{cls.name}.{grp.lock_attr} read in a SECOND "
                        f"atomic section after {sorted(seen_reads)} — "
                        "a writer between the sections pairs state no "
                        "writer ever produced; read the whole group in "
                        "ONE lock region"))
                seen_reads |= reads
        return findings

    def _sections(self, meth: ast.FunctionDef, cls: "A.ClassInfo",
                  grp: LockGroup, aliases: Dict[str, str],
                  summary: _MethodSummary
                  ) -> List[Tuple[ast.AST, Set[str], Set[str]]]:
        """Ordered atomic sections in `meth`: with-lock regions + calls
        to self-methods that acquire the group lock internally."""
        out: List[Tuple[ast.AST, Set[str], Set[str]]] = []

        def visit(node: ast.AST) -> None:
            if isinstance(node, ast.With):
                if any(aliases.get(A._self_attr(i.context_expr))
                       == grp.lock_attr for i in node.items):
                    reads, writes = summary._field_accesses(node)
                    out.append((node, reads, writes))
                    return               # whole region is one section
                for stmt in node.body:
                    visit(stmt)
                return
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                return
            if isinstance(node, ast.Call):
                m = A._self_attr(node.func)
                if m is not None and m in cls.methods \
                        and summary.acquires(m):
                    reads = summary.reads(m)
                    writes = summary.writes(m)
                    if reads or writes:
                        out.append((node, set(reads), set(writes)))
            for child in ast.iter_child_nodes(node):
                visit(child)

        for stmt in meth.body:
            visit(stmt)
        return out

    @staticmethod
    def _writes_outside(meth: ast.FunctionDef, fields: Set[str]) -> bool:
        """Direct group-field writes anywhere in the method body (a
        writer is a CAS/install path even when the write is outside a
        lock region — B3 already polices THAT hazard)."""
        for n in ast.walk(meth):
            if isinstance(n, ast.Attribute) and isinstance(n.ctx, ast.Store):
                if A._self_attr(n) in fields:
                    return True
            if isinstance(n, (ast.Assign, ast.AugAssign)):
                targets = n.targets if isinstance(n, ast.Assign) \
                    else [n.target]
                for t in targets:
                    if isinstance(t, ast.Subscript) \
                            and A._self_attr(t.value) in fields:
                        return True
        return False
