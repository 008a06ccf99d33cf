"""C1 — revision-before-content ordering for lock-free stamped snapshots.

The repo's cache-consistency idiom pairs a monotonic revision counter
with the content it stamps (`map_revision` + the grid, a tile store's
`revision` + its tiles, `serving_revision()` + `serving_snapshot()`).
Readers that cannot afford a lock take the pair as two separate reads,
and then the ORDER is the whole correctness argument:

* revision FIRST, content second: a writer landing between the reads
  leaves *newer content under an older stamp* — conservative; the next
  freshness peek sees a newer revision and re-reads.
* content first, revision second: the same interleaving stamps *old
  content with the new revision* — every later freshness check compares
  equal and the stale content is served as current **forever**.

This exact inversion was caught by review three times
(the voxel `serving_snapshot`, the relocalizer's pyramid cache, the
planner's `_planning_grid` tick path) before this checker existed.

Mechanics: within one function, the checker collects lock-free reads of
*revision-named* attributes/methods (``*_revision``, ``*_rev``,
``revision``) and of *content-named* ones (``grid``/``*_grid``,
``*snapshot*``, ``states``, ``tiles``) per receiver expression
(``self``, ``self.mapper``, a local alias). If the first content read
of a receiver precedes its first revision read, the revision read is
flagged. Reads made while holding a lock are exempt — a lock-atomic
snapshot has no ordering hazard (tears across *separate* lock regions
are C2's department), and re-reading the revision after content as a
staleness *re-check* passes because the first revision read came first.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Tuple

from jax_mapping_torch.analysis import astutil as A
from jax_mapping_torch.analysis.core import Finding, SourceModule

#: attribute / method names that read a revision stamp.
def _is_revision_name(name: str) -> bool:
    return (name == "revision" or name.endswith("_revision")
            or name.endswith("_rev"))


#: attribute / method names that read the content a revision stamps.
def _is_content_name(name: str) -> bool:
    return (name == "grid" or name.endswith("_grid")
            or "snapshot" in name
            or name in ("states", "tiles", "height_map"))


def _with_is_lock(item: ast.withitem) -> bool:
    """`with <expr>:` acquires a lock when the context expression is a
    dotted name mentioning a lock by the repo's naming convention
    (`self._lock`, `self._state_lock`, `store._refresh_lock`, ...)."""
    d = A.dotted(item.context_expr)
    if d is None and isinstance(item.context_expr, ast.Call):
        d = A.dotted(item.context_expr.func)
    return d is not None and "lock" in d.rsplit(".", 1)[-1].lower()


class RevisionOrderChecker:
    id = "C1-revision-order"

    def run(self, modules: List[SourceModule]) -> Iterable[Finding]:
        findings: List[Finding] = []
        for mod in modules:
            for func, symbol, _cls in A.walk_functions(mod.tree):
                if func.name == "__init__":
                    continue
                findings += self._scan(mod, func, symbol)
        return findings

    def _scan(self, mod: SourceModule, func: ast.FunctionDef,
              symbol: str) -> List[Finding]:
        #: receiver -> (first content read node, first revision read node)
        first_content: Dict[str, ast.AST] = {}
        first_revision: Dict[str, ast.AST] = {}
        flagged: Dict[str, Tuple[ast.AST, str]] = {}

        def receiver_of(attr_node: ast.Attribute) -> Optional[str]:
            return A.dotted(attr_node.value)

        def visit(node: ast.AST, in_lock: bool) -> None:
            if isinstance(node, ast.With):
                locked = in_lock or any(_with_is_lock(i)
                                        for i in node.items)
                for item in node.items:
                    visit(item.context_expr, in_lock)
                for stmt in node.body:
                    visit(stmt, locked)
                return
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                return                       # nested defs: separate scans
            if isinstance(node, ast.Attribute) \
                    and isinstance(node.ctx, ast.Load) and not in_lock:
                recv = receiver_of(node)
                if recv is not None:
                    self._record(node, node.attr, recv, first_content,
                                 first_revision, flagged)
            for child in ast.iter_child_nodes(node):
                visit(child, in_lock)

        for stmt in func.body:
            visit(stmt, False)

        return [mod.finding(
            self.id, "error", node, symbol,
            f"`{code_name}` read AFTER its content on receiver — a "
            "writer landing between the reads stamps OLD content with "
            "the NEW revision and serves it as current forever; read "
            "the revision first (newer-content-under-older-stamp heals "
            "at the next freshness peek)")
            for node, code_name in flagged.values()]

    @staticmethod
    def _record(node: ast.Attribute, name: str, recv: str,
                first_content: Dict, first_revision: Dict,
                flagged: Dict) -> None:
        if _is_revision_name(name):
            if recv not in first_revision:
                first_revision[recv] = node
                if recv in first_content and recv not in flagged:
                    flagged[recv] = (node, name)
        elif _is_content_name(name):
            first_content.setdefault(recv, node)
