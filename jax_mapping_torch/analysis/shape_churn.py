"""C4 — variant churn at entry-point call sites.

The counterpart of the JAX package's `analysis/shape_churn.py`. XLA
compiles one program per (static values, operand shapes); the port's
dispatch profiler (`obs/devprof.py`) keys a *variant* the same way, by
the values of an entry point's `static=` arguments and its tensors'
shapes, and a new variant in steady state is what the cold-start phase
counts as a recompile (limit 0). The cost behind it is the card's own:
each new shape is a new set of kernel configurations, workspace
allocations and cuDNN plans, and a new entry in the ledger and the
warm-up manifest. A call site whose static argument — or whose operand
*shape* — derives from an unbucketed runtime quantity (a queue length,
`len(scans)`, `t.shape[0]` of a cropped region) mints one variant per
distinct value. The repo's standing fix is pow2-style bucketing BEFORE
the boundary (crop spans bucketed to ``2**k ∪ 3·2**(k-1)``; the compile
budget pins the residual).

The checker taints *dynamic-size sources* — `len(...)`, `.shape`/`.size`
reads, `count_nonzero`, `.sum()`/`.item()` — through an ordered walk, and
flags, at call sites of known entry points (the package-wide registry):

* a **static argument** (`static=` of `_util.entry_point`) whose
  expression is dynamic-tainted, and
* a **tensor operand** built by slicing with a dynamic-tainted bound
  (``t[:n]`` — the shape IS the slice length).

Bucketing sanitizes: calls whose name matches ``bucket``/``pow2``/
``next_pow``/``pad_to``, and explicit ``2 ** k`` / ``1 << k``
arithmetic. Inside entry points themselves shapes are the variant's own
and are not churn — the checker only seeds taint in the calling
function.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, List, Optional, Set

from jax_mapping_torch.analysis import astutil as A
from jax_mapping_torch.analysis.core import Finding, SourceModule

_BUCKET_NAME = re.compile(r"bucket|pow2|pow_two|next_pow|pad_to",
                          re.IGNORECASE)
_DYNAMIC_SIZE_ATTRS = {"shape", "size"}
_DYNAMIC_SIZE_CALLS = {"len"}
_DYNAMIC_SIZE_NP = {"numpy.count_nonzero", "numpy.sum"}
#: array reductions whose VALUE is runtime data — `int(mask.sum())` in
#: a static position compiles one program per distinct count.
_DYNAMIC_SIZE_METHODS = {"sum", "count_nonzero", "item", "nonzero"}


def _is_bucketing_call(call: ast.Call) -> bool:
    name = None
    if isinstance(call.func, ast.Name):
        name = call.func.id
    elif isinstance(call.func, ast.Attribute):
        name = call.func.attr
    return name is not None and bool(_BUCKET_NAME.search(name))


def _is_pow2_expr(node: ast.AST) -> bool:
    """`2 ** k` / `1 << k` anywhere inside `node`."""
    for n in ast.walk(node):
        if isinstance(n, ast.BinOp):
            if isinstance(n.op, ast.Pow) \
                    and isinstance(n.left, ast.Constant) \
                    and n.left.value == 2:
                return True
            if isinstance(n.op, ast.LShift) \
                    and isinstance(n.left, ast.Constant) \
                    and n.left.value == 1:
                return True
    return False


def _sanitized(expr: ast.AST) -> bool:
    if _is_pow2_expr(expr):
        return True
    return any(_is_bucketing_call(n) for n in ast.walk(expr)
               if isinstance(n, ast.Call))


class ShapeChurnChecker:
    id = "C4-shape-churn"

    def __init__(self, shared=None):
        from jax_mapping_torch.analysis.torch_hazards import _SharedRegistry
        self._shared = shared or _SharedRegistry()
        self._shapes_static = False

    def run(self, modules: List[SourceModule]) -> Iterable[Finding]:
        reg = self._shared.get(modules)
        registry, scope = reg.entries, reg.scope()
        findings: List[Finding] = []
        for mod in modules:
            imports = A.import_table(mod.tree)
            for func, symbol, _cls in A.walk_functions(mod.tree):
                # Inside an entry point, shapes are its variant's own —
                # churn is a CALLER-side hazard.
                if any(A.entry_decorator_info(d, imports) is not None
                       for d in getattr(func, "decorator_list", ())):
                    continue
                # Below an entry point (its package-local callees), a
                # tensor's shape is fixed by the entry point's own
                # variant: `.shape`/`.size` reads are not new sources.
                self._shapes_static = (mod.dotted, symbol) in scope
                findings += self._scan(mod, func, symbol, imports,
                                       registry)
        return findings

    # -- dynamic-size taint --------------------------------------------------

    def _rhs_dynamic(self, value: ast.AST, imports: Dict[str, str],
                     tainted: Set[str]) -> Optional[bool]:
        if _sanitized(value):
            return False
        for n in ast.walk(value):
            if isinstance(n, ast.Call):
                if isinstance(n.func, ast.Name) \
                        and n.func.id in _DYNAMIC_SIZE_CALLS:
                    return True
                tgt = A.resolve(n.func, imports) or ""
                if tgt in _DYNAMIC_SIZE_NP:
                    return True
                if isinstance(n.func, ast.Attribute) \
                        and n.func.attr in _DYNAMIC_SIZE_METHODS:
                    return True
            elif isinstance(n, ast.Attribute) \
                    and n.attr in _DYNAMIC_SIZE_ATTRS \
                    and not self._shapes_static:
                return True
            elif isinstance(n, ast.Name) and n.id in tainted:
                return True
        return None

    def _expr_dynamic(self, expr: ast.AST, imports: Dict[str, str],
                      tainted: Set[str]) -> bool:
        return self._rhs_dynamic(expr, imports, tainted) is True

    # -- the pass ------------------------------------------------------------

    def _scan(self, mod: SourceModule, func: ast.FunctionDef, symbol: str,
              imports: Dict[str, str], registry) -> List[Finding]:
        tainted: Set[str] = set()
        findings: List[Finding] = []

        def check_call(call: ast.Call) -> None:
            tgt = A.resolve_call_target(call, mod, imports)
            site = registry.get(tgt) if tgt else None
            if site is None:
                return
            params = site.params
            static = site.static_params
            for idx, arg in enumerate(call.args):
                pname = params[idx] if idx < len(params) else None
                if pname in static:
                    if self._expr_dynamic(arg, imports, tainted):
                        findings.append(mod.finding(
                            self.id, "error", arg, symbol,
                            f"static argument `{pname}` of entry point "
                            f"`{site.func.name}` derives from an "
                            "unbucketed runtime size — one dispatch "
                            "variant per distinct value (a steady-state "
                            "recompile); bucket it (2**k-style) before "
                            "the call"))
                else:
                    self._check_operand(mod, call, arg, symbol, site,
                                        imports, tainted, findings)
            for kw in call.keywords:
                if kw.arg in static \
                        and self._expr_dynamic(kw.value, imports, tainted):
                    findings.append(mod.finding(
                        self.id, "error", kw.value, symbol,
                        f"static argument `{kw.arg}` of entry point "
                        f"`{site.func.name}` derives from an unbucketed "
                        "runtime size — one dispatch variant per "
                        "distinct value; bucket it before the call"))

        def on_stmt(stmt: ast.stmt) -> None:
            for call in A.statement_calls(stmt):
                check_call(call)

        # The A checkers' walk treats .shape/len as host metadata; here
        # they ARE the taint source, so this checker runs its own ordered
        # walk re-judging every assignment through `_rhs_dynamic`.
        self._run_with_sizes(tainted, on_stmt, func.body, imports)
        return findings

    class _Walk:
        """Mutable taint-set handle for the ordered walk."""
        def __init__(self, tainted: Set[str], on_stmt):
            self.tainted = tainted
            self.on_stmt = on_stmt

    def _run_with_sizes(self, tainted: Set[str], on_stmt,
                        body: List[ast.stmt],
                        imports: Dict[str, str]) -> None:
        walk = self._Walk(tainted, on_stmt)
        self._run_body(walk, body, imports)

    def _run_body(self, walk: "_Walk", body: List[ast.stmt],
                  imports: Dict[str, str]) -> None:
        for stmt in body:
            walk.on_stmt(stmt)
            if isinstance(stmt, ast.Assign) or (
                    isinstance(stmt, ast.AnnAssign)
                    and stmt.value is not None):
                targets = stmt.targets if isinstance(stmt, ast.Assign) \
                    else [stmt.target]
                verdict = self._rhs_dynamic(stmt.value, imports,
                                            walk.tainted)
                for t in targets:
                    names = A.target_names(t)
                    if verdict:
                        walk.tainted |= names
                    else:
                        walk.tainted -= names
            elif isinstance(stmt, ast.AugAssign):
                if self._rhs_dynamic(stmt.value, imports, walk.tainted):
                    walk.tainted |= A.target_names(stmt.target)
            elif isinstance(stmt, ast.For):
                if self._rhs_dynamic(stmt.iter, imports, walk.tainted):
                    walk.tainted |= A.target_names(stmt.target)
                self._run_body(walk, stmt.body, imports)
                self._run_body(walk, stmt.orelse, imports)
            elif isinstance(stmt, (ast.While, ast.If)):
                self._run_body(walk, stmt.body, imports)
                self._run_body(walk, stmt.orelse, imports)
            elif isinstance(stmt, ast.With):
                self._run_body(walk, stmt.body, imports)
            elif isinstance(stmt, ast.Try):
                self._run_body(walk, stmt.body, imports)
                for h in stmt.handlers:
                    self._run_body(walk, h.body, imports)
                self._run_body(walk, stmt.orelse, imports)
                self._run_body(walk, stmt.finalbody, imports)
            elif isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                   ast.ClassDef)):
                continue

    def _check_operand(self, mod: SourceModule, call: ast.Call,
                       arg: ast.AST, symbol: str, site,
                       imports: Dict[str, str], tainted: Set[str],
                       findings: List[Finding]) -> None:
        """Tensor operands sliced to a dynamic length: `f(t[:n])`."""
        for sub in [n for n in ast.walk(arg)
                    if isinstance(n, ast.Subscript)]:
            slices = sub.slice.elts if isinstance(sub.slice, ast.Tuple) \
                else [sub.slice]
            for s in slices:
                if not isinstance(s, ast.Slice):
                    continue
                for bound in (s.lower, s.upper):
                    if bound is None or _sanitized(bound):
                        continue
                    if self._expr_dynamic(bound, imports, tainted):
                        findings.append(mod.finding(
                            self.id, "error", sub, symbol,
                            f"operand of entry point `{site.func.name}` "
                            "sliced to an unbucketed runtime length — "
                            "each distinct shape is one more dispatch "
                            "variant; bucket/pad the length before the "
                            "call"))
                        return
