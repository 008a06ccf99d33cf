"""C3 — writes through a numpy view of a tensor.

The counterpart of the JAX package's `analysis/device_views.py`, where
the hazard is the opposite. `np.asarray(<jax array>)` is a READ-ONLY view
of the device buffer, so a write raises `ValueError` (on the one branch
that writes). `t.numpy()` of a CPU tensor, and `np.asarray(t)`, share
memory with `t` and are writable: a write through them changes `t`
silently. On the card, `t.cpu()` is a copy, so the same write changes only
the copy. The CPU tests and the card then compute different things from
the same code: the write is a hidden mutation of the tensor on one device
and a no-op on the other. The fix is the same as in JAX: `np.array(...)`
(or `.copy()`) when the host needs to write.

The checker runs one ordered taint pass per function:

* **tensor taint**: values produced by entry-point calls, by `torch.*`
  calls, or by attribute calls resolved through a class's module-alias
  table (``self._V = V`` in ``__init__`` makes ``self._V.height_map(...)``
  resolve to ``jax_mapping_torch.ops.voxel.height_map``).
* **view taint**: ``t.numpy()``, ``t.cpu().numpy()``,
  ``t.detach().numpy()`` (any ``.numpy()`` call: only a tensor has one)
  and ``np.asarray(t)`` of a tensor-tainted ``t``. Subscripts of a view
  are views; ``np.array(x)`` / ``x.copy()`` / ``.astype(...)`` clear both
  taints (a fresh buffer).
* **flagged sinks** on view-tainted names: subscript stores, augmented
  assignment, in-place methods (`fill`, `sort`, `put`, ...),
  ``np.copyto(view, ...)``, and ``out=view`` keywords.
"""

from __future__ import annotations

import ast
from typing import Dict, Iterable, List, Optional, Set

from jax_mapping_torch.analysis import astutil as A
from jax_mapping_torch.analysis.core import Finding, SourceModule

#: ndarray methods that write through the receiver.
_INPLACE_METHODS = {"fill", "sort", "partition", "put", "itemset",
                    "setfield", "resize"}
#: calls that return a FRESH writable array (clear both taints).
_COPYING_CALLS = {"numpy.array", "numpy.ascontiguousarray",
                  "numpy.copy"}
_COPYING_METHODS = {"copy", "astype"}


def class_module_aliases(cls: "A.ClassInfo",
                         imports: Dict[str, str]) -> Dict[str, str]:
    """`self.<attr>` -> dotted module for `self._V = V`-style stashes
    of imported modules on the instance (incl. tuple assigns:
    `self._V, self._jnp = V, jnp`)."""
    out: Dict[str, str] = {}

    def record(target: ast.AST, value: ast.AST) -> None:
        attr = A._self_attr(target)
        if attr is not None and isinstance(value, ast.Name) \
                and value.id in imports:
            out[attr] = imports[value.id]

    for meth in cls.methods.values():
        for node in ast.walk(meth):
            if not isinstance(node, ast.Assign):
                continue
            for t in node.targets:
                if isinstance(t, ast.Tuple) \
                        and isinstance(node.value, ast.Tuple) \
                        and len(t.elts) == len(node.value.elts):
                    for te, ve in zip(t.elts, node.value.elts):
                        record(te, ve)
                else:
                    record(t, node.value)
    return out


class DeviceViewMutationChecker:
    id = "C3-device-view"

    def __init__(self, shared=None):
        from jax_mapping_torch.analysis.torch_hazards import _SharedRegistry
        self._shared = shared or _SharedRegistry()

    def run(self, modules: List[SourceModule]) -> Iterable[Finding]:
        registry = self._shared.get(modules).entries
        findings: List[Finding] = []
        for mod in modules:
            imports = A.import_table(mod.tree)
            alias_of_class: Dict[str, Dict[str, str]] = {
                cls.name: class_module_aliases(cls, imports)
                for cls in A.collect_classes(mod)}
            for func, symbol, cls_name in A.walk_functions(mod.tree):
                aliases = alias_of_class.get(cls_name, {})
                findings += self._scan(mod, func, symbol, imports,
                                       aliases, registry)
        return findings

    # -- resolution ----------------------------------------------------------

    def _call_target(self, call: ast.Call, mod: SourceModule,
                     imports: Dict[str, str],
                     aliases: Dict[str, str]) -> Optional[str]:
        """Fully-qualified dotted target of a call, resolving
        `self._V.height_map` through the class alias table."""
        f = call.func
        if isinstance(f, ast.Attribute):
            base = A._self_attr(f.value)
            if base is not None and base in aliases:
                return f"{aliases[base]}.{f.attr}"
        return A.resolve(f, imports)

    def _is_device_call(self, call: ast.Call, mod: SourceModule,
                        imports: Dict[str, str], aliases: Dict[str, str],
                        registry) -> bool:
        tgt = self._call_target(call, mod, imports, aliases)
        if tgt is not None:
            if tgt.startswith("torch."):
                return True
            module, _, name = tgt.rpartition(".")
            if (module, name) in registry:
                return True
        # Bare-name / from-import call sites (same-module entry points).
        pair = A.resolve_call_target(call, mod, imports)
        return pair is not None and pair in registry

    # -- the pass ------------------------------------------------------------

    def _scan(self, mod: SourceModule, func: ast.FunctionDef, symbol: str,
              imports: Dict[str, str], aliases: Dict[str, str],
              registry) -> List[Finding]:
        device: Set[str] = set()
        view: Set[str] = set()
        findings: List[Finding] = []

        def names_of(expr: ast.AST) -> Set[str]:
            return {n.id for n in ast.walk(expr)
                    if isinstance(n, ast.Name)}

        def classify(value: ast.AST) -> Optional[str]:
            """'view' | 'device' | 'clean' | None (propagate by names)."""
            for call in [n for n in ast.walk(value)
                         if isinstance(n, ast.Call)]:
                tgt = self._call_target(call, mod, imports, aliases) or ""
                if tgt in _COPYING_CALLS:
                    return "clean"
                if isinstance(call.func, ast.Attribute) \
                        and call.func.attr in _COPYING_METHODS:
                    return "clean"
                if isinstance(call.func, ast.Attribute) \
                        and call.func.attr == "numpy" and not call.args:
                    return "view"
                if tgt == "numpy.asarray" and call.args and (
                        names_of(call.args[0]) & (device | view)
                        or any(self._is_device_call(c, mod, imports,
                                                    aliases, registry)
                               for c in ast.walk(call.args[0])
                               if isinstance(c, ast.Call))):
                    return "view"
                if self._is_device_call(call, mod, imports, aliases,
                                        registry):
                    return "device"
            return None

        def flag(node: ast.AST, what: str) -> None:
            findings.append(mod.finding(
                self.id, "error", node, symbol,
                f"{what} a numpy view of a tensor — on the CPU the "
                "view shares the tensor's memory and the write changes "
                "the tensor, on the card `.cpu()` copied it and the "
                "write changes only the copy; np.array-copy it before "
                "writing"))

        def check_sinks(stmt: ast.stmt) -> None:
            if isinstance(stmt, ast.Assign):
                for t in stmt.targets:
                    base = t.value if isinstance(t, ast.Subscript) else None
                    if base is not None and names_of(base) & view:
                        flag(stmt, "subscript-assigning into")
            elif isinstance(stmt, ast.AugAssign):
                t = stmt.target
                if isinstance(t, ast.Subscript):
                    t = t.value
                if isinstance(t, ast.Name) and t.id in view:
                    flag(stmt, "augmented-assigning into")
            for call in A.statement_calls(stmt):
                tgt = self._call_target(call, mod, imports, aliases) or ""
                if isinstance(call.func, ast.Attribute) \
                        and call.func.attr in _INPLACE_METHODS \
                        and names_of(call.func.value) & view:
                    flag(call, f"calling .{call.func.attr}() on")
                if tgt in ("numpy.copyto", "numpy.place", "numpy.putmask",
                           "numpy.put") and call.args \
                        and names_of(call.args[0]) & view:
                    flag(call, "passing as the destination of an "
                               "in-place numpy op")
                for kw in call.keywords:
                    if kw.arg == "out" and names_of(kw.value) & view:
                        flag(call, "passing as out= to")

        def on_stmt(stmt: ast.stmt, _tainted: Set[str]) -> None:
            check_sinks(stmt)

        # An ordered pass with two taint sets, driving assignments
        # through classify().
        def run_body(body: List[ast.stmt]) -> None:
            for stmt in body:
                on_stmt(stmt, set())
                if isinstance(stmt, ast.Assign) or (
                        isinstance(stmt, ast.AnnAssign)
                        and stmt.value is not None):
                    targets = stmt.targets if isinstance(stmt, ast.Assign) \
                        else [stmt.target]
                    verdict = classify(stmt.value)
                    if verdict is None:
                        # Taint propagates only through direct aliasing
                        # (`y = x`, `y = x[k]`, `y = x.T`): a container
                        # or arithmetic over a view is a fresh object —
                        # `summary = {"k": int(view.sum())}` must not
                        # make `summary[...] = ...` a finding.
                        base = stmt.value
                        while isinstance(base, (ast.Subscript,
                                                ast.Attribute)):
                            base = base.value
                        src = ({base.id} if isinstance(base, ast.Name)
                               else set())
                        verdict = ("view" if src & view
                                   else "device" if src & device
                                   else "clean")
                    for t in targets:
                        bound = A.target_names(t)
                        # a subscript store binds no fresh local
                        if isinstance(t, ast.Subscript):
                            continue
                        view.difference_update(bound)
                        device.difference_update(bound)
                        if verdict == "view":
                            view.update(bound)
                        elif verdict == "device":
                            device.update(bound)
                elif isinstance(stmt, (ast.For,)):
                    run_body(stmt.body)
                    run_body(stmt.orelse)
                elif isinstance(stmt, (ast.While, ast.If)):
                    run_body(stmt.body)
                    run_body(stmt.orelse)
                elif isinstance(stmt, ast.With):
                    run_body(stmt.body)
                elif isinstance(stmt, ast.Try):
                    run_body(stmt.body)
                    for h in stmt.handlers:
                        run_body(h.body)
                    run_body(stmt.orelse)
                    run_body(stmt.finalbody)
                elif isinstance(stmt, (ast.FunctionDef,
                                       ast.AsyncFunctionDef,
                                       ast.ClassDef)):
                    continue

        run_body(func.body)
        return findings
