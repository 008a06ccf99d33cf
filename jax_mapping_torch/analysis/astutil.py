"""Shared AST machinery for the checker families.

A copy of the JAX package's `analysis/astutil.py` in which the jit
registry becomes the entry-point registry: the functions marked
`_util.entry_point`, with the static names of `static=(...)`.

Everything here is deliberately *syntactic* — no imports are executed,
no types inferred. Resolution is by name through each module's import
table, which is exactly as strong as the repo's own conventions
(`import torch`, `from jax_mapping_torch.ops import planner as P`) and
degrades to silence, not false positives, on code that breaks them.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, Iterator, List, Optional, Sequence, Set, Tuple

from jax_mapping_torch.analysis.core import SourceModule


# -- imports -----------------------------------------------------------------

def import_table(tree: ast.Module) -> Dict[str, str]:
    """`_import_table`, computed once per parsed module (kept on the
    tree; callers only read it)."""
    table = getattr(tree, "_import_table", None)
    if table is None:
        table = tree._import_table = _import_table(tree)
    return table


def _import_table(tree: ast.Module) -> Dict[str, str]:
    """Alias -> dotted target for module-level imports.

    `import numpy as np`              -> {"np": "numpy"}
    `import functools`                -> {"functools": "functools"}
    `from jax_mapping_torch.ops import planner as P`
                               -> {"P": "jax_mapping_torch.ops.planner"}
    `from jax_mapping_torch.bridge.brain import brain_tick`
                               -> {"brain_tick":
                                   "jax_mapping_torch.bridge.brain.brain_tick"}
    Function-local imports are included too (the repo defers heavy
    imports into tick bodies).
    """
    table: Dict[str, str] = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.asname:
                    table[a.asname] = a.name
                else:
                    table[a.name.split(".")[0]] = a.name.split(".")[0]
                    table[a.name] = a.name
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            for a in node.names:
                table[a.asname or a.name] = f"{node.module}.{a.name}"
    return table


def dotted(node: ast.AST) -> Optional[str]:
    """`a.b.c` expression -> "a.b.c"; None for anything else."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def resolve(node: ast.AST, imports: Dict[str, str]) -> Optional[str]:
    """Expression -> fully-qualified dotted name through the import
    table: `np.asarray` -> "numpy.asarray"."""
    d = dotted(node)
    if d is None:
        return None
    head, _, rest = d.partition(".")
    base = imports.get(head, head)
    return f"{base}.{rest}" if rest else base


# -- symbols -----------------------------------------------------------------

def walk_functions(tree: ast.Module) -> Iterator[Tuple[ast.AST, str,
                                                       Optional[str]]]:
    """Yield (funcdef, dotted symbol, enclosing class name) for every
    function/method, depth-first."""
    def rec(node, prefix: str, cls: Optional[str]):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                sym = f"{prefix}{child.name}"
                yield child, sym, cls
                yield from rec(child, f"{sym}.", cls)
            elif isinstance(child, ast.ClassDef):
                yield from rec(child, f"{prefix}{child.name}.", child.name)
    yield from rec(tree, "", None)


def node_symbols(tree: ast.Module) -> Dict[int, str]:
    """id(node) -> dotted symbol of the innermost function enclosing it
    (module-level nodes are absent), computed once per parsed module
    (kept on the tree)."""
    hit = getattr(tree, "_node_symbols", None)
    if hit is not None:
        return hit
    out: Dict[int, str] = {}

    def rec(node, prefix: str, sym: Optional[str]):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                csym = f"{prefix}{child.name}"
                out[id(child)] = sym if sym is not None else csym
                rec(child, f"{csym}.", csym)
            elif isinstance(child, ast.ClassDef):
                if sym is not None:
                    out[id(child)] = sym
                rec(child, f"{prefix}{child.name}.", sym)
            else:
                if sym is not None:
                    out[id(child)] = sym
                rec(child, prefix, sym)
    rec(tree, "", None)
    tree._node_symbols = out
    return out


def param_names(func: ast.FunctionDef) -> List[str]:
    a = func.args
    names = [p.arg for p in a.posonlyargs + a.args]
    if a.vararg:
        names.append(a.vararg.arg)
    names += [p.arg for p in a.kwonlyargs]
    if a.kwarg:
        names.append(a.kwarg.arg)
    return names


def names_in(node: ast.AST) -> Set[str]:
    """Every bare Name loaded anywhere inside `node`."""
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


#: attributes whose access yields host-side metadata, not values (the
#: checkers skip them when judging what flows into an expression).
STATIC_ATTRS = {"shape", "ndim", "dtype", "size", "device", "is_cuda",
                "layout", "requires_grad"}
#: tensor methods that return host-side metadata without a sync.
STATIC_METHODS = {"size", "dim", "numel", "element_size", "stride",
                  "get_device", "is_contiguous", "data_ptr", "nbytes",
                  "is_floating_point"}


def target_names(target: ast.AST) -> Set[str]:
    """Names *bound* by an assignment target (x, (a, b), x[i] binds x)."""
    out: Set[str] = set()
    for n in ast.walk(target):
        if isinstance(n, ast.Name):
            out.add(n.id)
        elif isinstance(n, ast.Attribute):
            break                    # self.x = ... binds no local
    return out


def receiver_base(node: ast.AST) -> Optional[str]:
    """The root Name of an attribute/subscript chain (`r.path_xy[v]`
    -> "r"); None when rooted elsewhere (call result, literal)."""
    while isinstance(node, (ast.Attribute, ast.Subscript)):
        node = node.value
    return node.id if isinstance(node, ast.Name) else None


# -- entry-point registry ----------------------------------------------------

@dataclass
class EntrySite:
    """A function marked `_util.entry_point`: the port's counterpart of one
    of the JAX package's jitted functions (its `JitSite`). `static` is the
    decorator's `static=(...)`, the counterpart of `static_argnames`: those
    arguments key a dispatch-profiler variant by value."""
    module: SourceModule
    func: ast.FunctionDef
    symbol: str
    static: Tuple[str, ...] = ()
    decorator: ast.AST = None

    @property
    def params(self) -> List[str]:
        return param_names(self.func)

    @property
    def static_params(self) -> Set[str]:
        return set(self.static) & set(self.params)

    @property
    def traced_params(self) -> Set[str]:
        """The tensor-carrying parameters: everything not static."""
        return set(self.params) - self.static_params - {"self", "cls"}


def _const_strs(node: ast.AST) -> Tuple[str, ...]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return (node.value,)
    if isinstance(node, (ast.Tuple, ast.List)):
        return tuple(e.value for e in node.elts
                     if isinstance(e, ast.Constant)
                     and isinstance(e.value, str))
    return ()


def _is_entry_point_name(target: Optional[str]) -> bool:
    return target is not None and (
        target == "entry_point" or target.endswith("_util.entry_point"))


def entry_decorator_info(dec: ast.AST, imports: Dict[str, str]
                         ) -> Optional[Tuple[str, ...]]:
    """The static names when `dec` marks an entry point: `@entry_point`,
    `@entry_point(static=(...))`, `@_util.entry_point(...)` (any import
    path ending in `_util.entry_point`). None otherwise."""
    if _is_entry_point_name(resolve(dec, imports)):
        return ()
    if not isinstance(dec, ast.Call) \
            or not _is_entry_point_name(resolve(dec.func, imports)):
        return None
    for kw in dec.keywords:
        if kw.arg == "static":
            return _const_strs(kw.value)
    return ()


def build_entry_registry(modules: Sequence[SourceModule]
                         ) -> Dict[Tuple[str, str], EntrySite]:
    """(module dotted name, function name) -> EntrySite, package-wide."""
    registry: Dict[Tuple[str, str], EntrySite] = {}
    for mod in modules:
        imports = import_table(mod.tree)
        for func, symbol, _cls in walk_functions(mod.tree):
            for dec in getattr(func, "decorator_list", ()):
                static = entry_decorator_info(dec, imports)
                if static is not None:
                    registry[(mod.dotted, func.name)] = EntrySite(
                        module=mod, func=func, symbol=symbol,
                        static=static, decorator=dec)
                    break
    return registry


def resolve_call_target(call: ast.Call, mod: SourceModule,
                        imports: Dict[str, str]) -> Optional[Tuple[str,
                                                                   str]]:
    """Call site -> (module dotted, func name) candidate for registry
    lookup. `brain_tick(...)` in its own module -> (mod, brain_tick);
    `P.plan_to_goal(...)` -> (resolved P, plan_to_goal)."""
    f = call.func
    if isinstance(f, ast.Name):
        tgt = imports.get(f.id)
        if tgt and "." in tgt:                   # from-import of a symbol
            m, _, n = tgt.rpartition(".")
            return m, n
        return mod.dotted, f.id
    if isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name):
        base = imports.get(f.value.id)
        if base:
            return base, f.attr
    return None


# -- statements ------------------------------------------------------------

def statement_calls(stmt: ast.stmt) -> List[ast.Call]:
    """Every Call in `stmt`'s own expressions — nested statements are
    excluded (the walks visit them with their own on_stmt call, so
    descending here would double-count), as are nested def bodies."""
    out: List[ast.Call] = []
    stack: List[ast.AST] = [stmt]
    while stack:
        node = stack.pop()
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.stmt, ast.ExceptHandler)):
                continue
            if isinstance(child, ast.Call):
                out.append(child)
            stack.append(child)
    return out


# -- class structure (bridge checkers + hot-path roots) ----------------------

@dataclass
class ClassInfo:
    module: SourceModule
    node: ast.ClassDef
    name: str
    methods: Dict[str, ast.FunctionDef] = field(default_factory=dict)
    #: self attrs assigned threading.Lock()/RLock()/Condition() in any
    #: method, attr -> "Lock"|"RLock"|"Condition"
    lock_attrs: Dict[str, str] = field(default_factory=dict)
    #: methods registered as timer callbacks (per-tick hot roots)
    timer_callbacks: Set[str] = field(default_factory=set)
    #: methods registered as subscription callbacks
    sub_callbacks: Set[str] = field(default_factory=set)


def _self_attr(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute) and isinstance(node.value, ast.Name) \
            and node.value.id == "self":
        return node.attr
    return None


def _callback_method(arg: ast.AST) -> Optional[str]:
    """`self.tick` or `functools.partial(self._scan_cb, i)` -> method."""
    m = _self_attr(arg)
    if m is not None:
        return m
    if isinstance(arg, ast.Call) and arg.args:
        fn = dotted(arg.func) or ""
        if fn.endswith("partial"):
            return _self_attr(arg.args[0])
    return None


def collect_classes(mod: SourceModule) -> List[ClassInfo]:
    """`_collect_classes`, computed once per module (kept on the module;
    callers only read it)."""
    hit = getattr(mod, "_classes", None)
    if hit is None:
        hit = mod._classes = _collect_classes(mod)
    return hit


def _collect_classes(mod: SourceModule) -> List[ClassInfo]:
    imports = import_table(mod.tree)
    out: List[ClassInfo] = []
    for node in mod.tree.body:
        if not isinstance(node, ast.ClassDef):
            continue
        info = ClassInfo(module=mod, node=node, name=node.name)
        for item in node.body:
            if isinstance(item, ast.FunctionDef):
                info.methods[item.name] = item
        for meth in info.methods.values():
            for sub in ast.walk(meth):
                if isinstance(sub, ast.Assign) and len(sub.targets) == 1:
                    attr = _self_attr(sub.targets[0])
                    if attr is None or not isinstance(sub.value, ast.Call):
                        continue
                    target = resolve(sub.value.func, imports) or ""
                    kind = target.rpartition(".")[2]
                    if target.startswith("threading.") and kind in (
                            "Lock", "RLock", "Condition"):
                        info.lock_attrs[attr] = kind
                elif isinstance(sub, ast.Call):
                    fn = dotted(sub.func) or ""
                    if fn == "self.create_timer" and len(sub.args) >= 2:
                        cb = _callback_method(sub.args[1])
                        if cb:
                            info.timer_callbacks.add(cb)
                    elif fn == "self.create_subscription" \
                            and len(sub.args) >= 2:
                        cb = _callback_method(sub.args[1])
                        if cb:
                            info.sub_callbacks.add(cb)
        out.append(info)
    return out


def self_calls(func: ast.FunctionDef) -> Set[str]:
    """Names of same-class methods invoked as `self.m(...)`."""
    out: Set[str] = set()
    for node in ast.walk(func):
        if isinstance(node, ast.Call):
            m = _self_attr(node.func)
            if m is not None:
                out.add(m)
    return out
