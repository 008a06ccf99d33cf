"""Family A — hazards of the port on the card.

The counterpart of the JAX package's `analysis/jax_hazards.py`, with each
hazard in its torch meaning. JAX's boundary is the jit trace; the port's
is the CUDA stream: a call that needs a value, a shape or a copy the card
has not finished makes the host wait for it (a host sync), and the
staged warm-up (`resilience/warmup.py`) and the cost ledger
(`obs/ledger.py`) call every entry point on zeros, so an entry point must
be a pure function of its arguments.

A1 `A1-host-sync`      the operations that synchronise a card tensor:
                       `.item()`, `.tolist()`, `.cpu()`, `.numpy()`,
                       `.to("cpu")`; `float()`, `int()`, `bool()` and
                       `np.asarray`/`np.array` of a tensor; `if`, `while`,
                       `assert`, `not`, `and`/`or` and a conditional
                       expression on a tensor; `torch.equal`/`allclose`;
                       `torch.linalg.cholesky`/`inv`/`solve` (they read
                       their error info on the host);
                       the ops whose output shape depends on the data
                       (`nonzero`, `unique`, `masked_select`, `argwhere`,
                       boolean-mask indexing `x[mask]`, `repeat_interleave`
                       without `output_size`); and the blocking copy of a
                       host value onto the card (`torch.as_tensor(x,
                       device=...)`, `torch.tensor(..., device=...)`,
                       `x.to(dev)`, `x.cuda()`, and an indexed store
                       `x[idx] = 0.0` with tensor indices, which copies
                       the scalar over), which waits for the stream as a
                       copy back does. A call of a package function
                       whose body syncs its argument unconditionally (a
                       *sync helper*: `interop.slam_state_to_numpy`) is a
                       sync at the call. Inside an entry point or its
                       package-local callees a sync is an error; anywhere
                       else it is a warning ("in per-tick hot path" when a
                       timer or subscription callback reaches it).
A2 `A2-entry-hygiene`  a `static=` name that is not a parameter; an
                       unhashable literal in a static position at a call of
                       a known entry point (the dispatch profiler keys a
                       variant by the static values, `obs/devprof.py`); a
                       `for` over `range(<tensor>)`, which syncs and runs
                       one Python step per element.
A3 `A3-dtype-drift`    float64 on its way to the card: `torch.float64`,
                       `torch.double`, `.double()`, and `torch.as_tensor` /
                       `from_numpy` / `tensor` without `dtype=` of a numpy
                       value built as float64 (`np.float64`, `dtype=float`,
                       a dtype-less `np.array` over float literals). A
                       call that names `device="cpu"` builds a host
                       tensor and is clear.
A4 `A4-impure-entry`   inside entry points and their package-local
                       callees: draws from a global RNG (`torch.rand*`,
                       `randn*`, `randint`, `randperm`, `normal`,
                       `bernoulli`, `multinomial`, `poisson` or an in-place
                       `.uniform_()`... without `generator=`;
                       `np.random.<fn>`; `random.<fn>`), and mutation of
                       `self.<attr>` or of a module global. The warm-up and
                       the ledger call entry points on zeros, so a side
                       effect there corrupts state; the port's rule is an
                       explicit generator and explicit noise tensors.

Which values may lie on the card is a syntactic taint, as in the JAX
checkers: the results of entry-point calls, of `torch.*` factories and
`.to(...)`/`.cuda()` with a device that is not the literal CPU, of package
functions that return such a value (one summary pass), and the tensor
attributes of a class (`self.x` assigned from any of these in any method).
`.cpu()`, `.numpy()`, `.item()`, `.tolist()`, `float()`/`int()`, numpy
calls and a `torch.*` call with `device="cpu"` give host values. Hot-path
roots are discovered, not configured: every `self.create_timer` and
`self.create_subscription` callback and the methods it reaches through
`self.m()`.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from jax_mapping_torch.analysis import astutil as A
from jax_mapping_torch.analysis.core import Finding, SourceModule

#: tensor methods that copy a value to the host.
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
#: tensor methods / torch functions whose output shape depends on data.
_SHAPE_SYNC = {"nonzero", "unique", "unique_consecutive", "masked_select",
               "argwhere"}
#: torch functions that reduce to a host bool.
_BOOL_SYNC = {"equal", "allclose", "is_nonzero"}
#: torch.linalg functions that read their LAPACK info on the host to raise
#: on a singular input (the `_ex` forms do not).
_INFO_SYNC = {"linalg.cholesky", "linalg.inv", "linalg.solve",
              "linalg.lu_factor", "linalg.eigh", "linalg.eigvalsh",
              "linalg.lstsq", "linalg.matrix_rank", "linalg.pinv",
              "cholesky", "inverse", "cholesky_inverse"}
#: calls that turn a tensor into a Python scalar.
_HOST_SCALARS = {"float", "int", "bool", "complex"}
#: numpy conversions of a tensor (copy it to the host).
_HOST_CONVERTERS = {"numpy.asarray", "numpy.array"}
#: torch constructors that copy host data into a new tensor.
_COPY_CTORS = {"torch.as_tensor", "torch.tensor"}
#: calls whose result is a boolean mask.
_MASK_CALLS = {"isfinite", "isnan", "isinf", "isneginf", "isposinf",
               "logical_and", "logical_or", "logical_not", "logical_xor",
               "eq", "ne", "gt", "ge", "lt", "le", "bool", "isin"}
#: torch factories of new values (a call with no `device=` builds them on
#: the CPU); the copies of host data (`as_tensor`, `tensor`) are A3's own
#: rule.
_FACTORIES = {"zeros", "ones", "empty", "full", "arange", "linspace",
              "eye"}
#: attributes of `torch` that name a float64 dtype.
_F64_NAMES = {"torch.float64", "torch.double"}
#: global-RNG draws in torch (a `generator=` keyword makes them explicit).
_RNG_TORCH = {"rand", "rand_like", "randn", "randn_like", "randint",
              "randint_like", "randperm", "normal", "bernoulli",
              "multinomial", "poisson"}
_RNG_METHODS = {"uniform_", "normal_", "bernoulli_", "random_",
                "exponential_", "geometric_", "cauchy_", "log_normal_"}
#: numpy.random / random names that build an explicit generator.
_RNG_CTORS = {"default_rng", "Generator", "RandomState", "SeedSequence",
              "PCG64", "Random", "SystemRandom"}
#: container methods that mutate their receiver in place.
_MUTATORS = {"append", "extend", "insert", "pop", "popitem", "remove",
             "clear", "update", "setdefault", "add", "discard"}


# -- expression helpers ------------------------------------------------------

def _target(call: ast.Call, imports: Dict[str, str]) -> str:
    return A.resolve(call.func, imports) or ""


def _method(call: ast.Call) -> Optional[str]:
    return call.func.attr if isinstance(call.func, ast.Attribute) else None


def _kw(call: ast.Call, name: str) -> Optional[ast.AST]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def _is_cpu(expr: Optional[ast.AST], imports: Dict[str, str]) -> bool:
    """`"cpu"`, `"cpu:0"` or `torch.device("cpu")`."""
    if isinstance(expr, ast.Constant) and isinstance(expr.value, str):
        return expr.value.split(":")[0] == "cpu"
    if isinstance(expr, ast.Call) and _target(expr, imports) \
            == "torch.device" and expr.args:
        return _is_cpu(expr.args[0], imports)
    return False


def _is_dtype(expr: ast.AST, imports: Dict[str, str]) -> bool:
    if isinstance(expr, ast.Attribute) and expr.attr == "dtype":
        return True                       # `.to(other.dtype)`
    t = A.resolve(expr, imports) or ""
    return t.startswith("torch.") and (
        t[6:].startswith(("float", "int", "uint", "bool", "complex",
                          "half", "double", "long", "bfloat", "short")))


def _to_device(call: ast.Call, imports: Dict[str, str]
               ) -> Optional[ast.AST]:
    """The device of `x.to(dev)` / `x.to(device=dev)` (None: a dtype-only
    `.to`, or not a `.to` call)."""
    if _method(call) != "to":
        return None
    dev = _kw(call, "device")
    if dev is not None:
        return dev
    if call.args and not _is_dtype(call.args[0], imports):
        return call.args[0]
    return None


def _dotted_tokens(expr: ast.AST) -> List[str]:
    """The dotted prefixes of a Name/Attribute chain: `self.a.b` ->
    "self", "self.a", "self.a.b"."""
    d = A.dotted(expr)
    if d is None:
        return []
    parts = d.split(".")
    return [".".join(parts[:i + 1]) for i in range(len(parts))]


def _bound_tokens(target: ast.AST) -> Set[str]:
    """What an assignment target binds: names, `self.x` chains, and for a
    subscript store the container (`self.states[i] = ...` -> self.states)."""
    if isinstance(target, (ast.Tuple, ast.List)):
        out: Set[str] = set()
        for e in target.elts:
            out |= _bound_tokens(e)
        return out
    if isinstance(target, ast.Starred):
        return _bound_tokens(target.value)
    if isinstance(target, ast.Subscript):
        d = A.dotted(target.value)
        return {d} if d else set()
    d = A.dotted(target)
    return {d} if d else set()


# -- the shared registry -----------------------------------------------------

class Registry:
    """Package-wide facts every A/C checker reads, built once per module
    set: the entry points, the module functions, the classes with their
    tensor attributes, the package functions that return card values,
    and the sync helpers."""

    def __init__(self, modules: Sequence[SourceModule]):
        self.modules = list(modules)
        self.entries = A.build_entry_registry(modules)
        self.imports = {m.dotted: A.import_table(m.tree) for m in modules}
        #: (module, name) -> (module, func) for module-level functions
        #: (nested ones too, by their own name, as JAX's registry has).
        self.functions: Dict[Tuple[str, str],
                             Tuple[SourceModule, ast.FunctionDef]] = {}
        #: (module, symbol) -> (module, func, class name or None)
        self.by_symbol: Dict[Tuple[str, str],
                             Tuple[SourceModule, ast.FunctionDef,
                                   Optional[str]]] = {}
        #: id(funcdef) -> its symbol
        self.symbol_of: Dict[int, str] = {}
        for mod in modules:
            for func, sym, cls in A.walk_functions(mod.tree):
                if not isinstance(func, ast.FunctionDef):
                    continue
                self.by_symbol[(mod.dotted, sym)] = (mod, func, cls)
                self.symbol_of[id(func)] = sym
                if cls is None:
                    self.functions.setdefault((mod.dotted, func.name),
                                              (mod, func))
        #: (id(call), class) -> call_source verdict; reset as the
        #: summaries grow
        self.source_cache: Dict[Tuple[int, Optional[str]], bool] = {}
        self.classes: Dict[Tuple[str, str], "A.ClassInfo"] = {}
        for mod in modules:
            for cls in A.collect_classes(mod):
                self.classes[(mod.dotted, cls.name)] = cls
        #: (module, symbol) of functions whose result may be on the card
        self.device_returning: Set[Tuple[str, str]] = set()
        #: (module, symbol) of functions whose result derives from their
        #: arguments: on the card when an argument is
        self.param_returning: Set[Tuple[str, str]] = set()
        #: (module, class) -> "self.x" tokens that hold card tensors
        self.tensor_attrs: Dict[Tuple[str, str], Set[str]] = {}
        #: (module, symbol) -> per-position taint of its tuple result
        self.tuple_returns: Dict[Tuple[str, str], List[bool]] = {}
        #: names of the package's NamedTuple records with tensor fields
        #: (`SlamState`, `PoseGraph`): a parameter annotated with one
        #: carries card values
        self.record_types: Set[str] = set()
        for mod in modules:
            for node in mod.tree.body:
                if isinstance(node, ast.ClassDef) and any(
                        (A.dotted(b) or "").endswith("NamedTuple")
                        for b in node.bases) and any(
                        isinstance(st, ast.AnnAssign)
                        and "Tensor" in ast.unparse(st.annotation)
                        for st in node.body):
                    self.record_types.add(node.name)
        #: attribute names some class holds card tensors in, and method
        #: names whose every package definition returns card values: the
        #: cross-object reads (`self.mapper.states`, `st.mapper.
        #: merged_grid()`) resolve through them by name
        self.tensor_attr_names: Set[str] = set()
        self.device_method_names: Set[str] = set()
        self._summarize()
        self.sync_helpers = self._sync_helpers()
        self._scope: Optional[Dict[Tuple[str, str], Set[str]]] = None

    # -- resolution -----------------------------------------------------------

    def callee(self, call: ast.Call, mod: SourceModule,
               cls: Optional[str]) -> Optional[Tuple[str, str]]:
        """(module, symbol) of a package function or method `call` names:
        `f(...)`, `M.f(...)` through the import table, `self.m(...)`
        inside class `cls`."""
        f = call.func
        if cls is not None and isinstance(f, ast.Attribute) \
                and isinstance(f.value, ast.Name) and f.value.id == "self":
            key = (mod.dotted, f"{cls}.{f.attr}")
            return key if key in self.by_symbol else None
        tgt = A.resolve_call_target(call, mod, self.imports[mod.dotted])
        if tgt is None:
            return None
        if tgt in self.functions:
            m, func = self.functions[tgt]
            return (m.dotted, self.symbol_of[id(func)])
        return None

    def scope(self) -> Dict[Tuple[str, str], Set[str]]:
        """`entry_scope(self)`, computed once."""
        if self._scope is None:
            self._scope = entry_scope(self)
        return self._scope

    def is_entry_call(self, call: ast.Call, mod: SourceModule) -> bool:
        tgt = A.resolve_call_target(call, mod, self.imports[mod.dotted])
        return tgt is not None and tgt in self.entries

    def entry_of(self, call: ast.Call, mod: SourceModule):
        tgt = A.resolve_call_target(call, mod, self.imports[mod.dotted])
        return self.entries.get(tgt) if tgt else None

    # -- summaries ------------------------------------------------------------

    def _summarize(self) -> None:
        """Tensor attributes and card-returning functions, to a fixpoint
        (a few rounds: each round follows one more level of calls)."""
        for _round in range(4):
            changed = False
            self.source_cache.clear()
            self._name_maps()
            for (dotted, sym), (mod, func, cls) in self.by_symbol.items():
                attrs = self.tensor_attrs.get((dotted, cls), set()) \
                    if cls else set()
                walk = DeviceWalk(self, mod, cls, set(attrs))
                walk.run(func.body)
                key = (dotted, sym)
                params = set(A.param_names(func)) - {"self", "cls"} \
                    - host_params(func)
                if key not in self.param_returning and params:
                    pw = DeviceWalk(self, mod, cls, set(params))
                    pw.run(func.body)
                    if pw.returns_device:
                        self.param_returning.add(key)
                        changed = True
                if cls is not None and walk.stored_attrs - attrs:
                    self.tensor_attrs.setdefault((dotted, cls), set()) \
                        .update(walk.stored_attrs)
                    changed = True
                key = (dotted, sym)
                if walk.returns_device and key not in self.device_returning \
                        and (mod.dotted, func.name) not in self.entries:
                    self.device_returning.add(key)
                    changed = True
                if walk.returns_tuple is not None \
                        and self.tuple_returns.get(key) != walk.returns_tuple:
                    old = self.tuple_returns.get(key)
                    merged = walk.returns_tuple if old is None or len(
                        old) != len(walk.returns_tuple) else [
                            a or b for a, b in zip(old, walk.returns_tuple)]
                    if merged != old:
                        self.tuple_returns[key] = merged
                        changed = True
            if not changed:
                break
        self.source_cache.clear()
        self._name_maps()

    def _name_maps(self) -> None:
        self.tensor_attr_names = {t.split(".", 1)[1]
                                  for ts in self.tensor_attrs.values()
                                  for t in ts}
        by_name: Dict[str, List[bool]] = {}
        for (dotted, sym), (_m, func, cls) in self.by_symbol.items():
            if cls is not None and sym.count(".") == 1:
                by_name.setdefault(func.name, []).append(
                    (dotted, sym) in self.device_returning)
        self.device_method_names = {n for n, flags in by_name.items()
                                    if all(flags) and not n.startswith("__")}

    def _sync_helpers(self) -> Set[Tuple[str, str]]:
        """Package functions whose body syncs a parameter unconditionally:
        a sync op at the top level of the body (or of a nested helper the
        body calls) on a value derived from a parameter."""
        out: Set[Tuple[str, str]] = set()
        for (dotted, sym), (mod, func, cls) in self.by_symbol.items():
            if (mod.dotted, func.name) in self.entries:
                continue
            if "." in sym and cls is None:
                continue                  # a nested def: its parent counts
            params = set(A.param_names(func)) - {"self", "cls"}
            if not params:
                continue
            nested = {n.name: n for n in func.body
                      if isinstance(n, ast.FunctionDef)}
            seeds = set(params)
            for inner in nested.values():
                seeds |= set(A.param_names(inner))
            if _syncs_unconditionally(self, mod, cls, func, seeds, nested):
                out.add((dotted, sym))
        return out


def _syncs_unconditionally(reg: Registry, mod: SourceModule,
                           cls: Optional[str], func: ast.FunctionDef,
                           seeds: Set[str],
                           nested: Dict[str, ast.FunctionDef]) -> bool:
    """A sync op on a parameter-derived value outside any branch but a
    tensor guard (`if torch.is_tensor(x):`, `... if isinstance(x,
    torch.Tensor) else ...`): loops and `with` bodies count."""
    imports = reg.imports[mod.dotted]

    def stmts(body):
        for stmt in body:
            if isinstance(stmt, ast.If):
                if tensor_guard(stmt.test):
                    yield from stmts(stmt.body)
                continue
            if isinstance(stmt, (ast.For, ast.While, ast.With)):
                yield from stmts(stmt.body)
                continue
            if isinstance(stmt, (ast.Try, ast.FunctionDef, ast.ClassDef,
                                 ast.AsyncFunctionDef)):
                continue
            yield stmt

    def of_param(e: ast.AST) -> bool:
        """A value built from a parameter (not a list of host scalars)."""
        return not isinstance(e, (ast.List, ast.Tuple)) \
            and bool(A.names_in(e) & seeds)

    for body in [func.body] + [n.body for n in nested.values()]:
        for stmt in stmts(body):
            for call in A.statement_calls(stmt):
                m = _method(call)
                if m in ("cpu", "numpy", "tolist", "item") \
                        and of_param(call.func.value):
                    return True
                if _target(call, imports) in _HOST_CONVERTERS \
                        and call.args and of_param(call.args[0]):
                    return True
    return False


class _SharedRegistry:
    """One `Registry` build feeding A1-A4, C3 and C4 (the analogue of
    `lock_discipline._SharedWalk`): `all_checkers` hands them a shared
    instance so a full analysis walks every module once; a checker
    constructed on its own gets a private one. Re-keyed by module-set
    identity."""

    def __init__(self):
        self._key = None
        self._registry = None

    def get(self, modules: Sequence[SourceModule]) -> Registry:
        key = tuple(id(m) for m in modules)
        if key != self._key:
            self._registry = Registry(modules)
            self._key = key
        return self._registry


# -- the device-taint walk ---------------------------------------------------

class DeviceWalk:
    """Statement-ordered walk of one function body tracking which names
    and `self.x` chains may hold card tensors (the JAX checkers'
    `TaintWalk`, on dotted tokens, with an expression evaluator in place of
    name propagation). `on_stmt(stmt)` is called before each statement is
    applied; `stored_attrs` collects the `self.x` the body assigns card
    values to, `returns_device` whether a `return` does, `masks` the
    names bound to boolean masks and `containers` those bound to lists,
    tuples and dicts (whose truth value is their length)."""

    def __init__(self, reg: Registry, mod: SourceModule,
                 cls: Optional[str], tainted: Set[str], on_stmt=None):
        self.reg, self.mod, self.cls = reg, mod, cls
        self.imports = reg.imports[mod.dotted]
        self.tainted = tainted
        self.masks: Set[str] = set()
        self.containers: Set[str] = set()
        self.on_stmt = on_stmt
        self.stored_attrs: Set[str] = set()
        self.returns_device = False
        #: per-position taint of the tuples `return a, b, c` returns (None:
        #: no tuple return, or tuples of different lengths)
        self.returns_tuple: Optional[List[bool]] = None
        self._n_returns = 0

    # -- judging calls --------------------------------------------------------

    def call_source(self, call: ast.Call) -> bool:
        """A call whose result is a card tensor whatever its inputs."""
        key = (id(call), self.cls)
        hit = self.reg.source_cache.get(key)
        if hit is None:
            hit = self.reg.source_cache[key] = self._call_source(call)
        return hit

    def _call_source(self, call: ast.Call) -> bool:
        if self.reg.is_entry_call(call, self.mod):
            return True
        tgt = _target(call, self.imports)
        dev = _kw(call, "device")
        if tgt.startswith("torch.") and dev is not None \
                and not _is_cpu(dev, self.imports):
            return True
        to = _to_device(call, self.imports)
        if to is not None and not _is_cpu(to, self.imports):
            return True
        if _method(call) == "cuda":
            return True
        callee = self.reg.callee(call, self.mod, self.cls)
        return callee is not None and callee in self.reg.device_returning

    def call_host(self, call: ast.Call) -> bool:
        """A call whose result is a host value whatever its input."""
        m = _method(call)
        if m in _SYNC_METHODS or m in A.STATIC_METHODS:
            return True
        to = _to_device(call, self.imports)
        if to is not None and _is_cpu(to, self.imports):
            return True
        if isinstance(call.func, ast.Name) and call.func.id in (
                _HOST_SCALARS | {"len", "str", "repr", "range", "round",
                                 "isinstance", "hasattr", "callable",
                                 "id", "type", "getattr"}):
            return True
        tgt = _target(call, self.imports)
        if tgt.startswith("numpy.") or tgt.startswith("torch.is_"):
            return True
        dev = _kw(call, "device")
        return tgt.startswith("torch.") and _is_cpu(dev, self.imports)

    # -- judging expressions --------------------------------------------------

    def is_tainted(self, expr: ast.AST, bound: Optional[Set[str]] = None
                   ) -> bool:
        """Whether `expr` may evaluate to a card tensor (or a container of
        them). `bound` holds comprehension variables over card values."""
        t = self.tainted if bound is None else (self.tainted | bound)
        ev = lambda e: self.is_tainted(e, bound)              # noqa: E731
        if isinstance(expr, ast.Name):
            return expr.id in t
        if isinstance(expr, ast.Attribute):
            chain, base = [], expr
            while isinstance(base, ast.Attribute):
                chain.append(base.attr)
                base = base.value
            if any(a in A.STATIC_ATTRS for a in chain):
                return False              # shape, dtype, device: host
            toks = _dotted_tokens(expr)
            if toks:
                if any(k in t for k in toks):
                    return True
                return self._foreign_attr(toks[-1])
            return ev(base) or self._foreign_attr(
                ".".join(["?"] + chain[::-1]))
        if isinstance(expr, ast.Call):
            if self.call_host(expr):
                return False
            if self.call_source(expr):
                return True
            if isinstance(expr.func, ast.Attribute):
                tgt = _target(expr, self.imports)
                if tgt.startswith("torch."):
                    return any(ev(a) for a in expr.args) or any(
                        ev(k.value) for k in expr.keywords
                        if k.arg not in _META_KWARGS)
                callee = self.reg.callee(expr, self.mod, self.cls)
                if callee is not None:    # a package function: summarized
                    return callee in self.reg.param_returning and (
                        any(ev(a) for a in expr.args)
                        or any(ev(k.value) for k in expr.keywords))
                base = expr.func.value
                if not (isinstance(base, ast.Name)
                        and base.id in self.imports):
                    if expr.func.attr in self.reg.device_method_names \
                            and not (isinstance(base, ast.Name)
                                     and base.id == "self"):
                        return True       # `st.mapper.merged_grid()`
                    return ev(base)       # a method of a tensor
                # `M.Class(...)` / `M.f(...)` of another module: by its
                # arguments, as below.
            callee = self.reg.callee(expr, self.mod, self.cls)
            if callee is not None:        # a package function: summarized
                return callee in self.reg.param_returning and (
                    any(ev(a) for a in expr.args)
                    or any(ev(k.value) for k in expr.keywords))
            # A class (a NamedTuple of tensors) or an unknown callable:
            # by its arguments.
            return any(ev(a) for a in expr.args) or any(
                ev(k.value) for k in expr.keywords
                if k.arg not in _META_KWARGS)
        if isinstance(expr, ast.Subscript):
            return ev(expr.value)
        if isinstance(expr, ast.BinOp):
            return ev(expr.left) or ev(expr.right)
        if isinstance(expr, ast.UnaryOp):
            return not isinstance(expr.op, ast.Not) and ev(expr.operand)
        if isinstance(expr, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in expr.ops):
                return False
            sides = [expr.left] + expr.comparators
            if any(isinstance(c, ast.Constant)
                   and isinstance(c.value, (str, bytes, type(None)))
                   for c in sides):
                return False              # a string or None compare
            if any(self.is_container(c) and not ev(c) for c in sides):
                return False              # a host tuple or list compare
            return ev(expr.left) or any(ev(c) for c in expr.comparators)
        if isinstance(expr, ast.BoolOp):
            return any(ev(v) for v in expr.values)
        if isinstance(expr, ast.IfExp):
            guard = tensor_guard(expr.test)
            if guard:
                return self.is_tainted(expr.body, (bound or set()) | guard) \
                    or ev(expr.orelse)
            return ev(expr.body) or ev(expr.orelse)
        if isinstance(expr, (ast.List, ast.Tuple, ast.Set)):
            return any(ev(e) for e in expr.elts)
        if isinstance(expr, ast.Starred):
            return ev(expr.value)
        if isinstance(expr, ast.Dict):
            return any(ev(v) for v in expr.values if v is not None)
        if isinstance(expr, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                             ast.DictComp)):
            inner = set(bound or ())
            for gen in expr.generators:
                if self.is_tainted(gen.iter, inner or None):
                    inner |= A.target_names(gen.target)
            elts = [expr.key, expr.value] if isinstance(
                expr, ast.DictComp) else [expr.elt]
            return any(self.is_tainted(e, inner or None) for e in elts)
        if isinstance(expr, ast.NamedExpr):
            return ev(expr.value)
        return False

    def _foreign_attr(self, dotted: str) -> bool:
        """`a.b.X...` with X a card-tensor attribute of some package class
        (`self.mapper.states`, `st.mapper.shared_grid`): by name, past the
        root, never through a config."""
        parts = dotted.split(".")
        if len(parts) < 3 or any(p in _HOST_PARAM_NAMES or p.endswith("cfg")
                                 for p in parts):
            return False
        return any(p in self.reg.tensor_attr_names for p in parts[2:])

    def is_container(self, expr: ast.AST) -> bool:
        """A list/tuple/dict (by construction or by name): its truth value
        is its length, not a tensor's."""
        if isinstance(expr, (ast.List, ast.Tuple, ast.Dict, ast.Set,
                             ast.ListComp, ast.DictComp, ast.SetComp)):
            return True
        if isinstance(expr, ast.IfExp):
            return self.is_container(expr.body) or self.is_container(
                expr.orelse)
        d = A.dotted(expr)
        return d is not None and d in self.containers

    def is_mask(self, expr: ast.AST) -> bool:
        """A boolean-mask expression: a comparison, `~m`, `m & n`, a name
        bound to one, or a mask-making call."""
        if isinstance(expr, ast.Compare) and not all(
                isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                for op in expr.ops):
            return True
        if isinstance(expr, ast.UnaryOp) and isinstance(expr.op, ast.Invert):
            return True
        if isinstance(expr, ast.BinOp) and isinstance(
                expr.op, (ast.BitAnd, ast.BitOr, ast.BitXor)):
            return self.is_mask(expr.left) or self.is_mask(expr.right)
        if isinstance(expr, ast.Name):
            return expr.id in self.masks
        if isinstance(expr, ast.Call):
            m = _method(expr) or (expr.func.id if isinstance(
                expr.func, ast.Name) else None)
            return m in _MASK_CALLS
        return False

    # -- the walk -------------------------------------------------------------

    def _assign(self, targets: List[ast.AST], value: ast.AST) -> None:
        verdict = self.is_tainted(value)
        mask = self.is_mask(value)
        container = self.is_container(value)
        for t in targets:
            toks = _bound_tokens(t)
            if isinstance(t, ast.Subscript):
                # A store into a container taints it, never clears it.
                if verdict:
                    self.tainted |= toks
                    self._note_attr(toks)
                continue
            if isinstance(t, (ast.Tuple, ast.List)) and isinstance(
                    value, (ast.Tuple, ast.List)) \
                    and len(t.elts) == len(value.elts):
                for te, ve in zip(t.elts, value.elts):
                    self._assign([te], ve)
                continue
            per = self._tuple_summary(value)
            if isinstance(t, (ast.Tuple, ast.List)) and per is not None \
                    and len(per) == len(t.elts):
                for te, dev in zip(t.elts, per):
                    et = _bound_tokens(te)
                    if dev:
                        self.tainted |= et
                        self._note_attr(et)
                    else:
                        self.tainted -= et
                continue
            if verdict:
                self.tainted |= toks
                self._note_attr(toks)
            else:
                self.tainted -= toks
            (self.masks.update if mask and isinstance(t, ast.Name)
             else self.masks.difference_update)(toks)
            (self.containers.update if container
             else self.containers.difference_update)(toks)

    def _bind_loop(self, target: ast.AST, it: ast.AST) -> None:
        """A `for` target: `enumerate`'s index and `range`'s values are
        host ints; `zip` binds each target to its own iterable."""
        if isinstance(it, ast.Call) and isinstance(it.func, ast.Name):
            fn = it.func.id
            if fn == "range":
                self.tainted -= _bound_tokens(target)
                return
            if fn == "enumerate" and it.args and isinstance(
                    target, (ast.Tuple, ast.List)) and len(target.elts) == 2:
                self.tainted -= _bound_tokens(target.elts[0])
                self._bind_loop(target.elts[1], it.args[0])
                return
            if fn == "zip" and isinstance(target, (ast.Tuple, ast.List)) \
                    and len(target.elts) == len(it.args):
                for t, a in zip(target.elts, it.args):
                    self._bind_loop(t, a)
                return
        toks = _bound_tokens(target)
        if self.is_tainted(it):
            self.tainted |= toks
        else:
            self.tainted -= toks

    def _tuple_summary(self, value: ast.AST) -> Optional[List[bool]]:
        """Per-position taint of a package function's tuple result."""
        if not isinstance(value, ast.Call) or self.reg.is_entry_call(
                value, self.mod):
            return None
        callee = self.reg.callee(value, self.mod, self.cls)
        return self.reg.tuple_returns.get(callee) if callee else None

    def _host_guard(self, test: ast.AST) -> Set[str]:
        """Names an `isinstance(x, (int, float, ...))` test proves are not
        tensors inside its body."""
        if isinstance(test, ast.Call) and isinstance(test.func, ast.Name) \
                and test.func.id == "isinstance" and len(test.args) == 2 \
                and isinstance(test.args[0], ast.Name) \
                and "Tensor" not in ast.unparse(test.args[1]) \
                and "torch" not in ast.unparse(test.args[1]):
            return {test.args[0].id}
        return set()

    def _note_attr(self, toks: Set[str]) -> None:
        for t in toks:
            parts = t.split(".")
            if len(parts) == 2 and parts[0] == "self":
                self.stored_attrs.add(t)

    def run(self, body: List[ast.stmt]) -> None:
        for stmt in body:
            if self.on_stmt:
                self.on_stmt(stmt)
            if isinstance(stmt, ast.Assign):
                self._assign(stmt.targets, stmt.value)
            elif isinstance(stmt, ast.AnnAssign) and stmt.value is not None:
                self._assign([stmt.target], stmt.value)
            elif isinstance(stmt, ast.AugAssign):
                if self.is_tainted(stmt.value):
                    toks = _bound_tokens(stmt.target)
                    self.tainted |= toks
                    self._note_attr(toks)
            elif isinstance(stmt, ast.Return) and stmt.value is not None:
                if self.is_tainted(stmt.value):
                    self.returns_device = True
                elts = [self.is_tainted(e) for e in stmt.value.elts] \
                    if isinstance(stmt.value, ast.Tuple) else None
                if self._n_returns == 0:
                    self.returns_tuple = elts
                elif self.returns_tuple is not None and elts is not None \
                        and len(elts) == len(self.returns_tuple):
                    self.returns_tuple = [a or b for a, b in zip(
                        self.returns_tuple, elts)]
                else:
                    self.returns_tuple = None
                self._n_returns += 1
            elif isinstance(stmt, ast.Expr) and isinstance(stmt.value,
                                                           ast.Call):
                call = stmt.value
                sinks = [a for a in call.args if isinstance(a, ast.Attribute)
                         and a.attr in ("append", "extend")]
                if sinks and any(self.is_tainted(a) for a in call.args
                                 if a not in sinks):
                    for a in sinks:           # `tree_map(out.append, t)`
                        last = set(_dotted_tokens(a.value)[-1:])
                        self.tainted |= last
                        self.containers |= last
                if _method(call) in ("append", "extend", "insert") \
                        and call.args:
                    toks = _dotted_tokens(call.func.value)
                    last = set(toks[-1:]) if toks else set()
                    self.containers |= last
                    if self.is_tainted(call.args[-1]):
                        self.tainted |= last
                        self._note_attr(last)
            elif isinstance(stmt, ast.For):
                self._bind_loop(stmt.target, stmt.iter)
                self.run(stmt.body)
                self.run(stmt.orelse)
            elif isinstance(stmt, ast.If):
                host = self._host_guard(stmt.test)
                held = self.tainted & host
                added = tensor_guard(stmt.test) - self.tainted
                self.tainted -= host
                self.tainted |= added
                self.run(stmt.body)
                self.tainted -= added
                self.tainted |= held
                self.run(stmt.orelse)
            elif isinstance(stmt, ast.While):
                self.run(stmt.body)
                self.run(stmt.orelse)
            elif isinstance(stmt, ast.With):
                for item in stmt.items:
                    if item.optional_vars is not None \
                            and self.is_tainted(item.context_expr):
                        self.tainted |= _bound_tokens(item.optional_vars)
                self.run(stmt.body)
            elif isinstance(stmt, ast.Try):
                self.run(stmt.body)
                for h in stmt.handlers:
                    self.run(h.body)
                self.run(stmt.orelse)
                self.run(stmt.finalbody)


# -- base ----------------------------------------------------------------------

class _Base:
    id = ""
    severity = "error"

    def __init__(self, shared: Optional[_SharedRegistry] = None):
        self._shared = shared or _SharedRegistry()

    def registry(self, modules: Sequence[SourceModule]) -> Registry:
        return self._shared.get(modules)

    def run(self, modules: List[SourceModule]) -> Iterable[Finding]:
        raise NotImplementedError


def entry_scope(reg: Registry, depth_max: int = 6
                ) -> Dict[Tuple[str, str], Set[str]]:
    """(module, symbol) -> tainted parameters, for every entry point and
    the package-local functions it reaches within `depth_max` calls. A
    callee's tainted parameters are those a caller passes a card value
    (a tensor parameter of an entry point, or anything derived from
    one)."""
    scope: Dict[Tuple[str, str], Set[str]] = {}
    frontier: List[Tuple[Tuple[str, str], Set[str], int]] = []
    for site in reg.entries.values():
        frontier.append(((site.module.dotted, site.symbol),
                         set(site.traced_params) - host_params(site.func),
                         0))
    while frontier:
        key, seeds, depth = frontier.pop()
        known = scope.get(key)
        if known is not None and seeds <= known:
            continue
        scope[key] = (known or set()) | seeds
        mod, func, cls = reg.by_symbol[key]
        if depth >= depth_max:
            continue
        calls: List[Tuple[ast.Call, Set[int], Set[str]]] = []
        walk = DeviceWalk(reg, mod, cls, set(scope[key]))

        def on_stmt(stmt):
            for call in A.statement_calls(stmt):
                pos = {i for i, a in enumerate(call.args)
                       if walk.is_tainted(a)}
                kws = {kw.arg for kw in call.keywords
                       if kw.arg and walk.is_tainted(kw.value)}
                calls.append((call, pos, kws))

        walk.on_stmt = on_stmt
        walk.run(func.body)
        for call, pos, kws in calls:
            callee = reg.callee(call, mod, cls)
            if callee is None or callee == key:
                continue
            cmod, cfunc, ccls = reg.by_symbol[callee]
            if (cmod.dotted, cfunc.name) in reg.entries and ccls is None:
                continue                  # scanned as an entry point
            params = [p for p in A.param_names(cfunc)
                      if p not in ("self", "cls")]
            cseeds = {params[i] for i in pos if i < len(params)}
            cseeds |= kws & set(params)
            cseeds -= host_params(cfunc)
            frontier.append((callee, cseeds, depth + 1))
    return scope


#: words of a parameter annotation that name host values.
_HOST_ANNOTATIONS = {"int", "float", "bool", "str", "bytes", "complex",
                     "None", "Optional", "Union", "Tuple", "List", "Dict",
                     "Sequence", "tuple", "list", "dict", "np.ndarray",
                     "numpy.ndarray", "typing.Optional"}


def tensor_params(func: ast.FunctionDef,
                  records: Iterable[str] = ()) -> Set[str]:
    """Parameters annotated as tensors (`torch.Tensor`, `Optional[...]`)
    or as one of the package's tensor records (`records`)."""
    a = func.args
    out: Set[str] = set()
    for p in a.posonlyargs + a.args + a.kwonlyargs:
        if p.annotation is None:
            continue
        text = ast.unparse(p.annotation)
        words = {w.rsplit(".", 1)[-1] for w in re.findall(
            r"[A-Za-z_][A-Za-z_0-9.]*", text)}
        if "Tensor" in text or words & set(records):
            out.add(p.arg)
    return out


#: parameter names that hold host objects by the port's conventions (a
#: CPU `torch.Generator`, a config, a device).
_HOST_PARAM_NAMES = {"generator", "gen", "cfg", "config", "device", "dev",
                     "dtype"}
#: keywords of a torch call that carry no tensor value.
_META_KWARGS = {"generator", "dtype", "device", "layout", "requires_grad",
                "pin_memory", "memory_format", "non_blocking", "copy"}


def host_params(func: ast.FunctionDef) -> Set[str]:
    """Parameters annotated as host values only (`int`, `float`,
    `Optional[int]`, `np.ndarray`, a `...Config`): they carry no card
    value. A NamedTuple state or `torch.Tensor` annotation does."""
    a = func.args
    out: Set[str] = {p.arg for p in a.posonlyargs + a.args + a.kwonlyargs
                     if p.arg in _HOST_PARAM_NAMES}
    for p in a.posonlyargs + a.args + a.kwonlyargs:
        if p.annotation is None:
            continue
        words = re.findall(r"[A-Za-z_][A-Za-z_0-9.]*",
                           ast.unparse(p.annotation))
        if words and all(w in _HOST_ANNOTATIONS or w.endswith("Config")
                         for w in words):
            out.add(p.arg)
    return out


def tensor_guard(test: ast.AST, imports: Optional[Dict[str, str]] = None
                 ) -> Set[str]:
    """Names a test proves are tensors: `torch.is_tensor(x)`,
    `isinstance(x, torch.Tensor)`."""
    if not isinstance(test, ast.Call) or len(test.args) < 1 \
            or not isinstance(test.args[0], ast.Name):
        return set()
    fn = A.dotted(test.func) or ""
    if fn.endswith("is_tensor"):
        return {test.args[0].id}
    if fn == "isinstance" and len(test.args) == 2 \
            and "Tensor" in ast.unparse(test.args[1]):
        return {test.args[0].id}
    return set()


def _index_parts(sub: ast.Subscript) -> List[ast.AST]:
    return list(sub.slice.elts) if isinstance(sub.slice, ast.Tuple) \
        else [sub.slice]


def _own_exprs(stmt: ast.stmt) -> List[ast.AST]:
    """A statement's own expressions, without the statements it nests."""
    if isinstance(stmt, (ast.If, ast.While)):
        return [stmt.test]
    if isinstance(stmt, ast.For):
        return [stmt.iter]
    if isinstance(stmt, ast.With):
        return [i.context_expr for i in stmt.items]
    if isinstance(stmt, (ast.Try, ast.FunctionDef, ast.AsyncFunctionDef,
                         ast.ClassDef)):
        return []
    return [stmt]


def _guarded_nodes(stmt: ast.stmt) -> Dict[int, Set[str]]:
    """id(node) -> tensor-guard names for the nodes in the true branch of
    a conditional expression `a if torch.is_tensor(x) else b` within
    `stmt`'s own expressions."""
    out: Dict[int, Set[str]] = {}
    for n in ast.walk(stmt):
        if isinstance(n, ast.IfExp):
            names = tensor_guard(n.test)
            if names:
                for sub in ast.walk(n.body):
                    out.setdefault(id(sub), set()).update(names)
    return out


def _hot_methods(cls: "A.ClassInfo") -> Set[str]:
    """Timer and subscription callbacks plus their transitive same-class
    callees."""
    seen: Set[str] = set()
    frontier = [m for m in cls.timer_callbacks | cls.sub_callbacks
                if m in cls.methods]
    while frontier:
        m = frontier.pop()
        if m in seen:
            continue
        seen.add(m)
        frontier += [c for c in A.self_calls(cls.methods[m])
                     if c in cls.methods and c not in seen]
    return seen


# -- A1 ----------------------------------------------------------------------

class HostSyncChecker(_Base):
    id = "A1-host-sync"

    def run(self, modules: List[SourceModule]) -> Iterable[Finding]:
        reg = self.registry(modules)
        scope = reg.scope()
        hot: Set[Tuple[str, str]] = set()
        for (dotted, name), cls in reg.classes.items():
            hot |= {(dotted, f"{name}.{m}") for m in _hot_methods(cls)}
        findings: List[Finding] = []
        for key, (mod, func, cls) in reg.by_symbol.items():
            if "/analysis/" in mod.path:
                continue                  # the tooling, not the card path
            if key in scope:
                seeds = set(scope[key])
                severity, context = "error", "inside an entry point"
            else:
                seeds = tensor_params(func, reg.record_types)
                severity = "warning"
                context = ("in per-tick hot path" if key in hot
                           else "outside the entry points")
            if cls is not None:
                seeds |= reg.tensor_attrs.get((mod.dotted, cls), set())
            findings += self._scan(reg, mod, func, key[1], cls, seeds,
                                   severity, context)
        return findings

    def _scan(self, reg: Registry, mod: SourceModule, func, symbol: str,
              cls: Optional[str], seeds: Set[str], severity: str,
              context: str) -> List[Finding]:
        findings: List[Finding] = []
        imports = reg.imports[mod.dotted]
        flagged: Set[int] = set()

        def flag(node: ast.AST, what: str) -> None:
            if id(node) in flagged:
                return
            flagged.add(id(node))
            findings.append(mod.finding(
                self.id, severity, node, symbol,
                f"{what} {context} makes the host wait for the card"))

        def sync_call(call: ast.Call, bound=None) -> Optional[str]:
            """The description of `call` when it syncs, else None.
            `bound`: names a tensor guard around the call proves are
            tensors."""
            def tainted(e):
                return walk.is_tainted(e, bound)

            m = _method(call)
            tgt = _target(call, imports)
            if m is not None and isinstance(call.func, ast.Attribute):
                recv = call.func.value
                if m in _SYNC_METHODS and tainted(recv):
                    if isinstance(recv, ast.Call) and sync_call(recv, bound):
                        return None       # `.cpu().numpy()`: one site
                    return f".{m}() of a card tensor"
                if (m in _SHAPE_SYNC or m in _BOOL_SYNC) \
                        and tainted(recv) \
                        and not tgt.startswith(("numpy.", "torch.")):
                    return f".{m}() (its output shape or value is data)"
                if m == "repeat_interleave" \
                        and _kw(call, "output_size") is None \
                        and not tgt.startswith(("numpy.", "torch.")) \
                        and (not call.args or tainted(call.args[0])):
                    return ".repeat_interleave() of tensor repeats without " \
                           "output_size (its output shape is data)"
                to = _to_device(call, imports)
                if to is not None:
                    if _is_cpu(to, imports) and tainted(recv):
                        return ".to('cpu') of a card tensor"
                    if not _is_cpu(to, imports) \
                            and not tainted(recv):
                        return ".to(device) of a host value (a blocking " \
                               "copy)"
                if m == "cuda" and not tainted(recv):
                    return ".cuda() of a host value (a blocking copy)"
            if isinstance(call.func, ast.Name) \
                    and call.func.id in _HOST_SCALARS and call.args \
                    and tainted(call.args[0]):
                return f"{call.func.id}() of a card tensor"
            if tgt in _HOST_CONVERTERS and call.args \
                    and tainted(call.args[0]):
                return f"{tgt.replace('numpy.', 'np.')} of a card tensor"
            if tgt.startswith("torch."):
                name = tgt[6:]
                args = list(call.args) + [k.value for k in call.keywords]
                if (name in _SHAPE_SYNC or name in _BOOL_SYNC
                        or (name == "repeat_interleave"
                            and _kw(call, "output_size") is None
                            and (len(call.args) < 2
                                 or tainted(call.args[1])))
                        or (name == "where" and len(call.args) == 1)) \
                        and any(tainted(a) for a in args):
                    return f"torch.{name} (its output shape or value is " \
                           "data)"
                if name in _INFO_SYNC and any(tainted(a) for a in args):
                    return f"torch.{name} (it reads its error info on the " \
                           "host)"
                if tgt in _COPY_CTORS:
                    dev = _kw(call, "device")
                    if dev is not None and not _is_cpu(dev, imports) \
                            and call.args \
                            and not tainted(call.args[0]):
                        return f"{tgt} of a host value onto the card (a " \
                               "blocking copy)"
            callee = reg.callee(call, mod, cls)
            if callee is not None and callee in reg.sync_helpers \
                    and any(tainted(a) for a in call.args):
                return f"`{callee[1]}` (it copies its argument to the host)"
            return None

        def truth_tests(expr: ast.AST) -> List[ast.AST]:
            """Sub-expressions whose Python truth value is taken."""
            out: List[ast.AST] = []
            for n in ast.walk(expr):
                if isinstance(n, ast.IfExp):
                    out.append(n.test)
                elif isinstance(n, ast.BoolOp):
                    out.extend(n.values)
                elif isinstance(n, ast.UnaryOp) and isinstance(n.op, ast.Not):
                    out.append(n.operand)
                elif isinstance(n, ast.comprehension):
                    out.extend(n.ifs)
            return out

        def indexed_store(stmt: ast.stmt) -> None:
            """`x[idx] = 0.0`: a host value stored through tensor indices
            is copied onto the card first."""
            if not isinstance(stmt, ast.Assign) \
                    or walk.is_tainted(stmt.value):
                return
            for t in stmt.targets:
                if isinstance(t, ast.Subscript) and walk.is_tainted(t.value) \
                        and any(walk.is_tainted(i) and not walk.is_mask(i)
                                for i in _index_parts(t)):
                    flag(t, "an indexed store of a host value into a card "
                            "tensor (the value is copied onto the card)")

        def on_stmt(stmt: ast.stmt) -> None:
            indexed_store(stmt)
            guarded = _guarded_nodes(stmt)
            for call in A.statement_calls(stmt):
                what = sync_call(call, guarded.get(id(call)))
                if what:
                    flag(call, what)
            if isinstance(stmt, (ast.If, ast.While, ast.Assert)) \
                    and self._truth_tainted(walk, stmt.test):
                flag(stmt.test, "the truth value of a card tensor")
            for e in _own_exprs(stmt):
                for t in truth_tests(e):
                    if self._truth_tainted(walk, t):
                        flag(t, "the truth value of a card tensor")
                for sub in [n for n in ast.walk(e)
                            if isinstance(n, ast.Subscript)]:
                    if walk.is_tainted(sub.value) and any(
                            walk.is_mask(p) and walk.is_tainted(p)
                            for p in _index_parts(sub)):
                        flag(sub, "boolean-mask indexing of a card "
                                  "tensor (its output shape is data)")

        walk = DeviceWalk(reg, mod, cls, set(seeds), on_stmt=on_stmt)
        walk.run(func.body)
        return findings

    @staticmethod
    def _truth_tainted(walk: DeviceWalk, test: ast.AST) -> bool:
        """`if x:` / `if x.any():` / `if a > b:` on card values. A test of
        identity, length or metadata is host-side, as is one whose value
        a sync already turned into a Python scalar, and the truth value of
        a list or dict is its length."""
        if isinstance(test, ast.BoolOp):
            return False                  # its operands are judged alone
        if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
            return False
        if walk.is_container(test):
            return False
        return walk.is_tainted(test)


# -- A2 ----------------------------------------------------------------------

class EntryHygieneChecker(_Base):
    id = "A2-entry-hygiene"

    def run(self, modules: List[SourceModule]) -> Iterable[Finding]:
        reg = self.registry(modules)
        findings: List[Finding] = []
        for site in reg.entries.values():
            mod = site.module
            for name in site.static:
                if name not in site.params:
                    findings.append(mod.finding(
                        self.id, "error", site.decorator, site.symbol,
                        f"static name `{name}` is not a parameter of "
                        f"`{site.func.name}`"))
            findings += self._scan_body(reg, site)
        findings += self._scan_call_sites(reg)
        return findings

    def _scan_body(self, reg: Registry, site: "A.EntrySite"
                   ) -> List[Finding]:
        mod, symbol = site.module, site.symbol
        findings: List[Finding] = []

        def on_stmt(stmt: ast.stmt) -> None:
            if isinstance(stmt, ast.For) \
                    and isinstance(stmt.iter, ast.Call) \
                    and isinstance(stmt.iter.func, ast.Name) \
                    and stmt.iter.func.id == "range":
                bad = {A.dotted(a) or "?" for a in stmt.iter.args
                       if walk.is_tainted(a)}
                if bad:
                    findings.append(mod.finding(
                        self.id, "error", stmt, symbol,
                        f"Python `for` over range of tensor value(s) "
                        f"{sorted(bad)} inside an entry point — a host "
                        "sync, then one Python step per element"))

        walk = DeviceWalk(reg, mod, None, set(site.traced_params),
                          on_stmt=on_stmt)
        walk.run(site.func.body)
        return findings

    def _scan_call_sites(self, reg: Registry) -> List[Finding]:
        findings: List[Finding] = []
        for mod in reg.modules:
            sym_of = A.node_symbols(mod.tree)
            for call in [n for n in ast.walk(mod.tree)
                         if isinstance(n, ast.Call) and id(n) in sym_of]:
                site = reg.entry_of(call, mod)
                if site is None:
                    continue
                params, static = site.params, site.static_params
                bad = [(params[i], a) for i, a in enumerate(call.args)
                       if i < len(params) and params[i] in static]
                bad += [(kw.arg, kw.value) for kw in call.keywords
                        if kw.arg in static]
                for pname, arg in bad:
                    if isinstance(arg, (ast.List, ast.Dict, ast.Set,
                                        ast.ListComp, ast.DictComp,
                                        ast.SetComp)):
                        findings.append(mod.finding(
                            self.id, "error", arg, sym_of[id(call)],
                            f"unhashable literal passed as static "
                            f"`{pname}` of entry point "
                            f"`{site.func.name}` — the dispatch "
                            "profiler keys a variant by its static "
                            "values (TypeError, or no variant key)"))
        return findings


# -- A3 ----------------------------------------------------------------------

def _has_float_literal(node: ast.AST) -> bool:
    return any(isinstance(n, ast.Constant) and isinstance(n.value, float)
               for n in ast.walk(node))


class DtypeDriftChecker(_Base):
    id = "A3-dtype-drift"

    def run(self, modules: List[SourceModule]) -> Iterable[Finding]:
        findings: List[Finding] = []
        for mod in modules:
            if "/analysis/" in mod.path:
                continue
            imports = A.import_table(mod.tree)
            sym_of = A.node_symbols(mod.tree)
            # Host-side float64 is clear: a call that names the CPU
            # (`device="cpu"`, `.to("cpu", ...)`), a torch factory with no
            # device (it builds on the CPU), and a value copied to the
            # host in the same expression (`torch.cat([a.double(),
            # ...]).cpu()`: float64 holds every int32 and float32 of a
            # packed readback exactly).
            cpu_calls: Set[int] = set()
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.Call):
                    continue
                tgt = _target(node, imports)
                host = _is_cpu(_kw(node, "device"), imports) or (
                    _method(node) == "to" and node.args
                    and _is_cpu(node.args[0], imports)) or (
                    _method(node) in ("cpu", "numpy", "tolist", "item")) \
                    or (tgt.startswith("torch.") and tgt[6:] in _FACTORIES
                        and _kw(node, "device") is None)
                if host:
                    cpu_calls |= {id(n) for n in ast.walk(node)}
            for node in ast.walk(mod.tree):
                if id(node) in cpu_calls:
                    continue
                symbol = sym_of.get(id(node), "")
                if isinstance(node, ast.Attribute) \
                        and (A.resolve(node, imports) or "") in _F64_NAMES:
                    findings.append(mod.finding(
                        self.id, "warning", node, symbol,
                        f"{A.dotted(node)} in the port — the kernels and "
                        "the card path take float32; build host-only "
                        "float64 with device=\"cpu\" (or baseline it with "
                        "a note)"))
                elif isinstance(node, ast.Call) \
                        and _method(node) == "double" and not node.args:
                    findings.append(mod.finding(
                        self.id, "warning", node, symbol,
                        ".double() makes a float64 tensor — the card path "
                        "takes float32"))
            findings += self._scan_ctors(mod, sym_of, imports, cpu_calls)
        return findings

    def _scan_ctors(self, mod, sym_of: Dict[int, str], imports,
                    cpu_calls: Set[int]) -> List[Finding]:
        """`torch.as_tensor(x)` with no dtype of a numpy float64 value
        (names bound to one anywhere in the module count)."""
        f64: Set[str] = set()
        out: List[Finding] = []

        def is_f64(expr: ast.AST) -> bool:
            if isinstance(expr, ast.Name):
                return expr.id in f64
            if not isinstance(expr, ast.Call):
                return False
            tgt = _target(expr, imports)
            if tgt == "numpy.float64":
                return True
            if not tgt.startswith("numpy."):
                return False
            dt = _kw(expr, "dtype")
            if dt is not None:
                return (isinstance(dt, ast.Name) and dt.id == "float") \
                    or (A.resolve(dt, imports) or "") == "numpy.float64"
            return tgt in ("numpy.array", "numpy.asarray") and expr.args \
                and isinstance(expr.args[0], (ast.List, ast.Tuple)) \
                and _has_float_literal(expr.args[0]) and len(expr.args) < 2

        nodes = list(ast.walk(mod.tree))
        for node in nodes:
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    if isinstance(t, ast.Name) and is_f64(node.value):
                        f64.add(t.id)
        for node in nodes:
            if not isinstance(node, ast.Call) or id(node) in cpu_calls:
                continue
            tgt = _target(node, imports)
            if tgt in ("torch.as_tensor", "torch.from_numpy",
                       "torch.tensor") and node.args \
                    and _kw(node, "dtype") is None and is_f64(node.args[0]):
                out.append(mod.finding(
                    self.id, "warning", node, sym_of.get(id(node), ""),
                    f"{tgt} without dtype of a float64 numpy value makes "
                    "a float64 tensor — name dtype=torch.float32"))
        return out


# -- A4 ----------------------------------------------------------------------

class ImpureEntryChecker(_Base):
    id = "A4-impure-entry"

    def run(self, modules: List[SourceModule]) -> Iterable[Finding]:
        reg = self.registry(modules)
        scope = reg.scope()
        findings: List[Finding] = []
        for key in sorted(scope):
            mod, func, _cls = reg.by_symbol[key]
            findings += self._scan(mod, func, key[1], reg)
        return findings

    def _scan(self, mod: SourceModule, func: ast.FunctionDef, symbol: str,
              reg: Registry) -> List[Finding]:
        imports = reg.imports[mod.dotted]
        globals_ = {t.id for n in mod.tree.body
                    if isinstance(n, (ast.Assign, ast.AnnAssign))
                    for t in (n.targets if isinstance(n, ast.Assign)
                              else [n.target])
                    if isinstance(t, ast.Name)}
        declared = {name for n in ast.walk(func)
                    if isinstance(n, ast.Global) for name in n.names}
        local = set(A.param_names(func)) | {
            t for n in ast.walk(func) if isinstance(n, ast.Assign)
            for tg in n.targets for t in A.target_names(tg)
            if isinstance(tg, ast.Name)} - declared
        out: List[Finding] = []

        def is_global(node: ast.AST) -> bool:
            base = A.receiver_base(node)
            return base is not None and base in globals_ | declared \
                and base not in local

        for node in ast.walk(func):
            if isinstance(node, ast.Call):
                tgt = _target(node, imports)
                m = _method(node)
                leaf = tgt.rpartition(".")[2]
                if ((tgt.startswith("torch.") and tgt[6:] in _RNG_TORCH)
                        or m in _RNG_METHODS) \
                        and _kw(node, "generator") is None:
                    out.append(mod.finding(
                        self.id, "error", node, symbol,
                        f"`{tgt or '.' + m}` draws from the global RNG "
                        "inside an entry point — pass a generator= (the "
                        "warm-up and the ledger call entry points too)"))
                elif tgt.startswith(("numpy.random.", "random.")) \
                        and leaf not in _RNG_CTORS:
                    out.append(mod.finding(
                        self.id, "error", node, symbol,
                        f"`{tgt}` draws from a global RNG inside an entry "
                        "point — take a generator or noise tensor"))
                elif m in _MUTATORS and isinstance(node.func, ast.Attribute) \
                        and is_global(node.func.value):
                    out.append(mod.finding(
                        self.id, "error", node, symbol,
                        "mutation of a module global inside an entry "
                        "point — the warm-up's and the ledger's calls on "
                        "zeros mutate it too"))
            elif isinstance(node, (ast.Assign, ast.AugAssign)):
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    base = t.value if isinstance(t, ast.Subscript) else t
                    if A._self_attr(base) is not None:
                        out.append(mod.finding(
                            self.id, "error", node, symbol,
                            "mutation of `self` inside an entry point — "
                            "the warm-up's and the ledger's calls on zeros "
                            "mutate it too"))
                    elif (isinstance(t, ast.Name) and t.id in declared) \
                            or (isinstance(t, ast.Subscript)
                                and is_global(t.value)):
                        out.append(mod.finding(
                            self.id, "error", node, symbol,
                            "mutation of a module global inside an entry "
                            "point — the warm-up's and the ledger's calls "
                            "on zeros mutate it too"))
        return out
