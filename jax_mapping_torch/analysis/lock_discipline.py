"""Family B — lock-discipline checkers for the threaded bridge layer.

The bridge's thread topology: the executor spins timers on one thread,
the bus delivers subscription callbacks inline on the *publisher's*
thread, HTTP handlers arrive on ThreadingHTTPServer workers, and every
node serializes its own callbacks behind `Node._cb_lock`. Each class
guards its shared state with an instance lock (`self._lock` /
`self._state_lock`) — safety rests on three conventions this module
checks mechanically:

B1 `B1-lock-order`      every thread acquires locks in one global
                        order. The checker builds a static acquisition
                        graph — nodes are `Class.attr` locks, edges are
                        "acquired B while holding A" from nested `with`
                        blocks and from `self.m()` calls inside a lock
                        body whose callee (transitively) acquires — and
                        reports any strongly-connected component
                        (= potential deadlock cycle).
B2 `B2-callback-lock`   no callback/publish under a lock: invoking
                        `*.callback(...)`, `*_cb(...)` or
                        `*.publish(...)` while holding a lock hands
                        control to arbitrary foreign code (bus delivery
                        is inline!) that may try to take the same lock.
B3 `B3-unguarded-write` state written without the lock that guards it
                        elsewhere: in a class that owns a lock, an
                        attribute both accessed under `with self.<lock>`
                        and *written* outside any lock body (outside
                        `__init__`) is a torn-read hazard. Deliberate
                        single-writer/GIL-atomic sites are baselined,
                        with the justification in the baseline note.
                        The checker understands the `_locked` helper
                        convention interprocedurally: a private method
                        whose every same-class call site runs with a
                        lock held (lexically, or via a caller that
                        itself qualifies) is walked as lock-held — but
                        a method that escapes as a value (callback
                        reference) or is reachable from any unlocked
                        site is not.

Known static blind spots (the runtime `lockwatch` recorder covers the
live stack where these matter): cross-*object* edges (`sub._offer`
under the bus lock), and `Node._cb_lock` chains created by inline bus
delivery across nodes.

`build_lock_graph(modules)` exposes the B1 graph so tests can validate
it against `lockwatch`-observed runtime orderings.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from jax_mapping_torch.analysis import astutil as A
from jax_mapping_torch.analysis.core import Finding, SourceModule

#: Condition-protocol methods that are lock-safe by design.
_LOCK_PROTOCOL = {"notify", "notify_all", "wait", "wait_for", "acquire",
                  "release", "locked"}
#: call names that hand control to foreign code.
_CALLBACK_ATTRS = {"callback", "publish"}


@dataclass
class LockGraph:
    #: "Class.attr" -> "Class.attr" acquisition-order edges, each with
    #: the (module, node, symbol) site where the edge was introduced.
    edges: Dict[Tuple[str, str], Tuple[SourceModule, ast.AST, str]] = \
        field(default_factory=dict)

    def edge_set(self) -> Set[Tuple[str, str]]:
        return set(self.edges)

    def sccs(self) -> List[List[str]]:
        """Cycle-forming lock sets: Tarjan SCCs of size > 1, plus
        self-loops."""
        graph: Dict[str, Set[str]] = {}
        for a, b in self.edges:
            graph.setdefault(a, set()).add(b)
            graph.setdefault(b, set())
        index: Dict[str, int] = {}
        low: Dict[str, int] = {}
        on_stack: Set[str] = set()
        stack: List[str] = []
        out: List[List[str]] = []
        counter = [0]

        def strongconnect(v: str) -> None:
            index[v] = low[v] = counter[0]
            counter[0] += 1
            stack.append(v)
            on_stack.add(v)
            for w in graph[v]:
                if w not in index:
                    strongconnect(w)
                    low[v] = min(low[v], low[w])
                elif w in on_stack:
                    low[v] = min(low[v], index[w])
            if low[v] == index[v]:
                comp = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    comp.append(w)
                    if w == v:
                        break
                if len(comp) > 1 or v in graph[v]:
                    out.append(sorted(comp))

        for v in sorted(graph):
            if v not in index:
                strongconnect(v)
        return out


def _lock_aliases(cls: "A.ClassInfo") -> Dict[str, str]:
    """Condition attrs constructed over a sibling lock share its
    identity: `self._not_empty = threading.Condition(self._lock)` means
    acquiring `_not_empty` IS acquiring `_lock`."""
    aliases = {attr: attr for attr in cls.lock_attrs}
    for meth in cls.methods.values():
        for node in ast.walk(meth):
            if isinstance(node, ast.Assign) and len(node.targets) == 1 \
                    and isinstance(node.value, ast.Call):
                attr = A._self_attr(node.targets[0])
                if attr in cls.lock_attrs \
                        and cls.lock_attrs[attr] == "Condition" \
                        and node.value.args:
                    shared = A._self_attr(node.value.args[0])
                    if shared in cls.lock_attrs:
                        aliases[attr] = shared
    return aliases


class _ClassWalker:
    """Walks one class's methods tracking the held-lock stack; emits
    acquisition edges, callback-under-lock findings, and per-attribute
    guarded/unguarded access records."""

    def __init__(self, cls: "A.ClassInfo", graph: LockGraph,
                 checker_id_b2: Optional[str]):
        self.cls = cls
        self.graph = graph
        self.b2_id = checker_id_b2
        self.aliases = _lock_aliases(cls)
        self.b2: List[Tuple[ast.AST, str, str]] = []  # (site, symbol, lock)
        #: attr -> guarded access exists anywhere in the class
        self.guarded: Set[str] = set()
        #: (attr, site node, symbol) unguarded writes outside __init__
        self.unguarded_writes: List[Tuple[str, ast.AST, str]] = []
        self._acquires_cache: Dict[str, Set[str]] = {}
        #: True while walking a method that qualifies for the `_locked`
        #: helper convention (see _entry_locked_map)
        self._entry_locked_now = False

    def lock_name(self, attr: str) -> str:
        return f"{self.cls.name}.{self.aliases.get(attr, attr)}"

    def _with_lock_attr(self, item: ast.withitem) -> Optional[str]:
        attr = A._self_attr(item.context_expr)
        return attr if attr in self.cls.lock_attrs else None

    # transitive lock set a method acquires (for call-under-lock edges)
    def method_acquires(self, name: str,
                        _seen: Optional[Set[str]] = None) -> Set[str]:
        if name in self._acquires_cache:
            return self._acquires_cache[name]
        seen = _seen if _seen is not None else set()
        if name in seen or name not in self.cls.methods:
            return set()
        seen.add(name)
        out: Set[str] = set()
        meth = self.cls.methods[name]
        for node in ast.walk(meth):
            if isinstance(node, ast.With):
                for item in node.items:
                    attr = self._with_lock_attr(item)
                    if attr is not None:
                        out.add(self.lock_name(attr))
        for callee in A.self_calls(meth):
            out |= self.method_acquires(callee, seen)
        if _seen is None:
            self._acquires_cache[name] = out
        return out

    def walk(self) -> None:
        entry = self._entry_locked_map()
        for name, meth in self.cls.methods.items():
            self._entry_locked_now = entry.get(name, False)
            self._walk_body(meth.body, [], f"{self.cls.name}.{name}",
                            in_init=(name == "__init__"))
        self._entry_locked_now = False

    # -- the `_locked` helper convention (B3 interprocedural step) -------
    #
    # A private method whose EVERY same-class reference runs with a lock
    # held — lexically at the call site, or transitively because the
    # caller itself qualifies — executes under that lock at runtime even
    # though no `with` statement is visible in its own body. Treating
    # its attribute accesses as unguarded would force either inlining
    # every helper into the guarded block or baselining true positives,
    # and the zero-suppression tiers forbid the latter. Public and
    # dunder methods never qualify (they are entered from outside the
    # class), nor does a method that escapes as a value (a callback
    # reference is an unlocked entry point we cannot see).

    def _entry_locked_map(self) -> Dict[str, bool]:
        sites: Dict[str, List[Tuple[str, bool]]] = {}
        for name, meth in self.cls.methods.items():
            self._collect_sites(meth.body, False, name, sites)
        cand = {n for n in sites
                if n in self.cls.methods and n.startswith("_")
                and not n.startswith("__")}
        locked = {n: True for n in cand}
        changed = True
        while changed:          # monotone: True flips False, never back
            changed = False
            for n in cand:
                if locked[n] and not all(
                        lex or locked.get(caller, False)
                        for caller, lex in sites[n]):
                    locked[n] = False
                    changed = True
        return locked

    def _collect_sites(self, node, held: bool, caller: str,
                       sites: Dict[str, List[Tuple[str, bool]]]) -> None:
        if isinstance(node, list):
            for n in node:
                self._collect_sites(n, held, caller, sites)
            return
        if isinstance(node, ast.With):
            h = held or any(self._with_lock_attr(i) is not None
                            for i in node.items)
            self._collect_sites(node.items, held, caller, sites)
            self._collect_sites(node.body, h, caller, sites)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return                       # nested defs run later, unheld
        if isinstance(node, ast.Call):
            m = A._self_attr(node.func)
            if m is not None and m in self.cls.methods:
                sites.setdefault(m, []).append((caller, held))
                for sub in ast.iter_child_nodes(node):
                    if sub is not node.func:
                        self._collect_sites(sub, held, caller, sites)
                return
        elif isinstance(node, ast.Attribute):
            m = A._self_attr(node)
            if m is not None and m in self.cls.methods:
                # `self._helper` escaping as a value: an entry point
                # whose lock posture we cannot see — count it unlocked.
                sites.setdefault(m, []).append((caller, False))
        for sub in ast.iter_child_nodes(node):
            self._collect_sites(sub, held, caller, sites)

    def _walk_body(self, body: List[ast.stmt], held: List[str],
                   symbol: str, in_init: bool) -> None:
        for stmt in body:
            self._visit(stmt, held, symbol, in_init)

    def _visit(self, node: ast.AST, held: List[str], symbol: str,
               in_init: bool) -> None:
        if isinstance(node, ast.With):
            acquired = []
            for item in node.items:
                attr = self._with_lock_attr(item)
                if attr is None:
                    continue
                lock = self.lock_name(attr)
                for h in held:
                    if h != lock:
                        self.graph.edges.setdefault(
                            (h, lock),
                            (self.cls.module, item.context_expr, symbol))
                acquired.append(lock)
            self._walk_body(node.body, held + acquired, symbol, in_init)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return                       # nested defs run later, unheld
        # attribute accesses for B3
        for sub in ast.iter_child_nodes(node):
            self._visit(sub, held, symbol, in_init)
        if isinstance(node, ast.Call):
            self._visit_call(node, held, symbol)
        elif isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
            targets = node.targets if isinstance(node, ast.Assign) else \
                [node.target]
            for t in targets:
                attr = self._store_attr(t)
                if attr is None or attr in self.cls.lock_attrs:
                    continue
                if held or self._entry_locked_now:
                    self.guarded.add(attr)
                elif not in_init:
                    self.unguarded_writes.append((attr, node, symbol))
        elif isinstance(node, ast.Attribute) \
                and (held or self._entry_locked_now):
            attr = A._self_attr(node)
            if attr is not None and attr not in self.cls.lock_attrs:
                self.guarded.add(attr)

    @staticmethod
    def _store_attr(target: ast.AST) -> Optional[str]:
        """self.X = / self.X[...] = / self.X.append is NOT a store —
        only direct attribute stores and subscript stores on self.X."""
        if isinstance(target, ast.Subscript):
            target = target.value
        return A._self_attr(target)

    def _visit_call(self, call: ast.Call, held: List[str],
                    symbol: str) -> None:
        # edges through same-class method calls made while holding
        m = A._self_attr(call.func)
        if m is not None and m in self.cls.methods and held:
            for lock in self.method_acquires(m):
                for h in held:
                    if h != lock:
                        self.graph.edges.setdefault(
                            (h, lock), (self.cls.module, call, symbol))
        # B2: callback / publish invoked while holding a lock
        if self.b2_id is None or not held:
            return
        name = None
        if isinstance(call.func, ast.Attribute):
            name = call.func.attr
        elif isinstance(call.func, ast.Name):
            name = call.func.id
        if name is None or name in _LOCK_PROTOCOL:
            return
        if name in _CALLBACK_ATTRS or name.endswith("_cb"):
            self.b2.append((call, symbol, held[-1]))


def _walk_all(modules: Sequence[SourceModule], b2: bool
              ) -> Tuple[LockGraph, List["_ClassWalker"]]:
    graph = LockGraph()
    walkers = []
    for mod in modules:
        for cls in A.collect_classes(mod):
            if not cls.lock_attrs:
                continue
            w = _ClassWalker(cls, graph, "B2-callback-lock" if b2 else None)
            w.walk()
            walkers.append(w)
    return graph, walkers


class _SharedWalk:
    """One `_walk_all` pass feeding all three B checkers. `all_checkers`
    hands the trio a shared instance so a full analysis run walks each
    locked class once, not three times; a checker constructed on its
    own (fixture tests) gets a private one. Re-keyed by the identity of
    the module set, so reuse across analyses stays correct."""

    def __init__(self):
        self._key = None
        self._result = None

    def get(self, modules: Sequence[SourceModule]
            ) -> Tuple[LockGraph, List["_ClassWalker"]]:
        key = tuple(id(m) for m in modules)
        if key != self._key:
            self._result = _walk_all(modules, b2=True)
            self._key = key
        return self._result


def build_lock_graph(modules: Sequence[SourceModule]) -> LockGraph:
    """The static acquisition-order graph (the B1 input), exposed for
    tests to validate against `lockwatch` runtime observations."""
    return _walk_all(modules, b2=False)[0]


class LockOrderChecker:
    id = "B1-lock-order"

    def __init__(self, shared: Optional[_SharedWalk] = None):
        self._shared = shared or _SharedWalk()

    def run(self, modules: List[SourceModule]) -> Iterable[Finding]:
        graph, _walkers = self._shared.get(modules)
        findings = []
        for comp in graph.sccs():
            comp_set = set(comp)
            sites = [(edge, site) for edge, site in graph.edges.items()
                     if edge[0] in comp_set and edge[1] in comp_set]
            for (a, b), (mod, node, symbol) in sorted(
                    sites, key=lambda e: (e[1][0].path,
                                          getattr(e[1][1], "lineno", 0))):
                findings.append(mod.finding(
                    self.id, "error", node, symbol,
                    f"lock-order cycle among {comp}: this site orders "
                    f"{a} -> {b}, another site orders the reverse — "
                    "potential deadlock"))
        return findings


class CallbackUnderLockChecker:
    id = "B2-callback-lock"

    def __init__(self, shared: Optional[_SharedWalk] = None):
        self._shared = shared or _SharedWalk()

    def run(self, modules: List[SourceModule]) -> Iterable[Finding]:
        _graph, walkers = self._shared.get(modules)
        findings = []
        for w in walkers:
            for call, symbol, lock in w.b2:
                name = (call.func.attr if isinstance(call.func,
                                                     ast.Attribute)
                        else call.func.id)
                findings.append(w.cls.module.finding(
                    self.id, "error", call, symbol,
                    f"`{name}(...)` invoked while holding {lock} — "
                    "bus delivery is inline, so this re-enters foreign "
                    "code under the lock"))
        return findings


class UnguardedWriteChecker:
    id = "B3-unguarded-write"

    def __init__(self, shared: Optional[_SharedWalk] = None):
        self._shared = shared or _SharedWalk()

    def run(self, modules: List[SourceModule]) -> Iterable[Finding]:
        _graph, walkers = self._shared.get(modules)
        findings = []
        for w in walkers:
            for attr, node, symbol in w.unguarded_writes:
                if attr in w.guarded:
                    lock = next(iter(w.cls.lock_attrs))
                    findings.append(w.cls.module.finding(
                        self.id, "warning", node, symbol,
                        f"`self.{attr}` written without a lock but "
                        f"accessed under `self.{lock}` elsewhere in "
                        f"{w.cls.name} — torn-read hazard (baseline "
                        "deliberate single-writer sites with a note)"))
        return findings
