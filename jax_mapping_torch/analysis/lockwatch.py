"""Runtime lock-order recorder — the dynamic complement to B1.

The static graph (`lock_discipline.build_lock_graph`) cannot see
cross-object edges (bus lock -> subscription lock) or the per-node
`_cb_lock` chains created by inline bus delivery. `LockWatch` closes
that gap: it swaps selected instance locks for recording proxies, keeps
a per-thread held-lock stack, and logs every "acquired B while holding
A" pair actually exercised by a live run (e.g. `launch_sim_stack` in a
test). Tests then assert the observed order is acyclic and consistent
with the static graph.

Usage:

    watch = LockWatch()
    watch.watch(stack.bus, "_lock")            # -> "Bus._lock"
    watch.watch(stack.brain, "_state_lock")    # -> "ThymioBrain._state_lock"
    ... drive the stack ...
    watch.unwatch_all()
    assert watch.cycle() is None
    assert watch.edges() <= allowed_edges

Proxies forward the full Lock/RLock surface (`acquire`, `release`,
context manager, `locked`), count reentrant acquires without
re-recording, and are safe to leave installed for a whole process —
recording is one set-add under a private mutex per acquisition.

Do NOT watch a lock that other objects captured at construction time
(e.g. `Subscription._lock`, which its `Condition`s wrap): the proxy
only intercepts attribute access, so pre-captured references would
bypass it and the record would be partial in a misleading way.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Set, Tuple


class _RecordingLock:
    def __init__(self, watch: "LockWatch", real, name: str):
        self._watch = watch
        self._real = real
        self.name = name

    # -- lock protocol ------------------------------------------------------

    def acquire(self, blocking: bool = True, timeout: float = -1) -> bool:
        ok = self._real.acquire(blocking, timeout)
        if ok:
            self._watch._record_acquire(self.name)
        return ok

    def release(self) -> None:
        self._watch._record_release(self.name)
        self._real.release()

    def __enter__(self):
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self) -> bool:
        locked = getattr(self._real, "locked", None)
        return locked() if locked is not None else False

    def __repr__(self) -> str:
        return f"<RecordingLock {self.name} over {self._real!r}>"


class LockWatch:
    """Records runtime lock-acquisition order edges across threads."""

    def __init__(self):
        self._mu = threading.Lock()
        self._edges: Dict[Tuple[str, str], int] = {}
        self._tls = threading.local()
        self._installed: List[Tuple[object, str, object]] = []

    # -- installation -------------------------------------------------------

    def watch(self, obj: object, attr: str,
              name: Optional[str] = None) -> str:
        """Replace `obj.<attr>` with a recording proxy; returns the
        recorded lock name (default `TypeName.attr`, matching the
        static graph's `Class.attr` node names)."""
        real = getattr(obj, attr)
        if isinstance(real, _RecordingLock):
            return real.name
        lock_name = name or f"{type(obj).__name__}.{attr}"
        setattr(obj, attr, _RecordingLock(self, real, lock_name))
        self._installed.append((obj, attr, real))
        return lock_name

    def unwatch_all(self) -> None:
        for obj, attr, real in reversed(self._installed):
            setattr(obj, attr, real)
        self._installed.clear()

    # -- recording ----------------------------------------------------------

    def _held(self) -> List[str]:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    def _record_acquire(self, name: str) -> None:
        held = self._held()
        if name not in held:                  # reentrant RLock re-acquire
            with self._mu:
                for h in held:
                    key = (h, name)
                    self._edges[key] = self._edges.get(key, 0) + 1
        held.append(name)

    def _record_release(self, name: str) -> None:
        held = self._held()
        # LIFO is the norm; tolerate out-of-order release by removing
        # the most recent matching entry.
        for i in range(len(held) - 1, -1, -1):
            if held[i] == name:
                del held[i]
                return

    # -- results ------------------------------------------------------------

    def edges(self) -> Set[Tuple[str, str]]:
        with self._mu:
            return set(self._edges)

    def edge_counts(self) -> Dict[Tuple[str, str], int]:
        with self._mu:
            return dict(self._edges)

    def cycle(self) -> Optional[List[str]]:
        """A lock cycle in the observed order, or None. A cycle means
        two threads can deadlock given the right interleaving even if
        this run happened not to."""
        edges = self.edges()
        graph: Dict[str, Set[str]] = {}
        for a, b in edges:
            graph.setdefault(a, set()).add(b)
            graph.setdefault(b, set())
        WHITE, GREY, BLACK = 0, 1, 2
        color = {v: WHITE for v in graph}
        parent: Dict[str, str] = {}

        def dfs(v: str) -> Optional[List[str]]:
            color[v] = GREY
            for w in graph[v]:
                if color[w] == GREY:
                    path = [w, v]
                    u = v
                    while u != w:
                        u = parent[u]
                        path.append(u)
                    return list(reversed(path))
                if color[w] == WHITE:
                    parent[w] = v
                    found = dfs(w)
                    if found:
                        return found
            color[v] = BLACK
            return None

        for v in sorted(graph):
            if color[v] == WHITE:
                found = dfs(v)
                if found:
                    return found
        return None

    def check_against_static(self, static_edges: Set[Tuple[str, str]]
                             ) -> Set[Tuple[str, str]]:
        """Observed edges between locks the static graph KNOWS that the
        static pass missed (both endpoints appear somewhere in
        `static_edges`, the edge itself does not) — each one is a
        static-analysis blind spot worth a checker improvement."""
        known = {n for e in static_edges for n in e}
        return {e for e in self.edges()
                if e[0] in known and e[1] in known
                and e not in static_edges}
