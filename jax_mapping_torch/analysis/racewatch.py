"""Runtime lockset race detector — Eraser's refinement over live locks.

`lockwatch` answers "is the lock *order* consistent"; this module
answers the prior question: "is shared state actually protected by the
lock the design says protects it". It implements the lockset algorithm
of Savage et al.'s Eraser on top of the same `_RecordingLock` proxy
`lockwatch` uses, plus per-field access instrumentation:

* **Locks** are watched exactly like `LockWatch.watch` — the proxy
  maintains a per-thread held-lockset.
* **Fields** come from the lock-protection map
  (`analysis/protection.py`): `watch_object(obj, group)` swaps the
  instance's class for a dynamically-created subclass whose
  `__getattribute__`/`__setattr__` record (field, thread, held-lockset,
  is_write) events for the declared fields. Fields the design reads
  lock-free (`lockfree_ok`) are never instrumented — Eraser would
  rightly empty their lockset and wrongly call the *convention* a bug.
* **Refinement** (per field): the candidate lockset starts as ⊤ (all
  locks) and is intersected with the held set on every access once the
  field leaves its initialization phase. The Eraser state machine
  keeps first-thread-exclusive access exempt (constructor/single-owner
  setup), starts refining on second-thread reads (`SHARED`), and
  *reports* when the candidate set empties in `SHARED_MODIFIED`
  (a write raced a second thread with no common lock).

Watching is cooperative and test-scoped: install on a live stack
(`launch_sim_stack`), drive it — including the serving fan-out and SSE
threads lockwatch does not cover — then `unwatch_all()` and read
`reports()`. The proxies add one dict op per access; poses of a watched
run must equal an unwatched one (asserted in the self-check tests).
"""

from __future__ import annotations

import threading
from dataclasses import dataclass
from typing import Dict, FrozenSet, List, Optional, Tuple

from jax_mapping_torch.analysis.lockwatch import _RecordingLock
from jax_mapping_torch.analysis.protection import LockGroup

#: Eraser states.
VIRGIN = "virgin"
EXCLUSIVE = "exclusive"              # one thread only — no refinement
SHARED = "shared"                    # 2+ threads, reads only since shared
SHARED_MODIFIED = "shared-modified"  # 2+ threads incl. a write — report

#: ⊤ — "every lock" before the first refinement.
_TOP = None


@dataclass
class FieldState:
    name: str                        # "MapperNode.states@mapper"
    state: str = VIRGIN
    first_thread: Optional[int] = None
    #: candidate lockset; None = ⊤ (not yet refined).
    candidate: Optional[FrozenSet[str]] = _TOP
    n_reads: int = 0
    n_writes: int = 0
    #: filled when the candidate set empties in SHARED_MODIFIED.
    report: Optional[str] = None
    #: last locksets seen, for the report text.
    last_write_lockset: FrozenSet[str] = frozenset()


@dataclass(frozen=True)
class RaceReport:
    field: str
    message: str


class RaceWatch:
    """Record lock-held sets + field accesses; apply Eraser refinement."""

    def __init__(self):
        self._mu = threading.Lock()
        self._tls = threading.local()
        self._installed_locks: List[Tuple[object, str, object]] = []
        self._installed_objects: List[Tuple[object, type]] = []
        self._fields: Dict[Tuple[int, str], FieldState] = {}
        self._monitored_cache: Dict[Tuple[type, FrozenSet[str]], type] = {}

    # -- lock protocol (duck-typed for _RecordingLock) -----------------------

    def _held(self) -> List[str]:
        held = getattr(self._tls, "held", None)
        if held is None:
            held = self._tls.held = []
        return held

    def _record_acquire(self, name: str) -> None:
        self._held().append(name)

    def _record_release(self, name: str) -> None:
        held = self._held()
        for i in range(len(held) - 1, -1, -1):
            if held[i] == name:
                del held[i]
                return

    # -- installation --------------------------------------------------------

    def watch_lock(self, obj: object, attr: str,
                   name: Optional[str] = None) -> str:
        """Proxy `obj.<attr>` so acquisitions feed the held-lockset.
        Same contract (and same caveat about pre-captured lock
        references) as `LockWatch.watch`."""
        real = getattr(obj, attr)
        if isinstance(real, _RecordingLock):
            if real._watch is self:
                return real.name         # already ours: idempotent
            # Another watch's proxy (e.g. a LockWatch validating order
            # on the same stack): CHAIN ours over it — returning early
            # would route this lock's acquisitions only to the other
            # watch, leaving our held-set empty and every field's
            # candidate lockset spuriously intersecting to ∅.
        lock_name = name or f"{type(obj).__name__}.{attr}"
        setattr(obj, attr, _RecordingLock(self, real, lock_name))
        self._installed_locks.append((obj, attr, real))
        return lock_name

    def watch_object(self, obj: object, group: LockGroup,
                     name: Optional[str] = None) -> str:
        """Instrument `group.watchable_fields()` on `obj` AND its group
        lock. The object's class is swapped for a recording subclass;
        `unwatch_all` restores it."""
        tag = name or type(obj).__name__
        self.watch_lock(obj, group.lock_attr,
                        name=f"{group.cls}.{group.lock_attr}@{tag}")
        for extra in sorted(group.extra_locks):
            self.watch_lock(obj, extra,
                            name=f"{group.cls}.{extra}@{tag}")
        fields = frozenset(group.watchable_fields())
        cls = type(obj)
        key = (cls, fields)
        mon = self._monitored_cache.get(key)
        if mon is None:
            mon = self._make_monitored(cls, fields)
            self._monitored_cache[key] = mon
        self._installed_objects.append((obj, cls))
        # The subclass reads the watch + tag through instance slots set
        # BEFORE the swap so no recorded attribute is touched unarmed.
        object.__setattr__(obj, "_racewatch", self)
        object.__setattr__(obj, "_racewatch_tag", tag)
        obj.__class__ = mon
        return tag

    @staticmethod
    def _make_monitored(cls: type, fields: FrozenSet[str]) -> type:
        def __getattribute__(self, attr):
            value = object.__getattribute__(self, attr)
            if attr in fields:
                watch = object.__getattribute__(self, "_racewatch")
                tag = object.__getattribute__(self, "_racewatch_tag")
                watch._record_access(self, tag, attr, is_write=False)
            return value

        def __setattr__(self, attr, value):
            if attr in fields:
                watch = object.__getattribute__(self, "_racewatch")
                tag = object.__getattribute__(self, "_racewatch_tag")
                watch._record_access(self, tag, attr, is_write=True)
            object.__setattr__(self, attr, value)

        return type(f"Raced{cls.__name__}", (cls,), {
            "__getattribute__": __getattribute__,
            "__setattr__": __setattr__,
        })

    def unwatch_all(self) -> None:
        for obj, cls in reversed(self._installed_objects):
            obj.__class__ = cls
        self._installed_objects.clear()
        for obj, attr, real in reversed(self._installed_locks):
            setattr(obj, attr, real)
        self._installed_locks.clear()

    # -- the Eraser refinement ----------------------------------------------

    def _record_access(self, obj: object, tag: str, attr: str,
                       is_write: bool) -> None:
        held = frozenset(self._held())
        tid = threading.get_ident()
        key = (id(obj), attr)
        new_report = None
        with self._mu:
            st = self._fields.get(key)
            if st is None:
                st = self._fields[key] = FieldState(
                    name=f"{type(obj).__bases__[0].__name__}.{attr}@{tag}")
            if is_write:
                st.n_writes += 1
                st.last_write_lockset = held
            else:
                st.n_reads += 1
            if st.state == VIRGIN:
                st.state = EXCLUSIVE
                st.first_thread = tid
                return
            if st.state == EXCLUSIVE:
                if tid == st.first_thread:
                    return               # still single-owner: no refining
                st.state = SHARED_MODIFIED if is_write else SHARED
                # the first cross-thread access starts the candidate set
                st.candidate = held
            else:
                if st.state == SHARED and is_write:
                    st.state = SHARED_MODIFIED
                st.candidate = (held if st.candidate is _TOP
                                else st.candidate & held)
            if st.state == SHARED_MODIFIED and st.candidate is not _TOP \
                    and not st.candidate and st.report is None:
                st.report = (
                    f"{st.name}: candidate lockset EMPTY after a "
                    f"{'write' if is_write else 'read'} on thread "
                    f"{tid} holding {sorted(held) or ['<nothing>']} — "
                    "no single lock protects every access "
                    f"({st.n_reads} reads / {st.n_writes} writes "
                    "observed); the field races")
                new_report = st.name
        if new_report is not None:
            # Postmortem trigger: a race report is exactly
            # the moment the flight recorder's recent transitions
            # explain — record + dump OUTSIDE `_mu`, and BOTH on a
            # one-shot thread, never inline: _record_access fires
            # mid-attribute-access, i.e. while the racing thread may
            # still hold the watched object's own lock — and the
            # watched object may BE the global flight_recorder or the
            # Tracer attached to it (both have protection.py groups),
            # so an inline record()/dump() would re-take that
            # non-reentrant lock and self-deadlock (inline I/O under a
            # foreign caller lock would also break the B2 rule). The
            # thread sequences record before dump, so the dump's
            # snapshot still contains the report event. At most once
            # per field, so never hot.
            from jax_mapping_torch.obs.recorder import flight_recorder

            def _postmortem(field=new_report):
                flight_recorder.record("racewatch_report", field=field)
                flight_recorder.dump(f"racewatch_{field}")

            threading.Thread(target=_postmortem,
                             name=f"racewatch-dump-{new_report}",
                             daemon=True).start()

    # -- results -------------------------------------------------------------

    def reports(self) -> List[RaceReport]:
        with self._mu:
            return [RaceReport(field=st.name, message=st.report)
                    for st in self._fields.values()
                    if st.report is not None]

    def field_states(self) -> Dict[str, FieldState]:
        """Per-field final states keyed by display name (telemetry and
        the self-check's 'the watch actually saw traffic' assertion)."""
        with self._mu:
            return {st.name: st for st in self._fields.values()}
