"""Causal tracing with DETERMINISTIC ids — the FaultPlan contract

A copy of the JAX package's `obs/trace.py` (stdlib only): the same id
derivation, so the same publish sequence gives the same trace and span ids
in both packages.
extended to telemetry.

A `TraceContext` is the (trace_id, span_id, parent_span) triple carried
across the system's async boundaries: `Bus` publish/delivery (the
context rides a parallel queue next to each subscription's mailbox),
mapper tick, and HTTP handlers. Ids are NOT random: a root context
created at a bus publish derives its trace id from `(seed, topic, seq)`
— the launch seed, the topic string, and that topic's monotone publish
count — and every child span id hashes down from its parent. Two
same-seed deterministic runs (`Stack.run_steps`) therefore emit
IDENTICAL trace streams, which is what makes `obs/diff.py` able to
answer "*where* did two supposedly-bit-identical runs diverge" instead
of only "they differ".

Spans land in one bounded, lock-guarded ring (the flight-recorder
discipline: never block the hot path, never grow without bound) and
export as Chrome-trace/Perfetto JSON via `obs/export.py`, `GET
/trace?since=` and `python -m jax_mapping_torch.obs`.

Everything here is host-side stdlib — no torch import, nothing on the
device path, so `ObsConfig(enabled=False)` (no Tracer constructed) is
bit-exact pre-obs behavior and `enabled=True` may not perturb a single
tensor.
"""

from __future__ import annotations

import collections
import contextlib
import hashlib
import threading
import time
from typing import Dict, Iterator, List, NamedTuple, Optional, Tuple


class TraceContext(NamedTuple):
    """One hop of a causal chain. `parent_span == 0` marks a root."""

    trace_id: int
    span_id: int
    parent_span: int = 0


def h64(*parts) -> int:
    """Deterministic 64-bit id from the parts' string forms (blake2b —
    stable across processes and runs, unlike `hash()` under
    PYTHONHASHSEED). Never returns 0: 0 is the 'no parent' sentinel."""
    h = hashlib.blake2b(digest_size=8)
    for p in parts:
        h.update(str(p).encode())
        h.update(b"\x00")
    return int.from_bytes(h.digest(), "big") or 1


class Tracer:
    """Deterministic span factory + bounded span ring.

    Thread contract: the current context is THREAD-LOCAL (`use`/`span`
    set it around callback delivery and handler bodies); the ring, the
    span counter and the per-scope sequence table mutate only under
    `_lock` (racewatch-gated — see analysis/protection.py). Sequence
    numbers are per (kind, scope) so bus traffic on one topic can never
    perturb another topic's ids, and HTTP-created roots (live polls are
    inherently nondeterministic) never touch the topic scopes the
    deterministic-stream contract covers.
    """

    def __init__(self, seed: int = 0, capacity: int = 65536):
        self.seed = seed
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._spans: collections.deque = collections.deque(maxlen=capacity)
        #: Spans ever recorded (also the per-span monotone `seq` stamp
        #: `/trace?since=` filters on). Guarded by `_lock` like the ring.
        self.n_spans = 0
        self._seq: Dict[Tuple[str, str], int] = {}
        self._t0 = time.perf_counter()

    # -- current-context plumbing (thread-local) -----------------------------

    def current(self) -> Optional[TraceContext]:
        return getattr(self._tls, "ctx", None)

    @contextlib.contextmanager
    def use(self, ctx: Optional[TraceContext]) -> Iterator[None]:
        """Make `ctx` the thread's current context for a block (the bus
        sets the publish context around callback delivery, so a
        subscriber callback reads its causal parent via `current()`)."""
        prev = getattr(self._tls, "ctx", None)
        self._tls.ctx = ctx
        try:
            yield
        finally:
            self._tls.ctx = prev

    # -- id derivation -------------------------------------------------------

    def _next_seq(self, kind: str, scope: str) -> int:
        with self._lock:
            key = (kind, scope)
            self._seq[key] = self._seq.get(key, 0) + 1
            return self._seq[key]

    def derive(self, parent: Optional[TraceContext], name: str,
               key=0) -> TraceContext:
        """Child of `parent`, or a fresh deterministic root when there
        is no parent. `key` disambiguates same-name siblings (the
        mapper passes (robot, scan stamp))."""
        if parent is None:
            seq = self._next_seq("root", name)
            trace_id = h64("trace", self.seed, name, seq)
            return TraceContext(trace_id, h64("span", trace_id, key), 0)
        return TraceContext(
            parent.trace_id,
            h64("span", parent.trace_id, parent.span_id, name, key),
            parent.span_id)

    # -- the bus boundary ----------------------------------------------------

    def on_publish(self, topic: str) -> TraceContext:
        """Derive the context one bus publish carries. No ambient
        context (a sensor/timer origin) starts a ROOT whose trace id is
        `h64("trace", seed, topic, seq)` — the deterministic-stream
        anchor; a publish inside a traced callback chains as a child."""
        parent = self.current()
        seq = self._next_seq("topic", topic)
        if parent is None:
            trace_id = h64("trace", self.seed, topic, seq)
            ctx = TraceContext(trace_id, h64("span", trace_id), 0)
        else:
            ctx = TraceContext(
                parent.trace_id,
                h64("span", parent.trace_id, parent.span_id, topic, seq),
                parent.span_id)
        self._record(f"publish:{topic}", ctx, 0.0)
        return ctx

    # -- span emission -------------------------------------------------------

    def emit(self, name: str, parent: Optional[TraceContext] = None,
             key=0) -> TraceContext:
        """Record one instant span (e.g. `mapper.fuse` per fused scan).
        Explicit `parent` beats the ambient context; both absent makes
        a root."""
        ctx = self.derive(parent if parent is not None else self.current(),
                          name, key)
        self._record(name, ctx, 0.0)
        return ctx

    @contextlib.contextmanager
    def span(self, name: str, parent: Optional[TraceContext] = None,
             key=0) -> Iterator[TraceContext]:
        """Timed span that is also the block's current context, so
        publishes inside chain under it (mapper tick, HTTP handler)."""
        ctx = self.derive(parent if parent is not None else self.current(),
                          name, key)
        t0 = time.perf_counter()
        with self.use(ctx):
            try:
                yield ctx
            finally:
                self._record(name, ctx, time.perf_counter() - t0, t0=t0)

    def _record(self, name: str, ctx: TraceContext, dur_s: float,
                t0: Optional[float] = None) -> None:
        start = t0 if t0 is not None else time.perf_counter()
        with self._lock:
            self.n_spans += 1
            self._spans.append({
                "seq": self.n_spans,
                "name": name,
                "trace_id": ctx.trace_id,
                "span_id": ctx.span_id,
                "parent_span": ctx.parent_span,
                # Wall-ish fields for Perfetto; the diff tool drops them
                # (they are the one nondeterministic part of a span).
                "ts_us": (start - self._t0) * 1e6,
                "dur_us": dur_s * 1e6,
                "tid": threading.get_ident() & 0xFFFF,
            })

    # -- export --------------------------------------------------------------

    def spans_since(self, seq: int = 0) -> List[dict]:
        """Spans with `seq` stamps strictly greater than `seq`, oldest
        first (the `/trace?since=` contract); copies, never live ring
        entries. Seq stamps are append-ordered, so the tail is found by
        walking from the newest end — an incremental `/trace` poll
        holds the emission lock (shared with every hot-path span
        record) for O(new spans), not a full 64k-ring scan."""
        refs: List[dict] = []
        with self._lock:
            # References only under the lock (span dicts are immutable
            # once emplaced by _record) — the dict copies of a full-ring
            # read (a postmortem dump) happen outside, off the lock
            # every hot-path span emit contends on.
            for s in reversed(self._spans):
                if s["seq"] <= seq:
                    break
                refs.append(s)
        refs.reverse()
        return [dict(s) for s in refs]

    def last_seq(self) -> int:
        with self._lock:
            return self.n_spans

    def stats(self) -> dict:
        with self._lock:
            return {"n_spans": self.n_spans, "ring_len": len(self._spans)}
