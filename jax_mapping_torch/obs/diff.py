"""Trace-diff: turn "two runs must be bit-identical" into a WHERE.

A copy of the JAX package's `obs/diff.py` (stdlib only); it diffs either
package's streams.

Every determinism gate in this repo (FaultPlan chaos soaks, the
scenario engine, the obs stream-identity contract) ends in a bare
array/stream compare: it can say two same-seed runs diverged, never
where. This module compares two event/span streams after NORMALIZING
away the fields that are legitimately nondeterministic (wall
timestamps, durations, thread ids, absolute sequence stamps, dump
paths) and reports the FIRST divergence point — the index, both sides'
events, and a unified summary — so a failed gate hands the operator
the first transition that differed instead of a 4096^2 grid diff.

Works on flight-recorder event streams and tracer span streams alike
(both are lists of flat dicts); `python -m jax_mapping_torch.obs diff a b`
wraps it for dump files. Pure stdlib, no torch import.
"""

from __future__ import annotations

from typing import Iterable, List, NamedTuple, Optional, Sequence, Tuple

#: Fields that may differ between two same-seed runs by design: wall
#: clocks, host timing, thread identity, the process-lifetime absolute
#: counters, and dump file names (numbered per process).
VOLATILE_FIELDS = ("seq", "wall_ts", "ts_us", "dur_us", "tid", "path")


def normalize_events(events: Iterable[dict],
                     ignore: Sequence[str] = VOLATILE_FIELDS
                     ) -> List[Tuple]:
    """Each event reduced to a sorted (key, value) tuple with the
    volatile fields dropped — the comparable causal content."""
    out = []
    for e in events:
        out.append(tuple(sorted((k, v) for k, v in e.items()
                                if k not in ignore)))
    return out


class Divergence(NamedTuple):
    """First point two streams disagree. `index` is the position in the
    normalized streams; a side is None when that stream simply ended
    (length mismatch)."""

    index: int
    a: Optional[dict]
    b: Optional[dict]

    def describe(self) -> str:
        def fmt(side, e):
            if e is None:
                return f"  {side}: <stream ended>"
            return f"  {side}: " + ", ".join(
                f"{k}={v!r}" for k, v in sorted(e.items())
                if k not in VOLATILE_FIELDS)
        return (f"first divergence at event #{self.index}:\n"
                + fmt("A", self.a) + "\n" + fmt("B", self.b))


def diff_streams(a: Sequence[dict], b: Sequence[dict],
                 ignore: Sequence[str] = VOLATILE_FIELDS
                 ) -> Optional[Divergence]:
    """None when the normalized streams are identical, else the first
    divergence point with the ORIGINAL (un-normalized) events attached
    so the report keeps timestamps for human context."""
    na, nb = normalize_events(a, ignore), normalize_events(b, ignore)
    for i, (ea, eb) in enumerate(zip(na, nb)):
        if ea != eb:
            return Divergence(i, dict(a[i]), dict(b[i]))
    if len(na) != len(nb):
        i = min(len(na), len(nb))
        return Divergence(i,
                          dict(a[i]) if i < len(a) else None,
                          dict(b[i]) if i < len(b) else None)
    return None


def diff_dumps(dump_a: dict, dump_b: dict) -> dict:
    """Compare two flight-recorder dump documents (events AND spans);
    returns {"events": Divergence|None, "spans": Divergence|None,
    "identical": bool} — the postmortem workflow's one-call answer."""
    ev = diff_streams(dump_a.get("events", ()), dump_b.get("events", ()))
    sp = diff_streams(dump_a.get("spans", ()), dump_b.get("spans", ()))
    return {"events": ev, "spans": sp,
            "identical": ev is None and sp is None}
