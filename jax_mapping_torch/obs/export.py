"""Chrome-trace / Perfetto export for tracer spans and recorder dumps.

A copy of the JAX package's `obs/export.py` (stdlib only).

One converter, three consumers: `GET /trace?since=` serves live spans,
`python -m jax_mapping_torch.obs export` converts a flight-recorder dump to a
`chrome://tracing` / Perfetto-loadable file, and tests read the event
shape. Pure stdlib (the `python -m` entry must start fast, no torch
import).
"""

from __future__ import annotations

import json
from typing import Iterable, List


def chrome_events(spans: Iterable[dict]) -> List[dict]:
    """Tracer span records -> Chrome Trace Event Format 'X' (complete)
    events. Ids ride in `args` (Perfetto's flow/query surface); instant
    spans get a 1 us floor so they stay visible on the timeline."""
    out = []
    for s in spans:
        out.append({
            "name": s["name"],
            "ph": "X",
            "ts": round(float(s.get("ts_us", 0.0)), 3),
            "dur": max(round(float(s.get("dur_us", 0.0)), 3), 1.0),
            "pid": 1,
            "tid": int(s.get("tid", 1)),
            "args": {
                "trace_id": f"{s['trace_id']:016x}",
                "span_id": f"{s['span_id']:016x}",
                "parent_span": f"{s['parent_span']:016x}",
                "seq": s.get("seq"),
            },
        })
    return out


def recorder_events_as_chrome(events: Iterable[dict]) -> List[dict]:
    """Flight-recorder events -> instant ('i') marks on their own track,
    so a dump's transitions overlay the span timeline in one view."""
    out = []
    for i, e in enumerate(events):
        args = {k: v for k, v in e.items()
                if k not in ("kind", "wall_ts")}
        out.append({
            "name": e.get("kind", "event"),
            "ph": "i",
            "s": "g",                       # global-scope instant mark
            "ts": float(i),                 # ring order; dumps lack a
            "pid": 1, "tid": 0,             # shared clock with spans
            "args": args,
        })
    return out


def dump_to_chrome(dump: dict) -> dict:
    """A flight-recorder dump (obs/recorder.py JSON) -> one Chrome
    trace document: spans as complete events, recorder transitions as
    instant marks."""
    return {"traceEvents": chrome_events(dump.get("spans", ()))
            + recorder_events_as_chrome(dump.get("events", ())),
            "otherData": {"reason": dump.get("reason", "")}}


def write_chrome_trace(path: str, spans: Iterable[dict],
                       events: Iterable[dict] = ()) -> str:
    with open(path, "w") as f:
        json.dump({"traceEvents": chrome_events(spans)
                   + recorder_events_as_chrome(events)}, f)
    return path
