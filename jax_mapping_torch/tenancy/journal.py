"""Durable control plane: an append-only, CRC-per-record lifecycle journal.

A copy of the JAX package's `tenancy/journal.py` (stdlib only): the record
format, the CRC, compaction and torn-tail truncation are the same, so the
same record sequence writes the same file bytes in both packages.

The `TenantControlPlane` registry was purely in-memory: a supervisor
crash forgot which tenants exist even though their checkpoints survive
on disk. This module makes the registry durable with the two-file
scheme every production control plane converges on:

* ``control.journal`` — append-only binary records, one per lifecycle
  transition (admit / suspend / resume / evict / quarantine / readmit
  / checkpoint watermark). Each record is ``<u32 length> <payload>
  <u32 crc32(payload)>`` with a JSON payload, so the io/checkpoint
  corruption doctrine applies verbatim: a torn tail (power loss
  mid-append) fails its length or CRC check, the reader TRUNCATES the
  file back to the last intact record, and replay proceeds — corrupt
  degrades, never crashes.
* ``registry.json`` — a compaction snapshot of the folded registry
  (written atomically via tmp+rename, CRC-stamped), taken every
  `journal_compact_every` records so replay cost stays bounded over a
  plane's lifetime. The snapshot stores the sequence number of the
  last folded record; ``read_registry`` loads the snapshot (falling
  back to full-journal replay when it is missing or rotten) and
  replays only the journal records with a HIGHER sequence number —
  "snapshot newer than journal tail" therefore reads cleanly as
  "nothing left to replay".

Replay folds records into ``{tid: {"seed", "epoch", "revision",
"steps", "state"}}``; `TenantControlPlane.restore()` then re-admits
every non-evicted tenant from its generation-retained checkpoint
through the StagedWarmup ladder with its epoch BUMPED (the restart-epoch
protocol: clients resync instead of seeing revision regressions).

Threading: appends run under the control plane's `_lock` — the
journal is leaf stdlib file IO whose ordering must match the registry
mutation order it records (the `step()` device-work-under-lock
precedent); readers run at restore time, before the plane serves.
"""

from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Dict, Optional, Tuple

JOURNAL_NAME = "control.journal"
SNAPSHOT_NAME = "registry.json"

#: Lifecycle record kinds (the full containment vocabulary).
RECORD_KINDS = frozenset({
    "admit", "suspend", "resume", "evict", "quarantine", "readmit",
    "checkpoint", "restore",
})

_HEADER = struct.Struct("<I")            # record length prefix
_TRAILER = struct.Struct("<I")           # crc32 over the payload


def _crc(payload: bytes) -> int:
    return zlib.crc32(payload) & 0xFFFFFFFF


class ControlJournal:
    """One plane's journal + snapshot pair under `dirpath`."""

    def __init__(self, dirpath: str):
        self.dirpath = dirpath
        os.makedirs(dirpath, exist_ok=True)
        self.journal_path = os.path.join(dirpath, JOURNAL_NAME)
        self.snapshot_path = os.path.join(dirpath, SNAPSHOT_NAME)
        #: Monotonic record sequence; restored from disk so a reopened
        #: journal keeps extending the same ordering.
        self.seq = 0
        self.n_appends = 0
        self.n_compactions = 0
        registry, seq, _ = read_registry(dirpath)
        self.seq = seq
        self._registry = registry

    # -- append path (control plane, under its _lock) ------------------------

    def append(self, kind: str, tid: str, **fields) -> int:
        """Append one lifecycle record; returns its sequence number.
        The write is flushed (a crash loses at most the torn tail the
        reader truncates, never an acknowledged record's prefix)."""
        if kind not in RECORD_KINDS:
            raise ValueError(f"unknown journal record kind {kind!r}")
        self.seq += 1
        rec = {"seq": self.seq, "kind": kind, "tid": tid, **fields}
        payload = json.dumps(rec, sort_keys=True).encode()
        with open(self.journal_path, "ab") as f:
            f.write(_HEADER.pack(len(payload)) + payload
                    + _TRAILER.pack(_crc(payload)))
            f.flush()
            os.fsync(f.fileno())
        self._fold(self._registry, rec)
        self.n_appends += 1
        return self.seq

    def compact(self) -> None:
        """Fold the live registry into the snapshot (atomic tmp+rename,
        CRC-stamped) and truncate the journal: replay cost resets to
        zero records."""
        doc = {"seq": self.seq, "tenants": self._registry}
        payload = json.dumps(doc, sort_keys=True).encode()
        body = {"crc32": _crc(payload),
                "registry": doc}
        tmp = self.snapshot_path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(body, f, sort_keys=True)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, self.snapshot_path)
        with open(self.journal_path, "wb") as f:
            f.flush()
            os.fsync(f.fileno())
        self.n_compactions += 1

    def registry(self) -> Dict[str, dict]:
        """The live folded registry (the caller copies if it mutates)."""
        return self._registry

    # -- fold ----------------------------------------------------------------

    @staticmethod
    def _fold(registry: Dict[str, dict], rec: dict) -> None:
        tid = rec.get("tid", "")
        if not tid:
            return
        row = registry.setdefault(tid, {
            "seed": 0, "epoch": -1, "revision": 0, "steps": 0,
            "state": "new"})
        # world_shape/world_dtype ride admit/checkpoint/restore records
        # so `restore()` can build a load template without the live
        # world array (checkpoints hold the bytes, the journal holds
        # the shape).
        for k in ("seed", "epoch", "revision", "steps",
                  "world_shape", "world_dtype"):
            if k in rec:
                row[k] = rec[k]
        kind = rec.get("kind")
        if kind in ("admit", "resume", "readmit"):
            row["state"] = "active"
        elif kind == "suspend":
            row["state"] = "suspended"
        elif kind == "quarantine":
            row["state"] = "quarantined"
        elif kind == "evict":
            row["state"] = "evicted"
        # "checkpoint" is a pure watermark and "restore" re-asserts a
        # lifecycle verbatim — both carry an explicit "state" field
        # (folded below) instead of a kind-implied one.
        if "state" in rec:
            row["state"] = rec["state"]


def read_journal(path: str, truncate_torn: bool = True
                 ) -> Tuple[list, int]:
    """(records, truncated_bytes) from an append-only journal file.
    A torn tail — short header, short payload, or CRC mismatch — ends
    the walk at the last intact record and (by default) truncates the
    file there, the io/checkpoint doctrine: corrupt degrades, never
    crashes, and the torn bytes can never resurrect."""
    records = []
    if not os.path.exists(path):
        return records, 0
    good_end = 0
    with open(path, "rb") as f:
        data = f.read()
    off = 0
    while off + _HEADER.size <= len(data):
        (length,) = _HEADER.unpack_from(data, off)
        end = off + _HEADER.size + length + _TRAILER.size
        if length > len(data) or end > len(data):
            break                        # torn mid-record
        payload = data[off + _HEADER.size: off + _HEADER.size + length]
        (crc,) = _TRAILER.unpack_from(data, end - _TRAILER.size)
        if _crc(payload) != crc:
            break                        # bit rot / torn payload
        try:
            rec = json.loads(payload)
        except ValueError:
            break
        records.append(rec)
        good_end = end
        off = end
    truncated = len(data) - good_end
    if truncated and truncate_torn:
        with open(path, "rb+") as f:
            f.truncate(good_end)
    return records, truncated


def _read_snapshot(path: str) -> Optional[dict]:
    """The snapshot's {seq, tenants} doc, or None when missing/rotten
    (CRC mismatch, unparseable) — the caller then replays the full
    journal instead of crashing (the fallback doctrine)."""
    if not os.path.exists(path):
        return None
    try:
        with open(path) as f:
            body = json.load(f)
        doc = body["registry"]
        payload = json.dumps(doc, sort_keys=True).encode()
        if _crc(payload) != body["crc32"]:
            return None
        return doc
    except (OSError, ValueError, KeyError, TypeError):
        return None


def read_registry(dirpath: str) -> Tuple[Dict[str, dict], int, dict]:
    """(registry, last_seq, meta): the folded tenant registry from
    snapshot + journal replay under `dirpath`. Records at or below the
    snapshot's sequence are skipped (an older journal tail than the
    snapshot replays to nothing — the "snapshot newer than journal
    tail" case); a missing/rotten snapshot degrades to full replay;
    a torn journal tail is truncated. `meta` reports what happened."""
    snap = _read_snapshot(os.path.join(dirpath, SNAPSHOT_NAME))
    registry: Dict[str, dict] = {}
    base_seq = 0
    if snap is not None:
        registry = {t: dict(row) for t, row in snap["tenants"].items()}
        base_seq = int(snap["seq"])
    records, truncated = read_journal(
        os.path.join(dirpath, JOURNAL_NAME))
    last_seq = base_seq
    n_replayed = 0
    for rec in records:
        seq = int(rec.get("seq", 0))
        if seq <= base_seq:
            continue                     # already folded in snapshot
        ControlJournal._fold(registry, rec)
        last_seq = max(last_seq, seq)
        n_replayed = n_replayed + 1
    return registry, last_seq, {
        "snapshot": snap is not None,
        "snapshot_seq": base_seq,
        "n_replayed": n_replayed,
        "torn_bytes_truncated": truncated,
    }
