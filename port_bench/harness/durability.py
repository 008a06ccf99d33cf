"""Reading back what a tenant control plane wrote to disk, with the
benchmark's own readers: the lifecycle journal (records of `<u32
length> <JSON payload> <u32 crc32>`, and a `registry.json` snapshot once
compacted) and a tenant's containment checkpoint (an `.npz` whose leaves
carry their CRC32 in a JSON meta member)."""

from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Dict

import numpy as np

META_KEY = "__jax_mapping_meta__"
_U32 = struct.Struct("<I")


def _crc(b: bytes) -> int:
    return zlib.crc32(b) & 0xFFFFFFFF


def journal_admits(dirpath: str) -> Dict[str, dict]:
    """{tid: the fields of its last admit} from the snapshot and the
    intact records of the journal under `dirpath`."""
    out: Dict[str, dict] = {}
    snap = os.path.join(dirpath, "registry.json")
    if os.path.exists(snap):
        doc = json.load(open(snap))["registry"]
        for tid, row in doc.get("tenants", {}).items():
            if row.get("state") == "active":
                out[tid] = dict(row)
    path = os.path.join(dirpath, "control.journal")
    data = open(path, "rb").read() if os.path.exists(path) else b""
    off = 0
    while off + 4 <= len(data):
        (n,) = _U32.unpack_from(data, off)
        end = off + 4 + n + 4
        if end > len(data):
            break
        payload = data[off + 4:off + 4 + n]
        if _crc(payload) != _U32.unpack_from(data, end - 4)[0]:
            break
        rec = json.loads(payload)
        if rec.get("kind") == "admit":
            out[rec["tid"]] = rec
        off = end
    return out


def checkpoint_leaves(path: str) -> Dict[str, np.ndarray]:
    """Every leaf of a checkpoint by key; a leaf whose bytes fail their
    CRC32 is left out."""
    with np.load(path, allow_pickle=False) as z:
        meta = json.loads(bytes(z[META_KEY].tobytes()).decode())
        out = {}
        for k in meta["keys"]:
            a = np.asarray(z[k])
            if _crc(np.ascontiguousarray(a).tobytes()) == meta["crc32"][k]:
                out[k] = a
    return out
