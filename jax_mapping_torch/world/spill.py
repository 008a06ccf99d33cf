"""Disk spill tier for evicted world tiles (the `io/checkpoint`
integrity doctrine applied to the sliding window's cold storage).

Append-only record file, the tenancy-journal framing:

    <u32 payload_len> <payload> <u32 crc32(payload)>

where `payload` is one JSON meta line + b"\\n" + the tile's raw bytes:

    {"tile": [r, c], "gen": 7, "decay": 3, "dtype": "float32",
     "shape": [256, 256], "coarse": 1, "crc": <crc32 of tile bytes>}

Two CRCs on purpose: the record CRC catches torn appends (the walk on
open truncates the tail to the last good record, never fatal — the
tenancy-journal recovery rule), while the inner tile CRC travels WITH
the tile so a bit flip inside an otherwise well-framed record (the
`spill_corrupt` chaos kind) is detected at READ time: `get()` returns
None and the caller degrades the tile to unknown with a flight event
instead of scattering garbage into the live map.

Newest generation wins: re-evicting a tile appends a new record and
the in-memory index moves; `compact()` rewrites only the live records
(the journal compaction idiom). Reads are offset seeks into the open
file — no index file on disk, the walk IS the recovery.
"""

from __future__ import annotations

import json
import os
import struct
import threading
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np

_LEN = struct.Struct("<I")
_CRC = struct.Struct("<I")

#: Frame overhead per record, bytes (length prefix + trailing CRC).
_FRAME = _LEN.size + _CRC.size


class SpillRecord:
    """One rehydrated tile read back from disk (CRC-verified)."""

    __slots__ = ("tile", "gen", "decay_epoch", "coarse", "data")

    def __init__(self, tile: Tuple[int, int], gen: int,
                 decay_epoch: int, coarse: int, data: np.ndarray):
        self.tile = tile
        self.gen = gen
        self.decay_epoch = decay_epoch
        self.coarse = coarse
        self.data = data


class SpillStore:
    """Append-only CRC-framed tile spill file + in-memory index.

    Thread-safe: the world store's eviction runs on the mapper tick
    thread while disk rehydration reads from a prefetch thread; one
    lock serializes the file handle (reads seek, appends run at EOF).
    """

    FILENAME = "tiles.spill"

    def __init__(self, directory: str):
        self.directory = directory
        os.makedirs(directory, exist_ok=True)
        self.path = os.path.join(directory, self.FILENAME)
        self._lock = threading.Lock()
        #: (r, c) -> (gen, payload offset, payload length)
        self._index: Dict[Tuple[int, int], Tuple[int, int, int]] = {}
        self.n_appends = 0
        self.n_reads = 0
        self.n_corrupt_reads = 0
        self.n_truncated_bytes = 0
        self._open_and_recover()

    # -- recovery --------------------------------------------------------

    def _open_and_recover(self) -> None:
        """Walk the file; a torn/corrupt tail truncates to the last
        good record (the tenancy-journal rule: a crash mid-append must
        not orphan the whole spill)."""
        mode = "r+b" if os.path.exists(self.path) else "w+b"
        # Construction is single-threaded, but the recovery walk still
        # runs under `_lock` so every `_f`/`_index` write site in the
        # class is guarded (no baselined single-writer exception).
        with self._lock:
            self._f = open(self.path, mode)
            good_end = 0
            self._f.seek(0, os.SEEK_END)
            size = self._f.tell()
            self._f.seek(0)
            while True:
                head = self._f.read(_LEN.size)
                if len(head) < _LEN.size:
                    break
                (plen,) = _LEN.unpack(head)
                start = self._f.tell()
                if start + plen + _CRC.size > size:
                    break                   # torn append
                payload = self._f.read(plen)
                (crc,) = _CRC.unpack(self._f.read(_CRC.size))
                if zlib.crc32(payload) & 0xFFFFFFFF != crc:
                    break                   # corrupt frame: stop here
                meta = self._parse_meta(payload)
                if meta is None:
                    break
                tile = (int(meta["tile"][0]), int(meta["tile"][1]))
                cur = self._index.get(tile)
                if cur is None or int(meta["gen"]) >= cur[0]:
                    self._index[tile] = (int(meta["gen"]), start, plen)
                good_end = self._f.tell()
            if good_end < size:
                self.n_truncated_bytes = size - good_end
                self._f.truncate(good_end)
            self._f.seek(0, os.SEEK_END)

    @staticmethod
    def _parse_meta(payload: bytes) -> Optional[dict]:
        nl = payload.find(b"\n")
        if nl < 0:
            return None
        try:
            return json.loads(payload[:nl])
        except ValueError:
            return None

    # -- protocol --------------------------------------------------------

    def put(self, tile: Tuple[int, int], gen: int, data: np.ndarray,
            decay_epoch: int, coarse: int = 1) -> None:
        """Append one evicted tile; newest generation wins on read."""
        raw = np.ascontiguousarray(data).tobytes()
        meta = json.dumps({
            "tile": [int(tile[0]), int(tile[1])],
            "gen": int(gen),
            "decay": int(decay_epoch),
            "dtype": str(data.dtype),
            "shape": list(data.shape),
            "coarse": int(coarse),
            "crc": zlib.crc32(raw) & 0xFFFFFFFF,
        }, sort_keys=True).encode("ascii")
        payload = meta + b"\n" + raw
        frame = (_LEN.pack(len(payload)) + payload
                 + _CRC.pack(zlib.crc32(payload) & 0xFFFFFFFF))
        with self._lock:
            self._f.seek(0, os.SEEK_END)
            off = self._f.tell() + _LEN.size
            self._f.write(frame)
            self._f.flush()
            self._index[(int(tile[0]), int(tile[1]))] = (
                int(gen), off, len(payload))
            self.n_appends += 1

    def get(self, tile: Tuple[int, int]) -> Optional[SpillRecord]:
        """Read back a tile, CRC-verified at BOTH layers; None on a
        miss or on corruption (the caller owns the unknown-degrade +
        flight event — this layer never raises on bad bytes)."""
        key = (int(tile[0]), int(tile[1]))
        with self._lock:
            entry = self._index.get(key)
            if entry is None:
                return None
            gen, off, plen = entry
            self._f.seek(off)
            payload = self._f.read(plen)
            self._f.seek(0, os.SEEK_END)
        self.n_reads += 1
        meta = self._parse_meta(payload)
        if meta is None:
            self.n_corrupt_reads += 1
            return None
        raw = payload[payload.find(b"\n") + 1:]
        if zlib.crc32(raw) & 0xFFFFFFFF != int(meta["crc"]):
            self.n_corrupt_reads += 1
            return None
        data = np.frombuffer(raw, dtype=np.dtype(meta["dtype"]))
        try:
            data = data.reshape(meta["shape"]).copy()
        except ValueError:
            self.n_corrupt_reads += 1
            return None
        return SpillRecord(key, gen, int(meta["decay"]),
                           int(meta.get("coarse", 1)), data)

    def discard(self, tile: Tuple[int, int]) -> None:
        """Drop a tile from the index (its bytes stay until compaction
        — the append-only contract)."""
        with self._lock:
            self._index.pop((int(tile[0]), int(tile[1])), None)

    def tiles(self) -> List[Tuple[int, int]]:
        with self._lock:
            return sorted(self._index)

    def __contains__(self, tile: Tuple[int, int]) -> bool:
        with self._lock:
            return (int(tile[0]), int(tile[1])) in self._index

    def nbytes(self) -> int:
        with self._lock:
            self._f.seek(0, os.SEEK_END)
            return self._f.tell()

    def compact(self) -> None:
        """Rewrite only the live (index-reachable) records — the
        journal compaction idiom, CRC frames preserved."""
        with self._lock:
            live = []
            for tile in sorted(self._index):
                gen, off, plen = self._index[tile]
                self._f.seek(off)
                live.append((tile, gen, self._f.read(plen)))
            self._f.seek(0)
            self._f.truncate(0)
            self._index.clear()
            for tile, gen, payload in live:
                frame = (_LEN.pack(len(payload)) + payload
                         + _CRC.pack(zlib.crc32(payload) & 0xFFFFFFFF))
                off = self._f.tell() + _LEN.size
                self._f.write(frame)
                self._index[tile] = (gen, off, len(payload))
            self._f.flush()

    # -- chaos seam ------------------------------------------------------

    def corrupt_tiles(self, n: int) -> List[Tuple[int, int]]:
        """Flip one bit inside the TILE BYTES of up to `n` spilled
        tiles, on disk, deterministically (sorted tile order) — the
        `spill_corrupt` FaultPlan seam. The frame CRC is rewritten so
        the corruption models silent media rot that the outer framing
        cannot see; only the inner tile CRC catches it at read time.
        Returns the tiles actually hit."""
        hit: List[Tuple[int, int]] = []
        with self._lock:
            for tile in sorted(self._index):
                if len(hit) >= n:
                    break
                gen, off, plen = self._index[tile]
                self._f.seek(off)
                payload = bytearray(self._f.read(plen))
                nl = payload.find(b"\n")
                if nl < 0 or nl + 1 >= len(payload):
                    continue
                # Flip the middle byte's low bit: deterministic, and
                # guaranteed inside the tile-bytes region.
                k = nl + 1 + (len(payload) - nl - 1) // 2
                payload[k] ^= 0x01
                self._f.seek(off)
                self._f.write(payload)
                # Re-stamp the frame CRC: silent rot, not a torn frame.
                self._f.write(_CRC.pack(zlib.crc32(bytes(payload))
                                        & 0xFFFFFFFF))
                hit.append(tile)
            self._f.flush()
            self._f.seek(0, os.SEEK_END)
        return hit

    def close(self) -> None:
        with self._lock:
            try:
                self._f.close()
            except OSError:
                pass

    def status(self) -> dict:
        with self._lock:
            n = len(self._index)
        return {"tiles": n, "appends": self.n_appends,
                "reads": self.n_reads,
                "corrupt_reads": self.n_corrupt_reads,
                "truncated_bytes": self.n_truncated_bytes}
