"""ctypes binding + wire codec for the C++ LD06 ingest pipeline.

`Ld06Parser` wraps `src/ld06.cpp` (built on demand with g++ into
``build/libld06.so``); `encode_packets` produces spec-conformant LD06 byte
streams from range arrays so the simulated fleet can feed the *native* path
the same bytes real hardware would (UART framing per
`pi/src/thymio_project/launch/pi_hardware.launch.py:17-18`,
230400 baud; packet layout per the ldrobot datasheet — see ld06.cpp header).

A copy of the JAX package's `native/ld06.py` over the port's own copy of
the C++ source: the library builds at first use into this package's
`native/build/` (never the JAX package's), into a temporary name renamed
into place, so two processes building at once cannot load a half-written
file. A failed build raises; there is no Python fallback.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "src", "ld06.cpp")
_SO = os.path.join(_DIR, "build", "libld06.so")

PACKET_BYTES = 47
POINTS_PER_PACKET = 12

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None


def _crc8_table() -> np.ndarray:
    t = np.zeros(256, np.uint8)
    for i in range(256):
        crc = i
        for _ in range(8):
            crc = ((crc << 1) ^ 0x4D) if crc & 0x80 else (crc << 1)
            crc &= 0xFF
        t[i] = crc
    return t


_CRC_TABLE = _crc8_table()


def crc8(data: bytes) -> int:
    crc = 0
    for b in data:
        crc = _CRC_TABLE[crc ^ b]
    return int(crc)


def _build() -> Optional[str]:
    """Compile the shared lib; returns an error string or None."""
    os.makedirs(os.path.dirname(_SO), exist_ok=True)
    tmp = f"{_SO}.{os.getpid()}.tmp"
    cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", _SRC, "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"g++ unavailable: {e}"
    if proc.returncode != 0:
        return f"g++ failed: {proc.stderr[-2000:]}"
    os.replace(tmp, _SO)
    return None


def _load() -> Tuple[Optional[ctypes.CDLL], Optional[str]]:
    global _lib, _build_error
    with _lock:
        if _lib is not None or _build_error is not None:
            return _lib, _build_error
        if not os.path.exists(_SO) or \
                os.path.getmtime(_SO) < os.path.getmtime(_SRC):
            err = _build()
            if err is not None:
                _build_error = err
                return None, err
        lib = ctypes.CDLL(_SO)
        lib.ld06_create.restype = ctypes.c_void_p
        lib.ld06_create.argtypes = [ctypes.c_int, ctypes.c_int,
                                    ctypes.c_float]
        lib.ld06_destroy.argtypes = [ctypes.c_void_p]
        lib.ld06_feed.restype = ctypes.c_int
        lib.ld06_feed.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_uint8),
                                  ctypes.c_int]
        lib.ld06_take_scan.restype = ctypes.c_int
        lib.ld06_take_scan.argtypes = [ctypes.c_void_p,
                                       ctypes.POINTER(ctypes.c_float),
                                       ctypes.POINTER(ctypes.c_float),
                                       ctypes.c_int]
        lib.ld06_speed.restype = ctypes.c_double
        lib.ld06_speed.argtypes = [ctypes.c_void_p]
        lib.ld06_stat.restype = ctypes.c_long
        lib.ld06_stat.argtypes = [ctypes.c_void_p, ctypes.c_int]
        _lib = lib
        return _lib, None


def native_available() -> bool:
    lib, _ = _load()
    return lib is not None


_STATS = {"packets": 0, "crc_errors": 1, "resyncs": 2, "points": 3,
          "points_filtered": 4, "scans": 5}


class Ld06Parser:
    """Feed raw bytes, take complete 360° scans.

    Uses the C++ pipeline when buildable; otherwise raises (there is no
    silent Python fallback — the native path IS the component; tests gate
    on `native_available()`).
    """

    def __init__(self, n_beams: int = 360, min_confidence: int = 15,
                 band_m: float = 0.15):
        lib, err = _load()
        if lib is None:
            raise RuntimeError(f"libld06 unavailable: {err}")
        self._lib = lib
        self.n_beams = n_beams
        self._h = lib.ld06_create(n_beams, min_confidence,
                                  ctypes.c_float(band_m))

    def __del__(self):
        h = getattr(self, "_h", None)
        if h:
            self._lib.ld06_destroy(h)
            self._h = None

    def feed(self, data: bytes) -> int:
        """Returns the number of points parsed from complete packets."""
        arr = (ctypes.c_uint8 * len(data)).from_buffer_copy(data)
        return self._lib.ld06_feed(self._h, arr, len(data))

    def take_scan(self) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """(ranges_m, intensities), both (n_beams,), or None if no complete
        rotation is pending. Beam i covers [i, i+1) * 360/n_beams degrees;
        0.0 = no return (the outlier code downstream treats as far,
        `server/.../main.py:152`)."""
        ranges = np.zeros(self.n_beams, np.float32)
        intens = np.zeros(self.n_beams, np.float32)
        ok = self._lib.ld06_take_scan(
            self._h,
            ranges.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            intens.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            self.n_beams)
        if not ok:
            return None
        return ranges, intens

    @property
    def speed_deg_s(self) -> float:
        return self._lib.ld06_speed(self._h)

    def stats(self) -> dict:
        return {k: int(self._lib.ld06_stat(self._h, v))
                for k, v in _STATS.items()}


def encode_packets(ranges_m: np.ndarray, confidences: Optional[np.ndarray]
                   = None, speed_deg_s: int = 3600,
                   start_angle_deg: float = 0.0,
                   timestamp_ms: int = 0) -> bytes:
    """Encode one rotation of beam ranges into LD06 packets.

    Produces ceil(n/12) spec-conformant 47-byte packets sweeping from
    `start_angle_deg` through 360°. Used by the sim to drive the native
    parser with real wire bytes, and by tests as the golden encoder.
    """
    r = np.asarray(ranges_m, np.float64)
    n = len(r)
    conf = (np.full(n, 200, np.int32) if confidences is None
            else np.asarray(confidences, np.int32))
    out = bytearray()
    deg_per_beam = 360.0 / n
    i = 0
    while i < n:
        chunk = min(POINTS_PER_PACKET, n - i)
        idx = np.arange(i, i + POINTS_PER_PACKET) % n     # pad by wrapping
        start = (start_angle_deg + i * deg_per_beam) % 360.0
        end = (start_angle_deg
               + (i + POINTS_PER_PACKET - 1) * deg_per_beam) % 360.0
        pkt = bytearray()
        pkt += bytes([0x54, 0x2C])
        pkt += int(speed_deg_s).to_bytes(2, "little")
        pkt += int(round(start * 100)).to_bytes(2, "little")
        for j in idx:
            mm = int(round(max(r[j], 0.0) * 1000.0))
            pkt += int(min(mm, 0xFFFF)).to_bytes(2, "little")
            pkt += bytes([int(np.clip(conf[j], 0, 255))])
        pkt += int(round(end * 100)).to_bytes(2, "little")
        pkt += int(timestamp_ms % 30000).to_bytes(2, "little")
        pkt += bytes([crc8(bytes(pkt))])
        assert len(pkt) == PACKET_BYTES
        out += pkt
        i += chunk
    return bytes(out)
