"""Byte transports for the LD06 ingest node: serial, TCP, UDP.

The reference vendors the ldrobot driver with two transport backends —
UART serial (`pi_hardware.launch.py:17-18`, /dev/ttyUSB0 @ 230400) and a
TCP/UDP network path (`network_socket_interface_linux.cpp`, SURVEY.md
§2.3) for lidars behind a serial-to-ethernet bridge. `Ld06IngestNode`
takes any zero-argument callable returning the freshest bytes; these are
the concrete implementations for real deployments, stdlib-only:

  * `SerialTransport` — a tty put into raw mode at 230400 baud via
    termios (no pyserial in this image, none needed: reading a configured
    tty is just os.read);
  * `TcpTransport` — client socket to a serial-device server, with
    bounded-backoff auto-reconnect (the lidar bridge may boot after us);
  * `UdpTransport` — bound datagram socket (the vendored driver's UDP
    server mode).

All are non-blocking: they return b"" when nothing is pending, so the
node's 100 Hz poll timer never stalls the executor, and all are safe to
`close()` from another thread. Tests drive them with ptys and localhost
sockets carrying `native.ld06.encode_packets` bytes — the same
spec-conformant stream real hardware produces.

Cross-process trace propagation (the freshness-SLO tier): the
reference system is distributed by construction — acquisition on the
Pi, fusion on the PC — and causal tracing stopped dead at this
socket. A NEW-protocol sender wraps its byte chunks in versioned
frames (`encode_frame`) whose header can carry a compact `TraceContext`
(trace_id / span_id / parent, 24 bytes big-endian); the receiving
`TcpTransport` auto-detects the protocol PER CONNECTION from the first
bytes (a legacy peer's raw LD06 stream never starts with the frame
magic — the Pi-side process may lag the PC-side on upgrade, absent
frames simply mean "legacy peer") and `FrameDecoder` strips headers,
handing the ingest node the payload byte stream plus the freshest
acquisition context to re-establish around its scan publish — so a
scan's fuse span parents back to its acquisition across the process
boundary. Robustness contract: a truncated or garbage frame header
DEGRADES to untraced delivery with a counter (`n_frame_errors`),
never a disconnect — the skipped bytes flow through raw and the LD06
parser's own checksum resync recovers; symmetrically, a framed stream
fed to a LEGACY receiver still parses (headers are small inter-packet
garbage the parser skips), so mismatched upgrades interop in both
directions. Framing is trace-plumbing only: with no Tracer armed the
contexts are decoded and dropped — bit-inert, the ObsConfig doctrine.
"""

from __future__ import annotations

import errno
import os
import random
import socket
import time
from typing import Optional

from jax_mapping_torch.obs.trace import TraceContext

#: Frame magic. First byte deliberately != 0x54 (the LD06 packet
#: header): a fresh connection's first bytes decide the protocol, and
#: a legacy LD06 stream can never open with this pair.
FRAME_MAGIC = b"\xa9\x4c"
FRAME_VERSION = 1
#: Header flags: bit0 = a 24-byte TraceContext follows the length.
_FLAG_CTX = 0x01
#: Sanity bound on a frame's payload length: a corrupted length field
#: must not make the decoder buffer unbounded garbage waiting for a
#: frame that never completes.
MAX_FRAME_PAYLOAD = 1 << 20
_BASE_HEADER = 8                      # magic(2) ver(1) flags(1) len(4)
_CTX_BYTES = 24


def encode_frame(payload: bytes,
                 ctx: Optional[TraceContext] = None) -> bytes:
    """One wire frame: header (+ optional trace context) + payload."""
    flags = _FLAG_CTX if ctx is not None else 0
    head = FRAME_MAGIC + bytes((FRAME_VERSION, flags)) \
        + len(payload).to_bytes(4, "little")
    if ctx is not None:
        head += ctx.trace_id.to_bytes(8, "big") \
            + ctx.span_id.to_bytes(8, "big") \
            + ctx.parent_span.to_bytes(8, "big")
    return head + payload


class FrameEncoder:
    """Sender-side helper (the Pi-side acquisition process): wraps each
    outgoing chunk in a frame, deriving one acquisition span per frame
    from the sender's Tracer when armed (ids are deterministic from the
    sender's seed — the stream-identity contract holds per process).
    `tracer=None` emits context-less frames (still versioned: the
    receiver knows it is talking to a new peer)."""

    def __init__(self, tracer=None, span_name: str = "ld06.acquire"):
        self.tracer = tracer
        self.span_name = span_name
        self.n_frames = 0

    def encode(self, payload: bytes) -> bytes:
        self.n_frames += 1
        ctx = None
        if self.tracer is not None:
            ctx = self.tracer.emit(self.span_name, key=self.n_frames)
        return encode_frame(payload, ctx)


class FrameDecoder:
    """Receiver-side stream deframer with legacy auto-detection.

    Modes: `unknown` (deciding on the connection's first bytes) →
    `framed` or `legacy`. Legacy mode is a pure passthrough — the
    pre-framing byte path bit-for-bit. Framed mode strips headers and
    records the freshest frame's TraceContext; any malformed header
    (bad magic mid-stream, wrong version, unknown flags, oversize
    length) counts an error, clears the context, and RESYNCS to the
    next magic while delivering the skipped bytes raw — degraded
    untraced delivery, never a protocol abort."""

    def __init__(self) -> None:
        self.reset()

    def reset(self) -> None:
        """Per-connection state: a reconnected peer renegotiates."""
        self.mode = "unknown"
        self._buf = bytearray()
        self.last_ctx: Optional[TraceContext] = None
        self.n_frames = 0
        self.n_traced_frames = 0
        self.n_frame_errors = 0

    def feed(self, data: bytes) -> bytes:
        """Consume raw socket bytes, return payload bytes (possibly
        b"": an incomplete frame waits in the buffer)."""
        if self.mode == "legacy":
            return data
        self._buf += data
        if self.mode == "unknown":
            if len(self._buf) >= 1 \
                    and self._buf[0] != FRAME_MAGIC[0]:
                self.mode = "legacy"
            elif len(self._buf) >= 2 \
                    and bytes(self._buf[:2]) != FRAME_MAGIC:
                self.mode = "legacy"
            elif len(self._buf) >= 2:
                self.mode = "framed"
            if self.mode == "legacy":
                out = bytes(self._buf)
                self._buf = bytearray()
                return out
            if self.mode == "unknown":
                return b""
        return self._parse_frames()

    def _parse_frames(self) -> bytes:
        out = bytearray()
        buf = self._buf
        while True:
            if len(buf) < 2:
                break
            if bytes(buf[:2]) != FRAME_MAGIC:
                # Garbage between frames: resync to the next magic and
                # deliver the skipped bytes raw (the LD06 parser's own
                # resync copes) — degraded, counted, never an abort.
                self.n_frame_errors += 1
                self.last_ctx = None
                idx = buf.find(FRAME_MAGIC, 1)
                if idx < 0:
                    # Keep the final byte: a magic pair may straddle
                    # this read and the next.
                    out += buf[:-1]
                    del buf[:-1]
                    break
                out += buf[:idx]
                del buf[:idx]
                continue
            if len(buf) < _BASE_HEADER:
                break
            ver, flags = buf[2], buf[3]
            length = int.from_bytes(bytes(buf[4:8]), "little")
            if ver != FRAME_VERSION or (flags & ~_FLAG_CTX) \
                    or length > MAX_FRAME_PAYLOAD:
                # Corrupted or future header: drop the magic pair and
                # rescan — its remains deliver raw via the branch above.
                self.n_frame_errors += 1
                self.last_ctx = None
                del buf[:2]
                continue
            header = _BASE_HEADER + (_CTX_BYTES if flags & _FLAG_CTX
                                     else 0)
            if len(buf) < header + length:
                break                          # incomplete: wait
            if flags & _FLAG_CTX:
                raw = bytes(buf[_BASE_HEADER:header])
                self.last_ctx = TraceContext(
                    int.from_bytes(raw[0:8], "big"),
                    int.from_bytes(raw[8:16], "big"),
                    int.from_bytes(raw[16:24], "big"))
                self.n_traced_frames += 1
            else:
                self.last_ctx = None
            out += buf[header:header + length]
            del buf[:header + length]
            self.n_frames += 1
        return bytes(out)

    def stats(self) -> dict:
        return {"mode": self.mode, "n_frames": self.n_frames,
                "n_traced_frames": self.n_traced_frames,
                "n_frame_errors": self.n_frame_errors}


class SerialTransport:
    """Raw-mode tty reader (the reference's UART path)."""

    def __init__(self, path: str, baud: int = 230400):
        import termios
        self.path = path
        self._fd = os.open(path, os.O_RDWR | os.O_NOCTTY | os.O_NONBLOCK)
        try:
            attrs = termios.tcgetattr(self._fd)
            # cfmakeraw semantics: no line discipline mangling the binary
            # packet stream.
            attrs[0] = 0                                   # iflag
            attrs[1] = 0                                   # oflag
            attrs[2] = termios.CS8 | termios.CREAD | termios.CLOCAL
            attrs[3] = 0                                   # lflag
            rate = getattr(termios, f"B{baud}", None)
            if rate is not None:
                attrs[4] = attrs[5] = rate                 # ispeed/ospeed
            termios.tcsetattr(self._fd, termios.TCSANOW, attrs)
        except termios.error:
            # Not a real tty (a pty pair or fifo in tests): raw bytes
            # flow regardless; baud only means something on real UARTs.
            pass

    def __call__(self) -> bytes:
        try:
            return os.read(self._fd, 4096)
        except BlockingIOError:
            return b""
        except OSError:
            return b""

    def close(self) -> None:
        try:
            os.close(self._fd)
        except OSError:
            pass


class TcpTransport:
    """Auto-reconnecting client to a lidar TCP server.

    Fully non-blocking, including the DIAL: connects via connect_ex on a
    non-blocking socket and completes the handshake across poll calls (a
    blocking create_connection would stall the shared executor up to its
    timeout every backoff window while the lidar bridge is down).
    Counters: `n_connects` counts every established connection;
    `n_reconnects` only those after a previous one existed (a healthy
    single-connection session reads 0).

    Backoff carries SEEDED jitter: each scheduled retry waits
    `backoff * (1 + jitter * rng())`. Without it, a fleet of clients
    that all lost the same lidar bridge redial in lockstep and hammer
    it the instant it returns (the thundering-herd reconnect the
    resilience subsystem's Supervisor backoff also avoids); the seed
    keeps chaos tests reproducible. `last_backoff_s` and the counters
    feed the ingest node's heartbeat payload.

    Trace-frame deframing (`framed=None`, the default): each
    connection auto-detects whether the peer speaks the versioned
    frame protocol (FrameDecoder) — a legacy raw-byte peer passes
    through bit-for-bit, a framing peer's headers are stripped and the
    freshest acquisition TraceContext is exposed via
    `trace_context()`. `framed=False` pins the pre-framing passthrough
    exactly (the behavior of a receiver that predates frames — the
    interop tests' "old PC-side" stand-in)."""

    def __init__(self, host: str, port: int,
                 reconnect_backoff_s: float = 0.5,
                 max_backoff_s: float = 5.0,
                 jitter: float = 0.25, seed: Optional[int] = None,
                 framed: Optional[bool] = None):
        self.host, self.port = host, port
        #: Per-connection deframer; None = the legacy receiver
        #: (framed=False), which never inspects the stream.
        self._decoder = FrameDecoder() if framed is not False else None
        self._sock: Optional[socket.socket] = None
        self._pending: Optional[socket.socket] = None
        self._backoff = reconnect_backoff_s
        self._backoff0 = reconnect_backoff_s
        self._max_backoff = max_backoff_s
        self._jitter = jitter
        self._rng = random.Random(seed)
        self._next_attempt = 0.0
        self.n_connects = 0
        self.n_reconnects = 0
        #: The jittered wait the most recent failure scheduled (0.0
        #: while connected) — exported in heartbeats.
        self.last_backoff_s = 0.0
        self._closed = False

    def _jittered(self, base_s: float) -> float:
        return base_s * (1.0 + self._jitter * self._rng.random())

    def _fail_attempt(self) -> None:
        if self._pending is not None:
            try:
                self._pending.close()
            except OSError:
                pass
            self._pending = None
        self.last_backoff_s = self._jittered(self._backoff)
        self._next_attempt = time.monotonic() + self.last_backoff_s
        self._backoff = min(self._backoff * 2, self._max_backoff)

    def _established(self, s: socket.socket) -> None:
        if self.n_connects > 0:
            self.n_reconnects += 1
        self.n_connects += 1
        self._sock = s
        self._pending = None
        self._backoff = self._backoff0
        self.last_backoff_s = 0.0
        if self._decoder is not None:
            # A new incarnation of the peer renegotiates the protocol
            # (the lidar bridge may have been upgraded/downgraded
            # across its reboot).
            self._decoder.reset()

    def trace_context(self) -> Optional[TraceContext]:
        """The freshest acquisition TraceContext decoded from the wire
        (None: legacy peer, context-less frames, or framing off) — the
        ingest node re-establishes it around its scan publish."""
        return None if self._decoder is None else self._decoder.last_ctx

    def stats(self) -> dict:
        """Heartbeat-payload export (ld06_node): reconnect pressure and
        the current backoff posture at a glance, plus the wire
        protocol's framing posture (mode + degraded-frame counter)."""
        out = {"connected": self._sock is not None,
               "n_connects": self.n_connects,
               "n_reconnects": self.n_reconnects,
               "backoff_s": round(self.last_backoff_s, 4)}
        if self._decoder is not None:
            out["framing"] = self._decoder.stats()
        return out

    def _connect_step(self) -> None:
        """Advance the non-blocking dial one step; never blocks."""
        import select
        now = time.monotonic()
        if self._closed:
            return
        if self._pending is None:
            if now < self._next_attempt:
                return
            s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            s.setblocking(False)
            rc = s.connect_ex((self.host, self.port))
            if rc == 0:
                self._established(s)
            elif rc in (errno.EINPROGRESS, errno.EWOULDBLOCK,
                        errno.EAGAIN):
                self._pending = s
            else:
                self._pending = s
                self._fail_attempt()
            return
        # Handshake in flight: writable == resolved (then check SO_ERROR).
        _, w, _ = select.select([], [self._pending], [], 0)
        if not w:
            return
        err = self._pending.getsockopt(socket.SOL_SOCKET, socket.SO_ERROR)
        if err == 0:
            self._established(self._pending)
        else:
            self._fail_attempt()

    def __call__(self) -> bytes:
        s = self._sock                       # snapshot: close() may race
        if s is None:
            self._connect_step()
            s = self._sock
            if s is None:
                return b""
        try:
            data = s.recv(4096)
        except BlockingIOError:
            return b""
        except OSError:
            data = b""
        if not data:
            # Peer closed (lidar bridge rebooted): drop and re-dial.
            try:
                s.close()
            except OSError:
                pass
            if self._sock is s:
                self._sock = None
            self.last_backoff_s = self._jittered(self._backoff0)
            self._next_attempt = time.monotonic() + self.last_backoff_s
            return b""
        if self._decoder is not None:
            return self._decoder.feed(data)
        return data

    def close(self) -> None:
        self._closed = True
        for s in (self._sock, self._pending):
            if s is not None:
                try:
                    s.close()
                except OSError:
                    pass
        self._sock = None
        self._pending = None


class UdpTransport:
    """Bound datagram receiver (the vendored driver's UDP mode)."""

    def __init__(self, bind_host: str = "0.0.0.0", bind_port: int = 8889):
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((bind_host, bind_port))
        self._sock.setblocking(False)
        self.port = self._sock.getsockname()[1]

    def __call__(self) -> bytes:
        out = b""
        # Drain every pending datagram: packets are 47 bytes and arrive
        # faster than the poll when the lidar bursts a rotation.
        while True:
            try:
                chunk, _addr = self._sock.recvfrom(4096)
            except BlockingIOError:
                break
            except OSError as e:
                if e.errno in (errno.EAGAIN, errno.EWOULDBLOCK):
                    break
                return out
            out += chunk
        return out

    def close(self) -> None:
        try:
            self._sock.close()
        except OSError:
            pass
