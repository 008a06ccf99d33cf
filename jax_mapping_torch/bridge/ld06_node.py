"""LD06 ingest node: wire bytes -> `sensor_msgs/LaserScan` on the bus.

The role of the reference driver's ROS node TU (`demo.cpp` in SURVEY.md
§2.3: param handling, LaserScan assembly/publish) on top of the native C++
parse/filter pipeline (`native.ld06`). A transport callable supplies bytes —
a serial port read, a TCP socket, a recorded dump, or the simulator's
`encode_packets` output — so the identical node runs against hardware and
sim. Publishes Best-Effort like the reference's `/scan` (report.pdf §V.A).
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np

from jax_mapping_torch.bridge.bus import Bus
from jax_mapping_torch.bridge.messages import Header, LaserScan
from jax_mapping_torch.bridge.node import Node
from jax_mapping_torch.bridge.qos import qos_sensor_data
from jax_mapping_torch.bridge.tf import TfTree
from jax_mapping_torch.config import ScanConfig


class Ld06IngestNode(Node):
    """Poll a byte transport, publish complete rotations."""

    def __init__(self, scan_cfg: ScanConfig, bus: Bus,
                 transport: Callable[[], bytes],
                 topic: str = "scan", frame_id: str = "base_laser",
                 tf: Optional[TfTree] = None,
                 poll_period_s: float = 0.01, realtime: bool = True,
                 min_confidence: int = 15, band_m: float = 0.15):
        super().__init__("ld06_ingest", bus, tf)
        from jax_mapping_torch.native import Ld06Parser

        self.scan_cfg = scan_cfg
        self.transport = transport
        self.frame_id = frame_id
        self.parser = Ld06Parser(n_beams=scan_cfg.n_beams,
                                 min_confidence=min_confidence,
                                 band_m=band_m)
        self.pub = self.create_publisher(topic, qos_sensor_data)
        self.n_scans_published = 0
        #: Scans published under a cross-process acquisition context
        #: (the transport decoded a trace frame): the wire context is
        #: made CURRENT around the publish, so the bus derives the
        #: publish's TraceContext as a CHILD of the remote acquisition
        #: span — a fused scan's span chain crosses the process
        #: boundary back to the Pi-side acquisition. Attribution is
        #: per-poll (the freshest frame's context covers the rotations
        #: completed by that poll's bytes — frames outpace rotations,
        #: so the approximation is one frame at most).
        self.n_traced_publishes = 0
        # Heartbeat for the Supervisor; the payload surfaces the
        # transport's reconnect pressure (TcpTransport.stats: counters +
        # current jittered backoff) so an operator sees a flapping lidar
        # bridge on /status without shelling into the pi.
        from jax_mapping_torch.resilience.supervisor import Heartbeater
        self._heartbeater = Heartbeater(self)
        if realtime:
            self.create_timer(poll_period_s, self.poll)

    def poll(self) -> None:
        """Drain the transport, publish any completed rotations."""
        data = self.transport()
        if data:
            self.parser.feed(data)
        # Cross-process trace propagation: a framing transport exposes
        # the freshest acquisition TraceContext decoded from the wire;
        # with a tracer armed, the scan publish runs under it so the
        # bus chains the publish as a child of the REMOTE acquisition
        # span (absent either — legacy peer, tracing off — the publish
        # roots locally, the pre-frames behavior exactly).
        tracer = getattr(self.bus, "tracer", None)
        wire_ctx = None
        if tracer is not None:
            ctx_fn = getattr(self.transport, "trace_context", None)
            if callable(ctx_fn):
                wire_ctx = ctx_fn()
        while True:
            out = self.parser.take_scan()
            if out is None:
                break
            ranges, intensities = out
            sc = self.scan_cfg
            msg = LaserScan(
                header=Header(stamp=time.monotonic(),
                              frame_id=self.frame_id),
                angle_min=sc.angle_min_rad,
                angle_increment=sc.angle_increment_rad,
                scan_time=(360.0 / self.parser.speed_deg_s
                           if self.parser.speed_deg_s > 0 else 0.1),
                range_min=sc.range_min_m,
                range_max=sc.range_max_m,
                ranges=np.asarray(ranges, np.float32),
                intensities=np.asarray(intensities, np.float32))
            if wire_ctx is not None:
                with tracer.use(wire_ctx):
                    self.pub.publish(msg)
                self.n_traced_publishes += 1
            else:
                self.pub.publish(msg)
            self.n_scans_published += 1
        payload = {"scans_published": self.n_scans_published}
        stats = getattr(self.transport, "stats", None)
        if callable(stats):
            payload["transport"] = stats()
        self._heartbeater.beat(payload)
