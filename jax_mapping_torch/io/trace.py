"""Trace record/replay: the framework's rosbag.

Copy of the JAX package's `io/trace.py` (it imports no JAX), on the
port's bus and messages, with the same file format: a bag written by
either package replays in the other. Golden-trace tests replay recorded
/scan + /odom through the mapper. `TraceRecorder` taps bus topics;
`TraceReplayer` re-publishes a saved trace in stamp order (fast-forward
or realtime), so a single recorded run becomes a deterministic regression
fixture, and a live run on hardware becomes a reproducible offline
dataset.

Format: one `.npz` — a JSON index of records (topic, stamp, message type,
scalar fields) plus each array field stored under `r<i>.<field>`. No pickle
anywhere (traces may come from untrusted robots).
"""

from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from jax_mapping_torch.bridge import messages as M
from jax_mapping_torch.bridge.bus import Bus
from jax_mapping_torch.bridge.qos import QoSProfile, Reliability

_INDEX_KEY = "__trace_index__"

#: Message types allowed in traces (no-pickle allowlist).
_TYPES = {
    "LaserScan": M.LaserScan,
    "Odometry": M.Odometry,
    "OccupancyGrid": M.OccupancyGrid,
    "TransformStamped": M.TransformStamped,
    "FrontierArray": M.FrontierArray,
    "DepthImage": M.DepthImage,
}


def _split_msg(msg: Any) -> tuple[Dict[str, Any], Dict[str, np.ndarray]]:
    """Dataclass -> (json-able scalars incl. nested, array fields)."""
    scalars: Dict[str, Any] = {}
    arrays: Dict[str, np.ndarray] = {}
    for f in dataclasses.fields(msg):
        v = getattr(msg, f.name)
        if isinstance(v, np.ndarray):
            arrays[f.name] = v
        elif dataclasses.is_dataclass(v):
            sub_s, sub_a = _split_msg(v)
            scalars[f.name] = {"__nested__": type(v).__name__, **sub_s}
            for k, a in sub_a.items():
                arrays[f"{f.name}.{k}"] = a
        else:
            scalars[f.name] = v
    return scalars, arrays


_NESTED_TYPES = {
    "Header": M.Header, "Pose2D": M.Pose2D, "Twist": M.Twist,
    "MapMetaData": M.MapMetaData,
}


def _join_msg(type_name: str, scalars: Dict[str, Any],
              arrays: Dict[str, np.ndarray]) -> Any:
    cls = _TYPES.get(type_name) or _NESTED_TYPES[type_name]
    kwargs: Dict[str, Any] = {}
    for f in dataclasses.fields(cls):
        if f.name in arrays:
            kwargs[f.name] = arrays[f.name]
        elif f.name in scalars:
            v = scalars[f.name]
            if isinstance(v, dict) and "__nested__" in v:
                sub = dict(v)
                sub_type = sub.pop("__nested__")
                sub_arrays = {
                    k[len(f.name) + 1:]: a for k, a in arrays.items()
                    if k.startswith(f.name + ".")}
                kwargs[f.name] = _join_msg(sub_type, sub, sub_arrays)
            else:
                kwargs[f.name] = v
    return cls(**kwargs)


class TraceRecorder:
    """Subscribe to `topics` and accumulate every sample, reliably (a bag
    must not drop; QoS depth is large and Reliable)."""

    def __init__(self, bus: Bus, topics: Sequence[str]):
        self.records: List[tuple[float, str, Any]] = []
        self._subs = []
        for topic in topics:
            self._subs.append(bus.subscribe(
                topic, QoSProfile(depth=100000,
                                  reliability=Reliability.RELIABLE),
                callback=lambda msg, t=topic: self._on(t, msg)))

    def _on(self, topic: str, msg: Any) -> None:
        stamp = getattr(getattr(msg, "header", None), "stamp", None)
        if stamp is None:
            stamp = time.monotonic()
        self.records.append((stamp, topic, msg))

    def stop(self) -> None:
        for s in self._subs:
            s.close()

    def save(self, path: str, config_json: Optional[str] = None) -> int:
        """Write the bag; returns the record count.

        config_json: optional SlamConfig.to_json() of the recording run,
        so replay tooling can detect config drift (shape-incompatible
        scans fused silently otherwise). Stored as a wrapper dict; bags
        written by older versions (bare list index) still load.
        """
        index = []
        arrays: Dict[str, np.ndarray] = {}
        for i, (stamp, topic, msg) in enumerate(
                sorted(self.records, key=lambda r: r[0])):
            type_name = type(msg).__name__
            if type_name not in _TYPES:
                raise TypeError(f"cannot record {type_name} on {topic}")
            scalars, arrs = _split_msg(msg)
            index.append({"stamp": stamp, "topic": topic,
                          "type": type_name, "scalars": scalars})
            for k, a in arrs.items():
                arrays[f"r{i}.{k}"] = a
        meta = {"records": index, "config": config_json, "version": 2}
        arrays[_INDEX_KEY] = np.frombuffer(
            json.dumps(meta).encode(), np.uint8)
        tmp = path + ".tmp"
        with open(tmp, "wb") as f:
            np.savez_compressed(f, **arrays)
        os.replace(tmp, path)
        return len(index)


class TraceReplayer:
    """Load a bag and re-publish it."""

    def __init__(self, path: str):
        self.path = path
        with np.load(path) as z:
            meta = json.loads(bytes(z[_INDEX_KEY].tobytes()).decode())
            if isinstance(meta, dict):              # v2 wrapper
                self.index = meta["records"]
                self.config_json: Optional[str] = meta.get("config")
            else:                                    # v1 bare list
                self.index = meta
                self.config_json = None
            self._arrays = {k: z[k] for k in z.files if k != _INDEX_KEY}

    def __len__(self) -> int:
        return len(self.index)

    def messages(self):
        """Yield (stamp, topic, message) in stamp order."""
        for i, rec in enumerate(self.index):
            prefix = f"r{i}."
            arrays = {k[len(prefix):]: a for k, a in self._arrays.items()
                      if k.startswith(prefix)}
            yield rec["stamp"], rec["topic"], _join_msg(
                rec["type"], rec["scalars"], arrays)

    def replay(self, bus: Bus, speed: Optional[float] = None,
               topic_map: Optional[Dict[str, str]] = None) -> int:
        """Publish every record. speed=None: as fast as possible;
        speed=1.0: original timing (relative stamps). Returns count."""
        pubs: Dict[str, Any] = {}
        t0: Optional[float] = None
        wall0 = time.monotonic()
        n = 0
        for stamp, topic, msg in self.messages():
            topic = (topic_map or {}).get(topic, topic)
            if speed is not None:
                if t0 is None:
                    t0 = stamp
                due = wall0 + (stamp - t0) / speed
                delay = due - time.monotonic()
                if delay > 0:
                    time.sleep(delay)
            if topic not in pubs:
                pubs[topic] = bus.publisher(topic)
            pubs[topic].publish(msg)
            n += 1
        return n
