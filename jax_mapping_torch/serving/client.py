"""Reference delta-map client: snapshot + tile deltas -> local mosaic.

A copy of the JAX package's `serving/client.py` on the port's PNG codec;
the wire format is the same, so either package's client reads either
package's server.

The consumer half of the tile protocol, used by the serving load
generator and the delta-correctness tests: polls `GET /tiles?since=R`,
applies the returned tiles to per-level host mosaics, and ENFORCES the
protocol's safety properties — the server's revision never goes
backwards, and no returned tile is stamped at or before the client's
`since` (a stale tile or a revision regression raises, which is exactly
what the concurrent hammer test leans on).
"""

from __future__ import annotations

import base64
import json
import re
import urllib.request
from typing import Dict, List, Optional

import numpy as np

from jax_mapping_torch.bridge import png as png_codec

#: `Server-Timing: rev;desc="42", age;dur=12.3` — the revision-age
#: entry's duration, milliseconds (the serving tier's freshness
#: stamp: a SERVER monotonic delta since the served revision's
#: install, so the client measures observed staleness without
#: trusting any cross-host wall clock).
_AGE_RE = re.compile(r"\bage;dur=([0-9.]+)")


def parse_revision_age_ms(server_timing: Optional[str]
                          ) -> Optional[float]:
    """The `age;dur=` milliseconds of a Server-Timing header value,
    or None (absent header, no age entry, malformed)."""
    if not server_timing:
        return None
    m = _AGE_RE.search(server_timing)
    if m is None:
        return None
    try:
        return float(m.group(1))
    except ValueError:
        return None


class RevisionRegression(AssertionError):
    """The server violated revision monotonicity for this client."""


class TenantGone(RuntimeError):
    """A tenant route answered 404: the tenant was evicted (or never
    existed) — mission CHURN, not server breakage. Loadgen and
    operators branch on this instead of a generic HTTPError; the
    server's error body rides along as `.detail`."""

    def __init__(self, route: str, detail: str = ""):
        super().__init__(
            f"tenant route {route} is gone"
            + (f": {detail}" if detail else ""))
        self.route = route
        self.detail = detail


class DeltaMapClient:
    """Polls one tile route and maintains the reconstructed mosaics."""

    def __init__(self, base_url: str, route: str = "/tiles",
                 timeout_s: float = 10.0):
        self.base_url = base_url.rstrip("/")
        self.route = route
        self.timeout_s = timeout_s
        self.revision = -1            # pre-snapshot: everything is new
        self.meta: dict = {}
        #: level -> (size, size) uint8 mosaic (unknown-127 before the
        #: first covering tile arrives; the first poll covers all).
        self.mosaics: Dict[int, np.ndarray] = {}
        #: Server restart epoch (None until the first response): a
        #: supervisor restart-resume legitimately re-serves an OLDER
        #: revision under a bumped epoch — the client drops its cache
        #: and resyncs full instead of raising RevisionRegression.
        self.epoch: Optional[int] = None
        self.n_polls = 0
        self.n_not_modified = 0
        self.n_tiles_applied = 0
        self.n_tiles_pruned = 0       # evicted-marker prunes (windowed)
        self.n_epoch_resyncs = 0
        self.bytes_received = 0
        self.snapshot_bytes = 0       # first (full) poll's body size
        self._etag: Optional[str] = None
        #: Client-observed staleness (the freshness-SLO tier): the
        #: served revision's age per response, from the Server-Timing
        #: header (server monotonic deltas — no clock trust). None
        #: until a header arrives; the bounded history feeds loadgen's
        #: revision-age percentiles.
        self.last_revision_age_ms: Optional[float] = None
        self.revision_ages_ms: List[float] = []
        self._age_history_cap = 4096
        #: The body's status stamp from the last 200 ("warming" /
        #: "quarantined" / None for steady state) — a quarantined
        #: tenant keeps serving its frozen last-good revision, and
        #: this is how a client tells frozen-by-design from stalled.
        self.state: Optional[str] = None

    # -- protocol ------------------------------------------------------------

    def poll(self, level: Optional[int] = None) -> dict:
        """One delta round trip; returns the decoded response body.

        Replays the server's ETag as `If-None-Match`: a client that is
        already at the live revision pays a body-less 304, not even the
        empty-manifest JSON."""
        # Routes may carry their own query (the per-tenant namespace:
        # route="/tiles?tenant=m0"); extend it instead of double-"?".
        sep = "&" if "?" in self.route else "?"
        url = f"{self.base_url}{self.route}{sep}since={self.revision}"
        if level is not None:
            url += f"&level={level}"
        req = urllib.request.Request(url)
        if self._etag:
            req.add_header("If-None-Match", self._etag)
        try:
            with urllib.request.urlopen(req,
                                        timeout=self.timeout_s) as r:
                raw = r.read()
                self._etag = r.headers.get("ETag") or self._etag
                self._note_age(r.headers.get("Server-Timing"))
        except urllib.error.HTTPError as e:
            if e.code == 404 and "tenant=" in self.route:
                # Tenant churn, typed: an evicted/unknown tenant's 404
                # must read as TenantGone, not generic breakage.
                try:
                    detail = json.loads(e.read() or b"{}").get(
                        "error", "")
                except (ValueError, OSError):
                    detail = ""
                raise TenantGone(self.route, detail) from e
            if e.code != 304:
                raise
            e.read()
            # A 304 confirms freshness like a body does — the age
            # header rides it, and the client's staleness series must
            # include its already-current polls.
            self._note_age(e.headers.get("Server-Timing"))
            self.n_polls += 1
            self.n_not_modified += 1
            return {"revision": self.revision, "since": self.revision,
                    "tiles": [], "not_modified": True}
        body = json.loads(raw)
        first = self.n_polls == 0
        self.n_polls += 1
        self.bytes_received += len(raw)
        if first:
            self.snapshot_bytes = len(raw)
        self.state = body.get("state")
        if self._note_epoch(body):
            # Restart epoch advanced: this body is a delta against a
            # serving generation we no longer share. Cache dropped;
            # refetch the full snapshot under the new epoch (the reset
            # put since back to -1, so this recursion terminates).
            return self.poll(level)
        self.apply(body)
        return body

    def _note_age(self, server_timing: Optional[str]) -> None:
        age = parse_revision_age_ms(server_timing)
        if age is None:
            return
        self.last_revision_age_ms = age
        self.revision_ages_ms.append(age)
        del self.revision_ages_ms[:-self._age_history_cap]

    def _note_epoch(self, body: dict) -> bool:
        """Track the server's restart epoch; on an advance, drop every
        cached artifact (mosaics, revision, ETag) and report True —
        the caller must resync full. The mapper restart-resume case:
        revision regression under a NEW epoch is protocol-legal."""
        ep = int(body.get("epoch", 0))
        if self.epoch is None:
            self.epoch = ep
            return False
        if ep == self.epoch:
            return False
        self.epoch = ep
        self.revision = -1
        self.mosaics = {}
        self.meta = {}
        self._etag = None
        self.n_epoch_resyncs += 1
        return True

    def apply(self, body: dict) -> None:
        """Apply one /tiles response; raises on any staleness. Epoch
        handling lives in poll(); direct apply() callers are expected
        to feed one epoch's bodies."""
        rev = int(body["revision"])
        if rev < self.revision:
            raise RevisionRegression(
                f"server revision went backwards: {self.revision} -> {rev}")
        since = int(body.get("since", self.revision))
        self.meta = {k: v for k, v in body.items() if k != "tiles"}
        t = int(body["tile_cells"])
        sizes = {lv["level"]: lv["size_cells"] for lv in body["levels"]}
        for tile in body["tiles"]:
            tile_rev = int(tile["revision"])
            if tile_rev <= since:
                raise RevisionRegression(
                    f"tile {tile['level']}/{tile['ty']}/{tile['tx']} "
                    f"stamped {tile_rev} <= since={since}: stale serve")
            lvl = int(tile["level"])
            if lvl not in self.mosaics:
                self.mosaics[lvl] = np.full(
                    (sizes[lvl], sizes[lvl]), 127, np.uint8)
            ty, tx = int(tile["ty"]), int(tile["tx"])
            if tile.get("evicted"):
                # Typed tile-evicted marker (the bounded-memory world):
                # the window no longer backs this tile — prune it to
                # unknown instead of treating the byteless entry as a
                # protocol violation. Re-entry re-serves real bytes.
                self.mosaics[lvl][ty * t:(ty + 1) * t,
                                  tx * t:(tx + 1) * t] = 127
                self.n_tiles_pruned += 1
                continue
            arr = png_codec.decode_gray(
                base64.b64decode(tile["png"]))
            self.mosaics[lvl][ty * t:(ty + 1) * t,
                              tx * t:(tx + 1) * t] = arr
            self.n_tiles_applied += 1
        self.revision = rev

    def image(self, level: int = 0) -> np.ndarray:
        """The reconstructed mosaic at a pyramid level (grid
        orientation; `np.flipud` for display coordinates)."""
        return self.mosaics[level]
