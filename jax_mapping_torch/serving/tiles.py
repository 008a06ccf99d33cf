"""Revision-keyed tile store with a quadtree overview pyramid.

Port of the JAX package's `serving/tiles.py`. One `TileStore` serves one
2D uint8 image surface (the thresholded occupancy gray of the fleet's
shared grid, or the voxel mapper's height map) as fixed-size PNG tiles
at pyramid levels 0..L (level k is 2^k x coarser). The store is
PULL-based: `refresh()` snapshots the provider, builds the pyramid and
hashes every tile where the provider's image lies (`ops/grid.to_gray`,
`downsample_gray`, `tile_hashes`), copies only the hashes to the host
(one small copy a refresh), and re-encodes only tiles whose 64-bit
content hash changed. A level's image crosses to the host only when one
of its tiles changed, and then once: the steady-state serving cost is
proportional to what the mapper actually touched, not to the map size.

Delta protocol: every re-encoded tile is stamped with the map revision
it changed at; `tiles_since(r)` returns exactly the tiles stamped
newer than `r`. A client that applies an initial `since=-1` snapshot
plus every delta reconstructs the live image bit for bit.

Consistency: tile bytes, per-tile stamps, and the store revision are
installed atomically under `_lock`, so a reader can never observe a
tile whose bytes are older than its stamp. `_refresh_lock`
single-flights the encode work; readers only wait on the brief
install/read critical sections.

Device work runs on the handler thread that refreshes, on the default
stream the mapper's tick thread also launches on: the mapper never
writes into a grid it has handed out (every fuse, re-fuse, decay, shift
and restore installs a new tensor), so the snapshot the refresh reads
stays the revision it was taken at.
"""

from __future__ import annotations

import base64
import threading
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from jax_mapping_torch.bridge import png as png_codec
from jax_mapping_torch.config import ServingConfig
from jax_mapping_torch.utils import global_metrics as M


def _downsample_max_u8(img: torch.Tensor) -> torch.Tensor:
    """2x block max for continuous-gray surfaces (voxel height maps:
    taller top surface wins, 0 = unmapped loses)."""
    n0, n1 = img.shape
    return img.reshape(n0 // 2, 2, n1 // 2, 2).amax(dim=(1, 3))


class TileStore:
    """Tile cache over one image provider.

    `snapshot_fn() -> (revision, image, dirty_hint)`: `revision` is the
    provider's monotonic content revision; `image` is the full-res 2D
    uint8 tensor (on any device) or numpy array in GRID orientation;
    `dirty_hint` is an optional (T, T) bool mask of level-0 tiles the
    producer marked touched since the last snapshot (the mapper's
    patch-extent marks), a conservative superset used for telemetry
    (`n_hint_missed` counts hash-detected changes the hint failed to
    cover; it should stay 0). The hash diff, not the hint, decides what
    re-encodes. A windowed provider returns a 4th element, the (T, T)
    bool mask of level-0 tiles evicted from the live window.

    `revision_fn()` is the cheap freshness peek (no image work). A
    tensor image is hashed where it lies, a numpy image on the CPU.
    """

    def __init__(self, cfg: ServingConfig, name: str,
                 revision_fn: Callable[[], int],
                 snapshot_fn: Callable[[], Tuple],
                 downsample_fn: Optional[Callable] = None,
                 meta: Optional[dict] = None,
                 on_install: Optional[Callable[[int], None]] = None):
        self.cfg = cfg
        self.name = name
        self._revision_fn = revision_fn
        self._snapshot_fn = snapshot_fn
        self._downsample_fn = downsample_fn
        #: Telemetry hook called with the committed store revision after
        #: each refresh that re-installed; invoked outside both store
        #: locks, and its failures never break serving.
        self._on_install = on_install
        self.meta = dict(meta or {})
        self._lock = threading.Lock()
        self._refresh_lock = threading.Lock()
        #: (level, ty, tx) -> (revision_changed_at, png_bytes)
        self._tiles: Dict[Tuple[int, int, int], Tuple[int, bytes]] = {}
        #: per-level (T, T, 2) uint32 hash arrays from the last refresh.
        self._hashes: List[np.ndarray] = []
        self.revision = -1          # provider revisions start at 0
        self.n_refreshes = 0
        self.n_tiles_encoded = 0
        self.n_tiles_clean_skipped = 0
        self.n_hint_missed = 0
        self._level_sizes: Optional[List[int]] = None
        #: Bounded-memory serving (world/store.py): level-0 tiles the
        #: window evicted carry a typed `evicted` marker in the delta
        #: stream instead of PNG bytes, (ty, tx) -> revision stamped at
        #: eviction. `evicted_epoch` counts eviction-state transitions
        #: (the /tiles ETag `-w` suffix, so a cache validator can never
        #: 304 across an eviction flip).
        self._evicted_stamps: Dict[Tuple[int, int], int] = {}
        self._evicted_mask: Optional[np.ndarray] = None
        self.evicted_epoch = 0
        self.n_tiles_evicted_served = 0

    # -- geometry ------------------------------------------------------------

    def _levels_for(self, size: int) -> List[int]:
        """Pyramid level edge sizes: full-res first, each next level 2x
        coarser, stopping at the configured depth or when a level would
        shrink below one tile or stop dividing evenly."""
        t = self.cfg.tile_cells
        if size % t:
            raise ValueError(
                f"{self.name}: image edge {size} not divisible by "
                f"ServingConfig.tile_cells={t}")
        sizes = [size]
        while (len(sizes) < self.cfg.pyramid_levels
               and sizes[-1] // 2 >= t and (sizes[-1] // 2) % t == 0):
            sizes.append(sizes[-1] // 2)
        return sizes

    # -- refresh -------------------------------------------------------------

    def refresh(self) -> int:
        """Bring the cache up to the provider's revision; returns the
        store revision afterwards. Cheap when already fresh (one
        revision peek). Single-flighted: concurrent callers serialize on
        `_refresh_lock`, each re-checking freshness on entry."""
        with self._refresh_lock:
            rev = int(self._revision_fn())
            with self._lock:
                if rev == self.revision:
                    return self.revision
            # The serving-snapshot latency stage: the provider snapshot
            # and the hash/diff/re-encode, the cost a /tiles poller pays
            # when the map moved.
            with M.stages.stage("serving.snapshot"):
                snap = self._snapshot_fn()
                if len(snap) == 4:
                    rev, image, hint, evicted = snap
                else:
                    rev, image, hint = snap
                    evicted = None
                rev = int(rev)
                self._install(rev, image, hint, evicted)
        if self._on_install is not None:
            try:
                self._on_install(rev)
            except Exception:                     # noqa: BLE001
                pass                              # telemetry only
        return rev

    def _pyramid(self, image) -> Tuple[List[torch.Tensor], List[int]]:
        """The level images where `image` lies, full-res first."""
        img = image if torch.is_tensor(image) else torch.as_tensor(
            np.ascontiguousarray(image))
        if img.dim() != 2 or img.shape[0] != img.shape[1]:
            # The pyramid, manifest meta and client mosaics are all
            # square-edged; a rectangular provider is rejected loudly.
            raise ValueError(
                f"{self.name}: tile serving needs a square image, got "
                f"{tuple(img.shape)}")
        sizes = self._levels_for(int(img.shape[0]))
        from jax_mapping_torch.ops import grid as G
        down = self._downsample_fn or G.downsample_gray
        imgs = [img]
        for _ in sizes[1:]:
            imgs.append(down(imgs[-1]))
        return imgs, sizes

    def _level_hashes(self, imgs: List[torch.Tensor]) -> List[np.ndarray]:
        """Per-level (T, T, 2) uint32 tile hashes, computed where the
        images lie; the levels' hashes cross to the host in one copy."""
        from jax_mapping_torch.ops import grid as G
        t = self.cfg.tile_cells
        hs = [G.tile_hashes(im, t) for im in imgs]
        flat = torch.cat([h.reshape(-1) for h in hs]).cpu().numpy()
        out, k = [], 0
        for h in hs:
            n = h.numel()
            out.append(flat[k:k + n].astype(np.uint32).reshape(h.shape))
            k += n
        return out

    def _install(self, rev: int, image, hint: Optional[np.ndarray],
                 evicted: Optional[np.ndarray] = None) -> None:
        """Hash, diff, and re-encode under `_refresh_lock`; commit
        atomically under `_lock`. Caller holds `_refresh_lock`."""
        t = self.cfg.tile_cells
        imgs, sizes = self._pyramid(image)
        hashes = self._level_hashes(imgs)

        first = not self._hashes
        encoded: Dict[Tuple[int, int, int], Tuple[int, bytes]] = {}
        n_clean = 0
        hint_missed = 0
        for lvl, (im, h) in enumerate(zip(imgs, hashes)):
            if first:
                changed = np.ones(h.shape[:2], bool)
            else:
                changed = np.any(h != self._hashes[lvl], axis=-1)
            if lvl == 0 and hint is not None and not first:
                hint_missed += int(np.count_nonzero(changed & ~hint))
            if lvl == 0 and evicted is not None:
                # Evicted level-0 tiles serve a typed marker, never
                # bytes: the commit below stamps them. (The mosaic paints
                # them unknown, so the hash still tracks content, and
                # re-entry re-encodes normally.)
                changed = changed & ~evicted
            n_clean += int(changed.size - np.count_nonzero(changed))
            if not changed.any():
                continue
            host = im.cpu().numpy()    # fetch this level once, then slice
            for ty, tx in np.argwhere(changed):
                tile = host[ty * t:(ty + 1) * t, tx * t:(tx + 1) * t]
                encoded[(lvl, int(ty), int(tx))] = (rev, png_codec.encode_gray(
                    tile, compress_level=self.cfg.png_compress_level))

        with self._lock:
            self._tiles.update(encoded)
            if evicted is not None:
                prev = self._evicted_mask
                for ty, tx in np.argwhere(evicted):
                    key = (int(ty), int(tx))
                    if prev is None or not prev[key]:
                        # Newly evicted: drop the cached bytes so a full
                        # resync can never serve a tile the window no
                        # longer backs; stamp the marker at THIS rev.
                        self._tiles.pop((0,) + key, None)
                        self._evicted_stamps[key] = rev
                        self.evicted_epoch += 1
                if prev is not None:
                    for ty, tx in np.argwhere(prev & ~evicted):
                        self._evicted_stamps.pop((int(ty), int(tx)), None)
                        self.evicted_epoch += 1
                self._evicted_mask = evicted.copy()
            self._hashes = hashes
            self._level_sizes = sizes
            self.revision = rev
            self.n_refreshes += 1
            self.n_tiles_encoded += len(encoded)
            self.n_tiles_clean_skipped += n_clean
            self.n_hint_missed += hint_missed

    # -- serving -------------------------------------------------------------

    def tiles_since(self, since: int, level: Optional[int] = None
                    ) -> Tuple[int, List[dict], dict]:
        """(revision, tile entries stamped newer than `since`, manifest
        meta). Entries carry base64 PNG bytes ready for the JSON route;
        `since=-1` is the full snapshot."""
        with self._lock:
            rev = self.revision
            sizes = list(self._level_sizes or [])
            entries = [
                {"level": lvl, "ty": ty, "tx": tx, "revision": tile_rev,
                 "png": base64.b64encode(data).decode("ascii")}
                for (lvl, ty, tx), (tile_rev, data)
                in sorted(self._tiles.items())
                if tile_rev > since and (level is None or lvl == level)]
            evicted_entries = [
                {"level": 0, "ty": ty, "tx": tx, "revision": tile_rev,
                 "evicted": True}
                for (ty, tx), tile_rev in sorted(self._evicted_stamps.items())
                if tile_rev > since and (level is None or level == 0)]
            self.n_tiles_evicted_served += len(evicted_entries)
            entries.extend(evicted_entries)
            n_evicted = len(self._evicted_stamps)
        meta = dict(self.meta)
        meta.update({
            "map": self.name,
            "tile_cells": self.cfg.tile_cells,
            "levels": [{"level": i, "size_cells": s}
                       for i, s in enumerate(sizes)],
        })
        if n_evicted or self._evicted_mask is not None:
            meta["evicted_tiles"] = n_evicted
        return rev, entries, meta

    def stats(self) -> dict:
        with self._lock:
            return {
                "revision": self.revision,
                "n_refreshes": self.n_refreshes,
                "n_tiles_encoded": self.n_tiles_encoded,
                "n_tiles_clean_skipped": self.n_tiles_clean_skipped,
                "n_hint_missed": self.n_hint_missed,
                "n_tiles_cached": len(self._tiles),
                "n_tiles_evicted": len(self._evicted_stamps),
                "evicted_epoch": self.evicted_epoch,
            }


class MapServing:
    """The bundle the HTTP plane mounts: tile stores + event channel.

    Built by `MapApiServer` when the attached mapper's config has
    `serving.enabled`; the mapper's tick thread calls
    `on_map_revision(rev)` (a revision listener, invoked outside the
    mapper's state lock) and the channel fans it out to every
    `/map-events` client queue."""

    def __init__(self, cfg: ServingConfig, mapper=None, voxel_mapper=None,
                 events=None, pipeline=None):
        from jax_mapping_torch.serving.events import EventChannel
        self.cfg = cfg
        #: Pipeline latency ledger (obs/pipeline.py) or None: the grid
        #: store's commits stamp its tile-re-encoded waypoint.
        self.pipeline = pipeline
        #: Carried over a mapper restart (http_api.rebind_mapper), so
        #: connected /map-events clients keep their streams.
        self.events = events if events is not None \
            else EventChannel(cfg.event_queue_depth)
        self.mapper = mapper
        self.map_store: Optional[TileStore] = None
        self.voxel_store: Optional[TileStore] = None
        if mapper is not None:
            # LOGICAL geometry for the manifest: windowed, the served
            # surface is the full addressable lattice (window content in
            # place, evicted tiles as typed markers), so clients keep one
            # fixed world-anchored mosaic however the window moves.
            g = getattr(mapper, "full_cfg", mapper.cfg).grid
            world = getattr(mapper, "world", None)

            def _map_snapshot():
                from jax_mapping_torch.ops import grid as G
                rev, grid, hint = mapper.serving_snapshot()
                if world is None:
                    return rev, G.to_gray(g, grid), hint
                # Compose outside the mapper's state lock, then verify
                # no shift landed mid-compose: every shift/rehydrate
                # bumps the revision, so rev-stability proves the grid
                # and the window origin/away-set belong together.
                for _ in range(4):
                    mosaic, evicted = world.compose_serving(
                        G.to_gray(g, grid))
                    if mapper.serving_revision() == rev:
                        break
                    rev, grid, hint2 = mapper.serving_snapshot()
                    if hint2 is not None:
                        hint = hint2 if hint is None else (hint | hint2)
                return rev, mosaic, hint, evicted

            self.map_store = TileStore(
                cfg, "grid", mapper.serving_revision, _map_snapshot,
                meta={"resolution_m": g.resolution_m,
                      "origin_m": list(g.origin_m),
                      "size_cells": g.size_cells,
                      "orientation": "grid-row0-min-y"},
                on_install=(None if pipeline is None
                            else pipeline.encoded))
        if voxel_mapper is not None and \
                self._voxel_servable(cfg, voxel_mapper.cfg.voxel):
            v = voxel_mapper.cfg.voxel

            def _voxel_snapshot():
                rev, img = voxel_mapper.serving_snapshot()
                return rev, torch.as_tensor(
                    img, device=voxel_mapper.device), None

            self.voxel_store = TileStore(
                cfg, "voxel-height", voxel_mapper.serving_revision,
                _voxel_snapshot, downsample_fn=_downsample_max_u8,
                meta={"resolution_m": v.resolution_m,
                      "origin_m": list(v.origin_m[:2]),
                      "size_cells": v.size_x_cells,
                      "orientation": "grid-row0-min-y",
                      "palette": "height-ramp"})

    @staticmethod
    def _voxel_servable(cfg: ServingConfig, voxel) -> bool:
        """Tile geometry fits the voxel height map? The store needs a
        square, tile-divisible image; a stack running a rectangular or
        odd-sized voxel grid keeps working, with /voxel-tiles answering
        404 (no store) instead of 500ing on every request."""
        return (voxel.size_x_cells == voxel.size_y_cells
                and voxel.size_x_cells % cfg.tile_cells == 0)

    def on_map_revision(self, rev: int) -> None:
        """Mapper revision listener, called on the tick thread outside
        every mapper lock; fans a small event to the bounded per-client
        queues."""
        self.events.emit({"map": "grid", "revision": int(rev)})

    def epoch(self, source: str) -> int:
        """The serving restart epoch stamped into /tiles responses: the
        grid surface follows the mapper's `restart_epoch` (bumped on the
        replacement node of a restart); other surfaces stay at 0.
        Clients treat an epoch advance as 'drop cache, resync full'."""
        if source == "grid" and self.mapper is not None:
            return int(getattr(self.mapper, "restart_epoch", 0))
        return 0

    def store(self, source: str) -> Optional[TileStore]:
        return self.map_store if source == "grid" else \
            self.voxel_store if source == "voxel-height" else None

    def stats(self) -> dict:
        out = {
            "events": {
                "n_events": self.events.n_events,
                "n_clients": self.events.n_clients(),
                "n_clients_peak": self.events.n_clients_peak,
                "n_dropped": self.events.n_dropped_total(),
            }
        }
        if self.map_store is not None:
            out["grid"] = self.map_store.stats()
        if self.voxel_store is not None:
            out["voxel"] = self.voxel_store.stats()
        return out
