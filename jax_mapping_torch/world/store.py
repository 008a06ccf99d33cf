"""Robocentric sliding-window world store (the bounded-memory contract).

Port of the JAX package's `world/store.py`. `grid.size_cells` is the
LOGICAL world extent (it allocates nothing); the device holds a fixed
`window_tiles^2` window of the tile lattice that shifts with the fleet,
so device bytes do not grow with distance travelled.

Frames. The mapper runs all of its device machinery on the window-sized
`SlamConfig` of `window_slam_config`; poses live in the robocentric
WINDOW frame and `offset_xy()` maps window -> world (`world = window +
offset`). The offset starts at exactly zero (the initial window is
centred on the logical origin) and advances by whole tiles.

A shift rolls the device window and re-zeros the entering band
(`shift_window`, one new tensor: the mapper's states alias one grid, so
grids are values, never edited in place). The leaving band comes to the
host in ONE copy and is split there in the JAX package's tile order, so
admissions, the schedule log and the generation stamps are the same as
the reference's. Leaving tiles land in a host LRU under the
`MemoryGovernor`'s ladder and spill to disk with CRC and generation
stamps (`world/spill.py`). Re-entry rehydrates: a host hit is scattered
into the window at once; a disk hit starts a prefetch thread that
`poll_prefetch` joins at the NEXT tick (a deterministic one-tick
unknown-degrade whatever the IO timing); a corrupt spill degrades the
tile to unknown with a flight event, never an exception.

`fuse_scan_global` is the store-level fusion the oracle tests drive:
the inverse sensor model (`ops.sensor_kernel.scan_deltas`: K1 on a CUDA
tensor, the plain `classify_patch` on the CPU) classifies at the GLOBAL
patch origin and the clip-add lands at the window-local one, so the
window equals a big-grid run of the same scans cell for cell.

Every transition appends to a bounded `schedule` log: two same-seed
drives produce equal logs.
"""

from __future__ import annotations

import dataclasses
import threading
from collections import OrderedDict
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from jax_mapping_torch.config import SlamConfig
from jax_mapping_torch.obs.recorder import flight_recorder
from jax_mapping_torch.utils import global_metrics as M
from jax_mapping_torch.world.governor import MemoryGovernor
from jax_mapping_torch.world.spill import SpillStore

Tile = Tuple[int, int]

#: Schedule-log bound: a soak's full eviction history fits (the
#: determinism tests compare complete logs); the counter counts past it.
_SCHEDULE_CAP = 65536


# ---------------------------------------------------------------------------
# Window primitives
# ---------------------------------------------------------------------------

def shift_window(grid: torch.Tensor, dr_cells: int,
                 dc_cells: int) -> torch.Tensor:
    """The window shifted by (dr, dc) CELLS in logical space, as a new
    tensor: content rolls by the negated shift and the entering band
    re-zeros to unknown."""
    wr, wc = grid.shape
    out = torch.roll(grid, (-dr_cells, -dc_cells), dims=(0, 1))
    if dr_cells > 0:
        out[max(0, wr - dr_cells):] = 0.0
    elif dr_cells < 0:
        out[:min(wr, -dr_cells)] = 0.0
    if dc_cells > 0:
        out[:, max(0, wc - dc_cells):] = 0.0
    elif dc_cells < 0:
        out[:, :min(wc, -dc_cells)] = 0.0
    return out


def extract_tiles(grid: torch.Tensor, slots: Sequence[Tile],
                  t: int) -> np.ndarray:
    """(n, t, t) host copy of the window tiles at `slots` (window-tile
    coordinates), stacked on the device and read in one copy."""
    return torch.stack([grid[r * t:(r + 1) * t, c * t:(c + 1) * t]
                        for r, c in slots]).cpu().numpy()


def scatter_tiles(grid: torch.Tensor, hits: Sequence[tuple],
                  t: int) -> None:
    """Write host tiles into `grid` IN PLACE at their window slots: one
    upload, to the window's own device, for all of them. `hits`: ((r, c)
    slot, (t, t) array) pairs. Callers pass a tensor that nothing else
    holds."""
    up = torch.as_tensor(np.stack([a for _, a in hits]).astype(np.float32),
                         device=grid.device)
    for k, ((r, c), _) in enumerate(hits):
        grid[r * t:(r + 1) * t, c * t:(c + 1) * t] = up[k]


# ---------------------------------------------------------------------------
# Config derivation
# ---------------------------------------------------------------------------

def window_slam_config(cfg: SlamConfig) -> SlamConfig:
    """The window-sized `SlamConfig` of `world.windowed`: the same
    resolution, patch, alignment, sensor and matcher parameters, with
    `grid.size_cells` shrunk to window_tiles * serving.tile_cells."""
    w = cfg.world
    t = cfg.serving.tile_cells
    g = cfg.grid
    if g.size_cells % t:
        raise ValueError(
            f"grid.size_cells={g.size_cells} not divisible by "
            f"serving.tile_cells={t}")
    wc = w.window_tiles * t
    nt = g.size_cells // t
    if w.window_tiles > nt:
        raise ValueError(
            f"window_tiles={w.window_tiles} exceeds the logical "
            f"lattice ({nt} tiles)")
    if (nt - w.window_tiles) % 2:
        raise ValueError(
            f"logical minus window tiles ({nt} - {w.window_tiles}) "
            "must be even so the initial window centres on the "
            "logical origin (the zero-offset start contract)")
    if g.patch_cells > wc:
        raise ValueError(
            f"patch_cells={g.patch_cells} exceeds the window "
            f"({wc} cells); grow window_tiles or shrink the patch")
    if 2 * w.margin_tiles >= w.window_tiles:
        raise ValueError(
            f"margin_tiles={w.margin_tiles} leaves no interior in a "
            f"{w.window_tiles}-tile window")
    return cfg.replace(grid=dataclasses.replace(g, size_cells=wc))


class WorldStore:
    """Fixed-budget device window + host LRU + disk spill of the logical
    tile lattice.

    Locking: `_lock` guards the host-side maps (LRU, away-set, pending
    prefetches, the generation stamp): the mapper tick thread evicts and
    rehydrates while other threads compose serving mosaics, read status
    and take checkpoint payloads. The caller (the mapper) owns the device
    grid and serializes shifts under its own state lock."""

    def __init__(self, cfg: SlamConfig, spill_dir: Optional[str] = None):
        self.full_cfg = cfg
        self.cfg = window_slam_config(cfg)
        w = cfg.world
        self.tile_cells = cfg.serving.tile_cells
        self.window_tiles = w.window_tiles
        self.window_cells = self.window_tiles * self.tile_cells
        self.logical_tiles = cfg.grid.size_cells // self.tile_cells
        self.margin_tiles = w.margin_tiles
        #: Initial window origin on the logical tile lattice; the centred
        #: start makes offset_xy() == 0.
        self._anchor = (self.logical_tiles - self.window_tiles) // 2
        self.origin_tile: Tuple[int, int] = (self._anchor, self._anchor)

        self._lock = threading.Lock()
        #: (r, c) -> (gen, decay_epoch, float32 (t, t) array, coarse)
        self._host: "OrderedDict[Tile, tuple]" = OrderedDict()
        #: Every logical tile NOT resident that once held content (host,
        #: disk, in-flight prefetch or lost): the serving evicted mask.
        self._away: set = set()
        #: Disk prefetches in flight: tile -> (thread, result holder).
        self._pending: Dict[Tile, tuple] = {}

        dir_ = spill_dir if spill_dir is not None else w.spill_dir
        self.spill: Optional[SpillStore] = \
            SpillStore(dir_) if dir_ else None
        self.governor = MemoryGovernor(w)

        self.decay_epoch = 0
        self._gen = 0
        self.n_shifts = 0
        self.n_evictions = 0
        self.n_rehydrated_host = 0
        self.n_rehydrated_disk = 0
        self.n_lost = 0
        self.n_corrupt_spills = 0
        self.eviction_epoch = 0       # bumps per away-set change
        #: Bounded memory-traffic log (see the module docstring).
        self.schedule: List[tuple] = []
        self.n_schedule_events = 0

    # -- frame math --------------------------------------------------------

    def offset_xy(self) -> np.ndarray:
        """(2,) float32 window -> world translation: world = window +
        offset. Exactly zero at the centred start; computed from the
        integer tile delta, so a shift sequence always gives one float."""
        res = np.float32(self.full_cfg.grid.resolution_m)
        dc = np.int32((self.origin_tile[1] - self._anchor)
                      * self.tile_cells)
        dr = np.int32((self.origin_tile[0] - self._anchor)
                      * self.tile_cells)
        return np.array([np.float32(dc) * res, np.float32(dr) * res],
                        np.float32)

    def shift_delta_m(self, dr: int, dc: int) -> np.ndarray:
        """World-metre translation a (dr, dc)-tile shift adds to the
        offset (what the mapper subtracts from its pose-like leaves)."""
        res = np.float32(self.full_cfg.grid.resolution_m)
        return np.array(
            [np.float32(dc * self.tile_cells) * res,
             np.float32(dr * self.tile_cells) * res], np.float32)

    def desired_shift(self, poses_window: Sequence[np.ndarray]
                      ) -> Tuple[int, int]:
        """(dr, dc) tile shift that recentres the fleet, or (0, 0).

        Shifts only when some robot strays into the `margin_tiles` edge
        band (hysteresis), recentring on the fleet centroid clamped to
        the logical lattice."""
        t = self.tile_cells
        res = self.full_cfg.grid.resolution_m
        half = self.window_cells * res / 2.0
        wt = self.window_tiles
        m = self.margin_tiles
        tiles = []
        for p in poses_window:
            col = (float(p[0]) + half) / res
            row = (float(p[1]) + half) / res
            tiles.append((int(row // t), int(col // t)))
        trigger = any(
            tr < m or tr >= wt - m or tc < m or tc >= wt - m
            for tr, tc in tiles)
        if not trigger:
            return (0, 0)
        cr = sum(tr for tr, _ in tiles) / len(tiles)
        cc = sum(tc for _, tc in tiles) / len(tiles)
        dr = int(round(cr - (wt - 1) / 2.0))
        dc = int(round(cc - (wt - 1) / 2.0))
        lim = self.logical_tiles - wt
        r0, c0 = self.origin_tile
        dr = max(0, min(lim, r0 + dr)) - r0
        dc = max(0, min(lim, c0 + dc)) - c0
        return (dr, dc)

    # -- shift + eviction + rehydration -------------------------------------

    def shift(self, grid: torch.Tensor, dr: int, dc: int) -> torch.Tensor:
        """Shift the window by (dr, dc) tiles: evict the leaving band
        through the governor ladder, roll and re-zero, rehydrate the
        entering tiles (host: scattered now; disk: a prefetch joined at
        the next poll). Returns the new window; `grid` is unchanged."""
        if (dr, dc) == (0, 0):
            return grid
        t = self.tile_cells
        r0, c0 = self.origin_tile
        leaving, entering = self._bands(dr, dc)

        # The leaving tiles of the OLD grid in one copy, admitted
        # host-side in tile order (the ladder decides spill, coarsen or
        # refuse).
        arrs = extract_tiles(grid, leaving, t) if leaving else ()
        for (wr, wc_), arr in zip(leaving, arrs):
            self._admit((r0 + wr, c0 + wc_), arr)

        grid = shift_window(grid, dr * t, dc * t)
        with self._lock:
            self.origin_tile = (r0 + dr, c0 + dc)
        self.n_shifts += 1
        M.counters.inc("world.shifts")
        self._note("shift", dr, dc, self.origin_tile[0],
                   self.origin_tile[1])

        # Rehydrate what the entering band re-covers.
        nr0, nc0 = self.origin_tile
        hits = []
        for (wr, wc_) in entering:
            arr = self._rehydrate((nr0 + wr, nc0 + wc_))
            if arr is not None:
                hits.append(((wr, wc_), arr))
        if hits:
            scatter_tiles(grid, hits, t)      # `grid` is the new tensor
        return grid

    def _bands(self, dr: int, dc: int):
        """Window-tile coordinates of the (leaving, entering) bands of a
        (dr, dc)-tile shift: leaving in PRE-shift window coordinates,
        entering in POST-shift ones; a tile leaves (enters) when its row
        OR column does."""
        wt = self.window_tiles

        def band_leave(d, wt):
            if d > 0:
                return set(range(min(d, wt)))
            if d < 0:
                return set(range(max(0, wt + d), wt))
            return set()

        def band_enter(d, wt):
            if d > 0:
                return set(range(max(0, wt - d), wt))
            if d < 0:
                return set(range(min(-d, wt)))
            return set()

        rows_l, cols_l = band_leave(dr, wt), band_leave(dc, wt)
        rows_e, cols_e = band_enter(dr, wt), band_enter(dc, wt)
        leaving = [(r, c) for r in range(wt) for c in range(wt)
                   if r in rows_l or c in cols_l]
        entering = [(r, c) for r in range(wt) for c in range(wt)
                    if r in rows_e or c in cols_e]
        return leaving, entering

    def _admit(self, tile: Tile, arr: np.ndarray) -> None:
        """One evicted tile enters the host tier through the governor
        ladder. All-unknown tiles are not retained (re-entry re-creates
        them exactly)."""
        with self._lock:
            self.n_evictions += 1
            M.counters.inc("world.evictions")
            if not arr.any():
                self._host.pop(tile, None)
                if self.spill is not None:
                    self.spill.discard(tile)
                self._away.discard(tile)
                return
            self._away.add(tile)
            self.eviction_epoch += 1
            rung = self.governor.observe(len(self._host) + 1)
            if rung >= 3 and self.spill is None:
                # Rung 3 with no deeper tier: refuse admission. The
                # newest content is dropped, so the tile re-enters as
                # unknown, never as old walls.
                self._host.pop(tile, None)
                self.governor.n_refused += 1
                self.n_lost += 1
                M.counters.inc("world.tiles_lost")
                self._note("lost", tile[0], tile[1], "refused")
                self._flight("world_admission_refused", tile=list(tile))
                return
            self._gen += 1
            self._host[tile] = (self._gen, self.decay_epoch, arr, 1)
            self._host.move_to_end(tile)
            self._note("evict", tile[0], tile[1], self._gen)
            self._shed(rung)

    def _shed(self, rung: int) -> None:
        """Spill (or drop) the coldest host tiles down to the rung's
        target occupancy. Caller holds `_lock`."""
        target = (self.governor.effective_budget() if rung == 0
                  else self.governor.target_resident())
        coarsen = (self.full_cfg.world.retention_coarsen
                   if rung >= 2 else 1)
        while len(self._host) > target:
            tile, (gen, epoch, arr, coarse) = \
                self._host.popitem(last=False)
            if self.spill is None:
                self.governor.n_drops += 1
                self.n_lost += 1
                self._away.add(tile)
                M.counters.inc("world.tiles_lost")
                self._note("lost", tile[0], tile[1], "no_spill_tier")
                continue
            k = max(coarse, coarsen)
            out = arr
            if k > coarse:
                out = _coarsen(arr, k // coarse)
                self.governor.n_coarsened += 1
                M.counters.inc("world.tiles_coarsened")
            self.spill.put(tile, gen, out, epoch, coarse=k)
            self.governor.n_spills += 1
            M.counters.inc("world.tiles_spilled")
            self._note("spill", tile[0], tile[1], gen, k)

    def _rehydrate(self, tile: Tile) -> Optional[np.ndarray]:
        """One entering tile: a host hit returns the array to scatter
        now; a disk hit starts a prefetch joined at the next poll (None);
        a miss stays unknown (None)."""
        with self._lock:
            entry = self._host.pop(tile, None)
            if entry is not None:
                gen, epoch, arr, coarse = entry
                self._away.discard(tile)
                self.eviction_epoch += 1
                if self.spill is not None:
                    self.spill.discard(tile)   # resident beats stale
                arr = self._catch_up(arr, epoch, coarse)
                self.n_rehydrated_host += 1
                M.counters.inc("world.rehydrated_host")
                self._note("rehydrate", tile[0], tile[1], "host")
                return arr
            if self.spill is not None and tile in self.spill:
                holder: list = []
                th = threading.Thread(
                    target=self._prefetch_read, args=(tile, holder),
                    name=f"world-prefetch-{tile[0]}-{tile[1]}",
                    daemon=True)
                self._pending[tile] = (th, holder)
                th.start()
                self._note("prefetch", tile[0], tile[1])
                M.counters.inc("world.prefetches")
            elif tile in self._away:
                # Nothing to restore (the tile was lost): it is resident
                # again, as unknown, so the evicted marker clears; the
                # loss stays visible through n_lost and the schedule.
                self._away.discard(tile)
                self.eviction_epoch += 1
                self._note("reenter_unknown", tile[0], tile[1])
        return None

    def _prefetch_read(self, tile: Tile, holder: list) -> None:
        """Prefetch-thread body: only the disk read and CRC check run off
        the tick thread; the scatter waits for `poll_prefetch`, so the
        rehydrate schedule does not depend on IO timing."""
        holder.append(self.spill.get(tile))

    def poll_prefetch(self, grid: torch.Tensor):
        """Join the prefetches (blocking on any still running:
        determinism over latency) and scatter them into a copy of the
        window; corrupt spills degrade to unknown with a flight event.
        Returns (grid, n_applied); `grid` itself is unchanged."""
        with self._lock:
            pending = sorted(self._pending.items())
            self._pending.clear()
        if not pending:
            return grid, 0
        hits = []
        for tile, (th, holder) in pending:
            th.join()
            rec = holder[0] if holder else None
            slot = self._window_slot(tile)
            with self._lock:
                if rec is None:
                    self.n_corrupt_spills += 1
                    self.n_lost += 1
                    if self.spill is not None:
                        self.spill.discard(tile)
                    if slot is not None:
                        # Resident again (as unknown): the evicted
                        # marker clears, as for a lost tile's re-entry.
                        self._away.discard(tile)
                        self.eviction_epoch += 1
                    M.counters.inc("world.corrupt_spills")
                    self._note("corrupt", tile[0], tile[1])
                    self._flight("world_spill_corrupt",
                                 tile=list(tile))
                    continue
                if slot is None:
                    # The window moved on while the read was in flight:
                    # keep the tile warm in the host tier.
                    self._gen += 1
                    self._host[tile] = (self._gen, rec.decay_epoch,
                                        rec.data, rec.coarse)
                    self.spill.discard(tile)
                    self._note("rehydrate", tile[0], tile[1],
                               "disk_to_host")
                    continue
                self._away.discard(tile)
                self.eviction_epoch += 1
                self.spill.discard(tile)
                arr = rec.data
                if rec.coarse > 1:
                    arr = _upsample(arr, rec.coarse, self.tile_cells)
                arr = self._catch_up(arr, rec.decay_epoch, 1)
                self.n_rehydrated_disk += 1
                M.counters.inc("world.rehydrated_disk")
                self._note("rehydrate", tile[0], tile[1], "disk")
            hits.append((slot, arr))
        if hits:
            grid = grid.clone()
            scatter_tiles(grid, hits, self.tile_cells)
        return grid, len(hits)

    def _window_slot(self, tile: Tile) -> Optional[Tuple[int, int]]:
        r = tile[0] - self.origin_tile[0]
        c = tile[1] - self.origin_tile[1]
        if 0 <= r < self.window_tiles and 0 <= c < self.window_tiles:
            return (r, c)
        return None

    # -- decay exactness -----------------------------------------------------

    def note_decay_pass(self) -> None:
        """The mapper decayed the RESIDENT window (`ops.grid.decay_grid`);
        evicted tiles catch up lazily when they come back."""
        with self._lock:
            self.decay_epoch += 1

    def _catch_up(self, arr: np.ndarray, tile_epoch: int,
                  coarse: int) -> np.ndarray:
        """Apply the decay passes a tile missed while evicted: one
        SEQUENTIAL clip(x*f) per missed pass in float32, the device's
        per-pass arithmetic bit for bit (f^k at once rounds otherwise)."""
        k = self.decay_epoch - tile_epoch
        if k <= 0:
            return arr
        d = self.full_cfg.decay
        f = np.float32(d.factor)
        c = np.float32(d.evidence_cap)
        out = arr.astype(np.float32, copy=True)
        for _ in range(k):
            out = np.clip(out * f, -c, c)
        return out

    # -- chaos seams ---------------------------------------------------------

    def corrupt_spill(self, n_tiles: int) -> List[Tile]:
        """Flip a CRC-detectable bit in up to `n_tiles` spilled tiles,
        deterministically. No disk tier: nothing to corrupt."""
        if self.spill is None:
            return []
        hit = self.spill.corrupt_tiles(int(n_tiles))
        for tile in hit:
            self._note("chaos_corrupt", tile[0], tile[1])
        return hit

    def hold_pressure(self, name: str, squeeze: float) -> None:
        """Synthetic budget squeeze; overlapping holds compose worst-of in
        the governor. Sheds at once, so the squeeze shows the tick it
        lands."""
        self.governor.hold_pressure(name, squeeze)
        with self._lock:
            rung = self.governor.observe(len(self._host))
            self._note("pressure", name, round(float(squeeze), 4))
            self._shed(max(rung, 1))

    def release_pressure(self, name: str) -> None:
        self.governor.release_pressure(name)
        with self._lock:
            self.governor.observe(len(self._host))
            self._note("pressure_clear", name)

    # -- serving composition -------------------------------------------------

    def compose_serving(self, window_gray):
        """(logical gray mosaic, (nt, nt) evicted mask): the resident
        window pasted at its origin, everything else unknown-127, and the
        tiles now away (host, disk, in flight, lost) flagged. A tensor
        window gives a tensor mosaic on its device, an array an array."""
        L = self.logical_tiles * self.tile_cells
        t = self.tile_cells
        if torch.is_tensor(window_gray):
            mosaic = torch.full((L, L), 127, dtype=torch.uint8,
                                device=window_gray.device)
        else:
            mosaic = np.full((L, L), 127, np.uint8)
        r0, c0 = self.origin_tile
        mosaic[r0 * t:r0 * t + self.window_cells,
               c0 * t:c0 * t + self.window_cells] = window_gray
        mask = np.zeros((self.logical_tiles, self.logical_tiles), bool)
        with self._lock:
            for (r, c) in self._away:
                mask[r, c] = True
        return mosaic, mask

    # -- checkpoint (io/checkpoint.py world sidecar) -------------------------

    def checkpoint_payload(self) -> Dict[str, np.ndarray]:
        """Flat-array payload of the checkpoint's world sidecar: window
        origin, epochs and away-set, plus the host tier. With a disk tier
        the host tiles flush to the spill file (the spill index is then
        the manifest, rehydrated lazily on restore); without one they are
        embedded."""
        with self._lock:
            if self.spill is not None:
                while self._host:
                    tile, (gen, epoch, arr, coarse) = \
                        self._host.popitem(last=False)
                    self.spill.put(tile, gen, arr, epoch,
                                   coarse=coarse)
                self.spill.compact()
            payload = {
                "origin_tile": np.asarray(self.origin_tile, np.int64),
                "epochs": np.asarray(
                    [self.decay_epoch, self._gen,
                     self.eviction_epoch], np.int64),
                "away": np.asarray(sorted(self._away),
                                   np.int64).reshape(-1, 2),
            }
            if self.spill is None and self._host:
                meta, tiles = [], []
                for tile, (gen, epoch, arr, coarse) in \
                        self._host.items():
                    if coarse != 1:
                        arr = _upsample(arr, coarse, self.tile_cells)
                    meta.append([tile[0], tile[1], gen, epoch])
                    tiles.append(arr)
                payload["host_meta"] = np.asarray(meta, np.int64)
                payload["host_tiles"] = np.stack(tiles)
        return payload

    def restore_payload(self, payload: Dict[str, np.ndarray]) -> None:
        """Re-anchor at the checkpointed origin; away tiles rehydrate
        lazily on re-entry (disk tier) or from the embedded host tier."""
        with self._lock:
            origin = payload["origin_tile"]
            self.origin_tile = (int(origin[0]), int(origin[1]))
            epochs = payload["epochs"]
            self.decay_epoch = int(epochs[0])
            self._gen = int(epochs[1])
            self.eviction_epoch = int(epochs[2])
            self._away = {(int(r), int(c))
                          for r, c in np.asarray(payload["away"])}
            self._host.clear()
            self._pending.clear()
            if "host_meta" in payload:
                meta = np.asarray(payload["host_meta"])
                tiles = np.asarray(payload["host_tiles"], np.float32)
                for row, arr in zip(meta, tiles):
                    self._host[(int(row[0]), int(row[1]))] = (
                        int(row[2]), int(row[3]), arr, 1)

    # -- observability -------------------------------------------------------

    def _note(self, kind: str, *args) -> None:
        self.n_schedule_events += 1
        if len(self.schedule) < _SCHEDULE_CAP:
            self.schedule.append((kind,) + args)

    @staticmethod
    def _flight(event: str, **kw) -> None:
        flight_recorder.record(event, **kw)

    def host_tiles(self) -> int:
        with self._lock:
            return len(self._host)

    def status(self) -> dict:
        """The store's status section (host maps read under the lock,
        counters lock-free)."""
        with self._lock:
            host = len(self._host)
            away = len(self._away)
            pending = len(self._pending)
            host_bytes = sum(e[2].nbytes for e in self._host.values())
        s = {
            "windowed": True,
            "origin_tile": list(self.origin_tile),
            "window_tiles": self.window_tiles,
            "logical_tiles": self.logical_tiles,
            "device_window_bytes": self.window_cells ** 2 * 4,
            "host_tiles": host,
            "host_bytes": host_bytes,
            "away_tiles": away,
            "pending_prefetch": pending,
            "shifts": self.n_shifts,
            "evictions": self.n_evictions,
            "rehydrated_host": self.n_rehydrated_host,
            "rehydrated_disk": self.n_rehydrated_disk,
            "lost_tiles": self.n_lost,
            "corrupt_spills": self.n_corrupt_spills,
            "eviction_epoch": self.eviction_epoch,
            "decay_epoch": self.decay_epoch,
            "schedule_events": self.n_schedule_events,
            "governor": self.governor.status(),
        }
        if self.spill is not None:
            s["spill"] = self.spill.status()
        return s

    # -- store-level fusion at global coordinates ----------------------------

    def fuse_scan_global(self, window_grid: torch.Tensor, ranges,
                         pose_world) -> torch.Tensor:
        """Fuse one scan into the window with the inverse sensor model at
        GLOBAL coordinates (K1 at the logical patch origin), clip-added
        at the window-local offset: the window then equals a big-grid
        fusion of the same scans cell for cell. Returns a new window.
        The mapper's windowed steps run the window-frame SLAM step
        instead."""
        from jax_mapping_torch.ops import grid as G
        from jax_mapping_torch.ops import sensor_kernel as SK
        g = self.full_cfg.grid
        pose = torch.as_tensor(np.asarray(pose_world, np.float32))
        # The patch origin on the host's copy of the pose: no device read.
        og = G.patch_origin(g, pose[:2]).numpy()
        r0, c0 = self.origin_tile
        local = og - np.array([r0 * self.tile_cells, c0 * self.tile_cells])
        wc = self.window_cells
        p = g.patch_cells
        if not (0 <= local[0] <= wc - p and 0 <= local[1] <= wc - p):
            raise ValueError(
                f"patch at logical {og.tolist()} does not fit the "
                f"window at origin {self.origin_tile} — shift first")
        dev = window_grid.device
        delta = SK.scan_deltas(
            g, self.full_cfg.scan,
            torch.as_tensor(np.asarray(ranges, np.float32),
                            device=dev).reshape(1, -1),
            pose.to(dev).reshape(1, 3),
            torch.as_tensor(og.astype(np.int32), device=dev).reshape(1, 2)
        )[0]
        lr, lc = int(local[0]), int(local[1])
        out = window_grid.clone()
        out[lr:lr + p, lc:lc + p] = torch.clamp(
            out[lr:lr + p, lc:lc + p] + delta, g.logodds_min,
            g.logodds_max)
        return out

    def close(self) -> None:
        # Join in-flight prefetch reads BEFORE closing the spill file: a
        # reader racing the close would die on a closed file.
        with self._lock:
            pending = list(self._pending.values())
            self._pending.clear()
        for th, _holder in pending:
            th.join()
        if self.spill is not None:
            self.spill.close()


# ---------------------------------------------------------------------------
# Rung-2 retention coarsening (host-side, lossy, bounded)
# ---------------------------------------------------------------------------

def _coarsen(arr: np.ndarray, k: int) -> np.ndarray:
    """Downsample by max-|logodds| per k x k block: walls survive."""
    t = arr.shape[0]
    b = arr.reshape(t // k, k, t // k, k).transpose(0, 2, 1, 3) \
        .reshape(t // k, t // k, k * k)
    idx = np.abs(b).argmax(axis=2)
    return np.take_along_axis(b, idx[..., None], axis=2)[..., 0] \
        .astype(np.float32)


def _upsample(arr: np.ndarray, k: int, t: int) -> np.ndarray:
    """Nearest-neighbour re-expansion of a coarsened tile back to the
    (t, t) lattice."""
    out = np.repeat(np.repeat(arr, k, axis=0), k, axis=1)
    return np.ascontiguousarray(out[:t, :t], dtype=np.float32)
