"""Bounded-memory world store: its config derivation.

Port of `window_slam_config` from the JAX package's `world/store.py`, the
one definition of a window-sized mission config that
`tenancy.megabatch.windowed_mission_config` reads. The store itself
(`WorldStore`: the device window, the host LRU and disk spill, the
memory governor) is not ported yet; ROADMAP queue A.7 holds it.
"""

from __future__ import annotations

import dataclasses

from jax_mapping_torch.config import SlamConfig


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
