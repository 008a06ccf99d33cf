"""Ground-truth worlds the benchmark makes from its seed (numpy).

A frozen copy of the port's `sim/world.py` generators, so that the
benchmark makes its inputs itself and hands the same world to the program
and to the reference: boolean occupancy bitmaps with the map grid's
centred indexing (row = y, col = x). `rooms_wide_doors` widens each door
of `rooms_with_doors` to a given width (the mission stack's world).
"""

from __future__ import annotations

import numpy as np


def empty_arena(size_cells: int, resolution_m: float,
                wall_cells: int = 2) -> np.ndarray:
    """Closed rectangular arena: walls around the border."""
    w = np.zeros((size_cells, size_cells), bool)
    t = wall_cells
    w[:t, :] = True
    w[-t:, :] = True
    w[:, :t] = True
    w[:, -t:] = True
    return w


def rooms_with_doors(size_cells: int, resolution_m: float,
                     seed: int = 1) -> tuple:
    """Arena split into rooms by two horizontal and two vertical walls,
    each with a door gap: a loop-closure friendly course. Returns
    (world, doors), one named rectangle per gap (the dict form of
    `arena_with_door`)."""
    rng = np.random.default_rng(seed)
    w = empty_arena(size_cells, resolution_m)
    door = max(3, int(0.5 / resolution_m))
    doors = []
    for k, frac in enumerate((0.33, 0.66)):
        pos = int(size_cells * frac)
        gap = int(rng.integers(door, size_cells - 2 * door))
        w[pos:pos + 2, :] = True
        w[pos:pos + 2, gap:gap + door] = False
        doors.append({"name": f"door_h{k}", "r0": pos, "r1": pos + 2,
                      "c0": gap, "c1": gap + door})
        gap = int(rng.integers(door, size_cells - 2 * door))
        w[:, pos:pos + 2] = True
        w[gap:gap + door, pos:pos + 2] = False
        doors.append({"name": f"door_v{k}", "r0": gap, "r1": gap + door,
                      "c0": pos, "c1": pos + 2})
    return w, doors


def rooms_wide_doors(size_cells: int, resolution_m: float,
                     door_m: float = 2.0, seed: int = 1) -> np.ndarray:
    """`rooms_with_doors` with each door widened to `door_m` about its
    centre: the frontier planner's 0.8 m pooled cells seal 0.5 m doors,
    2 m doors stay open to it."""
    w, doors = rooms_with_doors(size_cells, resolution_m, seed=seed)
    half = int(round(door_m / resolution_m)) // 2
    for d in doors:
        if d["r1"] - d["r0"] == 2:              # a gap in a horizontal wall
            c = (d["c0"] + d["c1"]) // 2
            w[d["r0"]:d["r1"], c - half:c + half] = False
        else:
            r = (d["r0"] + d["r1"]) // 2
            w[r - half:r + half, d["c0"]:d["c1"]] = False
    return w
