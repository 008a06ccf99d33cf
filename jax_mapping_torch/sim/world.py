"""Ground-truth worlds for the simulated fleet (numpy).

A copy of the JAX package's `sim/world.py` generators: boolean occupancy
bitmaps with the map grid's centred indexing (row = y, col = x). The
scenario worlds also report their door gaps. The same seed gives the
same world as the JAX package, array for array.
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


def plank_course(size_cells: int, resolution_m: float, n_planks: int = 12,
                 seed: int = 0, margin_m: float = 0.6) -> np.ndarray:
    """Arena plus random thin axis-aligned wall segments ('planks'),
    keeping a clear margin around the centre so robots can start there."""
    rng = np.random.default_rng(seed)
    w = empty_arena(size_cells, resolution_m)
    res = resolution_m
    margin_c = int(margin_m / res)
    c = size_cells // 2
    for _ in range(n_planks):
        length = rng.integers(int(0.5 / res), int(2.0 / res))
        thick = max(1, int(0.04 / res))
        r0 = rng.integers(2, size_cells - 2 - length)
        c0 = rng.integers(2, size_cells - 2 - length)
        horiz = rng.random() < 0.5
        if horiz:
            rr = slice(r0, r0 + thick)
            cc = slice(c0, c0 + length)
        else:
            rr = slice(r0, r0 + length)
            cc = slice(c0, c0 + thick)
        if abs((rr.start + rr.stop) / 2 - c) < margin_c and \
                abs((cc.start + cc.stop) / 2 - c) < margin_c:
            continue
        w[rr, cc] = True
    return w


def arena_with_door(size_cells: int, resolution_m: float,
                    wall_frac: float = 0.62,
                    door_m: float = 0.5) -> tuple:
    """Arena split by one vertical wall with a centred door gap.

    Returns (world, doors): `world` has the door open; each door is a dict
    {name, r0, r1, c0, c1} naming the half-open cell rectangle a
    door-closing event fills with wall."""
    w = empty_arena(size_cells, resolution_m)
    door = max(3, int(door_m / resolution_m))
    thick = 2
    col = int(size_cells * wall_frac)
    w[:, col:col + thick] = True
    r0 = size_cells // 2 - door // 2
    w[r0:r0 + door, col:col + thick] = False
    doors = [{"name": "door0", "r0": r0, "r1": r0 + door,
              "c0": col, "c1": col + thick}]
    return w, doors


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


def rooms_world(size_cells: int, resolution_m: float,
                seed: int = 1) -> np.ndarray:
    """`rooms_with_doors` without the door report."""
    return rooms_with_doors(size_cells, resolution_m, seed)[0]


def corridor_course(size_cells: int, resolution_m: float,
                    corridor_w_m: float = 1.2, n_rooms: int = 4,
                    seed: int = 2) -> tuple:
    """A long east-west corridor through a solid slab, with `n_rooms` side
    rooms behind door gaps, alternating sides; the centre cell is always
    carved. Returns (world, doors) in the dict form of
    `arena_with_door`."""
    rng = np.random.default_rng(seed)
    w = np.ones((size_cells, size_cells), bool)
    res = resolution_m
    half = max(2, int(corridor_w_m / res) // 2)
    c = size_cells // 2
    w[c - half:c + half, 2:size_cells - 2] = False
    door = max(3, int(0.5 / res))
    thick = 2
    doors = []
    for k in range(n_rooms):
        cx = int((k + 1) * size_cells / (n_rooms + 1))
        room = max(door + 4,
                   int(rng.integers(int(1.2 / res), int(2.0 / res))))
        if k % 2 == 0:
            wall_r0 = c + half
            r0, r1 = wall_r0 + thick, min(size_cells - 2,
                                          wall_r0 + thick + room)
        else:
            wall_r0 = c - half - thick
            r1, r0 = wall_r0, max(2, wall_r0 - room)
        c0 = max(2, cx - room // 2)
        c1 = min(size_cells - 2, cx + room // 2)
        w[r0:r1, c0:c1] = False
        g0 = min(max(c0 + 1, cx - door // 2), c1 - door - 1)
        w[wall_r0:wall_r0 + thick, g0:g0 + door] = False
        doors.append({"name": f"room{k}", "r0": wall_r0,
                      "r1": wall_r0 + thick, "c0": g0, "c1": g0 + door})
    return w, doors


def stamp_disc(world: np.ndarray, row: float, col: float,
               radius_cells: float) -> np.ndarray:
    """Stamp a filled occupied disc into `world` in place, clipped to its
    extent; returns `world`."""
    nr, nc = world.shape
    r0 = max(0, int(row - radius_cells) - 1)
    r1 = min(nr, int(row + radius_cells) + 2)
    c0 = max(0, int(col - radius_cells) - 1)
    c1 = min(nc, int(col + radius_cells) + 2)
    if r1 <= r0 or c1 <= c0:
        return world
    rr = np.arange(r0, r1, dtype=np.float32)[:, None] - row
    cc = np.arange(c0, c1, dtype=np.float32)[None, :] - col
    world[r0:r1, c0:c1] |= (rr * rr + cc * cc) <= radius_cells ** 2
    return world
