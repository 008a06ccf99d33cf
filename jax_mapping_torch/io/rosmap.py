"""ROS map_server map format: `<name>.pgm` + `<name>.yaml`.

Copy of the JAX package's `io/rosmap.py` (numpy only): a map either
package writes reads in the other.

The artifact every slam_toolbox operator ends a session with (`ros2 run
nav2_map_server map_saver_cli`): a binary P5 PGM raster plus a YAML
sidecar with resolution/origin/thresholds. The reference never saved a
map at all — restart lost it (SURVEY.md §5 checkpoint: "none in project
code") — and the framework's own npz checkpoints are richer but private.
This module speaks the ecosystem format so maps move BETWEEN stacks:
export for Nav2/map_server/localization consumers, import to seed a grid
from a map produced by any ROS SLAM.

Conventions (map_saver's trinary mode):
  occupied (100) -> 0 (black), free (0) -> 254, unknown (-1) -> 205;
  PGM row 0 is the TOP of the image while grid row 0 is min-y, so rows
  flip on both paths (the same flipud the reference's /map-image does,
  `server/.../main.py:266`).

No pyyaml dependency: the sidecar is a flat key: value document both
ways (map_server itself writes exactly this shape).
"""

from __future__ import annotations

import os
from typing import Tuple

import numpy as np

_OCC_PX = 0          # black
_FREE_PX = 254
_UNKNOWN_PX = 205


def save_map(base_path: str, occupancy: np.ndarray, resolution_m: float,
             origin_m: Tuple[float, float]) -> Tuple[str, str]:
    """Write `<base>.pgm` + `<base>.yaml` from an int8 {-1, 0, 100} grid
    (row 0 = min-y, the nav_msgs/OccupancyGrid layout). Returns the two
    paths written."""
    occ = np.asarray(occupancy)
    if occ.ndim != 2:
        raise ValueError(f"expected (H, W) occupancy, got {occ.shape}")
    px = np.full(occ.shape, _UNKNOWN_PX, np.uint8)
    px[occ == 0] = _FREE_PX
    px[occ == 100] = _OCC_PX
    px = np.flipud(px)                       # grid min-y -> image bottom
    pgm_path = base_path + ".pgm"
    yaml_path = base_path + ".yaml"
    h, w = px.shape
    with open(pgm_path, "wb") as f:
        f.write(f"P5\n{w} {h}\n255\n".encode())
        f.write(np.ascontiguousarray(px).tobytes())
    image_name = os.path.basename(pgm_path)
    with open(yaml_path, "w") as f:
        f.write(
            f"image: {image_name}\n"
            "mode: trinary\n"
            f"resolution: {resolution_m}\n"
            f"origin: [{origin_m[0]}, {origin_m[1]}, 0.0]\n"
            "negate: 0\n"
            "occupied_thresh: 0.65\n"
            # The map_server standard value — NOT a nicer-looking 0.2 or
            # 0.25: unknown pixel 205 has p_occ = 50/255 = 0.19607...,
            # which must land ABOVE free_thresh to stay unknown on
            # re-import (0.196 < 0.19607 by construction).
            "free_thresh: 0.196\n")
    return pgm_path, yaml_path


def _parse_yaml(text: str) -> dict:
    """Flat key: value parser for map_server sidecars (plus the one-line
    [x, y, yaw] origin list). Unknown keys are kept as strings."""
    out: dict = {}
    for line in text.splitlines():
        line = line.split("#", 1)[0].strip()
        if not line or ":" not in line:
            continue
        k, v = line.split(":", 1)
        v = v.strip()
        if v.startswith("[") and v.endswith("]"):
            out[k.strip()] = [float(x) for x in v[1:-1].split(",") if
                              x.strip()]
            continue
        try:
            out[k.strip()] = float(v) if "." in v or "e" in v.lower() \
                else int(v)
        except ValueError:
            out[k.strip()] = v
    return out


def load_map(yaml_path: str) -> Tuple[np.ndarray, float,
                                      Tuple[float, float]]:
    """Read a map_server `<name>.yaml` (+ its PGM) back into an int8
    {-1, 0, 100} occupancy grid (row 0 = min-y), resolution, origin.

    Trinary semantics with the standard thresholds: pixel/255 ABOVE
    occupied_thresh of occupancy probability -> 100, below free_thresh ->
    0, else -1 (map_server's interpretation: occupancy p = (255-px)/255
    when negate=0)."""
    with open(yaml_path) as f:
        meta = _parse_yaml(f.read())
    if "image" not in meta or "resolution" not in meta:
        raise ValueError(
            f"{yaml_path}: missing 'image' or 'resolution' key")
    img_path = os.path.join(os.path.dirname(os.path.abspath(yaml_path)),
                            str(meta["image"]))
    with open(img_path, "rb") as f:
        magic = f.readline().strip()
        if magic != b"P5":
            raise ValueError(f"unsupported PGM magic {magic!r} "
                             "(binary P5 only)")
        def _header_line():
            # PNM allows comment lines anywhere in the header — between
            # the magic and dims AND between dims and maxval.
            tokens = f.readline().split()
            while tokens and tokens[0].startswith(b"#"):
                tokens = f.readline().split()
            return tokens

        dims = _header_line()
        try:
            w, h = int(dims[0]), int(dims[1])
            maxval = int(_header_line()[0])
            px = np.frombuffer(f.read(w * h), np.uint8).reshape(h, w)
        except (IndexError, ValueError) as e:
            # Truncated/malformed header or short pixel payload — the
            # hand-rolled parser must surface one exception type so
            # callers' polite-refusal contracts hold.
            raise ValueError(f"malformed PGM {img_path}: {e}") from e
    if maxval != 255:
        raise ValueError(f"unsupported PGM maxval {maxval}")
    negate = int(meta.get("negate", 0))
    p_occ = (px.astype(np.float32) / 255.0 if negate
             else (255.0 - px.astype(np.float32)) / 255.0)
    occ_t = float(meta.get("occupied_thresh", 0.65))
    free_t = float(meta.get("free_thresh", 0.196))
    occ = np.full(px.shape, -1, np.int8)
    occ[p_occ > occ_t] = 100
    occ[p_occ < free_t] = 0
    occ = np.flipud(occ)                     # image bottom -> grid min-y
    origin = meta.get("origin", [0.0, 0.0, 0.0])
    if not isinstance(origin, list) or len(origin) < 2:
        raise ValueError(f"malformed origin {origin!r} "
                         "(expected [x, y, yaw])")
    if len(origin) > 2 and abs(float(origin[2])) > 1e-9:
        # Legal in ROS, but embedding is axis-aligned (same stance as the
        # same-resolution-only rule): importing a rotated map unrotated
        # would put every wall silently in the wrong place.
        raise ValueError(
            f"map origin yaw {origin[2]} != 0: rotated imports are not "
            "supported; re-save the map axis-aligned")
    return (np.ascontiguousarray(occ), float(meta["resolution"]),
            (float(origin[0]), float(origin[1])))


def embed_in_grid(occupancy: np.ndarray, resolution_m: float,
                  origin_m: Tuple[float, float], grid_cfg) -> np.ndarray:
    """Place an imported occupancy raster into a framework-sized
    (size_cells, size_cells) int8 grid at the cell offset its origin
    implies; cells outside the import stay unknown (-1). Same-resolution
    only — resampling an occupancy trichotomy is a policy decision the
    caller should make explicitly."""
    occ = np.asarray(occupancy, np.int8)
    if abs(resolution_m - grid_cfg.resolution_m) > 1e-9:
        raise ValueError(
            f"imported map resolution {resolution_m} != grid "
            f"{grid_cfg.resolution_m}; resample before embedding")
    n = grid_cfg.size_cells
    out = np.full((n, n), -1, np.int8)
    r0 = int(round((origin_m[1] - grid_cfg.origin_m[1]) / resolution_m))
    c0 = int(round((origin_m[0] - grid_cfg.origin_m[0]) / resolution_m))
    src_r = slice(max(0, -r0), min(occ.shape[0], n - r0))
    src_c = slice(max(0, -c0), min(occ.shape[1], n - c0))
    if src_r.stop <= src_r.start or src_c.stop <= src_c.start:
        return out                           # no overlap
    out[src_r.start + r0:src_r.stop + r0,
        src_c.start + c0:src_c.stop + c0] = occ[src_r, src_c]
    return out


#: Exceptions a malformed/missing map-prior import can raise; entry
#: points catch exactly this for their polite-refusal (rc=2) contract —
#: ONE definition so demo and ros_launch cannot drift.
SEED_ERRORS = (OSError, ValueError, KeyError, TypeError, IndexError)


def seed_mapper(mapper, yaml_path: str, grid_cfg) -> int:
    """Load a map_server artifact and seed `mapper` with it as a
    log-odds prior (the full --map-prior pipeline: load -> same-res
    embed -> prior -> mapper.seed_map_prior). Returns the occupied-cell
    count for operator logging; raises one of SEED_ERRORS on bad
    input."""
    occ, res, origin = load_map(yaml_path)
    occ = embed_in_grid(occ, res, origin, grid_cfg)
    mapper.seed_map_prior(logodds_prior(occ))
    return int((occ == 100).sum())


def logodds_prior(occupancy: np.ndarray, occ_logodds: float = 2.0,
                  free_logodds: float = -2.0) -> np.ndarray:
    """An int8 occupancy grid as a log-odds PRIOR for seeding a mapper:
    confident but not saturated, so live scans can still overturn stale
    walls (the use map_server localization gives an imported map)."""
    occ = np.asarray(occupancy)
    lo = np.zeros(occ.shape, np.float32)
    lo[occ == 100] = occ_logodds
    lo[occ == 0] = free_logodds
    return lo
