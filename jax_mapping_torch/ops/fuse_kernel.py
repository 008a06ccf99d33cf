"""Fused fusion: the streaming fold, the shared-patch window engine
(kernel K5) and the touched-tile accounting.

Port of the JAX package's `ops/fuse_kernel.py`.

* `stream_fold`, the body `grid._classify_fold` runs: scans are
  classified by kernel K1 in sub-batches of `_STREAM_CHUNK` and each
  sub-batch folds into the grid at once, so at most `_STREAM_CHUNK` x P x P
  deltas are live (64 x 1.6 MB = 105 MB at the default config) however
  many scans the call fuses; the 8192-scan loop-closure re-fuse never
  materialises its 13 GB of deltas.
* `window_fused`, the shared-patch window fuse that
  `grid.fuse_scans_window` takes when `GridConfig.fused_fusion` is on. It
  follows the JAX package's TPU engine: up to `SK._MAX_B_PER_CALL` scans
  go through kernel K5 (`window_apply`, CUDA source
  `csrc/window_fuse.cu`), which replaces `_window_apply_pallas`:
  clip(patch + sum_b delta_b) in one pass, in place on the grid, with the
  sum in b order and one `patch + acc` addition. K5 is bound by the
  classification (~55 float operations per cell and scan within range)
  against one read and one write of the patch; each block classifies
  its 16 x 16 tile for every scan once (constant or per-cell, the class
  of `SK.tile_classes_plain`), then each thread keeps its cells' sums in
  registers and loops over the scans, running the per-cell model only
  where the class asks for it (see the source).
  Larger windows are summed by kernel K4 as 512-scan subtotals and
  applied once.
* `touched_tile_box`, `patch_span_tiles`, `fuse_scans_window_touched` and
  `fuse_scans_touched`: which serving tiles a step's patches touched, and
  the hashes of that region of the new grid.

On a CPU tensor `window_apply` runs its plain version
(`window_apply_plain`); on a CUDA tensor it launches K5 or raises.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from jax_mapping_torch._util import entry_point
from jax_mapping_torch.config import GridConfig, ScanConfig
from jax_mapping_torch.obs import ledger
from jax_mapping_torch.ops import _cuda
from jax_mapping_torch.ops import sensor_kernel as SK

_STREAM_CHUNK = 64

#: Extra tile-box slack (grid cells) for intra-window motion when the box
#: is derived from a step's endpoint poses.
_ENDPOINT_SLACK_CELLS = 8


def stream_fold(grid_cfg: GridConfig, scan_cfg: ScanConfig,
                grid_arr: torch.Tensor, ranges_b: torch.Tensor,
                poses_b: torch.Tensor, mask_b: Optional[torch.Tensor],
                clamp: bool = True,
                tenant: Optional[torch.Tensor] = None) -> None:
    """Classify and fold `ranges_b` into `grid_arr` in place, in b order,
    `_STREAM_CHUNK` scans at a time; with `tenant`, scan b into grid
    tenant[b] of a (T, N, N) stack (one K1 launch and one host read a
    sub-batch for every tenant's scans)."""
    from jax_mapping_torch.ops import grid as G
    B = ranges_b.shape[0]
    for s in range(0, B, _STREAM_CHUNK):
        e = min(B, s + _STREAM_CHUNK)
        deltas, origins = G._classify_batch(grid_cfg, scan_cfg,
                                            ranges_b[s:e], poses_b[s:e])
        G._fold(grid_cfg, grid_arr, deltas, origins,
                None if mask_b is None else mask_b[s:e], clamp=clamp,
                tenant=None if tenant is None else tenant[s:e])


# ---------------------------------------------------------------------------
# Shared-patch window engine (kernel K5)
# ---------------------------------------------------------------------------

def _patch_start(grid_cfg: GridConfig, origin_rc: torch.Tensor):
    """(row0, col0) host ints of a patch origin, clamped into the grid as
    jax.lax.dynamic_slice clamps its start (one host read)."""
    hi = grid_cfg.size_cells - grid_cfg.patch_cells
    r0, c0 = origin_rc.tolist()
    return min(max(r0, 0), hi), min(max(c0, 0), hi)


def window_apply_plain(grid_cfg: GridConfig, scan_cfg: ScanConfig,
                       grid_arr: torch.Tensor, ranges_b: torch.Tensor,
                       poses_b: torch.Tensor,
                       origin_rc: torch.Tensor) -> None:
    """Plain PyTorch version of K5, in place on `grid_arr`:
    patch = clip(patch + window_delta_plain(...)) at origin_rc."""
    P = grid_cfg.patch_cells
    r0, c0 = _patch_start(grid_cfg, origin_rc)
    acc = SK.window_delta_plain(grid_cfg, scan_cfg, ranges_b, poses_b,
                                origin_rc)
    sl = grid_arr[r0:r0 + P, c0:c0 + P]
    sl.copy_(torch.clamp(sl + acc, grid_cfg.logodds_min,
                         grid_cfg.logodds_max))


@entry_point(static=("grid_cfg", "scan_cfg"))
def window_apply(grid_cfg: GridConfig, scan_cfg: ScanConfig,
                 grid_arr: torch.Tensor, ranges_b: torch.Tensor,
                 poses_b: torch.Tensor, origin_rc: torch.Tensor) -> None:
    """grid[r0:r0+P, c0:c0+P] = clip(patch + sum_b delta_b), in place on
    `grid_arr`, for at most `SK._MAX_B_PER_CALL` scans sharing the patch
    at origin_rc (2,) int32 (callers chunk larger windows)."""
    B = ranges_b.shape[0]
    if B > SK._MAX_B_PER_CALL:
        raise ValueError(f"{B} scans in one window apply; at most "
                         f"{SK._MAX_B_PER_CALL}")
    if ranges_b.device.type == "cpu":
        window_apply_plain(grid_cfg, scan_cfg, grid_arr, ranges_b, poses_b,
                           origin_rc)
        return
    N = grid_cfg.size_cells
    SK._check_window(grid_cfg, scan_cfg, ranges_b, poses_b, origin_rc)
    _cuda.check_cuda(grid_arr, "grid_arr", torch.float32, (N, N))
    _cuda.call("window_fuse", _cuda.ptr(ranges_b), _cuda.ptr(poses_b), B,
               _cuda.ptr(origin_rc), _cuda.ptr(grid_arr), N,
               grid_cfg.patch_cells, scan_cfg.padded_beams,
               *SK.model_args(grid_cfg, scan_cfg), grid_cfg.logodds_min,
               grid_cfg.logodds_max, entry="window_apply_launch")
    _cuda.count_launch("window_apply")
    _cuda.note_cost("window_apply", lambda: ledger.window_apply_cost(
        grid_cfg, scan_cfg, ranges_b, poses_b, origin_rc))


def window_fused(grid_cfg: GridConfig, scan_cfg: ScanConfig,
                 grid_arr: torch.Tensor, ranges_b: torch.Tensor,
                 poses_b: torch.Tensor,
                 origin_rc: torch.Tensor) -> torch.Tensor:
    """Fuse a shared-patch window into a copy of the grid; returns it.

    The JAX package's TPU engine: B = 0 clamp-applies a zero patch;
    B <= `SK._MAX_B_PER_CALL` runs K5 on the grid's patch; larger windows
    are summed by K4 as 512-scan subtotals added in order, then applied
    once with a clamp. Its XLA engine reassociates at 64-scan sub-chunks
    instead; the port follows the TPU's sums. Every pose must satisfy the
    shared-patch contract (`SK.window_fits`)."""
    from jax_mapping_torch.ops import grid as G
    B = ranges_b.shape[0]
    out = grid_arr.clone()
    if 0 < B <= SK._MAX_B_PER_CALL:
        window_apply(grid_cfg, scan_cfg, out, ranges_b, poses_b, origin_rc)
        return out
    delta = SK.window_delta(grid_cfg, scan_cfg, ranges_b, poses_b,
                            origin_rc)
    G.apply_patch(grid_cfg, out, delta, *_patch_start(grid_cfg, origin_rc))
    return out


# ---------------------------------------------------------------------------
# Touched-tile accounting (serving tile units)
# ---------------------------------------------------------------------------

def patch_span_tiles(grid_cfg: GridConfig, tile_cells: int) -> int:
    """Serving tiles per axis that one fusion patch can intersect:
    ceil(P / t) + 1, clamped to the tile grid."""
    if grid_cfg.size_cells % tile_cells:
        raise ValueError(
            f"tile_cells={tile_cells} does not divide grid.size_cells="
            f"{grid_cfg.size_cells}")
    span = -(-grid_cfg.patch_cells // tile_cells) + 1
    return min(span, grid_cfg.size_cells // tile_cells)


@entry_point(static=("grid_cfg", "tile_cells"))
def touched_tile_box(grid_cfg: GridConfig, tile_cells: int,
                     poses_xy: torch.Tensor,
                     pad_cells: torch.Tensor) -> torch.Tensor:
    """(4,) int32 [tr0, tr1, tc0, tc1] inclusive serving-tile bounds of
    every fusion patch a step at the (N, 2) endpoint poses touched, padded
    by `pad_cells` (the step's travel bound), the endpoint slack and the
    origin-alignment quantum."""
    from jax_mapping_torch.ops import grid as G
    P = grid_cfg.patch_cells
    nt = grid_cfg.size_cells // tile_cells
    origins = G.patch_origin(grid_cfg, poses_xy)                 # (N, 2)
    pad = (_ENDPOINT_SLACK_CELLS + torch.as_tensor(pad_cells).to(
        device=poses_xy.device, dtype=torch.int32)
        + max(grid_cfg.align_rows, grid_cfg.align_cols))
    lo = torch.clamp(origins.amin(dim=0) - pad, 0, grid_cfg.size_cells - 1)
    hi = torch.clamp(origins.amax(dim=0) + P - 1 + pad, 0,
                     grid_cfg.size_cells - 1)
    t0 = torch.div(lo, tile_cells, rounding_mode="floor")
    t1 = torch.clamp_max(torch.div(hi, tile_cells, rounding_mode="floor"),
                         nt - 1)
    return torch.stack([t0[0], t1[0], t0[1], t1[1]]).to(torch.int32)


@entry_point(static=("grid_cfg", "scan_cfg", "tile_cells"))
def fuse_scans_window_touched(grid_cfg: GridConfig, scan_cfg: ScanConfig,
                              tile_cells: int, grid_arr: torch.Tensor,
                              ranges_b: torch.Tensor, poses_b: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor,
                                         torch.Tensor]:
    """Fuse a shared-patch window and hash the tile region it touched.

    Returns (new_grid, tile_rc, hashes): `tile_rc` is the (2,) int32
    [tile_row, tile_col] origin of the touched K x K tile region
    (K = `patch_span_tiles`), `hashes` its (K, K, 2) per-tile content
    hashes (`grid.tile_hashes`) over the new grid. Honours
    `GridConfig.fused_fusion` like `grid.fuse_scans_window`. The region
    is sliced at host ints (one host read of the origin)."""
    from jax_mapping_torch.ops import grid as G
    new = G.fuse_scans_window(grid_cfg, scan_cfg, grid_arr, ranges_b,
                              poses_b)
    origin = G.patch_origin(grid_cfg, poses_b[:, :2].mean(dim=0))
    K = patch_span_tiles(grid_cfg, tile_cells)
    nt = grid_cfg.size_cells // tile_cells
    tile_rc = torch.clamp_max(
        torch.div(origin, tile_cells, rounding_mode="floor"),
        nt - K).to(torch.int32)
    tr, tc = (v * tile_cells for v in tile_rc.tolist())
    span = K * tile_cells
    region = new[tr:tr + span, tc:tc + span]
    return new, tile_rc, G.tile_hashes(region, tile_cells)


@entry_point(static=("grid_cfg", "scan_cfg", "tile_cells"))
def fuse_scans_touched(grid_cfg: GridConfig, scan_cfg: ScanConfig,
                       tile_cells: int, grid_arr: torch.Tensor,
                       ranges_b: torch.Tensor, poses_b: torch.Tensor,
                       mask_b: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fuse scattered scans and report the serving tiles they touched.

    Returns (new_grid, touched): the grid exactly as `grid.fuse_scans`
    (or `grid.fuse_scans_masked` with a mask) gives it, and the (nt, nt)
    bool mask of the K x K tile boxes (K = `patch_span_tiles`) at
    min(origin // tile_cells, nt - K) of every contributing scan's patch;
    a masked-out scan marks nothing. The boxes are marked in one scatter
    on the grid's device."""
    from jax_mapping_torch.ops import grid as G
    if mask_b is None:
        out = G.fuse_scans(grid_cfg, scan_cfg, grid_arr, ranges_b, poses_b)
    else:
        out = G.fuse_scans_masked(grid_cfg, scan_cfg, grid_arr, ranges_b,
                                  poses_b, mask_b)
    K = patch_span_tiles(grid_cfg, tile_cells)
    nt = grid_cfg.size_cells // tile_cells
    dev = grid_arr.device
    B = ranges_b.shape[0]
    rc = torch.clamp_max(torch.div(G.patch_origin(grid_cfg, poses_b[:, :2]),
                                   tile_cells, rounding_mode="floor"),
                         nt - K).long()                          # (B, 2)
    ar = torch.arange(K, device=dev)
    rows = (rc[:, 0, None] + ar)[:, :, None].expand(B, K, K)
    cols = (rc[:, 1, None] + ar)[:, None, :].expand(B, K, K)
    keep = (torch.ones(B, dtype=torch.int32, device=dev) if mask_b is None
            else mask_b.to(torch.int32))
    hits = torch.zeros((nt, nt), dtype=torch.int32, device=dev)
    hits.index_put_((rows.reshape(-1), cols.reshape(-1)),
                    keep[:, None, None].expand(B, K, K).reshape(-1),
                    accumulate=True)
    return out, hits > 0
