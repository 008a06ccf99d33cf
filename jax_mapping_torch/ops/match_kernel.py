"""Kernel K8: the matcher's raster-window correlations on Hopper.

Replaces no Pallas kernel: the JAX package's matcher scores its windows
with XLA (`ops/scan_match.py::_conv_scores_grid`, a grouped 1-D
convolution whose channels are patch rows, and `_bnb_scores`, slice
gathers under an einsum). CUDA source: `csrc/match_correlate.cu`. Every
score is

    <rasters[r, a], field[r, y0 : y0 + P, x0 : x0 + P]> / mass_ref[r]

with window starts clamped as jax.lax.dynamic_slice clamps them:

* `window_scores`, dense: each row's A rasters against n_out rows of
  starts min(my * stride, H - P) by the convolution's L = (W - P) //
  stride + 1 columns mx * stride; (R, A, n_out, L). The matcher's top
  bound, fine angles, level-1 covariance surface and exhaustive sweep.
* `candidate_scores`, a candidate list: row r's K candidates (a_k, oy_k,
  ox_k), starts clamped into [0, H - P] and [0, W - P]; (R, K). Every
  level of the branch-and-bound descent.

What bounds it on an H100: reading the rasters once, and the fields. The
products are few (a raster is K1's hit band, zero on nearly every cell),
and the shape, a few outputs a raster against a P x P reduction, tiles
badly as a GEMM (M = A, N = the windows, K = P * P = 409,600 walked
serially by a handful of tiles). So K8 splits the reduction: a warp
takes one 32 x 32 tile of a raster, skips it if all its cells are zero,
and otherwise sums each window over the tile's non-zero cells (a column
a lane, down the rows, then a fixed butterfly over the lanes); a second
grid adds a window's tile partials in a fixed order and divides by the
mass. Every sum's order depends on P alone, never on R, A, K or which
rows share a launch: a tenant megabatch's rows are scored in one launch
and each lane equals its solo call bit for bit, and a candidate's score
equals the dense score at the same start. All products are >= 0, so the
zeros left out change no bit. f32 products and sums, one rounding each.

Two grids a call (`LAUNCHES["match_correlate"]` counts both). On a CPU
tensor the wrappers run the plain versions (`window_scores_plain`, the
grouped `conv1d`; `candidate_scores_plain`, chunked gathers and an
einsum), which sum in another order; on a CUDA tensor they launch K8 or
raise.
"""

from __future__ import annotations

import torch
import torch.nn.functional as Fn

from jax_mapping_torch.obs import ledger
from jax_mapping_torch.ops import _cuda

#: Raster cells a side of K8's tiles (csrc/match_correlate.cu kTile).
TILE = 32

#: Candidate windows gathered per step of `candidate_scores_plain` (bounds
#: its transient memory to about this many P x P float windows per row).
_PLAIN_CHUNK = 16


def n_columns(fpad: torch.Tensor, P: int, stride: int) -> int:
    """L, the window columns of a dense call: the convolution's outputs."""
    return (fpad.shape[-1] - P) // stride + 1


def window_scores_plain(fpad: torch.Tensor, rasters: torch.Tensor,
                        mass_ref: torch.Tensor, n_out: int,
                        stride: int) -> torch.Tensor:
    """Plain PyTorch version of K8's dense mode: a grouped 1-D convolution
    whose channels are patch rows, one window of the field per row of
    starts."""
    R, A, P, _ = rasters.shape
    H, W = fpad.shape[-2], fpad.shape[-1]
    dev = fpad.device
    starts = torch.clamp_max(torch.arange(n_out, device=dev) * stride, H - P)
    rows = starts[:, None] + torch.arange(P, device=dev)         # (n_out, P)
    windows = fpad[:, rows, :]                                  # (R, n, P, W)
    windows = windows.permute(1, 0, 2, 3).reshape(n_out, R * P, W)
    out = Fn.conv1d(windows, rasters.reshape(R * A, P, P), stride=stride,
                    groups=R)                                   # (n, R*A, L)
    out = out.reshape(n_out, R, A, -1).permute(1, 2, 0, 3)
    return out / mass_ref[:, None, None, None]


def candidate_scores_plain(lvl: torch.Tensor, rasters: torch.Tensor,
                           a_idx: torch.Tensor, oy: torch.Tensor,
                           ox: torch.Tensor,
                           mass_ref: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of K8's candidate mode: each candidate's
    raster and field window gathered, `_PLAIN_CHUNK` at a time, under an
    einsum."""
    R, _, P, _ = rasters.shape
    H, W = lvl.shape[-2], lvl.shape[-1]
    dev = lvl.device
    K = a_idx.shape[1]
    ar = torch.arange(P, device=dev)
    rr = torch.arange(R, device=dev)[:, None]
    out = []
    for s in range(0, K, _PLAIN_CHUNK):
        e = min(K, s + _PLAIN_CHUNK)
        y0 = oy[:, s:e].clamp(0, H - P)
        x0 = ox[:, s:e].clamp(0, W - P)
        rows = (y0[..., None] + ar)[..., :, None]               # (R,k,P,1)
        cols = (x0[..., None] + ar)[..., None, :]               # (R,k,1,P)
        sl = lvl[rr[..., None, None], rows, cols]               # (R,k,P,P)
        ra = rasters[rr, a_idx[:, s:e]]                         # (R,k,P,P)
        out.append(torch.einsum("rkij,rkij->rk", sl, ra))
    return torch.cat(out, dim=1) / mass_ref[:, None]


def _check(field, rasters, mass_ref):
    R, A, P, _ = rasters.shape
    _cuda.check_cuda(rasters, "rasters", torch.float32, (R, A, P, P))
    _cuda.check_cuda(field, "field", torch.float32)
    _cuda.check_cuda(mass_ref, "mass_ref", torch.float32, (R,))
    if field.dim() != 3 or field.shape[0] != R \
            or min(field.shape[1], field.shape[2]) < P:
        raise ValueError(f"field: expected ({R}, >= {P}, >= {P}), got "
                         f"{tuple(field.shape)}")


def _partials(rows: int, P: int, dev) -> torch.Tensor:
    n = -(-P // TILE)
    return torch.empty((rows, n * n), dtype=torch.float32, device=dev)


def window_scores(fpad: torch.Tensor, rasters: torch.Tensor,
                  mass_ref: torch.Tensor, n_out: int,
                  stride: int) -> torch.Tensor:
    """(R, A, n_out, L) scores of (R, A, P, P) rasters against an already
    padded (R, H, W) field at n_out rows of starts min(my * stride, H - P)
    and L columns mx * stride (`n_columns`)."""
    if fpad.device.type == "cpu":
        return window_scores_plain(fpad, rasters, mass_ref, n_out, stride)
    _check(fpad, rasters, mass_ref)
    R, A, P, _ = rasters.shape
    H, W = fpad.shape[-2], fpad.shape[-1]
    L = n_columns(fpad, P, stride)
    out = torch.empty((R, A, n_out, L), dtype=torch.float32,
                      device=fpad.device)
    if out.numel() == 0:
        return out
    partial = _partials(out.numel(), P, fpad.device)
    _cuda.call("match_correlate", _cuda.ptr(fpad), _cuda.ptr(rasters),
               _cuda.ptr(mass_ref), _cuda.ptr(partial), _cuda.ptr(out), R, A,
               P, H, W, n_out, L, stride,
               entry="match_correlate_dense_launch")
    _cuda.count_launch("match_correlate", 2)
    _cuda.note_cost("match_correlate", lambda: ledger.match_correlate_cost(
        rasters, fpad, out.numel()))
    return out


def candidate_scores(lvl: torch.Tensor, rasters: torch.Tensor,
                     a_idx: torch.Tensor, oy: torch.Tensor, ox: torch.Tensor,
                     mass_ref: torch.Tensor) -> torch.Tensor:
    """(R, K) scores of row r's candidates: raster a_idx[r, k] (in [0, A))
    against the (R, H, W) field `lvl` at (oy[r, k], ox[r, k]), each start
    clamped into the field."""
    if lvl.device.type == "cpu":
        return candidate_scores_plain(lvl, rasters, a_idx, oy, ox, mass_ref)
    _check(lvl, rasters, mass_ref)
    R, A, P, _ = rasters.shape
    K = a_idx.shape[1]
    idx = [x.to(torch.int64).contiguous() for x in (a_idx, oy, ox)]
    for name, x in zip(("a_idx", "oy", "ox"), idx):
        _cuda.check_cuda(x, name, torch.int64, (R, K))
    out = torch.empty((R, K), dtype=torch.float32, device=lvl.device)
    if out.numel() == 0:
        return out
    partial = _partials(R * K, P, lvl.device)
    _cuda.call("match_correlate", _cuda.ptr(lvl), _cuda.ptr(rasters),
               *(_cuda.ptr(x) for x in idx), _cuda.ptr(mass_ref),
               _cuda.ptr(partial), _cuda.ptr(out), R, A, K, P,
               lvl.shape[-2], lvl.shape[-1],
               entry="match_correlate_list_launch")
    _cuda.count_launch("match_correlate", 2)
    _cuda.note_cost("match_correlate", lambda: ledger.match_correlate_cost(
        rasters, lvl, R * K, index_bytes=3 * 8 * R * K))
    return out
