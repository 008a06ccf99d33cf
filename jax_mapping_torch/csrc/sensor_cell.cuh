// Per-cell inverse sensor model and the per-(tile, scan) class shared by
// kernels K1 (sensor_model.cu) and K4/K5 (window_fuse.cu), so that every
// kernel classifies a cell with one copy of the code.
//
// Numerics follow the plain PyTorch version (ops/grid.py) operation for
// operation: explicit round-to-nearest intrinsics, IEEE division and
// square root, the [0, 2pi) wrap of fmodf plus sign fix, rintf (half to
// even) for the beam index, and no multiply-add contraction (the sources
// are also built with --fmad=false).
//
// tile_class decides, once for a rectangle of cells and one scan, whether
// the model is the same constant on every cell of it, before any per-cell
// work. Every margin is conservative: a class may send a tile to the
// per-cell model needlessly, never the other way. The plain mirror is
// ops/sensor_kernel.py::tile_classes_plain, line for line.

#pragma once

#include <cuda_runtime.h>

namespace sensor_cell {

// Scalars of the sensor model, fixed for a launch.
struct Params {
  float res, ox, oy, inc, angle_min;
  int n_beams, ccw, full_circle;
  float invalid_range, range_min, range_max, max_r, tol, lo_occ, lo_free;
  float inv_inc;                        // 1 / inc, for tile_class only
};

constexpr float kPi = 3.141592653589793f;
constexpr float kTwoPi = 6.283185307179586f;
constexpr float kInvTwoPi = 0.15915494309189535f;

// The JAX package's degree-8 polynomial atan2 (ops/trig.py), in its order.
__device__ __forceinline__ float atan2_poly(float y, float x) {
  const float ax = fabsf(x);
  const float ay = fabsf(y);
  const float mx = fmaxf(ax, ay);
  const float mn = fminf(ax, ay);
  const float a = __fdiv_rn(mn, fmaxf(mx, 1e-30f));
  const float s = __fmul_rn(a, a);
  float p = 0.002932762f;
  p = __fadd_rn(__fmul_rn(p, s), -0.01641319f);
  p = __fadd_rn(__fmul_rn(p, s), 0.043278243f);
  p = __fadd_rn(__fmul_rn(p, s), -0.075569004f);
  p = __fadd_rn(__fmul_rn(p, s), 0.10667487f);
  p = __fadd_rn(__fmul_rn(p, s), -0.14211106f);
  p = __fadd_rn(__fmul_rn(p, s), 0.19993694f);
  p = __fadd_rn(__fmul_rn(p, s), -0.33333138f);
  p = __fadd_rn(__fmul_rn(p, s), 1.0f);
  float r = __fmul_rn(p, a);
  if (ay > ax) r = __fsub_rn(1.5707963267948966f, r);
  if (x < 0.0f) r = __fsub_rn(kPi, r);
  return (y < 0.0f) ? -r : r;
}

// Sanitised signed beam-table entry of raw range r at beam j
// (grid.sanitize_ranges semantics): +range for a hit, -carve limit
// otherwise, 0 for padded beams.
__device__ __forceinline__ float beam_entry(float r, int j, const Params& q) {
  const bool in_beam = j < q.n_beams;
  const bool is_zero = r <= 0.0f;
  r = is_zero ? q.invalid_range : r;
  const bool hit =
      !is_zero && r >= q.range_min && r <= q.range_max && in_beam;
  r = in_beam ? r : 0.0f;
  const float carve = fminf(r > 0.0f ? r : 0.0f, q.max_r);
  return hit ? r : -carve;
}

// Offset of grid row `row`'s (column `col`'s) cell centre from the pose,
// as cell_ray computes it. Both are non-decreasing in row (col), so the
// offsets of a rectangle's cells lie between those of its first and last
// row (column) exactly.
__device__ __forceinline__ float centre_dy(int row, float py,
                                           const Params& q) {
  return __fsub_rn(
      __fadd_rn(__fmul_rn(__fadd_rn((float)row, 0.5f), q.res), q.oy), py);
}

__device__ __forceinline__ float centre_dx(int col, float px,
                                           const Params& q) {
  return __fsub_rn(
      __fadd_rn(__fmul_rn(__fadd_rn((float)col, 0.5f), q.res), q.ox), px);
}

// Wrap of a bearing into [0, 2pi) with fmodf's value: for |th| < 2pi
// fmodf returns th itself, and for 2pi <= |th| < 4pi it returns
// th -/+ 2pi, which is exact (Sterbenz), so the software fmodf runs only
// beyond 4pi. At th = -2pi this gives +0 where fmodf gives -0; either
// way the beam is 0.
__device__ __forceinline__ float wrap_two_pi(float th) {
  const float a = fabsf(th);
  if (a >= kTwoPi) {
    if (a < 2.0f * kTwoPi) {
      th = th > 0.0f ? __fsub_rn(th, kTwoPi) : __fadd_rn(th, kTwoPi);
    } else {
      th = fmodf(th, kTwoPi);
    }
  }
  if (th < 0.0f) th = __fadd_rn(th, kTwoPi);
  return th;
}

// Range and beam of the grid cell (row, col) seen from pose (px, py, yaw).
struct CellRay {
  float r;
  int beam;
  bool in_fov;
};

__device__ __forceinline__ CellRay cell_ray(int row, int col, float px,
                                            float py, float yaw,
                                            const Params& q) {
  const float dx = centre_dx(col, px, q);
  const float dy = centre_dy(row, py, q);
  CellRay c;
  c.r = __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
  float th = __fsub_rn(atan2_poly(dy, dx), yaw);
  if (!q.ccw) th = -th;
  th = wrap_two_pi(__fsub_rn(th, q.angle_min));
  const int beam_raw = (int)rintf(__fdiv_rn(th, q.inc));
  int beam = beam_raw % q.n_beams;
  if (beam < 0) beam += q.n_beams;
  c.beam = beam;
  c.in_fov = q.full_circle || beam_raw <= q.n_beams - 1;
  return c;
}

// Log-odds delta of a cell at range r whose beam has table entry enc.
__device__ __forceinline__ float delta_of(const CellRay& c, float enc,
                                          const Params& q) {
  const bool beam_hit = enc > 0.0f && c.in_fov;
  const float carve = enc > 0.0f ? fminf(enc, q.max_r) : -enc;
  const bool is_free =
      (c.r < __fsub_rn(carve, q.tol)) && (c.r > q.range_min) && c.in_fov;
  const bool is_occ =
      beam_hit && (fabsf(__fsub_rn(c.r, enc)) <= q.tol) && (c.r <= q.max_r);
  return is_occ ? q.lo_occ : (is_free ? q.lo_free : 0.0f);
}

// Soft raster weight of the matcher: max(0, 1 - |r - z| / res) on hit
// beams within max range.
__device__ __forceinline__ float raster_of(const CellRay& c, float enc,
                                           const Params& q) {
  const bool keep = enc > 0.0f && c.in_fov && c.r <= q.max_r;
  const float w = fmaxf(
      __fsub_rn(1.0f, __fdiv_rn(fabsf(__fsub_rn(c.r, enc)), q.res)), 0.0f);
  return keep ? w : 0.0f;
}

// ---------------------------------------------------------------------------
// Per-(tile, scan) class
// ---------------------------------------------------------------------------

// kZero: every cell lies beyond max range + 2 cells (the model is 0 there:
// occ and rasters need r <= max range, free needs r < carve - tol <= max
// range). kNoHit: no beam that can reach the tile's cells is a hit near
// their ranges (rasters: |r - z| < res; deltas: |r - z| <= tol) and, for
// deltas, none carves up to them: every cell is 0. kFree (deltas, full
// circle only): every cell is nearer than every such beam's carve limit
// less tol, and beyond range_min, so every cell is exactly lo_free (occ is
// impossible: a hit's z >= carve > r + tol). kPerCell: anything else.
enum TileClass : int { kZero = 0, kNoHit = 1, kFree = 2, kPerCell = 3 };

// Largest |yaw| the class handles; beyond it the tile is kPerCell (the
// bearing interval's float error grows with |yaw|).
constexpr float kMaxYaw = 64.0f;

// Minimum, maximum and any over an aligned group of G neighbouring lanes
// of a warp, whose mask is `mask`, all calling.
template <int G>
__device__ __forceinline__ float group_min(float v, unsigned mask) {
  for (int off = G / 2; off > 0; off >>= 1)
    v = fminf(v, __shfl_xor_sync(mask, v, off));
  return v;
}

template <int G>
__device__ __forceinline__ float group_max(float v, unsigned mask) {
  for (int off = G / 2; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(mask, v, off));
  return v;
}

__device__ __forceinline__ bool group_any(bool v, unsigned mask) {
  return __any_sync(mask, v);
}

// Bearing of corner k (bit 0: last column, bit 1: last row) relative to
// corner 0's bearing a0, in (-pi, pi].
__device__ __forceinline__ float corner_rel(float ak, float a0) {
  float rel = __fsub_rn(ak, a0);
  if (rel > kPi) rel = __fsub_rn(rel, kTwoPi);
  else if (rel < -kPi) rel = __fadd_rn(rel, kTwoPi);
  return rel;
}

// Class of the cells of grid rows [r_lo, r_hi] x cols [c_lo, c_hi]
// (inclusive) for one scan at (px, py, yaw); enc(j) is the scan's beam
// table entry j. An aligned group of G neighbouring lanes of a warp
// (G = 8: K4/K5, a scan per group; G = 32: K1, a tile per warp) computes
// it together with the same arguments, lane = their lane index in the
// warp, and all get the class. Groups of one warp may work on different
// tiles or scans.
//
// The cells' offsets lie in the rectangle of the corner offsets, so the
// float range of every cell lies in [r_min, r_max] computed from the
// nearest and farthest offsets by the same monotone float operations, and
// (the pose lying more than 2 cells outside the rectangle) its bearing in
// the hull of the corners' bearings. The beam set widens that bearing
// interval by 2 beams on each side: the polynomial's error (< 3e-7 rad),
// the float error of the interval (its reciprocal multiplications
// included) and, on a full circle, the wrap's offset n_beams * inc - 2pi
// (< inc / 2) all stay well inside one beam.
template <int G, bool kRaster, class Enc>
__device__ __forceinline__ int tile_class(int r_lo, int r_hi, int c_lo,
                                          int c_hi, float px, float py,
                                          float yaw, const Params& q,
                                          Enc enc, int lane) {
  static_assert(G >= 4 && G <= 32 && (G & (G - 1)) == 0,
                "a group is 4, 8, 16 or 32 aligned lanes");
  const float slack = __fmul_rn(2.0f, q.res);
  const float dya = centre_dy(r_lo, py, q);
  const float dyb = centre_dy(r_hi, py, q);
  const float dxa = centre_dx(c_lo, px, q);
  const float dxb = centre_dx(c_hi, px, q);
  const float nx = (dxa <= 0.0f && dxb >= 0.0f)
                       ? 0.0f : fminf(fabsf(dxa), fabsf(dxb));
  const float ny = (dya <= 0.0f && dyb >= 0.0f)
                       ? 0.0f : fminf(fabsf(dya), fabsf(dyb));
  const float fx = fmaxf(fabsf(dxa), fabsf(dxb));
  const float fy = fmaxf(fabsf(dya), fabsf(dyb));
  const float r_min = __fsqrt_rn(__fadd_rn(__fmul_rn(nx, nx),
                                           __fmul_rn(ny, ny)));
  if (r_min > __fadd_rn(q.max_r, slack)) return kZero;
  // NaN poses and ranges fail these tests and go to the per-cell model.
  if (!(r_min > slack) || !(fabsf(yaw) <= kMaxYaw)) return kPerCell;
  const float r_max = __fsqrt_rn(__fadd_rn(__fmul_rn(fx, fx),
                                           __fmul_rn(fy, fy)));

  // The four corners' bearings relative to corner 0, then their interval.
  const int glane = lane & (G - 1);     // lane within the group
  unsigned mask = 0xffffffffu;
  if constexpr (G < 32) mask = ((1u << G) - 1u) << ((lane & 31) & ~(G - 1));
  const int k = glane & 3;              // corner k on lanes k mod 4
  const float ak = atan2_poly((k & 2) ? dyb : dya, (k & 1) ? dxb : dxa);
  const float a0 = __shfl_sync(mask, ak, (lane & 31) - glane);
  const float lo = group_min<4>(corner_rel(ak, a0), mask);
  const float hi = group_max<4>(corner_rel(ak, a0), mask);
  const float b_lo = __fadd_rn(a0, lo);
  const float b_hi = __fadd_rn(a0, hi);
  float t_lo, t_hi;                     // the interval in the beam frame
  if (q.ccw) {
    t_lo = __fsub_rn(__fsub_rn(b_lo, yaw), q.angle_min);
    t_hi = __fsub_rn(__fsub_rn(b_hi, yaw), q.angle_min);
  } else {
    t_lo = __fsub_rn(-__fsub_rn(b_hi, yaw), q.angle_min);
    t_hi = __fsub_rn(-__fsub_rn(b_lo, yaw), q.angle_min);
  }
  const float turns = floorf(__fmul_rn(t_lo, kInvTwoPi));
  t_lo = __fsub_rn(t_lo, __fmul_rn(turns, kTwoPi));
  t_hi = __fsub_rn(t_hi, __fmul_rn(turns, kTwoPi));
  const int lo_beam = (int)floorf(__fmul_rn(t_lo, q.inv_inc)) - 2;
  const int hi_beam = (int)ceilf(__fmul_rn(t_hi, q.inv_inc)) + 2;
  int j1;                               // raw beams lo_beam..j1
  if (q.full_circle) {
    j1 = min(hi_beam, lo_beam + q.n_beams - 1);
  } else {
    // Without a full circle the wrap is not periodic in the beams: an
    // interval that may cross 0 or 2pi goes to the per-cell model.
    if (lo_beam < 0 || __fmul_rn((float)hi_beam, q.inc) >= kTwoPi)
      return kPerCell;
    j1 = min(hi_beam, q.n_beams - 1);   // beams >= n_beams are out of view
  }

  const float band = kRaster ? q.res : q.tol;
  const float z_lo = __fsub_rn(__fsub_rn(r_min, band), slack);
  const float z_hi = __fadd_rn(__fadd_rn(r_max, band), slack);
  bool near = false;
  float lim_min = __int_as_float(0x7f800000);     // +inf
  float lim_max = -lim_min;
  for (int j = lo_beam + glane; j <= j1; j += G) {
    int m = j % q.n_beams;
    if (m < 0) m += q.n_beams;
    const float e = enc(m);
    near = near || (e > 0.0f && e >= z_lo && e <= z_hi);
    const float carve = e > 0.0f ? fminf(e, q.max_r) : -e;
    const float lim = __fsub_rn(carve, q.tol);
    lim_min = fminf(lim_min, lim);
    lim_max = fmaxf(lim_max, lim);
  }
  near = group_any(near, mask);
  if constexpr (kRaster) {
    return near ? kPerCell : kNoHit;
  } else {
    if (near) return kPerCell;
    lim_min = group_min<G>(lim_min, mask);
    lim_max = group_max<G>(lim_max, mask);
    if (lim_max <= __fsub_rn(r_min, slack)) return kNoHit;
    if (q.full_circle && __fsub_rn(r_min, slack) > q.range_min &&
        __fadd_rn(r_max, slack) < lim_min)
      return kFree;
    return kPerCell;
  }
}

}  // namespace sensor_cell
