// Per-cell inverse sensor model shared by kernels K1 (sensor_model.cu) and
// K4/K5 (window_fuse.cu), so that every kernel classifies a cell with one
// copy of the code.
//
// Numerics follow the plain PyTorch version (ops/grid.py) operation for
// operation: explicit round-to-nearest intrinsics, IEEE division and
// square root, fmodf plus sign fix for the [0, 2pi) wrap, rintf (half to
// even) for the beam index, and no multiply-add contraction (the sources
// are also built with --fmad=false).

#pragma once

#include <cuda_runtime.h>

namespace sensor_cell {

// Scalars of the sensor model, fixed for a launch.
struct Params {
  float res, ox, oy, inc, angle_min;
  int n_beams, ccw, full_circle;
  float invalid_range, range_min, range_max, max_r, tol, lo_occ, lo_free;
};

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
  if (x < 0.0f) r = __fsub_rn(3.141592653589793f, r);
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

// True when every cell of patch rows [i0, i1] of a patch whose first row
// is row0 lies farther than max range from a pose at world y py, so that
// the sensor model gives 0 there. Conservative: two cells of slack on the
// row gap (occ needs r <= max range, free needs r < carve - tol <= max
// range, rasters need r <= max range).
__device__ __forceinline__ bool rows_out_of_range(float py, int row0, int i0,
                                                  int i1, const Params& q) {
  const float pose_row = (py - q.oy) / q.res - 0.5f - (float)row0;
  const float gap = fmaxf(fmaxf((float)i0 - pose_row,
                                pose_row - (float)(i1 - 1)), 0.0f);
  return gap * q.res > q.max_r + 2.0f * q.res;
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
  const float two_pi = 6.283185307179586f;
  const float y = __fadd_rn(__fmul_rn(__fadd_rn((float)row, 0.5f), q.res),
                            q.oy);
  const float x = __fadd_rn(__fmul_rn(__fadd_rn((float)col, 0.5f), q.res),
                            q.ox);
  const float dx = __fsub_rn(x, px);
  const float dy = __fsub_rn(y, py);
  CellRay c;
  c.r = __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
  float th = __fsub_rn(atan2_poly(dy, dx), yaw);
  if (!q.ccw) th = -th;
  th = __fsub_rn(th, q.angle_min);
  th = fmodf(th, two_pi);
  if (th < 0.0f) th = __fadd_rn(th, two_pi);
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

}  // namespace sensor_cell
