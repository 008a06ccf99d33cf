// Kernels K4 and K5: the shared-patch scan window.
//
// K4 (window_delta_launch) replaces the accumulating Pallas kernel of
// jax_mapping/ops/sensor_kernel.py::window_delta (_make_kernel with
// accumulate=True): out (P, P) = sum over b of scan b's log-odds delta, all
// B scans on one patch at a shared origin.
// K5 (window_apply_launch) replaces jax_mapping/ops/fuse_kernel.py::
// _window_apply_pallas (_make_kernel with fused_apply=True):
// grid[r0:r0+P, c0:c0+P] = clip(grid patch + sum_b delta_b, lo, hi),
// computed in place on the grid through its row stride, with one
// patch + acc addition. The patch is never copied out and back.
//
// Bound on an H100: the classification, ~55 float operations per (cell,
// scan) for every cell within max range of a scan, against reading B beam
// tables and writing one patch (K5: reading and writing it), so the work
// is bound by operations for any B of interest. Most (cell, scan) pairs
// add a constant: 0 beyond the scan's range or behind its walls, exactly
// lo_free in the open space it carves. So the design classifies each
// (16 x 16 tile, scan) pair once per block (sensor_cell.cuh::tile_class,
// 8 lanes per scan, so that a window of 16 scans takes one round, the beam
// table read through the cache) into shared memory with the poses; warp 0
// lists the scans that add anything, in b order, and each thread walks
// that list for its two cells: a kZero or kNoHit scan is left out (exact:
// an accumulator is never -0, so adding +0 changes nothing), a kFree scan
// adds lo_free with one rounding, as the per-cell delta would, and only a
// kPerCell scan runs the per-cell model. The b-order sum in registers and
// the single patch + acc addition keep the reference's sums bit for bit;
// 1600 blocks of 128 threads at the default config keep several blocks on
// every SM. The origin is read on the device, clamped like
// jax.lax.dynamic_slice clamps its start, so no host sync is needed. There
// is no product, so tensor cores have no part.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sensor_cell.cuh"

namespace {

constexpr int kTile = 16;
constexpr int kThreads = 128;             // two cells of the tile each
constexpr int kMaxB = 512;                // the wrappers' _MAX_B_PER_CALL
constexpr int kGroup = 8;                 // lanes that classify one scan

template <bool kApply>
__global__ void __launch_bounds__(kThreads) window_kernel(
    const float* __restrict__ ranges, const float* __restrict__ poses, int B,
    const int* __restrict__ origin, float* __restrict__ out, int n_grid,
    int P, int nb_pad, float lo, float hi, sensor_cell::Params q) {
  __shared__ unsigned char scls[kMaxB];
  __shared__ float spose[3 * kMaxB];
  __shared__ short slist[kMaxB];          // scans that add, in b order
  __shared__ int n_live;

  const int hi_start = n_grid - P;
  const int row0 = min(max(origin[0], 0), hi_start);
  const int col0 = min(max(origin[1], 0), hi_start);
  const int ntc = (P + kTile - 1) / kTile;
  const int i0 = (blockIdx.x / ntc) * kTile;
  const int j0 = (blockIdx.x % ntc) * kTile;
  const int i1 = min(i0 + kTile, P) - 1;
  const int j1 = min(j0 + kTile, P) - 1;

  // Each group of kGroup lanes classifies the tile for one scan at a time
  // (16 scans a round); then warp 0 lists the scans that add anything, in
  // b order.
  const int lane = threadIdx.x & 31;
  for (int s = threadIdx.x / kGroup; s < B; s += kThreads / kGroup) {
    const float* rb = ranges + (size_t)s * nb_pad;
    const float px = poses[3 * s + 0];
    const float py = poses[3 * s + 1];
    const float yaw = poses[3 * s + 2];
    const int cls = sensor_cell::tile_class<kGroup, false>(
        row0 + i0, row0 + i1, col0 + j0, col0 + j1, px, py, yaw, q,
        [&](int m) { return sensor_cell::beam_entry(__ldg(rb + m), m, q); },
        lane);
    if ((lane & (kGroup - 1)) == 0) {
      scls[s] = (unsigned char)cls;
      spose[3 * s + 0] = px;
      spose[3 * s + 1] = py;
      spose[3 * s + 2] = yaw;
    }
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    int n = 0;
    for (int s0 = 0; s0 < B; s0 += 32) {
      const int s = s0 + lane;
      const bool live = s < B && scls[s] >= sensor_cell::kFree;
      const unsigned ballot = __ballot_sync(0xffffffffu, live);
      if (live) slist[n + __popc(ballot & ((1u << lane) - 1u))] = s;
      n += __popc(ballot);
    }
    if (lane == 0) n_live = n;
  }
  __syncthreads();

  const int j = j0 + (threadIdx.x & 15);
  int ci[2];
  bool live[2];
  float acc[2];
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    ci[k] = i0 + (threadIdx.x >> 4) + 8 * k;
    live[k] = ci[k] <= i1 && j <= j1;
    acc[k] = 0.0f;
  }
  for (int t = 0; t < n_live; ++t) {
    const int s = slist[t];               // uniform over the block
    if (scls[s] == sensor_cell::kFree) {
#pragma unroll
      for (int k = 0; k < 2; ++k) acc[k] = __fadd_rn(acc[k], q.lo_free);
      continue;
    }
    const float px = spose[3 * s + 0];
    const float py = spose[3 * s + 1];
    const float yaw = spose[3 * s + 2];
    const float* rb = ranges + (size_t)s * nb_pad;
#pragma unroll
    for (int k = 0; k < 2; ++k) {
      if (!live[k]) continue;
      const sensor_cell::CellRay c =
          sensor_cell::cell_ray(row0 + ci[k], col0 + j, px, py, yaw, q);
      const float enc = sensor_cell::beam_entry(__ldg(rb + c.beam), c.beam,
                                                q);
      acc[k] = __fadd_rn(acc[k], sensor_cell::delta_of(c, enc, q));
    }
  }

#pragma unroll
  for (int k = 0; k < 2; ++k) {
    if (!live[k]) continue;
    if (kApply) {
      float* g = out + (size_t)(row0 + ci[k]) * n_grid + (col0 + j);
      *g = fminf(fmaxf(__fadd_rn(*g, acc[k]), lo), hi);
    } else {
      out[(size_t)ci[k] * P + j] = acc[k];
    }
  }
}

template <bool kApply>
int launch(const void* ranges, const void* poses, int B, const void* origin,
           void* out, int n_grid, int P, int nb_pad, float lo, float hi,
           const sensor_cell::Params& q, void* stream) {
  if (P <= 0 || B < 0 || B > kMaxB || nb_pad <= 0)
    return (int)cudaErrorInvalidValue;
  const int ntc = (P + kTile - 1) / kTile;
  window_kernel<kApply><<<ntc * ntc, kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ranges), static_cast<const float*>(poses), B,
      static_cast<const int*>(origin), static_cast<float*>(out), n_grid, P,
      nb_pad, lo, hi, q);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int window_delta_launch(
    const void* ranges, const void* poses, int B, const void* origin,
    void* out, int n_grid, int P, int nb_pad, int n_beams, float res,
    float ox, float oy, float inc, float angle_min, int ccw, int full_circle,
    float invalid_range, float range_min, float range_max, float max_r,
    float tol, float lo_occ, float lo_free, void* stream) {
  const sensor_cell::Params q{res, ox, oy, inc, angle_min, n_beams, ccw,
                              full_circle, invalid_range, range_min,
                              range_max, max_r, tol, lo_occ, lo_free,
                              1.0f / inc};
  return launch<false>(ranges, poses, B, origin, out, n_grid, P, nb_pad,
                       0.0f, 0.0f, q, stream);
}

extern "C" int window_apply_launch(
    const void* ranges, const void* poses, int B, const void* origin,
    void* grid, int n_grid, int P, int nb_pad, int n_beams, float res,
    float ox, float oy, float inc, float angle_min, int ccw, int full_circle,
    float invalid_range, float range_min, float range_max, float max_r,
    float tol, float lo_occ, float lo_free, float lo, float hi,
    void* stream) {
  const sensor_cell::Params q{res, ox, oy, inc, angle_min, n_beams, ccw,
                              full_circle, invalid_range, range_min,
                              range_max, max_r, tol, lo_occ, lo_free,
                              1.0f / inc};
  return launch<true>(ranges, poses, B, origin, grid, n_grid, P, nb_pad, lo,
                      hi, q, stream);
}
