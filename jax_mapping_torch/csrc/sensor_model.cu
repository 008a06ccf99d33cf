// Kernel K1: per-scan inverse sensor model, delta or raster mode.
//
// Replaces the Pallas kernel of jax_mapping/ops/sensor_kernel.py
// (_make_kernel, launched by _per_scan_call for scan_deltas and
// scan_rasters). Output: (B, P, P) f32, one patch per scan at its own
// origin.
//
// Bound on an H100: the output write, P * P * 4 bytes per scan (275 MB for
// the matcher's 168 candidate rasters), since the function's operations
// (~55 per cell within max range) take a third of that time at the f32
// rate. Almost all of the output is a constant: a raster is non-zero only
// within a cell of a hit on the cell's own beam, and a delta is 0 or
// exactly lo_free on most of the patch. So the design decides the constant
// per 16 x 16 tile before any per-cell work: a warp takes a tile, computes
// its class for the scan (sensor_cell.cuh::tile_class: its range interval
// from the corner offsets, its beam set from the corner bearings, a warp
// reduction over the beam table) and then writes either the constant with
// 16-byte stores or, for a kPerCell tile, the per-cell model of every cell
// (the same cell_ray and delta_of / raster_of as the plain version, bit
// for bit). A block of 8 warps covers a 16-row band of one scan's patch
// (or a part of one, when the bands of few scans would leave SMs idle),
// its warps taking the band's tiles in turn, and stages the scan's
// sanitised signed beam table (hit beams store +range, others -carve
// limit) in shared memory once. There is no product, so tensor cores have
// no part here.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sensor_cell.cuh"

namespace {

constexpr int kTile = 16;
constexpr int kWarps = 8;                 // a tile at a time per warp
constexpr int kThreads = 32 * kWarps;
constexpr int kTargetBlocks = 792;        // 6 blocks on each of 132 SMs

template <bool kRaster>
__global__ void __launch_bounds__(kThreads) sensor_model_kernel(
    const float* __restrict__ ranges, const float* __restrict__ poses,
    const int* __restrict__ origins, float* __restrict__ out, int P,
    int nb_pad, int splits, sensor_cell::Params q) {
  extern __shared__ float table[];
  const int b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ntc = (P + kTile - 1) / kTile;
  const int per_block = (ntc + splits - 1) / splits;
  const int tc0 = (blockIdx.x % splits) * per_block;
  const int tc1 = min(tc0 + per_block, ntc);
  const int i0 = (blockIdx.x / splits) * kTile;
  const int i1 = min(i0 + kTile, P) - 1;
  const float px = poses[3 * b + 0];
  const float py = poses[3 * b + 1];
  const float yaw = poses[3 * b + 2];
  const int row0 = origins[2 * b + 0];
  const int col0 = origins[2 * b + 1];

  const float* rb = ranges + (size_t)b * nb_pad;
  for (int j = threadIdx.x; j < nb_pad; j += kThreads)
    table[j] = sensor_cell::beam_entry(rb[j], j, q);
  __syncthreads();

  // Lane l writes columns j0 + 4 (l % 4) .. + 3 of rows l / 4 and
  // l / 4 + 8 of a tile: a warp store covers 8 rows of 64 bytes.
  float* ob = out + (size_t)b * P * P;
  const bool vec = (P & 3) == 0;          // rows start 16-byte aligned
  for (int tc = tc0 + warp; tc < tc1; tc += kWarps) {
    const int j0 = tc * kTile;
    const int j1 = min(j0 + kTile, P) - 1;
    const int cls = sensor_cell::tile_class<32, kRaster>(
        row0 + i0, row0 + i1, col0 + j0, col0 + j1, px, py, yaw, q,
        [&](int m) { return table[m]; }, lane);
    const int j = j0 + 4 * (lane & 3);
    const float fill = cls == sensor_cell::kFree ? q.lo_free : 0.0f;
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      const int i = i0 + 8 * pass + (lane >> 2);
      if (i > i1 || j > j1) continue;
      float v[4] = {fill, fill, fill, fill};
      if (cls == sensor_cell::kPerCell) {
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (j + k > j1) continue;
          const sensor_cell::CellRay c = sensor_cell::cell_ray(
              row0 + i, col0 + j + k, px, py, yaw, q);
          const float enc = table[c.beam];
          v[k] = kRaster ? sensor_cell::raster_of(c, enc, q)
                         : sensor_cell::delta_of(c, enc, q);
        }
      }
      float* dst = ob + (size_t)i * P + j;
      if (vec) {
        *reinterpret_cast<float4*>(dst) =
            make_float4(v[0], v[1], v[2], v[3]);
      } else {
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (j + k <= j1) dst[k] = v[k];
      }
    }
  }
}

}  // namespace

extern "C" int sensor_model_launch(
    int raster, const void* ranges, const void* poses, const void* origins,
    void* out, int B, int P, int nb_pad, int n_beams, float res, float ox,
    float oy, float inc, float angle_min, int ccw, int full_circle,
    float invalid_range, float range_min, float range_max, float max_r,
    float tol, float lo_occ, float lo_free, void* stream) {
  if (B <= 0 || P <= 0) return 0;
  const sensor_cell::Params q{res, ox, oy, inc, angle_min, n_beams, ccw,
                              full_circle, invalid_range, range_min,
                              range_max, max_r, tol, lo_occ, lo_free,
                              1.0f / inc};
  // A block takes a tile-row band of one scan, or a part of one when
  // there are too few bands and scans to fill the card.
  const int nt = (P + kTile - 1) / kTile;
  const int splits = max(1, min((nt + kWarps - 1) / kWarps,
                                (kTargetBlocks + nt * B - 1) / (nt * B)));
  const dim3 grid(nt * splits, B);
  const size_t smem = (size_t)nb_pad * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* rg = static_cast<const float*>(ranges);
  const float* ps = static_cast<const float*>(poses);
  const int* og = static_cast<const int*>(origins);
  float* o = static_cast<float*>(out);
  if (raster) {
    sensor_model_kernel<true><<<grid, kThreads, smem, s>>>(rg, ps, og, o, P,
                                                           nb_pad, splits, q);
  } else {
    sensor_model_kernel<false><<<grid, kThreads, smem, s>>>(
        rg, ps, og, o, P, nb_pad, splits, q);
  }
  return (int)cudaGetLastError();
}
