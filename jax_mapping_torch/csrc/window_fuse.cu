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
// scan) for every cell within range of a scan, against reading B beam
// tables and writing one patch (K5: reading and writing it), so the work
// is bound by operations for any B of interest. Design: one thread owns
// kCellsPerThread cells of the flattened patch and keeps their sums in
// registers; it loops over the scans in b order, which keeps the
// reference kernel's b-order sum bit for bit. The scans' sanitised signed
// beam tables and poses are staged in shared memory a chunk of scans at a
// time (16 x 512 floats = 32 KB at the default config), with a block
// barrier between chunks. A scan whose pose is out of range of every row
// the block owns is skipped for the whole block (block-uniform, exact: it
// would add zeros). The origin is read on the device, clamped like
// jax.lax.dynamic_slice clamps its start, so no host sync is needed.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sensor_cell.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kCellsPerThread = 4;
constexpr int kCellsPerBlock = kThreads * kCellsPerThread;
constexpr int kSmemBudget = 48 * 1024;   // no opt-in above the default
constexpr int kMaxChunk = 16;

template <bool kApply>
__global__ void __launch_bounds__(kThreads) window_kernel(
    const float* __restrict__ ranges, const float* __restrict__ poses, int B,
    const int* __restrict__ origin, float* __restrict__ out, int n_grid,
    int P, int nb_pad, int chunk, float lo, float hi, sensor_cell::Params q) {
  extern __shared__ float smem[];
  float* table = smem;                               // chunk x nb_pad
  float* spose = smem + (size_t)chunk * nb_pad;      // chunk x 3
  int* slive = reinterpret_cast<int*>(spose + 3 * chunk);

  const int hi_start = n_grid - P;
  const int row0 = min(max(origin[0], 0), hi_start);
  const int col0 = min(max(origin[1], 0), hi_start);
  const int ncells = P * P;
  const int base = blockIdx.x * kCellsPerBlock;
  const int last = min(base + kCellsPerBlock, ncells) - 1;
  const int i0 = base / P;
  const int i1 = last / P + 1;                       // rows [i0, i1)

  float acc[kCellsPerThread];
  int ci[kCellsPerThread];
  int cj[kCellsPerThread];
#pragma unroll
  for (int k = 0; k < kCellsPerThread; ++k) {
    const int cell = base + k * kThreads + threadIdx.x;
    acc[k] = 0.0f;
    ci[k] = cell / P;
    cj[k] = cell - ci[k] * P;
  }

  for (int b0 = 0; b0 < B; b0 += chunk) {
    const int n = min(chunk, B - b0);
    __syncthreads();                 // the previous chunk is consumed
    for (int t = threadIdx.x; t < n; t += kThreads) {
      const float* p = poses + 3 * (size_t)(b0 + t);
      spose[3 * t + 0] = p[0];
      spose[3 * t + 1] = p[1];
      spose[3 * t + 2] = p[2];
      slive[t] = !sensor_cell::rows_out_of_range(p[1], row0, i0, i1, q);
    }
    for (int t = threadIdx.x; t < n * nb_pad; t += kThreads) {
      const int s = t / nb_pad;
      const int j = t - s * nb_pad;
      table[t] = sensor_cell::beam_entry(
          ranges[(size_t)(b0 + s) * nb_pad + j], j, q);
    }
    __syncthreads();
    for (int s = 0; s < n; ++s) {
      if (!slive[s]) continue;       // uniform over the block
      const float px = spose[3 * s + 0];
      const float py = spose[3 * s + 1];
      const float yaw = spose[3 * s + 2];
      const float* tb = table + (size_t)s * nb_pad;
#pragma unroll
      for (int k = 0; k < kCellsPerThread; ++k) {
        if (base + k * kThreads + (int)threadIdx.x >= ncells) continue;
        const sensor_cell::CellRay c = sensor_cell::cell_ray(
            row0 + ci[k], col0 + cj[k], px, py, yaw, q);
        acc[k] = __fadd_rn(acc[k], sensor_cell::delta_of(c, tb[c.beam], q));
      }
    }
  }

#pragma unroll
  for (int k = 0; k < kCellsPerThread; ++k) {
    if (base + k * kThreads + (int)threadIdx.x >= ncells) continue;
    if (kApply) {
      float* g = out + (size_t)(row0 + ci[k]) * n_grid + (col0 + cj[k]);
      *g = fminf(fmaxf(__fadd_rn(*g, acc[k]), lo), hi);
    } else {
      out[(size_t)ci[k] * P + cj[k]] = acc[k];
    }
  }
}

template <bool kApply>
int launch(const void* ranges, const void* poses, int B, const void* origin,
           void* out, int n_grid, int P, int nb_pad, float lo, float hi,
           const sensor_cell::Params& q, void* stream) {
  if (P <= 0 || B < 0 || nb_pad <= 0) return (int)cudaErrorInvalidValue;
  const int per_scan = (nb_pad + 4) * (int)sizeof(float);
  const int chunk = max(1, min(kMaxChunk, kSmemBudget / per_scan));
  const size_t smem = (size_t)chunk * per_scan;
  const int blocks = (P * P + kCellsPerBlock - 1) / kCellsPerBlock;
  window_kernel<kApply><<<blocks, kThreads, smem,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ranges), static_cast<const float*>(poses), B,
      static_cast<const int*>(origin), static_cast<float*>(out), n_grid, P,
      nb_pad, chunk, lo, hi, q);
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
                              range_max, max_r, tol, lo_occ, lo_free};
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
                              range_max, max_r, tol, lo_occ, lo_free};
  return launch<true>(ranges, poses, B, origin, grid, n_grid, P, nb_pad, lo,
                      hi, q, stream);
}
