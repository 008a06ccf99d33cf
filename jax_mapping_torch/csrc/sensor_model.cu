// Kernel K1: per-scan inverse sensor model, delta or raster mode.
//
// Replaces the Pallas kernel of jax_mapping/ops/sensor_kernel.py
// (_make_kernel, launched by _per_scan_call for scan_deltas and
// scan_rasters). Output: (B, P, P) f32, one patch per scan at its own
// origin.
//
// Bound on an H100: the output write (P*P*4 bytes per scan) against
// ~60 float operations per cell. Design: grid (row bands, scans); each
// block loads its scan's sanitised signed beam table into shared memory
// (hit beams store +range, others -carve limit), then each thread
// evaluates cells of the band with one table lookup. A band whose row
// gap to the pose exceeds max range + 2 cells can hold no non-zero cell
// (occ needs r <= max range, free needs r < carve - tol <= max range,
// rasters need r <= max range), so it writes zeros and returns.
//
// The per-cell model (bearing polynomial, wrap, beam rounding,
// classification) lives in sensor_cell.cuh, shared with window_fuse.cu; it
// agrees bit for bit with the plain version.

#include <cuda_runtime.h>
#include <stdint.h>

#include "sensor_cell.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBand = 4;

template <bool kRaster>
__global__ void __launch_bounds__(kThreads) sensor_model_kernel(
    const float* __restrict__ ranges, const float* __restrict__ poses,
    const int* __restrict__ origins, float* __restrict__ out, int P,
    int nb_pad, sensor_cell::Params q) {
  extern __shared__ float table[];
  const int b = blockIdx.y;
  const int i0 = blockIdx.x * kRowsPerBand;
  const int i1 = min(i0 + kRowsPerBand, P);
  const float px = poses[3 * b + 0];
  const float py = poses[3 * b + 1];
  const float yaw = poses[3 * b + 2];
  const int row0 = origins[2 * b + 0];
  const int col0 = origins[2 * b + 1];
  float* outb = out + (size_t)b * P * P;
  const int ncell = (i1 - i0) * P;

  if (sensor_cell::rows_out_of_range(py, row0, i0, i1, q)) {
    for (int t = threadIdx.x; t < ncell; t += blockDim.x)
      outb[(size_t)i0 * P + t] = 0.0f;
    return;
  }

  const float* rb = ranges + (size_t)b * nb_pad;
  for (int j = threadIdx.x; j < nb_pad; j += blockDim.x)
    table[j] = sensor_cell::beam_entry(rb[j], j, q);
  __syncthreads();

  for (int t = threadIdx.x; t < ncell; t += blockDim.x) {
    const int i = i0 + t / P;
    const int j = t - (t / P) * P;
    const sensor_cell::CellRay c =
        sensor_cell::cell_ray(row0 + i, col0 + j, px, py, yaw, q);
    const float enc = table[c.beam];
    outb[(size_t)i * P + j] = kRaster ? sensor_cell::raster_of(c, enc, q)
                                      : sensor_cell::delta_of(c, enc, q);
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
                              range_max, max_r, tol, lo_occ, lo_free};
  const dim3 grid((P + kRowsPerBand - 1) / kRowsPerBand, B);
  const size_t smem = (size_t)nb_pad * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* rg = static_cast<const float*>(ranges);
  const float* ps = static_cast<const float*>(poses);
  const int* og = static_cast<const int*>(origins);
  float* o = static_cast<float*>(out);
  if (raster) {
    sensor_model_kernel<true><<<grid, kThreads, smem, s>>>(rg, ps, og, o, P,
                                                           nb_pad, q);
  } else {
    sensor_model_kernel<false><<<grid, kThreads, smem, s>>>(rg, ps, og, o, P,
                                                            nb_pad, q);
  }
  return (int)cudaGetLastError();
}
