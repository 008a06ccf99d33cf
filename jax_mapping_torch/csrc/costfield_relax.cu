// Kernel K3: per-robot min-plus cost-field relaxation.
//
// Replaces the Pallas kernel jax_mapping/ops/costfield.py::_relax_level_pallas.
// n_sweeps Jacobi sweeps over R fields of n x n, field f under blocked mask
// f / group (one mask for all fields, or one a tenant of the megabatch
// for its `group` robots):
//   d'[c] = blocked[c] ? BIG : min(d[c], min_k (d[c + o_k] + w_k))
// over the 8 neighbours o_k with w = 1 (axial) or 1.41421356 (diagonal)
// and BIG = 1e9 shifted in past the border. The first sweep reads `init`
// as given, blocked cells included. Each candidate is one f32 add and the
// minimum is exact in any order, so the result equals the plain PyTorch
// version (ops/costfield.py::_relax_level_xla) exactly.
//
// Bound on an H100: neither bytes nor operations. The fleet's three
// levels (64^2 x 64 sweeps, 128^2 x 16, 256^2 x 16, 8 robots) move 5.6 MB
// and do 0.21 G float operations, 3.2 us at the card's peak rates; but
// every sweep reads the whole previous one, so a level is a chain of
// 2 * iters dependent sweeps, each of which has to hear from the SMs
// that hold its neighbouring rows before it can start.
//
// Design: one launch a level (csrc/cluster_sweep.cuh). Each robot's field
// is a thread-block cluster whose CTAs hold row slabs double-buffered in
// shared memory and send their edge rows straight into the neighbours'
// shared memory (distributed shared memory, st.async onto the receiver's
// mbarrier), so a CTA waits for its two neighbours only and no sweep
// touches global memory. Fields too large for 16 CTAs' shared memory (n
// above about 600) take the second route, two global buffers ping-ponged
// in the 50 MB L2, one launch a sweep. The route is chosen by size, never
// as a fallback, and reported to the caller.

#include "cluster_sweep.cuh"

namespace {

constexpr float kBig = 1e9f;
constexpr float kSq2 = 1.41421356f;
constexpr int kThreads = 256;

// A row's candidates: for the cells above and below it, its centre plus 1
// (u) and its lesser side plus sqrt 2 (v); for its own centre cell, the
// centre (x) and the lesser side plus 1 (w). Rounding is monotone, so
// min(l + w, r + w) == min(l, r) + w exactly, and the cell's minimum over
// these six equals the minimum over its nine candidates.
struct RelaxOp {
  using T = float;
  struct Row {
    float x, u, v, w;
  };
  static __device__ __forceinline__ float fill() { return kBig; }
  static __device__ __forceinline__ Row row(float l, float x, float r) {
    const float s = fminf(l, r);
    return {x, __fadd_rn(x, 1.0f), __fadd_rn(s, kSq2), __fadd_rn(s, 1.0f)};
  }
  static __device__ __forceinline__ float cell(const Row& a, const Row& b,
                                               const Row& c,
                                               uint8_t blocked) {
    const float best = fminf(fminf(fminf(b.x, b.w), fminf(a.u, a.v)),
                             fminf(c.u, c.v));
    return blocked ? kBig : best;
  }
};

__device__ __forceinline__ float relax_cell(const float* __restrict__ d,
                                            int r, int c, int n) {
  float best = d[r * n + c];
#pragma unroll
  for (int dr = -1; dr <= 1; ++dr) {
#pragma unroll
    for (int dc = -1; dc <= 1; ++dc) {
      if (dr == 0 && dc == 0) continue;
      const int rr = r + dr;
      const int cc = c + dc;
      const float v = (rr >= 0 && rr < n && cc >= 0 && cc < n)
                          ? d[rr * n + cc] : kBig;
      const float w = (dr != 0 && dc != 0) ? kSq2 : 1.0f;
      best = fminf(best, __fadd_rn(v, w));
    }
  }
  return best;
}

__global__ void __launch_bounds__(kThreads) relax_sweep_global(
    const float* __restrict__ src, const uint8_t* __restrict__ blocked,
    float* __restrict__ dst, int R, int n, int group) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t nn = (size_t)n * n;
  if (idx >= nn * R) return;
  const int f = (int)(idx / nn);
  const int cell = (int)(idx - (size_t)f * nn);
  const int r = cell / n;
  const int c = cell - r * n;
  dst[idx] = blocked[(size_t)(f / group) * nn + cell]
                 ? kBig : relax_cell(src + (size_t)f * nn, r, c, n);
}

// Slab cells a thread (measured best at the fleet's three levels on the
// H100).
constexpr int kCellsPerThread = 16;

}  // namespace

// blocked: (R / group, n, n) uint8; init, out, scratch: (R, n, n) f32;
// field f sweeps under blocked mask f / group. The route is chosen by size
// (cluster_sweep::plan). info[0] receives the grids launched, info[1] the
// cluster size (0: global route), info[2] the threads a CTA, info[3] the
// clusters the card holds at once.
extern "C" int costfield_relax_launch(const void* blocked, const void* init,
                                      void* out, void* scratch, int R, int n,
                                      int n_sweeps, int group, int* info,
                                      void* stream) {
  info[0] = info[1] = info[2] = info[3] = 0;
  if (group <= 0 || (R > 0 && R % group)) return (int)cudaErrorInvalidValue;
  if (R <= 0 || n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* blk = static_cast<const uint8_t*>(blocked);
  cluster_sweep::Plan p;
  const int rc = cluster_sweep::plan(n, R, kCellsPerThread, &p);
  if (rc != 0) return rc;
  if (p.C > 0) {
    const int err = cluster_sweep::launch<RelaxOp>(
        static_cast<const float*>(init), blk, static_cast<float*>(out), R, n,
        n_sweeps, group, p, &info[3], s);
    if (err == 0) {
      info[0] = 1;
      info[1] = p.C;
      info[2] = p.threads;
    }
    return err;
  }

  const size_t nn = (size_t)n * n;
  if (n_sweeps <= 0) {
    cudaMemcpyAsync(out, init, sizeof(float) * nn * R,
                    cudaMemcpyDeviceToDevice, s);
    return (int)cudaGetLastError();
  }
  float* bufs[2] = {static_cast<float*>(out), static_cast<float*>(scratch)};
  const float* src = static_cast<const float*>(init);
  const unsigned blocks = (unsigned)((nn * R + kThreads - 1) / kThreads);
  info[2] = kThreads;
  // Sweep k (1-based) writes bufs[(n_sweeps - k) % 2]: the last one `out`.
  for (int k = 1; k <= n_sweeps; ++k) {
    float* dst = bufs[(n_sweeps - k) % 2];
    relax_sweep_global<<<blocks, kThreads, 0, s>>>(src, blk, dst, R, n,
                                                   group);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++info[0];
    src = dst;
  }
  return 0;
}
