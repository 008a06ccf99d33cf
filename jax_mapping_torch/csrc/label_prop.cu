// Kernel K2: 8-connected frontier component labels by label propagation.
//
// Replaces the Pallas kernel jax_mapping/ops/frontier.py::_label_prop_pallas.
// Exact integer semantics: from the seed, as given (the linear cell index
// on mask cells and -1 elsewhere when `label_components` makes it),
// exactly n_sweeps Jacobi sweeps, on each of T grids with its own mask, of
//   lab'[c] = mask[c] ? max(lab[c], lab[8 neighbours of c]) : -1
// with -1 shifted in past the border. The labels depend on the fixed
// sweep count, so the sweeps stay Jacobi and are never cut short.
//
// Bound on an H100: neither bytes nor operations. At the default 256 x 256
// clustering grid the function reads 320 KB, writes 256 KB and does 29 M
// integer operations over its 49 sweeps, under a microsecond at the
// card's rates; but every sweep reads the whole previous one, so the call
// is a chain of 49 dependent sweeps, each of which has to hear from the
// SMs that hold its neighbouring rows before it can start.
//
// Design: one launch a call (csrc/cluster_sweep.cuh). The labels are one
// thread-block cluster whose CTAs hold row slabs double-buffered in
// shared memory (at 256^2, 256 KB of int32 is more than one block's
// 227 KB) and send their edge rows straight into the neighbours' shared
// memory (distributed shared memory, st.async onto the receiver's
// mbarrier), so a CTA waits for its two neighbours only. Grids too large
// for 16 CTAs' shared memory (n above about 600, e.g. cluster_downsample
// = 1 on a 4096^2 map gives 1024^2) take the second route: two global
// buffers ping-ponged in L2, one launch a sweep. The route is chosen by
// size, never as a fallback, and reported to the caller. A batch of T
// grids (the tenant megabatch's, one a mission) is one launch on either
// route: T clusters, or T grids a sweep.

#include "cluster_sweep.cuh"

namespace {

constexpr int kThreads = 256;

// A row's share of the 3 x 3 maximum is the maximum of its three values
// (one three-input max instruction on Hopper).
struct LabelOp {
  using T = int;
  struct Row {
    int h;
  };
  static __device__ __forceinline__ int fill() { return -1; }
  static __device__ __forceinline__ Row row(int l, int x, int r) {
    return {__vimax3_s32(l, x, r)};
  }
  static __device__ __forceinline__ int cell(const Row& a, const Row& b,
                                             const Row& c, uint8_t on_mask) {
    return on_mask ? __vimax3_s32(a.h, b.h, c.h) : -1;
  }
};

__global__ void __launch_bounds__(kThreads) label_sweep_kernel(
    const int* __restrict__ src, const uint8_t* __restrict__ mask,
    int* __restrict__ dst, int T, int n) {
  const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  const size_t nn = (size_t)n * n;
  if (idx >= nn * T) return;
  if (!mask[idx]) {
    dst[idx] = -1;
    return;
  }
  const int cell = (int)(idx % nn);
  const int r = cell / n;
  const int c = cell - r * n;
  src += idx - cell;                     // this grid's labels
  int best = src[cell];
  for (int dr = -1; dr <= 1; ++dr) {
    for (int dc = -1; dc <= 1; ++dc) {
      if (dr == 0 && dc == 0) continue;
      const int rr = r + dr;
      const int cc = c + dc;
      const int v = (rr >= 0 && rr < n && cc >= 0 && cc < n)
                        ? src[rr * n + cc] : -1;
      best = max(best, v);
    }
  }
  dst[idx] = best;
}

// Slab cells a thread (measured best at the fleet's 256^2 on the H100).
constexpr int kCellsPerThread = 8;

}  // namespace

// mask: (T, n, n) uint8; seed, out, scratch: (T, n, n) int32, grid t
// sweeping under mask t. The route is chosen by size
// (cluster_sweep::plan). info[0] receives the grids launched, info[1] the
// cluster size (0: global route), info[2] the threads a CTA, info[3] the
// clusters the card holds at once.
extern "C" int label_prop_launch(const void* mask, const void* seed,
                                 void* out, void* scratch, int T, int n,
                                 int n_sweeps, int* info, void* stream) {
  info[0] = info[1] = info[2] = info[3] = 0;
  if (T <= 0 || n <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* m = static_cast<const uint8_t*>(mask);
  cluster_sweep::Plan p;
  const int rc = cluster_sweep::plan(n, T, kCellsPerThread, &p);
  if (rc != 0) return rc;
  if (p.C > 0) {
    const int err = cluster_sweep::launch<LabelOp>(
        static_cast<const int*>(seed), m, static_cast<int*>(out), T, n,
        n_sweeps, 1, p, &info[3], s);
    if (err == 0) {
      info[0] = 1;
      info[1] = p.C;
      info[2] = p.threads;
    }
    return err;
  }

  const size_t cells = (size_t)T * n * n;
  if (n_sweeps <= 0) {
    cudaMemcpyAsync(out, seed, sizeof(int) * cells, cudaMemcpyDeviceToDevice,
                    s);
    return (int)cudaGetLastError();
  }
  const unsigned blocks = (unsigned)((cells + kThreads - 1) / kThreads);
  int* bufs[2] = {static_cast<int*>(out), static_cast<int*>(scratch)};
  info[2] = kThreads;
  // Sweep k (1-based) writes bufs[(n_sweeps - k) % 2], so sweep n_sweeps
  // writes `out`.
  const int* src = static_cast<const int*>(seed);
  for (int k = 1; k <= n_sweeps; ++k) {
    int* dst = bufs[(n_sweeps - k) % 2];
    label_sweep_kernel<<<blocks, kThreads, 0, s>>>(src, m, dst, T, n);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    ++info[0];
    src = dst;
  }
  return 0;
}
