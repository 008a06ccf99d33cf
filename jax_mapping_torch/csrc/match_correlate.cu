// Kernel K8: the matcher's raster-window correlations.
//
// Replaces no Pallas kernel: the JAX package scores the matcher's windows
// with XLA (jax_mapping/ops/scan_match.py::_conv_scores_grid, a grouped
// 1-D convolution whose channels are patch rows, and _bnb_scores, slice
// gathers under an einsum). Every score is
//   score = <rasters[r, a], field[r, y0 : y0 + P, x0 : x0 + P]> / mass[r]
// over a task's window starts:
//   * dense (match_correlate_dense_launch): task (r, a) scores n_out rows
//     by L columns of starts, y0 = min(my * stride, H - P) (clamped as
//     jax.lax.dynamic_slice clamps) and x0 = mx * stride, L being the
//     convolution's (W - P) / stride + 1;
//   * a candidate list (match_correlate_list_launch): task (r, k) scores
//     raster a_k at (y0, x0) = (oy_k, ox_k), each clamped into [0, H - P]
//     and [0, W - P].
//
// Bound on an H100: reading the rasters, once (R * A * P * P * 4 bytes;
// 275 MB for the fine stage's 168 rasters at P = 640), and the fields. The
// products are few: a raster is K1's hit band, non-zero within a cell of
// a beam's hit, so nearly every cell is zero. The shape is a few outputs
// a raster against a P * P reduction, which a GEMM tiles badly, so the
// design splits the reduction instead: a warp takes one 32 x 32 tile of a
// task's raster, keeps it in registers (a column a lane), and decides at
// once whether the tile has a non-zero cell; an all-zero tile writes +0
// for every window and reads no field. Otherwise, for each of the task's
// windows, a lane sums its column down the tile's rows, reading the field
// only where its raster cell is non-zero, and the warp adds its 32
// columns in a fixed butterfly: one partial a (task, window, tile). A
// second grid adds a window's tile partials in a fixed order (lane l the
// tiles l, l + 32, ... in turn, then the butterfly) and divides by the
// mass once. No float atomics.
//
// The order of every sum depends on P and the tile shape alone, never on
// R, A, K or which rows share a launch, so a row scored in a batch equals
// the same row scored alone, bit for bit, and a candidate's score equals
// the dense score at the same start. Every product is >= 0 (rasters and
// fields are), so leaving out a zero product, or a tile of them, adds
// nothing: the skipped sums equal the full ones bit for bit. f32 products
// and sums, one rounding each (__fmul_rn, __fadd_rn; --fmad=false).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;                 // raster cells a side of a tile
constexpr int kWarps = 8;                 // warps a block
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kFull = 0xffffffffu;

struct Geometry {
  int P, H, W;        // raster side; field rows and columns
  int A;              // rasters a row
  int per_row;        // tasks a row: A (dense) or K (list)
  int ntx, n_tiles;   // tiles a side, tiles a raster
  int n_out, L, stride;  // dense: window rows, columns, stride
};

__device__ __forceinline__ float butterfly_sum(float v) {
#pragma unroll
  for (int m = 16; m >= 1; m >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(kFull, v, m));
  return v;
}

// Pass 1: partial[(task * S + s) * n_tiles + t] for window s of the task
// over tile t, a warp a tile.
template <bool kDense>
__global__ void __launch_bounds__(kThreads) correlate_tiles_k8(
    const float* __restrict__ field, const float* __restrict__ rasters,
    const long long* __restrict__ cand_a, const long long* __restrict__ cand_y,
    const long long* __restrict__ cand_x, float* __restrict__ partial,
    Geometry g) {
  const int lane = threadIdx.x & 31;
  const int t = blockIdx.y * kWarps + (threadIdx.x >> 5);
  if (t >= g.n_tiles) return;                       // uniform over the warp
  const long long task = blockIdx.x;
  const int r = (int)(task / g.per_row);
  int a, S, y0 = 0, x0 = 0;
  if (kDense) {
    a = (int)(task % g.per_row);
    S = g.n_out * g.L;
  } else {
    a = (int)cand_a[task];                 // in [0, A): a top-k index
    y0 = (int)min(max(cand_y[task], 0LL), (long long)(g.H - g.P));
    x0 = (int)min(max(cand_x[task], 0LL), (long long)(g.W - g.P));
    S = 1;
  }
  const int i0 = (t / g.ntx) * kTile;
  const int rows = min(kTile, g.P - i0);
  const int col = (t % g.ntx) * kTile + lane;
  const bool col_ok = col < g.P;
  const float* rp = rasters + ((size_t)r * g.A + a) * g.P * g.P
                    + (size_t)i0 * g.P + col;
  float rv[kTile];
  bool nz = false;
#pragma unroll
  for (int i = 0; i < kTile; ++i) {
    rv[i] = (col_ok && i < rows) ? __ldg(rp + (size_t)i * g.P) : 0.0f;
    nz = nz || rv[i] != 0.0f;
  }
  float* out = partial + (size_t)task * S * g.n_tiles + t;
  if (!__any_sync(kFull, nz)) {
    for (int s = lane; s < S; s += 32) out[(size_t)s * g.n_tiles] = 0.0f;
    return;
  }
  const float* fr = field + (size_t)r * g.H * g.W;
  for (int s = 0; s < S; ++s) {
    if (kDense) {
      y0 = min((s / g.L) * g.stride, g.H - g.P);
      x0 = (s % g.L) * g.stride;
    }
    const float* fp = fr + (size_t)(y0 + i0) * g.W + x0 + col;
    float acc = 0.0f;
#pragma unroll
    for (int i = 0; i < kTile; ++i)
      if (rv[i] != 0.0f)
        acc = __fadd_rn(acc, __fmul_rn(rv[i], __ldg(fp + (size_t)i * g.W)));
    acc = butterfly_sum(acc);
    if (lane == 0) out[(size_t)s * g.n_tiles] = acc;
  }
}

// Pass 2: out[o] = (sum over t of partial[o * n_tiles + t]) / mass[row],
// a warp an output.
__global__ void __launch_bounds__(kThreads) correlate_sum_k8(
    const float* __restrict__ partial, const float* __restrict__ mass,
    float* __restrict__ out, long long n_outputs, int outputs_per_row,
    int n_tiles) {
  const int lane = threadIdx.x & 31;
  const long long o = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (o >= n_outputs) return;
  const float* p = partial + (size_t)o * n_tiles;
  float v = 0.0f;
  for (int t = lane; t < n_tiles; t += 32) v = __fadd_rn(v, __ldg(p + t));
  v = butterfly_sum(v);
  if (lane == 0) out[o] = __fdiv_rn(v, __ldg(mass + o / outputs_per_row));
}

template <bool kDense>
int launch(const void* field, const void* rasters, const void* cand_a,
           const void* cand_y, const void* cand_x, const void* mass,
           void* partial, void* out, int R, Geometry g, void* stream) {
  if (g.P <= 0 || g.H < g.P || g.W < g.P || g.A <= 0 || R < 0 ||
      g.per_row < 0 || (kDense && (g.n_out <= 0 || g.L <= 0 ||
                                   g.stride <= 0)))
    return (int)cudaErrorInvalidValue;
  g.ntx = (g.P + kTile - 1) / kTile;
  g.n_tiles = g.ntx * g.ntx;
  const long long n_tasks = (long long)R * g.per_row;
  if (n_tasks == 0) return 0;
  const int ty = (g.n_tiles + kWarps - 1) / kWarps;
  if (n_tasks > 0x7fffffffLL || ty > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  correlate_tiles_k8<kDense><<<dim3((unsigned)n_tasks, ty), kThreads, 0, s>>>(
      static_cast<const float*>(field), static_cast<const float*>(rasters),
      static_cast<const long long*>(cand_a),
      static_cast<const long long*>(cand_y),
      static_cast<const long long*>(cand_x), static_cast<float*>(partial), g);
  int rc = (int)cudaGetLastError();
  if (rc != 0) return rc;
  const int S = kDense ? g.n_out * g.L : 1;
  const long long n_outputs = n_tasks * S;
  const long long blocks = (n_outputs + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  correlate_sum_k8<<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const float*>(partial), static_cast<const float*>(mass),
      static_cast<float*>(out), n_outputs, g.per_row * S, g.n_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// `partial` holds (tasks * windows) rows of ceil(P / 32)^2 floats.
extern "C" int match_correlate_dense_launch(
    const void* field, const void* rasters, const void* mass, void* partial,
    void* out, int R, int A, int P, int H, int W, int n_out, int L,
    int stride, void* stream) {
  Geometry g{P, H, W, A, A, 0, 0, n_out, L, stride};
  return launch<true>(field, rasters, nullptr, nullptr, nullptr, mass,
                      partial, out, R, g, stream);
}

extern "C" int match_correlate_list_launch(
    const void* field, const void* rasters, const void* cand_a,
    const void* cand_y, const void* cand_x, const void* mass, void* partial,
    void* out, int R, int A, int K, int P, int H, int W, void* stream) {
  Geometry g{P, H, W, A, K, 0, 0, 1, 1, 1};
  return launch<false>(field, rasters, cand_a, cand_y, cand_x, mass,
                       partial, out, R, g, stream);
}
