// Jacobi sweeps of a 3 x 3 stencil over R fields of n x n in one launch,
// one thread-block cluster per field. Shared by kernels K2
// (csrc/label_prop.cu) and K3 (csrc/costfield_relax.cu). Consecutive
// fields share a mask in groups of `group`: field f reads mask f / group
// (K2 gives every grid its own mask; K3 one mask to a tenant's R robots).
//
// Layout. CTA k of a cluster of C owns the slab of rows
// [k * S, min(n, (k + 1) * S)), S = ceil(n / C), and keeps it
// double-buffered in its own shared memory as (S + 2) rows of pitch(n)
// values: a halo row above and below the slab, the cells from column
// kLead (16-byte aligned), and the fill value in the columns just left
// and right of them, so the stencil needs no bounds test. Its slab of
// the per-cell byte mask is staged once beside the buffers. Staging is
// asynchronous (cp.async, 16-byte vectors where the rows allow), so the
// whole slab costs one memory latency, not one a loop trip.
//
// Halos. Sweep j reads buffer j % 2 and writes buffer (j + 1) % 2. After
// a CTA barrier, warp 0 stores the slab's first row into the upper
// neighbour's bottom halo row and warp 1 its last row into the lower
// neighbour's top halo row, in their shared memory (distributed shared
// memory), with st.async: each store completes its bytes on the
// receiving CTA's mbarrier for that buffer. A CTA starts sweep j + 1 once
// its mbarrier has seen both neighbours' rows of sweep j, so CTAs wait
// for their neighbours only, never for the whole cluster (a cluster
// barrier a sweep measured slower on an H100). The
// same chain keeps Jacobi semantics with two buffers: a neighbour can
// push sweep j + 1's rows into buffer j % 2 only after it has this CTA's
// rows of sweep j, which leave after this CTA's last read of sweep j.
// Each mbarrier expects the next phase's bytes before the CTA pushes the
// rows that let its neighbours send them. Halo rows past the grid's top
// or bottom edge and the fill columns hold the fill value and are never
// written; the staging fills buffer 0's interior halos from the input
// itself, so the first sweep reads the input as given. A CTA writes its
// slab out once the last rows pushed to it have landed, after a cluster
// barrier, so no CTA exits while another may still write to it.
//
// Threads. A thread owns one column (or every T-th column when n > T
// threads) of a band of the slab's rows and walks down the band. Each
// row's three values are folded once into an Op::Row summary (K2: their
// max; K3: the centre, and the lesser side value, each plus its step
// cost), and a cell combines the summaries of the three rows around it:
// three shared loads and a few operations a cell, and no division.
// (Computing the edge rows first, so that their trip overlaps the
// interior, measured slower on the H100: one more CTA barrier a sweep
// and nine loads a cell on the edges.)

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include <mutex>

namespace cluster_sweep {

namespace cg = cooperative_groups;

// Largest cluster: 8 is portable, 16 needs the non-portable attribute.
constexpr int kMaxCluster = 16;
constexpr int kMaxThreads = 512;
// First cell column of a buffer row (16-byte aligned for 4-byte values).
constexpr int kLead = 4;

// The port's own error, returned beside cudaError_t codes: the card can
// hold no cluster of the planned shape (cudaOccupancyMaxActiveClusters is
// 0).
constexpr int kNoClusterFits = -2;

__host__ __device__ inline int slab_rows(int n, int C) {
  return (n + C - 1) / C;
}

// Values per buffer row: the lead, the cells rounded up to 4, one more
// vector for the right fill column.
__host__ __device__ inline int pitch(int n) {
  return kLead + ((n + 3) & ~3) + 4;
}

// Shared memory of one CTA: two mbarriers (16 bytes), two buffers of
// 4-byte values, then the mask.
inline size_t smem_bytes(int n, int C) {
  const size_t S = (size_t)slab_rows(n, C);
  return 16 + 2 * (S + 2) * (size_t)pitch(n) * 4 + S * (size_t)n;
}

__device__ __forceinline__ void cp_async4(void* smem, const void* gmem) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(smem)),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(smem)),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

// The address of this CTA's shared `addr` in CTA `rank` of the cluster.
__device__ __forceinline__ unsigned remote(unsigned addr, int rank) {
  unsigned out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void expect_bytes(unsigned mbar, unsigned bytes) {
  unsigned long long state;
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 %0, [%1], %2;\n"
               : "=l"(state) : "r"(mbar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void wait_phase(unsigned mbar, unsigned parity) {
  unsigned done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(mbar), "r"(parity) : "memory");
  }
}

// Store 4 or 1 values into another CTA's shared memory, completing their
// bytes on that CTA's mbarrier.
__device__ __forceinline__ void push4(unsigned to, const int4& v,
                                      unsigned mbar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 "
      "[%0], {%1, %2, %3, %4}, [%5];\n"
      ::"r"(to), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(mbar)
      : "memory");
}

__device__ __forceinline__ void push1(unsigned to, int v, unsigned mbar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 "
      "[%0], %1, [%2];\n" ::"r"(to), "r"(v), "r"(mbar)
      : "memory");
}

// Op supplies: using T (4 bytes); struct Row; static T fill();
// static Row row(left, centre, right); static T cell(Row above, Row
// centre, Row below, mask byte of the cell).
template <typename Op>
__global__ void __launch_bounds__(kMaxThreads) sweep_kernel(
    const typename Op::T* __restrict__ in, const uint8_t* __restrict__ mask,
    typename Op::T* __restrict__ out, int n, int n_sweeps, int group) {
  using T = typename Op::T;
  using Row = typename Op::Row;
  static_assert(sizeof(T) == 4, "4-byte values");
  cg::cluster_group cluster = cg::this_cluster();
  const int C = (int)cluster.num_blocks();
  const int k = (int)cluster.block_rank();
  const int S = slab_rows(n, C);
  const int W = pitch(n);
  const int r0 = min(n, k * S);
  const int r1 = min(n, r0 + S);
  const int rows = r1 - r0;
  const int T_ = (int)blockDim.x;
  const int tid = (int)threadIdx.x;
  const T fill = Op::fill();

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned long long* mbar = reinterpret_cast<unsigned long long*>(smem);
  T* buf0 = reinterpret_cast<T*>(smem + 16);
  T* buf1 = buf0 + (size_t)(S + 2) * W;
  uint8_t* m = reinterpret_cast<uint8_t*>(buf1 + (size_t)(S + 2) * W);
  const T* src_g = in + (size_t)blockIdx.y * n * n;
  T* dst_g = out + (size_t)blockIdx.y * n * n;
  // 16-byte rows when n is a multiple of 4 and the fields are aligned.
  const bool vec = (n & 3) == 0 && ((uintptr_t)src_g & 15) == 0 &&
                   ((uintptr_t)dst_g & 15) == 0;
  const int V = n >> 2;

  // Stage buffer 0: grid rows r0 - 1 .. r1, the input as given, the fill
  // past the top and bottom edges (there in buffer 1 too).
  const int n_stage = (rows + 2) * (vec ? V : n);
  for (int e = tid; e < n_stage; e += T_) {
    const int br = vec ? e / V : e / n;
    const int c = vec ? 4 * (e - br * V) : e - br * n;
    const int gr = r0 - 1 + br;
    T* d0 = buf0 + (size_t)br * W + kLead + c;
    if (gr >= 0 && gr < n) {
      const T* s = src_g + (size_t)gr * n + c;
      if (vec) cp_async16(d0, s); else cp_async4(d0, s);
    } else {
      T* d1 = buf1 + (size_t)br * W + kLead + c;
      for (int q = 0; q < (vec ? 4 : 1); ++q) d0[q] = d1[q] = fill;
    }
  }
  // The fill columns of every row of both buffers.
  for (int br = tid; br < 2 * (S + 2); br += T_) {
    buf0[(size_t)br * W + kLead - 1] = fill;
    buf0[(size_t)br * W + kLead + n] = fill;
  }
  // The mask slab of this field's mask, contiguous in global memory.
  const uint8_t* ms =
      mask + ((size_t)(blockIdx.y / group) * n + (size_t)r0) * n;
  if (((uintptr_t)ms & 15) == 0 && ((rows * n) & 15) == 0) {
    for (int e = tid; e < (rows * n) >> 4; e += T_)
      cp_async16(m + 16 * e, ms + 16 * e);
  } else {
    for (int e = tid; e < rows * n; e += T_) m[e] = ms[e];
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  // Thread -> columns tc, tc + Tc, ... of the band [i0, i1) of rows.
  const int Tc = n >= T_ ? T_ : n;
  const int G = T_ / Tc;
  const int g = tid / Tc;
  const int tc = tid - g * Tc;
  const int i0 = g < G ? g * rows / G : rows;
  const int i1 = g < G ? (g + 1) * rows / G : rows;
  const int warp = tid >> 5;
  const int lane = tid & 31;

  // Halo rows this CTA receives each sweep (from the upper neighbour into
  // its top row, from the lower one into its bottom row) and sends (its
  // first row up into the upper one's row S + 1, which is full; its last
  // row down into the lower one's row 0), as shared::cluster addresses.
  const bool has_up = rows > 0 && r0 > 0;
  const bool has_dn = rows > 0 && r1 < n;
  const unsigned in_bytes = (unsigned)(has_up + has_dn) * n * 4;
  const unsigned mb0 = smem_addr(&mbar[0]);
  const unsigned mb1 = smem_addr(&mbar[1]);
  // Where warp 0 (up) or warp 1 (down) pushes into buffer 0 and 1.
  unsigned to_row0 = 0, to_row1 = 0, to_mb0 = 0, to_mb1 = 0;
  if (warp < 2 && (warp == 0 ? has_up : has_dn)) {
    const int rank = warp == 0 ? k - 1 : k + 1;
    const size_t row = (size_t)(warp == 0 ? S + 1 : 0) * W + kLead;
    to_row0 = remote(smem_addr(buf0 + row), rank);
    to_row1 = remote(smem_addr(buf1 + row), rank);
    to_mb0 = remote(mb0, rank);
    to_mb1 = remote(mb1, rank);
  }
  if (tid == 0) {
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 ::"r"(mb0) : "memory");
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
                 ::"r"(mb1) : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    // Sweep 0 pushes into buffer 1.
    if (in_bytes && n_sweeps > 0) expect_bytes(mb1, in_bytes);
  }
  __syncthreads();
  cluster.sync();   // every CTA runs, has staged and expects sweep 0's rows

  for (int j = 0; j < n_sweeps; ++j) {
    const T* src = (j & 1) ? buf1 : buf0;
    T* dst = (j & 1) ? buf0 : buf1;
    // Buffer j % 2's halo rows, pushed in sweep j - 1: use (j - 1) / 2 of
    // its mbarrier.
    if (j > 0 && in_bytes)
      wait_phase((j & 1) ? mb1 : mb0, ((j - 1) >> 1) & 1);
    for (int c = kLead + tc; i0 < i1 && c < kLead + n; c += Tc) {
      const T* p = src + (size_t)i0 * W + c;     // the row above row i0
      Row a = Op::row(p[-1], p[0], p[1]);
      p += W;
      Row b = Op::row(p[-1], p[0], p[1]);
      T* q = dst + (size_t)(i0 + 1) * W + c;
      const uint8_t* mm = m + i0 * n + (c - kLead);
#pragma unroll 4
      for (int i = i0; i < i1; ++i) {
        p += W;
        const Row r = Op::row(p[-1], p[0], p[1]);
        *q = Op::cell(a, b, r, *mm);
        q += W;
        mm += n;
        a = b;
        b = r;
      }
    }
    // Buffer j % 2 takes sweep j + 1's pushes: expect them before this
    // sweep's rows leave (its phase of sweep j is complete: waited above).
    if (tid == 0 && in_bytes && j + 1 < n_sweeps)
      expect_bytes((j & 1) ? mb1 : mb0, in_bytes);
    __syncthreads();
    // Warp 0 pushes row 1 up, warp 1 row `rows` down, into buffer
    // (j + 1) % 2 of the neighbour.
    const unsigned to = (j & 1) ? to_row0 : to_row1;
    const unsigned to_mb = (j & 1) ? to_mb0 : to_mb1;
    if (to) {
      const T* from = dst + (size_t)(warp == 0 ? 1 : rows) * W + kLead;
      if (vec) {
        for (int v = lane; v < V; v += 32)
          push4(to + 16 * v, reinterpret_cast<const int4*>(from)[v], to_mb);
      } else {
        for (int c = lane; c < n; c += 32)
          push1(to + 4 * c, reinterpret_cast<const int*>(from)[c], to_mb);
      }
    }
  }
  // The last rows pushed to this CTA (sweep n_sweeps - 1's) have landed
  // before it writes out and exits; the barrier keeps every CTA alive
  // until all have.
  if (n_sweeps > 0 && in_bytes)
    wait_phase((n_sweeps & 1) ? mb1 : mb0, ((n_sweeps - 1) >> 1) & 1);
  cluster.sync();

  const T* fin = (n_sweeps & 1) ? buf1 : buf0;
  if (vec) {
    for (int e = tid; e < rows * V; e += T_) {
      const int r = e / V;
      const int v = e - r * V;
      reinterpret_cast<int4*>(dst_g + (size_t)(r0 + r) * n)[v] =
          reinterpret_cast<const int4*>(fin + (size_t)(r + 1) * W + kLead)[v];
    }
  } else {
    for (int e = tid; e < rows * n; e += T_) {
      const int r = e / n;
      const int c = e - r * n;
      dst_g[(size_t)(r0 + r) * n + c] = fin[(size_t)(r + 1) * W + kLead + c];
    }
  }
}

// How a call runs: C CTAs of `threads` a field, or C = 0 for the
// caller's global route.
struct Plan {
  int C;
  int threads;
  size_t smem;
};

// The cluster size of R fields: about 128 CTAs in all (the card has 132
// SMs), at least 4 a field. Measured on the H100 at the fleet's shapes,
// one field runs fastest at 16 CTAs; 8 fields are within a few percent at
// 8 or 16.
inline int auto_cluster(int R) {
  int C = kMaxCluster;
  while (C > 4 && C * R > 128) C /= 2;
  return C;
}

// The plan of R fields of n x n: auto_cluster(R) CTAs a field, doubled
// until a slab fits a block's shared memory, about `cells_per_thread`
// slab cells a thread (128 to kMaxThreads); the global route (C = 0) when
// not even 16 CTAs hold a field. Returns 0 or a cudaError_t.
inline int plan(int n, int R, int cells_per_thread, Plan* p) {
  int dev = 0;
  int optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return (int)err;
  p->C = 0;
  p->threads = 0;
  p->smem = 0;
  int C = auto_cluster(R);
  while (C < kMaxCluster && smem_bytes(n, C) > (size_t)optin) C *= 2;
  if (smem_bytes(n, C) > (size_t)optin) return 0;   // global route
  int t = ((slab_rows(n, C) * n / cells_per_thread + 31) / 32) * 32;
  p->C = C;
  p->threads = t < 128 ? 128 : (t > kMaxThreads ? kMaxThreads : t);
  p->smem = smem_bytes(n, C);
  return 0;
}

namespace detail {

struct Entry {
  const void* fn;
  int dev, C, threads;
  size_t smem;
  int active;
};

inline std::mutex& lock() {
  static std::mutex mu;
  return mu;
}

}  // namespace detail

// Launch Op's kernel on plan `p` over R fields, `group` fields to a
// mask; `*active` receives the clusters the card can hold at once.
// Returns a cudaError_t or kNoClusterFits.
template <typename Op>
int launch(const typename Op::T* in, const uint8_t* mask,
           typename Op::T* out, int R, int n, int n_sweeps, int group,
           const Plan& p, int* active, cudaStream_t s) {
  static detail::Entry cache[64];
  static int n_cache = 0;
  static bool prepared[64] = {};
  void (*kernel)(const typename Op::T*, const uint8_t*, typename Op::T*,
                 int, int, int) = sweep_kernel<Op>;

  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)p.C, (unsigned)R, 1);
  cfg.blockDim = dim3((unsigned)p.threads, 1, 1);
  cfg.dynamicSmemBytes = p.smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)p.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;

  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  *active = -1;
  {
    std::lock_guard<std::mutex> guard(detail::lock());
    if (dev < 64 && !prepared[dev]) {
      int optin = 0;
      err = cudaDeviceGetAttribute(
          &optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
      if (err == cudaSuccess)
        err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return (int)err;
      prepared[dev] = true;
    }
    for (int i = 0; i < n_cache; ++i) {
      const detail::Entry& e = cache[i];
      if (e.fn == (const void*)kernel && e.dev == dev && e.C == p.C &&
          e.threads == p.threads && e.smem == p.smem) {
        *active = e.active;
        break;
      }
    }
    if (*active < 0) {
      err = cudaOccupancyMaxActiveClusters(active, kernel, &cfg);
      if (err != cudaSuccess) return (int)err;
      if (n_cache < 64)
        cache[n_cache++] = {(const void*)kernel, dev, p.C, p.threads,
                            p.smem, *active};
    }
  }
  if (*active == 0) return kNoClusterFits;
  err = cudaLaunchKernelEx(&cfg, kernel, in, mask, out, n, n_sweeps,
                           group);
  if (err == cudaSuccess) err = cudaGetLastError();
  return (int)err;
}

}  // namespace cluster_sweep
