// Kernels K6 and K7: the 3D depth-camera inverse sensor model at pitch 0.
//
// Both replace Pallas call sites of jax_mapping/ops/voxel_kernel.py, which
// build one kernel body (_make_kernel):
//   K6 voxel_image_launch  replaces image_deltas (non-accumulating):
//      out (B, Z, ny, nx) = each image's delta at its own origin.
//   K7 voxel_summed_launch replaces _summed_delta (accumulating, reached by
//      window_delta and region_delta):
//      out (Z, ny, nx) = sum over b, from 0 in b order, of image b's delta
//      at its own origin.
//
// The per-voxel program follows the Pallas body() operation by operation
// (one rounding each: nvcc --fmad=false, the _rn intrinsics, division
// correctly rounded, rint = round half to even): for voxel column (y, x)
// the camera x and z are constant in z at pitch 0, so the column's image
// column u is computed once; per z the image row v, a direct load of
// depth[b, v, u] (exact, where the TPU picks the column with a one-hot
// matmul), the euclidean trust horizon, the validity mask, free and
// occupied. v's division is fy (camz - wz) / czc: per column the
// correctly rounded 1/czc, per voxel two Markstein corrections (div_rn),
// which give the correctly rounded quotient without a call.
//
// Bound on an H100: the output write (K6: Z*ny*nx*4 bytes per image, 37.7
// MB at the default 64 x 384 x 384; K7: one (Z, ny, nx) sum), against ~20
// float operations per voxel that lies in front of the camera, inside the
// image and within the trust horizon: a few per cent of the voxels, so
// both are bound by bytes. The design evaluates only those voxels, and
// writes every other one as +0 without computing it:
//
// - Tiles. A block owns a tile of kTileY x kTileX voxel columns (a warp
//   spans one tile row, so each z-plane store of a warp is 128 contiguous
//   bytes) with all their layers; edge tiles are masked where the
//   region's sides are no multiple of the tile. A tile with no live image
//   writes its zeros with 16-byte stores.
// - A (tile, image) cull, once per pair before any per-voxel work
//   (tile_live). It bounds the camera coordinates of the tile's columns
//   from the corners of the tile widened by one cell: the coordinates are
//   coordinatewise monotone float functions of the cell-centre offsets,
//   so the corners bound every column exactly, and the widening is slack.
//   A pair is dead when the tile lies behind range_min, wholly beyond one
//   side plane of the image, or wholly beyond the trust horizon.
// - A z interval per (column, image) (column_terms). v is monotone in z,
//   so the layers with 0 <= rint(v) < H form an interval, and so do the
//   layers within the horizon (d2 is monotone in |camera y|); the column
//   holds a superset of their intersection, widened by one layer, and
//   every voxel outside it is 0 by the model's own mask.
// - The column's terms are computed once per (column, image) into shared
//   memory, the per-layer terms once per block.
// Skipping a dead pair or a layer outside the interval is exact: K6
// writes the +0 the model gives there, and in K7 an accumulator starts at
// +0 and is never -0, so adding the skipped +0 would change nothing.
//
// K6 gives each column four threads, each writing a quarter of its
// layers. K7 splits z across the block: thread (column, z group) sums
// kZChunk layers of one column in registers over the tile's live images
// in b order, so each voxel has one owner and keeps the b order; a group
// that meets an image's interval evaluates all its layers, branch-free,
// so that they interleave. The live work sits in about a tenth of the
// tiles, and the z split gives each of them Z / kZChunk warps.
// The plain mirrors of the cull and the interval are
// ops/voxel_kernel.py::tile_live_plain and column_z_range_plain.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTileX = 32;              // tile columns along x: one warp
constexpr int kTileY = 1;               // tile rows along y
constexpr int kCols = kTileX * kTileY;  // voxel columns of a tile
constexpr int kMaxZ = 128;              // layers (region_supported's limit)
constexpr int kZChunk = 8;              // K7: layers one thread sums
constexpr int kMaxImages = 32;          // K7: images per launch
constexpr int kImageThreads = 4 * kCols;  // K6: four z parts a column
constexpr unsigned kEmpty = 0xFFu << 16;  // packed z interval lo > hi

struct Params {
  int Z, H, W;
  float res, ox, oy, oz;
  float camz, fx, fy, cx, cy;
  float rmin, max_r, max_r2, tol, lo_occ, lo_free;
  float kv;   // layers a metre of camera depth spans in the image height
  float zc;   // the camera's height as a fractional layer index
};

// The per-column terms of one image (Pallas body(), first half).
struct Column {
  float cxc, czc, safe_z;
  int ui_c;
  bool in_front, in_u;
};

// Cell-centre offset of grid column gx (row gy) from the camera; monotone
// non-decreasing in the index.
__device__ __forceinline__ float centre_dx(int gx, float px, const Params& q) {
  return __fsub_rn(
      __fadd_rn(__fmul_rn(__fadd_rn((float)gx, 0.5f), q.res), q.ox), px);
}

__device__ __forceinline__ float centre_dy(int gy, float py, const Params& q) {
  return __fsub_rn(
      __fadd_rn(__fmul_rn(__fadd_rn((float)gy, 0.5f), q.res), q.oy), py);
}

__device__ __forceinline__ Column column_of(int gy, int gx, float px, float py,
                                            float cyaw, float syaw,
                                            const Params& q) {
  Column c;
  const float dx = centre_dx(gx, px, q);
  const float dy = centre_dy(gy, py, q);
  c.cxc = __fsub_rn(__fmul_rn(syaw, dx), __fmul_rn(cyaw, dy));
  c.czc = __fadd_rn(__fmul_rn(cyaw, dx), __fmul_rn(syaw, dy));
  c.in_front = c.czc > q.rmin;
  c.safe_z = c.in_front ? c.czc : 1.0f;
  const float u = __fadd_rn(__fdiv_rn(__fmul_rn(q.fx, c.cxc), c.safe_z), q.cx);
  const int ui = (int)rintf(u);
  c.in_u = ui >= 0 && ui < q.W;
  c.ui_c = min(max(ui, 0), q.W - 1);
  return c;
}

// a / b rounded to nearest from y = RN(1/b), for b > 0 and a quotient in
// the normal range (or a = 0): two Markstein corrections, whose residuals
// a - b q are exact under fma. After the first, q is within one ulp of
// a/b; the second then gives RN(a/b) (Markstein's theorem), the value of
// __fdiv_rn without its per-voxel reciprocal and slow-path call.
__device__ __forceinline__ float div_rn(float a, float b, float y) {
  float q = __fmul_rn(a, y);
  q = __fmaf_rn(__fmaf_rn(-b, q, a), y, q);
  return __fmaf_rn(__fmaf_rn(-b, q, a), y, q);
}

// What the per-voxel program needs of a column: cxc^2, czc, RN(1/czc)
// and, packed, the clamped image column (bits 0-15) and the z interval
// [lo, hi] (bits 16-23, 24-31; lo > hi when empty). A column behind the
// camera, outside the image or beyond the horizon in the plane is empty:
// its d2 is at least fl(cxc^2 + czc^2) whatever the layer, as rounding is
// monotone. Otherwise the interval is the layers within
// min(kv * czc, sqrt(max_r2 - cxc^2 - czc^2) / res) + 1 of zc.
__device__ __forceinline__ float4 column_terms(int gy, int gx, float px,
                                               float py, float cyaw,
                                               float syaw, const Params& q) {
  const Column c = column_of(gy, gx, px, py, cyaw, syaw, q);
  const float a = __fmul_rn(c.cxc, c.cxc);
  unsigned zz = kEmpty;
  const float s = __fadd_rn(a, __fmul_rn(c.czc, c.czc));
  if (c.in_front && c.in_u && s <= q.max_r2) {
    const float hv = __fmul_rn(q.kv, c.czc);
    const float hh = __fdiv_rn(__fsqrt_rn(__fsub_rn(q.max_r2, s)), q.res);
    const float h = __fadd_rn(fminf(hv, hh), 1.0f);
    const int lo = max((int)ceilf(__fsub_rn(q.zc, h)), 0);
    const int hi = min((int)floorf(__fadd_rn(q.zc, h)), q.Z - 1);
    if (lo <= hi) zz = (unsigned)lo << 16 | (unsigned)hi << 24;
  }
  return make_float4(a, c.czc, __frcp_rn(c.safe_z),
                     __uint_as_float((unsigned)c.ui_c | zz));
}

__device__ __forceinline__ float4 empty_terms() {
  return make_float4(0.0f, 1.0f, 1.0f, __uint_as_float(kEmpty));
}

__device__ __forceinline__ int z_lo(float4 col) {
  return (int)(__float_as_uint(col.w) >> 16 & 0xFFu);
}

__device__ __forceinline__ int z_hi(float4 col) {
  return (int)(__float_as_uint(col.w) >> 24);
}

// A layer's terms: fy * (camz - wz) and (camz - wz)^2.
__device__ __forceinline__ float2 layer_terms(int z, const Params& q) {
  const float wz = __fadd_rn(__fmul_rn(__fadd_rn((float)z, 0.5f), q.res),
                             q.oz);
  const float cyc = __fsub_rn(q.camz, wz);
  return make_float2(__fmul_rn(q.fy, cyc), __fmul_rn(cyc, cyc));
}

// One voxel's delta (Pallas body(), second half) for a column in front of
// the camera and inside the image (so safe_z = czc, with y = RN(1/czc)),
// a = cxc^2, c2 = czc^2, col_img = the column's depth image column. No
// branch: callers evaluate layers in parallel, and every layer outside
// the column's z interval gives +0 here. Where the voxel is valid zi > 0,
// so the carve limit min(zi > 0 ? zi : 0, max_r) is min(zi, max_r).
__device__ __forceinline__ float voxel_delta(float czc, float y, float a,
                                             float c2,
                                             const float* __restrict__ col_img,
                                             float2 layer, const Params& q) {
  const float v = __fadd_rn(div_rn(layer.x, czc, y), q.cy);
  const int vi = __float2int_rn(v);     // rintf, half to even
  // Any row in range will do where vi is not (the voxel is then invalid).
  const unsigned row = min((unsigned)vi, (unsigned)(q.H - 1));
  const float zi = __ldg(col_img + row * (unsigned)q.W);
  const float d2 = __fadd_rn(__fadd_rn(a, layer.y), c2);
  // Non-short-circuit tests: no branch, so the layers interleave.
  const bool valid = ((unsigned)vi < (unsigned)q.H) & (d2 <= q.max_r2) &
                     (zi > 0.0f) & (zi >= q.rmin);
  const bool fr = valid & (czc < __fsub_rn(fminf(zi, q.max_r), q.tol));
  const bool oc = valid & (fabsf(__fsub_rn(czc, zi)) <= q.tol) &
                  (zi <= q.max_r);
  return oc ? q.lo_occ : (fr ? q.lo_free : 0.0f);
}

// The column's depth image column: image b's column ui_c.
__device__ __forceinline__ const float* column_image(const float* depths,
                                                    int b, float4 col,
                                                    const Params& q) {
  return depths + (size_t)b * q.H * q.W + (__float_as_uint(col.w) & 0xFFFFu);
}

// May any voxel of grid rows [r_lo, r_hi] x columns [c_lo, c_hi] be
// non-zero for the camera at (px, py) with heading (cyaw, syaw)? False
// only when every one is 0 by the model's mask (see the header).
__device__ __forceinline__ bool tile_live(int r_lo, int r_hi, int c_lo,
                                          int c_hi, float px, float py,
                                          float cyaw, float syaw,
                                          const Params& q) {
  const float dx0 = __fsub_rn(centre_dx(c_lo, px, q), q.res);
  const float dx1 = __fadd_rn(centre_dx(c_hi, px, q), q.res);
  const float dy0 = __fsub_rn(centre_dy(r_lo, py, q), q.res);
  const float dy1 = __fadd_rn(centre_dy(r_hi, py, q), q.res);
  // The nearest point of the widened tile, beyond the horizon: the tile's
  // own columns lie at least ~res/sqrt(2) farther, far more than rounding.
  const float gx = dx0 > 0.0f ? dx0 : (dx1 < 0.0f ? -dx1 : 0.0f);
  const float gy = dy0 > 0.0f ? dy0 : (dy1 < 0.0f ? -dy1 : 0.0f);
  if (__fadd_rn(__fmul_rn(gx, gx), __fmul_rn(gy, gy)) > q.max_r2)
    return false;
  float zmin = INFINITY, zmax = -INFINITY, xmin = INFINITY, xmax = -INFINITY;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float dx = (k & 1) ? dx1 : dx0;
    const float dy = (k & 2) ? dy1 : dy0;
    const float czc = __fadd_rn(__fmul_rn(cyaw, dx), __fmul_rn(syaw, dy));
    const float cxc = __fsub_rn(__fmul_rn(syaw, dx), __fmul_rn(cyaw, dy));
    zmin = fminf(zmin, czc);
    zmax = fmaxf(zmax, czc);
    xmin = fminf(xmin, cxc);
    xmax = fmaxf(xmax, cxc);
  }
  if (zmax <= q.rmin) return false;             // behind range_min
  // Over the columns in front (czc in (rmin, zmax]) u is largest at
  // (xmax, the nearest depth) when xmax >= 0, else at (xmax, zmax); and
  // smallest at (xmin, the nearest) when xmin <= 0, else at (xmin, zmax).
  const float znear = fmaxf(zmin, q.rmin);
  const float umax = __fadd_rn(
      __fdiv_rn(__fmul_rn(q.fx, xmax), xmax >= 0.0f ? znear : zmax), q.cx);
  if (umax < -0.5f) return false;               // left of the image
  const float umin = __fadd_rn(
      __fdiv_rn(__fmul_rn(q.fx, xmin), xmin <= 0.0f ? znear : zmax), q.cx);
  return !(umin > __fsub_rn((float)q.W, 0.5f));  // right of the image
}

// +0 over rows [ty0, ty0 + kTileY) x columns [tx0, tx0 + kTileX) of Z
// layers, clipped to the (ny, nx) region: 16-byte stores where the tile
// row is whole and aligned.
__device__ __forceinline__ void zero_tile(float* __restrict__ out, int ty0,
                                          int tx0, int ny, int nx, int Z) {
  const int rows = min(kTileY, ny - ty0);
  const size_t plane = (size_t)ny * nx;
  const int t = threadIdx.x;
  const int n = blockDim.x;
  if (nx % 4 == 0 && tx0 + kTileX <= nx &&
      (reinterpret_cast<uintptr_t>(out) & 15) == 0) {
    constexpr int kPer = kTileX / 4;
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    for (int i = t; i < Z * rows * kPer; i += n) {
      const int zr = i / kPer;
      float* row = out + (size_t)(zr / rows) * plane +
                   (size_t)(ty0 + zr % rows) * nx + tx0;
      reinterpret_cast<float4*>(row)[i % kPer] = zero;
    }
  } else {
    const int w = min(kTileX, nx - tx0);
    for (int i = t; i < Z * rows * w; i += n) {
      const int zr = i / w;
      out[(size_t)(zr / rows) * plane + (size_t)(ty0 + zr % rows) * nx +
          tx0 + i % w] = 0.0f;
    }
  }
}

// K6: block (tile, image b). Four threads a column, each writing a
// quarter of its layers: zeros outside the column's interval, the model
// inside.
__global__ void __launch_bounds__(kImageThreads) voxel_image_kernel(
    const float* __restrict__ depths, const float* __restrict__ table,
    const int* __restrict__ origins, float* __restrict__ out, int ny, int nx,
    Params q) {
  __shared__ float2 slayer[kMaxZ];
  __shared__ float4 sterm[kCols];
  __shared__ int slive;
  const int b = blockIdx.y;
  const int ntx = (nx + kTileX - 1) / kTileX;
  const int ty0 = (blockIdx.x / ntx) * kTileY;
  const int tx0 = (blockIdx.x % ntx) * kTileX;
  const int t = threadIdx.x;
  float* outb = out + (size_t)b * q.Z * ny * nx;
  const int y0 = origins[2 * b + 0];
  const int x0 = origins[2 * b + 1];
  const float px = table[4 * b + 0], py = table[4 * b + 1];
  const float cyaw = table[4 * b + 2], syaw = table[4 * b + 3];
  if (t == 0)
    slive = tile_live(y0 + ty0, y0 + min(ty0 + kTileY, ny) - 1, x0 + tx0,
                      x0 + min(tx0 + kTileX, nx) - 1, px, py, cyaw, syaw, q);
  __syncthreads();
  if (!slive) {
    zero_tile(outb, ty0, tx0, ny, nx, q.Z);
    return;
  }
  for (int z = t; z < q.Z; z += blockDim.x) slayer[z] = layer_terms(z, q);
  const int col = t % kCols;
  const int r = ty0 + col / kTileX;
  const int c = tx0 + col % kTileX;
  const bool mine = r < ny && c < nx;
  if (t < kCols)
    sterm[t] = mine ? column_terms(y0 + r, x0 + c, px, py, cyaw, syaw, q)
                    : empty_terms();
  __syncthreads();
  if (!mine) return;
  const float4 T = sterm[col];
  const int lo = z_lo(T);
  const int hi = z_hi(T);
  const float c2 = __fmul_rn(T.y, T.y);
  const float* img = column_image(depths, b, T, q);
  const int part = (q.Z + 3) / 4;
  const int z_end = min(q.Z, (t / kCols + 1) * part);
  const size_t plane = (size_t)ny * nx;
  float* o = outb + (size_t)r * nx + c;
  for (int z = (t / kCols) * part; z < z_end; ++z)
    o[(size_t)z * plane] =
        (z >= lo && z <= hi)
            ? voxel_delta(T.y, T.z, T.x, c2, img, slayer[z], q)
            : 0.0f;
}

// K7: block = tile, all layers. Thread (column c, z group g) adds the
// deltas of layers [g kZChunk, (g + 1) kZChunk) of column c over the
// tile's live images in b order; a warp spans a tile row, so its stores
// of a layer are 128 contiguous bytes.
__global__ void __launch_bounds__(kCols * kMaxZ / kZChunk) voxel_summed_kernel(
    const float* __restrict__ depths, const float* __restrict__ table,
    const int* __restrict__ origins, float* __restrict__ out, int B, int ny,
    int nx, Params q) {
  __shared__ float spose[kMaxImages][4];
  __shared__ int sorig[kMaxImages][2];
  __shared__ float2 slayer[kMaxZ];
  __shared__ float4 sterm[kMaxImages][kCols];
  __shared__ unsigned smask;
  const int t = threadIdx.x;
  const int ntx = (nx + kTileX - 1) / kTileX;
  const int ty0 = (blockIdx.x / ntx) * kTileY;
  const int tx0 = (blockIdx.x % ntx) * kTileX;
  if (t < 32) {        // warp 0, lane b: the (tile, image b) cull
    bool live = false;
    if (t < B) {
      for (int i = 0; i < 4; ++i) spose[t][i] = table[4 * t + i];
      sorig[t][0] = origins[2 * t];
      sorig[t][1] = origins[2 * t + 1];
      live = tile_live(
          sorig[t][0] + ty0, sorig[t][0] + min(ty0 + kTileY, ny) - 1,
          sorig[t][1] + tx0, sorig[t][1] + min(tx0 + kTileX, nx) - 1,
          spose[t][0], spose[t][1], spose[t][2], spose[t][3], q);
    }
    const unsigned m = __ballot_sync(0xFFFFFFFFu, live);
    if (t == 0) smask = m;
  }
  __syncthreads();
  const unsigned mask = smask;
  if (mask == 0u) {
    zero_tile(out, ty0, tx0, ny, nx, q.Z);
    return;
  }
  // Layer terms up to a whole number of z groups (those past Z feed sums
  // that are never stored).
  const int zpad = (q.Z + kZChunk - 1) / kZChunk * kZChunk;
  for (int z = t; z < zpad; z += blockDim.x) slayer[z] = layer_terms(z, q);
  // The terms of every live image's columns, in b order.
  const int nl = __popc(mask);
  for (int i = t; i < nl * kCols; i += blockDim.x) {
    unsigned m = mask;                  // its (i / kCols)-th live image
    for (int n = 0; n < i / kCols; ++n) m &= m - 1u;
    const int b = __ffs(m) - 1;
    const int cc = i % kCols;
    const int rr = ty0 + cc / kTileX;
    const int xx = tx0 + cc % kTileX;
    sterm[i / kCols][cc] =
        (rr < ny && xx < nx)
            ? column_terms(sorig[b][0] + rr, sorig[b][1] + xx, spose[b][0],
                           spose[b][1], spose[b][2], spose[b][3], q)
            : empty_terms();
  }
  __syncthreads();
  const int col = t % kCols;
  const int z0 = (t / kCols) * kZChunk;
  const int r = ty0 + col / kTileX;
  const int c = tx0 + col % kTileX;
  if (r >= ny || c >= nx) return;
  float2 lay[kZChunk];
  float acc[kZChunk];
#pragma unroll
  for (int k = 0; k < kZChunk; ++k) {
    lay[k] = slayer[z0 + k];
    acc[k] = 0.0f;
  }
  // A live image whose interval meets the thread's layers adds the model
  // on all of them: +0 outside the interval, which leaves a sum unchanged.
  unsigned m = mask;
  for (int i = 0; i < nl; ++i, m &= m - 1u) {
    const float4 T = sterm[i][col];
    if (z_lo(T) >= z0 + kZChunk || z_hi(T) < z0 || z_lo(T) > z_hi(T))
      continue;
    const float c2 = __fmul_rn(T.y, T.y);
    const float* img = column_image(depths, __ffs(m) - 1, T, q);
#pragma unroll
    for (int k = 0; k < kZChunk; ++k)
      acc[k] = __fadd_rn(acc[k], voxel_delta(T.y, T.z, T.x, c2, img, lay[k], q));
  }
  const size_t plane = (size_t)ny * nx;
  float* o = out + (size_t)r * nx + c;
#pragma unroll
  for (int k = 0; k < kZChunk; ++k) {
    if (z0 + k < q.Z) o[(size_t)(z0 + k) * plane] = acc[k];
  }
}

Params make_params(int Z, int H, int W, float res, float ox, float oy,
                   float oz, float camz, float fx, float fy, float cx,
                   float cy, float rmin, float max_r, float max_r2, float tol,
                   float lo_occ, float lo_free, float kv, float zc) {
  return Params{Z,  H,    W,     res,    ox,  oy,     oz,      camz, fx, fy,
                cx, cy, rmin, max_r, max_r2, tol, lo_occ, lo_free, kv, zc};
}

int tiles(int ny, int nx) {
  return ((ny + kTileY - 1) / kTileY) * ((nx + kTileX - 1) / kTileX);
}

}  // namespace

extern "C" int voxel_image_launch(
    const void* depths, const void* table, const void* origins, void* out,
    int B, int ny, int nx, int Z, int H, int W, float res, float ox, float oy,
    float oz, float camz, float fx, float fy, float cx, float cy, float rmin,
    float max_r, float max_r2, float tol, float lo_occ, float lo_free,
    float kv, float zc, void* stream) {
  if (B < 0 || B > 65535 || ny <= 0 || nx <= 0 || Z <= 0 || Z > kMaxZ ||
      H <= 0 || W <= 0 || W > 0xFFFF)
    return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const Params q = make_params(Z, H, W, res, ox, oy, oz, camz, fx, fy, cx, cy,
                               rmin, max_r, max_r2, tol, lo_occ, lo_free, kv,
                               zc);
  const dim3 grid(tiles(ny, nx), B);
  voxel_image_kernel<<<grid, kImageThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(depths), static_cast<const float*>(table),
      static_cast<const int*>(origins), static_cast<float*>(out), ny, nx, q);
  return (int)cudaGetLastError();
}

extern "C" int voxel_summed_launch(
    const void* depths, const void* table, const void* origins, void* out,
    int B, int ny, int nx, int Z, int H, int W, float res, float ox, float oy,
    float oz, float camz, float fx, float fy, float cx, float cy, float rmin,
    float max_r, float max_r2, float tol, float lo_occ, float lo_free,
    float kv, float zc, void* stream) {
  if (B < 0 || B > kMaxImages || ny <= 0 || nx <= 0 || Z <= 0 || Z > kMaxZ ||
      H <= 0 || W <= 0 || W > 0xFFFF)
    return (int)cudaErrorInvalidValue;
  const Params q = make_params(Z, H, W, res, ox, oy, oz, camz, fx, fy, cx, cy,
                               rmin, max_r, max_r2, tol, lo_occ, lo_free, kv,
                               zc);
  const int threads = kCols * ((Z + kZChunk - 1) / kZChunk);
  voxel_summed_kernel<<<tiles(ny, nx), threads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(depths), static_cast<const float*>(table),
      static_cast<const int*>(origins), static_cast<float*>(out), B, ny, nx,
      q);
  return (int)cudaGetLastError();
}
