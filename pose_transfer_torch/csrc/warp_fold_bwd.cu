// Feature gradient of the fused two-pass warp fold (backward).
//
// Replaces pose_transfer_tpu/ops/warp_pallas.py::_bwd_pass2_kernel and
// ::_bwd_pass1_kernel (the pallas_calls of _backward). Given the cotangent g,
// the argmax idx of the forward (int8 part index) and the parts' transforms
// and masks, per sample n and part t:
//   dz[o, xo]   = f32(where(idx == t, g, +0)) * f32(mask[t, o, xo])
//   pass 2^T    dtmp[o, x] = round_T( sum_xo ramp(u(xo, o) - x) * dz[o, xo] )
//   pass 1^T    df_t[y, x] = round_T( sum_o ramp(v(x, o) - y) * dtmp[o, x] )
//   df = df_0, then df = round_T(df + df_t) for t = 1..P-1 (in part order)
// with the f32 ramp weights (NOT rounded to T) and the positions u, v of the
// forward (csrc/warp_fold.cu), computed with __fmul_rn/__fadd_rn.
//
// Design. The TPU kernels transpose the two passes as dense products with
// the banded matrices on the other side. A transposed pass is a scatter;
// here it is a GATHER with no atomics, so runs are deterministic. A block
// owns a kTileY x kTileX tile of df pixels and a 128-byte slice of their
// channels (kLanes threads of 16 bytes a pixel) and walks the parts in
// order, keeping df in registers. Per (tile, part):
// - Set-up, once per block, for up to kChunk parts at once: the part's
//   transform and its inverse slopes (one f64 reciprocal per part per
//   block), a box of output pixels (o, xo) holding every one whose taps can
//   reach the tile (the real-arithmetic preimage of the tile's corners,
//   widened by 2 pixels against the rounding of the positions), and for
//   each column x the hull of rows o with a nonzero weight to a row of the
//   tile (an index window from the inverse slope, narrowed to the exact
//   interval by evaluating the forward's own ramp at its ends: positions
//   are monotone in the index).
// - Mask skip: a part whose box misses the bounding box of its mask's
//   nonzero pixels (mask_bbox_kernel, launched first) contributes exactly
//   +0 and is skipped: no g or idx is read. On a training step's inputs
//   parts 1-9 cover 2-5 % of the pixels each.
// - For each (o, x) of the hulls, one thread finds the columns xo with a
//   nonzero weight to x and whether the mask is nonzero over them; where
//   it is 0 over this exact region the part is skipped too. Hulls and
//   columns are cut to the mask's bounding box: outside it dz is 0.
// - dtmp once: dtmp[o, x] for the hulls' rows and the tile's columns, all
//   the slice's channels, into shared memory, rounded to T; then each df_t
//   pixel sums its rows from there, instead of recomputing dtmp for each y.
//   Shared memory holds kRows rows a column: a steeper m11 (or the
//   whole-axis scan for |m11| < kMinSlope) stages the hull in several
//   passes of kRows rows, the df_t sums carried across them in registers.
//   (A per-pixel direct gather for such hulls measured ~0.9 of 1.37 ms on
//   a training step's inputs while taking 0.06 % of the (tile, part)
//   pairs, so it gave way to the passes.)
// Sums run in f64 from +0: every product of an f32 weight with an f32 (or
// bf16-valued) term is exact there, and the plain version's f64 products
// sum the same terms in another order, so a rounding to f32 or T may flip
// where the f64 sums straddle its boundary (the check's tolerance). After
// the redesign the f64 work is a few multiply-adds and conversions per
// channel and tap (H100 runs f64 at half the f32 rate); the kernel waits on
// memory and on its phases' barriers more than on them.
//
// Bound: memory. Least bytes per launch (each input read once, each output
// written once): itemsize*(2*N*H*W*C + N*P*H*W) + N*H*W*C (int8 idx)
// + 32*N*P. Fashion-256 stage 0 at N=8, P=10, bf16: 178 MB -> 0.053 ms at
// 3.35 TB/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxParts = 127;   // int8 argmax
// The tile and the rows of dtmp shared memory holds per column.
// ops/warp_pallas.py reads kTileY, kTileX and kMinSlope from this file for
// its copy of the box rule (bwd_boxes), which the CPU tests hold.
constexpr int kTileY = 4;
constexpr int kTileX = 16;
constexpr int kRows = 16;
constexpr float kMinSlope = 1e-3f;
constexpr int kLanes = 8;        // 16-byte chunks of a pixel in a block
constexpr int kChunk = 16;       // parts whose set-up a block does at once
static_assert(kRows * kTileX == kThreads, "one thread per (row, column)");
static_assert(kTileY * kTileX * kLanes == 2 * kThreads, "two df items");

template <typename T>
struct Num;

template <>
struct Num<float> {
  static __device__ __forceinline__ float load(float v) { return v; }
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ float store(float v) { return v; }
};

template <>
struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float load(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ float round(float v) {
    return __bfloat162float(__float2bfloat16_rn(v));
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float v) {
    return __float2bfloat16_rn(v);
  }
};

// max(0, 1 - |pos - j|) in f32
__device__ __forceinline__ float ramp(float pos, int j) {
  return fmaxf(0.0f, __fsub_rn(1.0f, fabsf(__fsub_rn(pos, (float)j))));
}

// fl(fl(fl(s*(i+.5)) + half) + off): u(xo, o) with (m00, txh, fl(m01*(o+.5)))
// or v(x, o) with (m11, tyh, fl(m10*(x+.5)))
__device__ __forceinline__ float position(float s, int i, float half,
                                          float off) {
  return __fadd_rn(__fadd_rn(__fmul_rn(s, (float)i + 0.5f), half), off);
}

// Whether a tap j in [a, b] of position p has a nonzero ramp weight (only
// floor(p) and floor(p) + 1 can).
__device__ __forceinline__ bool reaches(float p, int a, int b) {
  if (!(p > (float)a - 2.0f && p < (float)b + 2.0f)) return false;
  const int j0 = (int)floorf(p);
  return (j0 >= a && j0 <= b && ramp(p, j0) > 0.0f) ||
         (j0 + 1 >= a && j0 + 1 <= b && ramp(p, j0 + 1) > 0.0f);
}

// The index window [lo, hi] within [0, n) holding every i whose position
// s*(i + .5) + c, c between c1 and c2, can reach a tap in [a, b]: the
// real-arithmetic preimage of (a - 1, b + 1), widened by 2 on each side
// against the rounding of the f32 position; the whole axis for |s| <
// kMinSlope or a bound that is not finite; lo > hi when empty. inv = 1/s.
// (ops/warp_pallas.py::_window computes the same in torch, for the tests.)
__device__ __forceinline__ void window(float s, double inv, double c1,
                                       double c2, int a, int b, int n,
                                       int& lo, int& hi) {
  lo = 0;
  hi = n - 1;
  if (!(fabsf(s) >= kMinSlope)) return;
  const double e1 = (double)a - 1.0, e2 = (double)b + 1.0;
  const double p0 = __dsub_rn(__dmul_rn(__dsub_rn(e1, c1), inv), 0.5);
  const double p1 = __dsub_rn(__dmul_rn(__dsub_rn(e1, c2), inv), 0.5);
  const double p2 = __dsub_rn(__dmul_rn(__dsub_rn(e2, c1), inv), 0.5);
  const double p3 = __dsub_rn(__dmul_rn(__dsub_rn(e2, c2), inv), 0.5);
  const double p = floor(fmin(fmin(p0, p1), fmin(p2, p3))) - 2.0;
  const double q = ceil(fmax(fmax(p0, p1), fmax(p2, p3))) + 2.0;
  if (!(isfinite(p) && isfinite(q))) return;
  if (q < 0.0 || p > (double)(n - 1)) {
    lo = 1;
    hi = 0;
    return;
  }
  lo = (int)fmax(p, 0.0);
  hi = (int)fmin(q, (double)(n - 1));
}

// The window narrowed to the indices whose position reaches a tap in
// [a, b]: positions are monotone in the index, so these are an interval.
__device__ __forceinline__ void taps_of(float s, double inv, float half,
                                        float off, int a, int b, int n,
                                        int& lo, int& hi) {
  const double c = (double)half + (double)off;
  window(s, inv, c, c, a, b, n, lo, hi);
  while (lo <= hi && !reaches(position(s, lo, half, off), a, b)) ++lo;
  while (hi >= lo && !reaches(position(s, hi, half, off), a, b)) --hi;
}

// dtmp[o, x] of one 16-byte channel chunk before its rounding: the f64 sum
// over xo in [xl, xh] of ramp(u(xo, o) - x) * f32(g * mask), g where idx
// == t (+0 elsewhere), in increasing xo. Four candidates at a time, their
// loads issued before any of them is used (the kernel waits on memory, not
// on arithmetic); no branch on the weight or the mask: a zero adds +-0,
// which leaves a sum that started from +0 as it is.
template <typename T, int VEC>
__device__ __forceinline__ void dtmp_sum(
    const T* __restrict__ g, const int8_t* __restrict__ idx,
    const T* __restrict__ mask_row, int64_t row_at, int C, int t, float m00,
    float txh, float off_x, int x, int xl, int xh, double (&dt)[VEC]) {
  constexpr int kBatch = 4;
  using Sel = typename std::conditional<VEC == 8, uint2, uint32_t>::type;
#pragma unroll
  for (int k = 0; k < VEC; ++k) dt[k] = 0.0;
  for (int base = xl; base <= xh; base += kBatch) {
    uint4 raw[kBatch];
    Sel sel[kBatch];
    float m[kBatch];
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int xo = min(base + b, xh);   // past the end: a repeat, weight 0
      const int64_t at = (row_at + xo) * C;
      raw[b] = *reinterpret_cast<const uint4*>(g + at);
      sel[b] = *reinterpret_cast<const Sel*>(idx + at);
      m[b] = Num<T>::load(mask_row[xo]);
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const double wx =
          base + b <= xh ? (double)ramp(position(m00, base + b, txh, off_x), x)
                         : 0.0;
      const T* gv = reinterpret_cast<const T*>(&raw[b]);
      const int8_t* sv = reinterpret_cast<const int8_t*>(&sel[b]);
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float gk = sv[k] == t ? Num<T>::load(gv[k]) : 0.0f;
        dt[k] += wx * (double)__fmul_rn(gk, m[b]);
      }
    }
  }
}

// Whether mask_row is nonzero somewhere in [xl, xh] (four loads at a time).
template <typename T>
__device__ __forceinline__ bool mask_any(const T* __restrict__ mask_row,
                                         int xl, int xh) {
  for (int base = xl; base <= xh; base += 4) {
    float m[4];
#pragma unroll
    for (int b = 0; b < 4; ++b)
      m[b] = Num<T>::load(mask_row[min(base + b, xh)]);
    if (m[0] != 0.0f || m[1] != 0.0f || m[2] != 0.0f || m[3] != 0.0f)
      return true;
  }
  return false;
}

// The bounding box of each mask's nonzero pixels, as (r0, c0, -r1, -c1)
// per (n, part), by atomicMin into a buffer set to 0x7f7f7f7f (a mask that
// is 0 everywhere keeps r0 > r1). blockIdx.x = n * P + t; blockIdx.y cuts
// the rows.
template <typename T>
__global__ void __launch_bounds__(kThreads)
mask_bbox_kernel(const T* __restrict__ masks, int* __restrict__ bbox, int H,
                 int W) {
  const T* m = masks + (int64_t)blockIdx.x * H * W;
  const int rows = (H + gridDim.y - 1) / gridDim.y;
  const int r_a = blockIdx.y * rows, r_b = min(H, r_a + rows);
  int v[4] = {INT_MAX, INT_MAX, INT_MAX, INT_MAX};
  for (int i = r_a * W + threadIdx.x; i < r_b * W; i += kThreads) {
    if (Num<T>::load(m[i]) != 0.0f) {
      const int r = i / W, c = i % W;
      v[0] = min(v[0], r);
      v[1] = min(v[1], c);
      v[2] = min(v[2], -r);
      v[3] = min(v[3], -c);
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int w = __reduce_min_sync(0xffffffffu, v[k]);
    if (threadIdx.x % 32 == 0 && w != INT_MAX)
      atomicMin(bbox + 4 * blockIdx.x + k, w);
  }
}

// The rows [r_a, r_b) of df pixel q's column hull, from dtmp in shared
// memory (row r_a at its first row), added to dft in row order.
template <typename T, int VEC>
__device__ __forceinline__ void df_rows(const uint4* s_dtmp, float m10,
                                        float m11, float tyh, int oa, int r_a,
                                        int r_b, int y, int x, int xx,
                                        int lane, double (&dft)[VEC]) {
  const float off_y = __fmul_rn(m10, (float)x + 0.5f);
  for (int r = r_a; r < r_b; ++r) {
    const float wy = ramp(position(m11, oa + r, tyh, off_y), y);
    if (wy == 0.0f) continue;
    const uint4 raw = s_dtmp[((r - r_a) * kTileX + xx) * kLanes + lane];
    const T* dv = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int k = 0; k < VEC; ++k)
      dft[k] += (double)wy * (double)Num<T>::load(dv[k]);
  }
}

// acc = df_t for part 0, else round_T(acc + df_t), with df_t = round_T(dft).
template <typename T, int VEC>
__device__ __forceinline__ void fold_part(int t, const double (&dft)[VEC],
                                          T (&acc)[VEC]) {
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const float d = Num<T>::round((float)dft[k]);
    acc[k] = Num<T>::store(t == 0 ? d : __fadd_rn(Num<T>::load(acc[k]), d));
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_item(T* __restrict__ df, int64_t map0,
                                           int W, int C, int y_a, int x_a,
                                           int y_b, int x_b, int q,
                                           bool chunk_ok,
                                           const T (&acc)[VEC]) {
  const int y = y_a + q / kTileX, x = x_a + q % kTileX;
  if (y > y_b || x > x_b || !chunk_ok) return;
  uint4 res;
  T* rv = reinterpret_cast<T*>(&res);
#pragma unroll
  for (int k = 0; k < VEC; ++k) rv[k] = acc[k];
  *reinterpret_cast<uint4*>(df + (map0 + (int64_t)y * W + x) * C) = res;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 2)
warp_fold_bwd_kernel(const T* __restrict__ g, const float* __restrict__ warps,
                     const T* __restrict__ masks,
                     const int8_t* __restrict__ idx,
                     const int4* __restrict__ bbox, T* __restrict__ df,
                     unsigned long long* __restrict__ stats, int H, int W,
                     int C, int P, int tiles_x) {
  constexpr int VEC = 16 / sizeof(T);   // channels per thread (16 bytes)
  // per part of the chunk: transform, inverse slopes, box, liveness, and
  // per column the hull of rows [oa, oa + rows)
  __shared__ float s_tr[kChunk * 6];
  __shared__ double s_inv[kChunk * 2];      // 1/m00, 1/m11
  __shared__ int s_live[kChunk], s_passes[kChunk];
  __shared__ int4 s_bb[kChunk];             // the masks' bounding boxes
  __shared__ int s_oa[kChunk * kTileX], s_rows[kChunk * kTileX];
  // per (row, column) of the part at hand: columns xo, mask nonzero there
  __shared__ int s_xlo[kRows * kTileX], s_xhi[kRows * kTileX];
  __shared__ bool s_flag[kRows * kTileX];
  __shared__ uint4 s_dtmp[kRows * kTileX * kLanes];   // (row, column, lane)

  const int n = blockIdx.z;
  const int y_a = (blockIdx.x / tiles_x) * kTileY;
  const int x_a = (blockIdx.x % tiles_x) * kTileX;
  const int y_b = min(y_a + kTileY, H) - 1;
  const int x_b = min(x_a + kTileX, W) - 1;
  const int tid = threadIdx.x;
  const int lane = tid % kLanes;
  const int chunk = blockIdx.y * kLanes + lane;
  const bool chunk_ok = chunk < C / VEC;
  const int c0 = chunk * VEC;
  const int64_t map0 = (int64_t)n * H * W;   // first pixel of the sample
  const int xx_r = tid % kTileX, r_r = tid / kTileX;   // (row, column) role

  T acc0[VEC], acc1[VEC];   // df of the two pixels, always values of T
  // stats (thread 0 of the first channel slice): (tile, part) pairs
  // skipped, staged in more than one pass, and all of them
  unsigned long long n_skipped = 0, n_multipass = 0;
  for (int t0 = 0; t0 < P; t0 += kChunk) {
    const int tn = min(kChunk, P - t0);
    __syncthreads();   // the previous chunk's set-up is no longer read
    // set-up 1: one thread per part: transform, inverse slopes, box; a
    // part whose box misses its mask's bounding box is skipped
    if (tid < tn) {
      const float* w = warps + ((int64_t)n * P + t0 + tid) * 8;
      const float m00 = w[0], m01 = w[1], txh = __fsub_rn(w[2], 0.5f);
      const float m10 = w[3], m11 = w[4], tyh = __fsub_rn(w[5], 0.5f);
      const double inv00 = 1.0 / (double)m00, inv11 = 1.0 / (double)m11;
      for (int i = 0; i < 6; ++i) s_tr[6 * tid + i] = w[i];
      s_inv[2 * tid] = inv00;
      s_inv[2 * tid + 1] = inv11;
      int olo, ohi, xlo = 1, xhi = 0;
      window(m11, inv11,
             (double)tyh + (double)__fmul_rn(m10, (float)x_a + 0.5f),
             (double)tyh + (double)__fmul_rn(m10, (float)x_b + 0.5f), y_a,
             y_b, H, olo, ohi);
      if (olo <= ohi)
        window(m00, inv00,
               (double)txh + (double)__fmul_rn(m01, (float)olo + 0.5f),
               (double)txh + (double)__fmul_rn(m01, (float)ohi + 0.5f), x_a,
               x_b, W, xlo, xhi);
      const int4 bb = bbox[(int64_t)n * P + t0 + tid];   // r0, c0, -r1, -c1
      s_bb[tid] = make_int4(bb.x, bb.y, -bb.z, -bb.w);
      s_live[tid] = max(olo, bb.x) <= min(ohi, -bb.z) &&
                    max(xlo, bb.y) <= min(xhi, -bb.w);
      s_passes[tid] = 0;
    }
    __syncthreads();
    // set-up 2, all live parts at once: each column's hull of rows o
    // with a nonzero weight to a row of the tile, within the rows of the
    // mask's bounding box (dz is 0 outside it)
    for (int i = tid; i < tn * kTileX; i += kThreads) {
      const int tt = i / kTileX, x = x_a + i % kTileX;
      const float* tr = s_tr + 6 * tt;
      int lo = 1, hi = 0;
      if (x <= x_b && s_live[tt]) {
        taps_of(tr[4], s_inv[2 * tt + 1], __fsub_rn(tr[5], 0.5f),
                __fmul_rn(tr[3], (float)x + 0.5f), y_a, y_b, H, lo, hi);
        lo = max(lo, s_bb[tt].x);
        hi = min(hi, s_bb[tt].z);
      }
      const int rows = lo <= hi ? hi - lo + 1 : 0;
      s_oa[i] = lo;
      s_rows[i] = rows;
      atomicMax(&s_passes[tt], (rows + kRows - 1) / kRows);
    }
    __syncthreads();

    for (int tt = 0; tt < tn; ++tt) {
      const int t = t0 + tt;
      const float* tr = s_tr + 6 * tt;
      const float m00 = tr[0], m01 = tr[1], txh = __fsub_rn(tr[2], 0.5f);
      const float m10 = tr[3], m11 = tr[4], tyh = __fsub_rn(tr[5], 0.5f);
      const double inv00 = s_inv[2 * tt];
      const T* mask_t = masks + ((int64_t)n * P + t) * H * W;
      const int* oa_t = s_oa + tt * kTileX;
      const int* rows_t = s_rows + tt * kTileX;
      double dft0[VEC], dft1[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) dft0[k] = dft1[k] = 0.0;
      // the hulls in passes of kRows rows (one, unless m11 is steep)
      const int passes = s_live[tt] ? s_passes[tt] : 0;
      bool ran = false;
      for (int pass = 0; pass < passes; ++pass) {
        const int r_a = pass * kRows;
        // for each (row, column) of the pass: the columns xo with a nonzero
        // weight to x, within the mask's bounding box, and whether the mask
        // is nonzero over them (in a row whose taps from x reach the tile)
        bool flag = false;
        if (r_a + r_r < rows_t[xx_r]) {
          const int o = oa_t[xx_r] + r_a + r_r, x = x_a + xx_r;
          const float off_x = __fmul_rn(m01, (float)o + 0.5f);
          int lo, hi;
          taps_of(m00, inv00, txh, off_x, x, x, W, lo, hi);
          lo = max(lo, s_bb[tt].y);
          hi = min(hi, s_bb[tt].w);
          if (reaches(position(m11, o, tyh, __fmul_rn(m10, (float)x + 0.5f)),
                      y_a, y_b))
            flag = mask_any<T>(mask_t + (int64_t)o * W, lo, hi);
          s_xlo[tid] = lo;
          s_xhi[tid] = hi;
          s_flag[tid] = flag;
        }
        if (!__syncthreads_or(flag)) continue;   // the mask is 0 there
        ran = true;
        // dtmp for the pass's rows, rounded to T, into shared memory
        for (int i = tid; i < kRows * kTileX * kLanes; i += kThreads) {
          const int l = i % kLanes, xx = (i / kLanes) % kTileX;
          const int r = i / (kLanes * kTileX), e = r * kTileX + xx;
          if (r_a + r >= rows_t[xx]) continue;
          const int ch = blockIdx.y * kLanes + l;
          double dt[VEC];
#pragma unroll
          for (int k = 0; k < VEC; ++k) dt[k] = 0.0;
          if (s_flag[e] && ch < C / VEC) {
            const int o = oa_t[xx] + r_a + r;
            dtmp_sum<T, VEC>(g + ch * VEC, idx + ch * VEC,
                             mask_t + (int64_t)o * W, map0 + (int64_t)o * W,
                             C, t, m00, txh, __fmul_rn(m01, (float)o + 0.5f),
                             x_a + xx, s_xlo[e], s_xhi[e], dt);
          }
          uint4 res;
          T* rv = reinterpret_cast<T*>(&res);
#pragma unroll
          for (int k = 0; k < VEC; ++k) rv[k] = Num<T>::store((float)dt[k]);
          s_dtmp[i] = res;
        }
        __syncthreads();
        // this thread's two df pixels take the pass's rows
#pragma unroll
        for (int it = 0; it < 2; ++it) {
          const int q = (tid + it * kThreads) / kLanes;
          const int xx = q % kTileX, y = y_a + q / kTileX, x = x_a + xx;
          if (y > y_b || x > x_b || !chunk_ok) continue;
          const int r_b = min(r_a + kRows, rows_t[xx]);
          if (it == 0)
            df_rows<T, VEC>(s_dtmp, m10, m11, tyh, oa_t[xx], r_a, r_b, y, x,
                            xx, lane, dft0);
          else
            df_rows<T, VEC>(s_dtmp, m10, m11, tyh, oa_t[xx], r_a, r_b, y, x,
                            xx, lane, dft1);
        }
      }
      n_skipped += !ran;
      n_multipass += ran && passes > 1;
      // df_t rounded to T, summed in T, in part order (a skipped part or
      // pass adds +0)
      fold_part<T, VEC>(t, dft0, acc0);
      fold_part<T, VEC>(t, dft1, acc1);
    }
  }

  if (stats && tid == 0 && blockIdx.y == 0) {
    atomicAdd(stats, n_skipped);
    atomicAdd(stats + 1, n_multipass);
    atomicAdd(stats + 2, (unsigned long long)P);
  }
  store_item<T, VEC>(df + c0, map0, W, C, y_a, x_a, y_b, x_b, tid / kLanes,
                     chunk_ok, acc0);
  store_item<T, VEC>(df + c0, map0, W, C, y_a, x_a, y_b, x_b,
                     (tid + kThreads) / kLanes, chunk_ok, acc1);
}

template <typename T>
int launch(const void* g, const void* warps, const void* masks,
           const void* idx, void* bbox, void* df, void* stats, int N, int H,
           int W, int C, int P, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  cudaError_t e = cudaMemsetAsync(bbox, 0x7f, (size_t)N * P * 4 * sizeof(int),
                                  stream);
  if (e != cudaSuccess) return (int)e;
  mask_bbox_kernel<T><<<dim3((unsigned)(N * P), (unsigned)min(H, 16)),
                        kThreads, 0, stream>>>(
      static_cast<const T*>(masks), static_cast<int*>(bbox), H, W);
  const int tiles_x = (W + kTileX - 1) / kTileX;
  const int tiles_y = (H + kTileY - 1) / kTileY;
  dim3 grid((unsigned)(tiles_x * tiles_y),
            (unsigned)((C / VEC + kLanes - 1) / kLanes), (unsigned)N);
  warp_fold_bwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const float*>(warps),
      static_cast<const T*>(masks), static_cast<const int8_t*>(idx),
      static_cast<const int4*>(bbox), static_cast<T*>(df),
      static_cast<unsigned long long*>(stats), H, W, C, P, tiles_x);
  return 0;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. bbox: scratch of N * P * 4 int32 (the
// masks' bounding boxes, written here). stats: null, or 3 uint64 to which
// the launch adds the (tile, part) pairs it skipped, those it staged in more
// than one pass, and all its pairs. Returns cudaGetLastError() after
// the launches (0 = success). Shapes and alignment are checked by the
// caller (pose_transfer_torch/ops/warp_pallas.py): C % (16 / itemsize) ==
// 0, 1 <= P <= 127, every pointer 16-byte aligned, every tensor contiguous.
int warp_fold_bwd(const void* g, const void* warps, const void* masks,
                  const void* idx, void* df, void* bbox, void* stats, int N,
                  int H, int W, int C, int P, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P < 1 || P > kMaxParts) return (int)cudaErrorInvalidValue;
  int rc;
  if (dtype == 0)
    rc = launch<float>(g, warps, masks, idx, bbox, df, stats, N, H, W, C, P,
                       s);
  else if (dtype == 1)
    rc = launch<__nv_bfloat16>(g, warps, masks, idx, bbox, df, stats, N, H, W,
                               C, P, s);
  else
    return (int)cudaErrorInvalidValue;
  return rc ? rc : (int)cudaGetLastError();
}

const char* warp_fold_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
