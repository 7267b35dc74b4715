// Fused two-pass warp, mask multiply and max fold over the parts (forward).
//
// Replaces pose_transfer_tpu/ops/warp_pallas.py::_pass1_kernel and
// ::_pass2_kernel (the pallas_calls of _forward). Per sample n and part t
// (transform m00 m01 tx m10 m11 ty, f32, translations scaled to the map):
//   pass 1  tmp[o, x] = round_T( sum_y rT(ramp(v(x, o) - y)) * f[y, x] )
//   pass 2  z[o, xo]  = f32( sum_x rT(ramp(u(xo, o) - x)) * tmp[o, x] )
//   fold    zm = round_T(z * f32(mask[t, o, xo])); part 0 is assigned, a later
//           part wins where f32(zm) > f32(out) (strict: the earliest part
//           wins ties), idx = the winning part (int8)
// with ramp(d) = max(0, 1 - |d|) in f32, rT = rounding to T, and positions
//   v(x, o)  = fl(fl(fl(m11*(o+.5)) + fl(ty-.5)) + fl(m10*(x+.5)))
//   u(xo, o) = fl(fl(fl(m00*(xo+.5)) + fl(tx-.5)) + fl(m01*(o+.5)))
// computed with __fmul_rn/__fadd_rn, so that nvcc cannot contract them into
// fused multiply-adds: the plain version rounds every product and sum.
//
// Design. Each output needs only 2x2 feature taps per part (a ramp has at
// most two nonzero taps), so no banded matrix is built and tmp never
// leaves registers. A block owns a tile of output pixels (kTileX a row, as
// many rows as 256 threads give at `lanes` threads a pixel) and a slice of
// the channels: each thread 16 bytes of channels of one pixel, neighbouring
// lanes on neighbouring channels, walking the parts in order (the tie rule
// needs no cross-thread order). The per-pixel arithmetic (positions, first
// taps, weights rounded to T, the mask) is done once per pixel and part in
// a set-up round by the whole block, into shared-memory records, not once
// per channel thread; the channel threads then only gather (up to four
// 16-byte loads of f a part, from L1/L2: a sample's map is a few MB) and
// fold. Where the part's mask is 0 the pixel folds zm = +0 with no taps
// (and only for the first such part: a later one cannot win over the +0),
// so a (tile, part) whose mask is 0 everywhere issues no loads at all: on
// a training step's inputs parts 1-9 cover 2-5 % of the pixels each. The
// plain version rounds z*0 to z's signed zero instead, so the output
// differs from it only in the sign of zeros (idx not at all: the compare is
// a strict f32 '>' and +0 == -0). Sums of exact products: in f32 for bf16
// (a product of two bf16 values is exact in f32) and in f64 for f32 (exact
// there); a sum of at most two such terms then rounds once, whatever the
// order, as the plain version's f64 products do.
//
// Bound: memory. Least bytes per launch (each input read once, each output
// written once): itemsize*(2*N*H*W*C + N*P*H*W) + 32*N*P (+ N*H*W*C int8
// idx). Fashion-256 stage 0 at N=8, P=10, bf16: 145 MB without the argmax,
// 178 MB with it -> 0.043 / 0.053 ms at 3.35 TB/s. Operations (f32 or f64
// multiply-adds on the taps, ~6 per channel and part) are below that bound
// in bf16 and near it in f32.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxParts = 127;   // int8 argmax
constexpr int kTileX = 8;        // tile width
constexpr int kRecs = 512;       // (pixel, part) records of a set-up round

template <typename T>
struct Num;

template <>
struct Num<float> {
  using Acc = double;   // the product of two f32 values is exact in f64
  static __device__ __forceinline__ float load(float v) { return v; }
  static __device__ __forceinline__ float round(float v) { return v; }
  static __device__ __forceinline__ float store(float v) { return v; }
};

template <>
struct Num<__nv_bfloat16> {
  using Acc = float;    // the product of two bf16 values is exact in f32
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

// The first of the (at most two) taps j0, j0+1 of position pos along an
// axis of n, or false when no tap can lie in [0, n) (also for a NaN).
__device__ __forceinline__ bool first_tap(float pos, int n, int& j0) {
  if (!(pos > -2.0f && pos < (float)n + 1.0f)) return false;
  j0 = (int)floorf(pos);
  return true;
}

// One output pixel's taps for one part with a nonzero mask m: x taps x0 + i
// with weight wx[i], each with y taps y0[i] + j with weight wy[2i + j] (all
// rounded to T; a tap that carries no term has weight 0). 48 bytes, read
// with three 16-byte shared-memory loads.
struct __align__(16) Rec {
  float m, wx[2], wy[4];
  int x0, y0[2], pad[2];
};

template <typename T>
__device__ __forceinline__ Rec pixel_taps(const float* tr, float m, int o,
                                          int xo, int H, int W) {
  Rec r;
  r.m = m;
  r.wx[0] = r.wx[1] = 0.0f;
  r.wy[0] = r.wy[1] = r.wy[2] = r.wy[3] = 0.0f;
  r.x0 = r.y0[0] = r.y0[1] = 0;
  const float oc = (float)o + 0.5f;
  const float u = __fadd_rn(
      __fadd_rn(__fmul_rn(tr[0], (float)xo + 0.5f), __fsub_rn(tr[2], 0.5f)),
      __fmul_rn(tr[1], oc));
  const float base_y = __fadd_rn(__fmul_rn(tr[4], oc),
                                 __fsub_rn(tr[5], 0.5f));
  int x0;
  if (!first_tap(u, W, x0)) return r;
  r.x0 = x0;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int x = x0 + i;
    if (x < 0 || x >= W) continue;
    const float wx = Num<T>::round(ramp(u, x));
    if (wx == 0.0f) continue;
    const float v = __fadd_rn(base_y, __fmul_rn(tr[3], (float)x + 0.5f));
    int y0;
    if (!first_tap(v, H, y0)) continue;   // tmp = +0 adds nothing to z
    r.y0[i] = y0;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int y = y0 + j;
      if (y >= 0 && y < H) r.wy[2 * i + j] = Num<T>::round(ramp(v, y));
    }
    if (r.wy[2 * i] != 0.0f || r.wy[2 * i + 1] != 0.0f) r.wx[i] = wx;
  }
  return r;
}

// Without the argmax the kernel fits 40 registers a thread, six blocks an
// SM: it waits on memory, and more warps in flight hide more of it.
template <typename T, bool EMIT_IDX>
__global__ void __launch_bounds__(kThreads, EMIT_IDX ? 4 : 6)
warp_fold_kernel(const T* __restrict__ f, const float* __restrict__ warps,
                 const T* __restrict__ masks, T* __restrict__ out,
                 int8_t* __restrict__ idx,
                 unsigned long long* __restrict__ stats, int H, int W, int C,
                 int P, int lanes, int tiles_x) {
  constexpr int VEC = 16 / sizeof(T);   // channels per thread (16 bytes)
  using Acc = typename Num<T>::Acc;
  __shared__ Rec s_rec[kRecs];
  __shared__ unsigned long long s_live[kThreads];   // per pixel: parts with
                                                     // a nonzero mask
  __shared__ unsigned long long s_any;   // the same over the tile (stats)
  const int n = blockIdx.z;
  const int pix = kThreads / lanes;            // pixels in the tile
  const int o_t = (blockIdx.x / tiles_x) * (pix / kTileX);
  const int x_t = (blockIdx.x % tiles_x) * kTileX;

  const int p = threadIdx.x / lanes;
  const int chunk = blockIdx.y * lanes + threadIdx.x % lanes;
  const int o = o_t + p / kTileX;
  const int xo = x_t + p % kTileX;
  const bool active = chunk < C / VEC && o < H && xo < W;
  const T* fn = f + (int64_t)n * H * W * C + (int64_t)chunk * VEC;
  const int round_parts = min(64, kRecs / pix);   // parts a round holds

  T best[VEC];   // the running max, always a value of T
  int8_t arg[VEC];
  // A zero-mask part folds +0, which can only win where the running max is
  // below 0: after the first such part it never is, so later zero-mask
  // parts leave the fold as it is and are passed over.
  bool zero_folded = false;
  for (int t0 = 0; t0 < P; t0 += round_parts) {
    const int tn = min(round_parts, P - t0);
    if (t0) __syncthreads();   // the previous round's records are read
    if (threadIdx.x < pix) s_live[threadIdx.x] = 0;
    if (threadIdx.x == 0) s_any = 0;
    __syncthreads();
    for (int i = threadIdx.x; i < tn * pix; i += kThreads) {
      const int q = i % pix, t = t0 + i / pix;
      const int qo = o_t + q / kTileX, qx = x_t + q % kTileX;
      if (qo >= H || qx >= W) continue;
      const float m = Num<T>::load(
          masks[(((int64_t)n * P + t) * H + qo) * W + qx]);
      if (m == 0.0f) continue;
      s_rec[i] = pixel_taps<T>(warps + ((int64_t)n * P + t) * 8, m, qo, qx,
                               H, W);
      atomicOr(&s_live[q], 1ull << (t - t0));
      if (stats) atomicOr(&s_any, 1ull << (t - t0));
    }
    __syncthreads();
    // stats: the (tile, part) pairs of the round, and those skipped (no
    // pixel of the tile has a nonzero mask: no loads), once per tile
    if (stats && threadIdx.x == 0 && blockIdx.y == 0) {
      atomicAdd(stats, (unsigned long long)(tn - __popcll(s_any)));
      atomicAdd(stats + 1, (unsigned long long)tn);
    }
    if (!active) continue;
    // the parts to fold, in order: those with a nonzero mask, and the
    // first zero-mask part (+0) unless one was folded already
    const unsigned long long live = s_live[p];
    unsigned long long visit = live;
    const unsigned long long zeros =
        ~live & (tn == 64 ? ~0ull : (1ull << tn) - 1);
    if (zeros && !zero_folded) {
      visit |= zeros & (~zeros + 1);   // the lowest zero-mask part
      zero_folded = true;
    }
    while (visit) {
      const int tt = __ffsll((long long)visit) - 1;
      visit &= visit - 1;
      const int t = t0 + tt;
      Acc z[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) z[k] = Acc(0);
      float m = 0.0f;   // a zero-mask part: +0 times +0
      if ((live >> tt) & 1) {
        const Rec r = s_rec[tt * pix + p];
        m = r.m;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float wx = r.wx[i];
          if (wx == 0.0f) continue;
          Acc tmp[VEC];
#pragma unroll
          for (int k = 0; k < VEC; ++k) tmp[k] = Acc(0);
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const float wy = r.wy[2 * i + j];
            if (wy == 0.0f) continue;
            const uint4 raw = *reinterpret_cast<const uint4*>(
                fn + ((int64_t)(r.y0[i] + j) * W + r.x0 + i) * C);
            const T* fv = reinterpret_cast<const T*>(&raw);
#pragma unroll
            for (int k = 0; k < VEC; ++k)
              tmp[k] += Acc(wy) * Acc(Num<T>::load(fv[k]));
          }
#pragma unroll
          for (int k = 0; k < VEC; ++k)   // tmp rounded to T, as pass 1 stores
            z[k] += Acc(wx) * Acc(Num<T>::round((float)tmp[k]));
        }
      }
      // the f32 z times the f32 mask, rounded once, compared in f32
#pragma unroll
      for (int k = 0; k < VEC; ++k) {
        const float zm = Num<T>::round(__fmul_rn((float)z[k], m));
        if (t == 0 || zm > Num<T>::load(best[k])) {
          best[k] = Num<T>::store(zm);
          arg[k] = (int8_t)t;
        }
      }
    }
  }
  if (!active) return;

  const int64_t at = (((int64_t)n * H + o) * W + xo) * C + chunk * VEC;
  uint4 res;
  T* rv = reinterpret_cast<T*>(&res);
#pragma unroll
  for (int k = 0; k < VEC; ++k) rv[k] = best[k];
  *reinterpret_cast<uint4*>(out + at) = res;
  if constexpr (EMIT_IDX) {
    if constexpr (VEC == 8) {
      uint2 packed;
      int8_t* a = reinterpret_cast<int8_t*>(&packed);
#pragma unroll
      for (int k = 0; k < VEC; ++k) a[k] = arg[k];
      *reinterpret_cast<uint2*>(idx + at) = packed;
    } else {
      uint32_t packed;
      int8_t* a = reinterpret_cast<int8_t*>(&packed);
#pragma unroll
      for (int k = 0; k < VEC; ++k) a[k] = arg[k];
      *reinterpret_cast<uint32_t*>(idx + at) = packed;
    }
  }
}

template <typename T, bool EMIT_IDX>
void launch(const void* f, const void* warps, const void* masks, void* out,
            void* idx, void* stats, int N, int H, int W, int C, int P,
            cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int cv = C / VEC;
  int lanes = 1;   // the next power of two >= cv, at most 32
  while (lanes < cv && lanes < 32) lanes *= 2;
  const int tile_h = kThreads / lanes / kTileX;
  const int tiles_x = (W + kTileX - 1) / kTileX;
  const int tiles_y = (H + tile_h - 1) / tile_h;
  dim3 grid((unsigned)(tiles_x * tiles_y),
            (unsigned)((cv + lanes - 1) / lanes), (unsigned)N);
  warp_fold_kernel<T, EMIT_IDX><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(f), static_cast<const float*>(warps),
      static_cast<const T*>(masks), static_cast<T*>(out),
      static_cast<int8_t*>(idx), static_cast<unsigned long long*>(stats), H,
      W, C, P, lanes, tiles_x);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. stats: null, or 2 uint64 to which the
// launch adds the (tile, part) pairs it skipped and all its pairs. Returns
// cudaGetLastError() after the launch (0 = success). Shapes and alignment
// are checked by the caller (pose_transfer_torch/ops/warp_pallas.py):
// C % (16 / itemsize) == 0, 1 <= P <= 127, every pointer 16-byte aligned,
// every tensor contiguous.
int warp_fold(const void* f, const void* warps, const void* masks, void* out,
              void* idx, void* stats, int N, int H, int W, int C, int P,
              int dtype, int emit_idx, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P < 1 || P > kMaxParts) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    if (emit_idx)
      launch<float, true>(f, warps, masks, out, idx, stats, N, H, W, C, P,
                          s);
    else
      launch<float, false>(f, warps, masks, out, idx, stats, N, H, W, C, P,
                           s);
  } else if (dtype == 1) {
    if (emit_idx)
      launch<__nv_bfloat16, true>(f, warps, masks, out, idx, stats, N, H, W,
                                  C, P, s);
    else
      launch<__nv_bfloat16, false>(f, warps, masks, out, idx, stats, N, H, W,
                                   C, P, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* warp_fold_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
