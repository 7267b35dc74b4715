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
// the banded matrices on the other side, write dtmp (N, T, H, W, C) to HBM
// and accumulate df over a sequential part axis. A transposed pass is a
// scatter; here it is a GATHER with no atomics, so runs are deterministic:
// one thread owns 16 bytes of channels of one df pixel (y, x) and walks the
// parts in order. For a part, the rows o whose vertical taps touch y form a
// range: v(x, o) is affine in o with slope m11, so the range comes from
// inverting it, widened by one on each side; every candidate is then
// evaluated with the forward's own ramp formula, and a term outside the true
// support has weight exactly 0 and is skipped, so the margin cannot change
// the result. For each o with a nonzero weight, dtmp[o, x] is gathered the
// same way over the xo whose horizontal taps touch x (slope m00). A slope
// below 1e-3 in magnitude (or not finite) scans the whole row or column.
// dtmp is recomputed for each y it feeds (two, for a unit scale) and never
// goes to HBM. Sums run in f64 from +0: every product of the f32 weights
// with f32 (or bf16-valued) terms is exact there; the plain version's f64
// products sum the same terms in another order, so a rounding to f32 or T
// may flip where the f64 sums straddle its boundary (the check's
// tolerance).
//
// Bound: memory. Least bytes per launch (each input read once, each output
// written once): itemsize*(2*N*H*W*C + N*P*H*W) + N*H*W*C (int8 idx)
// + 32*N*P. Fashion-256 stage 0 at N=8, P=10, bf16: 178 MB -> 0.053 ms at
// 3.35 TB/s. The gathers re-read g and idx from L1/L2 about 2x2 times per
// part; their f64 multiply-adds are the kernel's real cost.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxParts = 127;   // int8 argmax

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

// [lo, hi] within [0, n) holding every i whose position
// slope*(i + .5) + offset lies within 1 of target, widened by one on each
// side against the rounding of the position; the whole axis when |slope| <
// 1e-3 or a bound is not finite; lo > hi when empty.
__device__ __forceinline__ void support(float slope, float offset, int target,
                                        int n, int& lo, int& hi) {
  lo = 0;
  hi = n - 1;
  if (!(fabsf(slope) >= 1e-3f)) return;
  const double inv = 1.0 / (double)slope;
  double a = ((double)target - 1.0 - (double)offset) * inv - 0.5;
  double b = ((double)target + 1.0 - (double)offset) * inv - 0.5;
  if (a > b) {
    const double s = a;
    a = b;
    b = s;
  }
  a = floor(a) - 1.0;
  b = ceil(b) + 1.0;
  if (!(isfinite(a) && isfinite(b))) return;
  if (b < 0.0 || a > (double)(n - 1)) {
    lo = 1;
    hi = 0;
    return;
  }
  lo = (int)fmax(a, 0.0);
  hi = (int)fmin(b, (double)(n - 1));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
warp_fold_bwd_kernel(const T* __restrict__ g, const float* __restrict__ warps,
                     const T* __restrict__ masks,
                     const int8_t* __restrict__ idx, T* __restrict__ df,
                     int H, int W, int C, int P) {
  constexpr int VEC = 16 / sizeof(T);   // channels per thread (16 bytes)
  __shared__ float s_tr[kMaxParts * 6];

  const int n = blockIdx.y;
  for (int i = threadIdx.x; i < P * 6; i += blockDim.x)
    s_tr[i] = warps[((int64_t)n * P + i / 6) * 8 + i % 6];
  __syncthreads();

  const int cv = C / VEC;
  const int64_t tid = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (tid >= (int64_t)H * W * cv) return;
  const int pix = (int)(tid / cv);
  const int c0 = (int)(tid % cv) * VEC;
  const int y = pix / W;
  const int x = pix % W;
  const float xc = (float)x + 0.5f;
  const int64_t map0 = (int64_t)n * H * W;   // first pixel of the sample

  float acc[VEC];
  for (int t = 0; t < P; ++t) {
    const float* tr = s_tr + 6 * t;
    const float m00 = tr[0], m01 = tr[1], txh = __fsub_rn(tr[2], 0.5f);
    const float m11 = tr[4], tyh = __fsub_rn(tr[5], 0.5f);
    const float off_y = __fmul_rn(tr[3], xc);      // fl(m10*(x+.5))
    const T* mask_t = masks + ((int64_t)n * P + t) * H * W;
    double dft[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) dft[k] = 0.0;
    int o_lo, o_hi;
    support(m11, __fadd_rn(tyh, off_y), y, H, o_lo, o_hi);
    for (int o = o_lo; o <= o_hi; ++o) {
      const float oc = (float)o + 0.5f;
      const float v = __fadd_rn(__fadd_rn(__fmul_rn(m11, oc), tyh), off_y);
      const float wy = ramp(v, y);
      if (wy == 0.0f) continue;
      // dtmp[o, x]: the pass-2 transpose, gathered over xo
      const float off_x = __fmul_rn(m01, oc);      // fl(m01*(o+.5))
      double dt[VEC];
#pragma unroll
      for (int k = 0; k < VEC; ++k) dt[k] = 0.0;
      int xo_lo, xo_hi;
      support(m00, __fadd_rn(txh, off_x), x, W, xo_lo, xo_hi);
      for (int xo = xo_lo; xo <= xo_hi; ++xo) {
        const float u = __fadd_rn(
            __fadd_rn(__fmul_rn(m00, (float)xo + 0.5f), txh), off_x);
        const float wx = ramp(u, x);
        if (wx == 0.0f) continue;
        const int64_t at = (map0 + (int64_t)o * W + xo) * C + c0;
        const float m = Num<T>::load(mask_t[(int64_t)o * W + xo]);
        const uint4 raw = *reinterpret_cast<const uint4*>(g + at);
        const T* gv = reinterpret_cast<const T*>(&raw);
        int8_t sel[VEC];
        if constexpr (VEC == 8) {
          *reinterpret_cast<uint2*>(sel) =
              *reinterpret_cast<const uint2*>(idx + at);
        } else {
          *reinterpret_cast<uint32_t*>(sel) =
              *reinterpret_cast<const uint32_t*>(idx + at);
        }
#pragma unroll
        for (int k = 0; k < VEC; ++k) {
          const float gk = sel[k] == t ? Num<T>::load(gv[k]) : 0.0f;
          dt[k] += (double)wx * (double)__fmul_rn(gk, m);
        }
      }
#pragma unroll
      for (int k = 0; k < VEC; ++k)   // dtmp rounded to T
        dft[k] += (double)wy * (double)Num<T>::round((float)dt[k]);
    }
#pragma unroll
    for (int k = 0; k < VEC; ++k) {   // df_t rounded to T, summed in T
      const float d = Num<T>::round((float)dft[k]);
      acc[k] = t == 0 ? d : Num<T>::round(__fadd_rn(acc[k], d));
    }
  }

  uint4 res;
  T* r = reinterpret_cast<T*>(&res);
#pragma unroll
  for (int k = 0; k < VEC; ++k) r[k] = Num<T>::store(acc[k]);
  *reinterpret_cast<uint4*>(df + (map0 + pix) * C + c0) = res;
}

template <typename T>
void launch(const void* g, const void* warps, const void* masks,
            const void* idx, void* df, int N, int H, int W, int C, int P,
            cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int64_t per_sample = (int64_t)H * W * (C / VEC);
  dim3 grid((unsigned)((per_sample + kThreads - 1) / kThreads), (unsigned)N);
  warp_fold_bwd_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const float*>(warps),
      static_cast<const T*>(masks), static_cast<const int8_t*>(idx),
      static_cast<T*>(df), H, W, C, P);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 = success). Shapes and alignment are checked by the caller
// (pose_transfer_torch/ops/warp_pallas.py): C % (16 / itemsize) == 0,
// 1 <= P <= 127, every pointer 16-byte aligned, every tensor contiguous.
int warp_fold_bwd(const void* g, const void* warps, const void* masks,
                  const void* idx, void* df, int N, int H, int W, int C,
                  int P, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P < 1 || P > kMaxParts) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    launch<float>(g, warps, masks, idx, df, N, H, W, C, P, s);
  else if (dtype == 1)
    launch<__nv_bfloat16>(g, warps, masks, idx, df, N, H, W, C, P, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

const char* warp_fold_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
