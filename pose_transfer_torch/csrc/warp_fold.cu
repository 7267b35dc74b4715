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
// Design. The TPU kernels build the banded ramp matrices in VMEM, one
// (part, column block) grid cell at a time, write tmp to HBM between the
// passes and keep a row block's running max resident across the part axis.
// Each output here needs only 2x2 feature taps per part (a ramp has at most
// two nonzero taps), so no matrix is built and tmp never leaves registers:
// one thread owns 16 bytes of channels (8 bf16 or 4 f32) of one output
// pixel and walks the parts in order (the tie rule needs no cross-thread
// order). Per part: u, its <= 2 in-range x taps; for each, v and its <= 2
// y taps (four 16-byte loads of f), tmp rounded to T, z, the mask, the
// compare. The sums start from +0, as a dense product does; an out-of-range
// position (the translation-by-1000 sentinel) has no taps and gives +0.
// Sums of exact products: in f32 for bf16 (a product of two bf16 values is
// exact in f32) and in f64 for f32 (exact there); a sum of at most two such
// terms then rounds once, whatever the order, as the plain version's f64
// products do. The sample's transforms are staged in shared memory.
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

template <typename T, bool EMIT_IDX>
__global__ void __launch_bounds__(kThreads)
warp_fold_kernel(const T* __restrict__ f, const float* __restrict__ warps,
                 const T* __restrict__ masks, T* __restrict__ out,
                 int8_t* __restrict__ idx, int H, int W, int C, int P) {
  constexpr int VEC = 16 / sizeof(T);   // channels per thread (16 bytes)
  using Acc = typename Num<T>::Acc;
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
  const int o = pix / W;
  const int xo = pix % W;
  const float oc = (float)o + 0.5f;
  const float xc = (float)xo + 0.5f;
  const T* fn = f + (int64_t)n * H * W * C + c0;

  float best[VEC];
  int8_t arg[VEC];
  for (int t = 0; t < P; ++t) {
    const float* tr = s_tr + 6 * t;
    const float u = __fadd_rn(
        __fadd_rn(__fmul_rn(tr[0], xc), __fsub_rn(tr[2], 0.5f)),
        __fmul_rn(tr[1], oc));
    const float base_y = __fadd_rn(__fmul_rn(tr[4], oc),
                                   __fsub_rn(tr[5], 0.5f));
    Acc z[VEC];
#pragma unroll
    for (int k = 0; k < VEC; ++k) z[k] = Acc(0);
    int x0;
    if (first_tap(u, W, x0)) {
      for (int x = max(x0, 0); x <= min(x0 + 1, W - 1); ++x) {
        const float wx = Num<T>::round(ramp(u, x));
        if (wx == 0.0f) continue;
        const float v = __fadd_rn(base_y,
                                  __fmul_rn(tr[3], (float)x + 0.5f));
        Acc tmp[VEC];
#pragma unroll
        for (int k = 0; k < VEC; ++k) tmp[k] = Acc(0);
        int y0;
        if (first_tap(v, H, y0)) {
          for (int y = max(y0, 0); y <= min(y0 + 1, H - 1); ++y) {
            const float wy = Num<T>::round(ramp(v, y));
            if (wy == 0.0f) continue;
            const uint4 raw = *reinterpret_cast<const uint4*>(
                fn + ((int64_t)y * W + x) * C);
            const T* fv = reinterpret_cast<const T*>(&raw);
#pragma unroll
            for (int k = 0; k < VEC; ++k)
              tmp[k] += Acc(wy) * Acc(Num<T>::load(fv[k]));
          }
        }
#pragma unroll
        for (int k = 0; k < VEC; ++k)   // tmp rounded to T, as pass 1 stores
          z[k] += Acc(wx) * Acc(Num<T>::round((float)tmp[k]));
      }
    }
    // the f32 z times the f32 mask, rounded once, compared in f32
    const float m =
        Num<T>::load(masks[(((int64_t)n * P + t) * H + o) * W + xo]);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float zm = Num<T>::round(__fmul_rn((float)z[k], m));
      if (t == 0 || zm > best[k]) {
        best[k] = zm;
        arg[k] = (int8_t)t;
      }
    }
  }

  const int64_t at = ((int64_t)n * H * W + pix) * C + c0;
  uint4 res;
  T* r = reinterpret_cast<T*>(&res);
#pragma unroll
  for (int k = 0; k < VEC; ++k) r[k] = Num<T>::store(best[k]);
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
            void* idx, int N, int H, int W, int C, int P,
            cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int64_t per_sample = (int64_t)H * W * (C / VEC);
  dim3 grid((unsigned)((per_sample + kThreads - 1) / kThreads), (unsigned)N);
  warp_fold_kernel<T, EMIT_IDX><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(f), static_cast<const float*>(warps),
      static_cast<const T*>(masks), static_cast<T*>(out),
      static_cast<int8_t*>(idx), H, W, C, P);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 = success). Shapes and alignment are checked by the caller
// (pose_transfer_torch/ops/warp_pallas.py): C % (16 / itemsize) == 0,
// 1 <= P <= 127, every pointer 16-byte aligned, every tensor contiguous.
int warp_fold(const void* f, const void* warps, const void* masks, void* out,
              void* idx, int N, int H, int W, int C, int P, int dtype,
              int emit_idx, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P < 1 || P > kMaxParts) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    if (emit_idx)
      launch<float, true>(f, warps, masks, out, idx, N, H, W, C, P, s);
    else
      launch<float, false>(f, warps, masks, out, idx, N, H, W, C, P, s);
  } else if (dtype == 1) {
    if (emit_idx)
      launch<__nv_bfloat16, true>(f, warps, masks, out, idx, N, H, W, C, P,
                                  s);
    else
      launch<__nv_bfloat16, false>(f, warps, masks, out, idx, N, H, W, C, P,
                                   s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* warp_fold_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
