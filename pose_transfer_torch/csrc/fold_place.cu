// Window-placement max fold of the deformable warp (forward).
//
// Replaces pose_transfer_tpu/ops/warp_fused.py::_place_kernel (reached by
// fold_place). Semantics, per sample n:
//   out <- body (the pre-masked body warp), idx <- 0
//   for p = 0..P-1 (fold order), inside part p's (SY, SX) window at
//   (y0, x0) = offs[n, p, 0:2]:
//     z = round_T(f32(win) * f32(mwin))          (rounded BEFORE the compare)
//     if f32(z) > f32(out): out <- z, idx <- offs[n, p, 2]   (strict: the
//                                                  earliest part wins ties)
//   zero pass: where zero_nb[n, y, x] and out < 0: out <- +0, idx <- -1
//
// Design. The TPU kernel walks a sequential (sample, part) grid and keeps a
// whole sample's out/idx block resident in VMEM. Hopper blocks run in
// parallel and in no order, so here the OUTPUT ELEMENT is the unit of
// parallel work and the part loop runs sequentially inside each thread:
// every thread owns VEC consecutive channels of one (n, y, x) pixel (16-byte
// loads along C, contiguous in NHWC), reads the body once, visits the
// sample's parts in order (offs staged in shared memory), keeps the running
// max and argmax in registers, applies the zero pass and writes out (and
// idx) once. Visiting each pixel's parts in order keeps the earliest-part
// tie rule exact without any cross-thread ordering.
//
// Bound: memory. No arithmetic to speak of; each input element is read once
// and each output element written once. Bytes per launch =
//   itemsize*(2*N*H*W*C + N*P*SY*SX*C + N*P*SY*SX) + N*H*W (zero_nb, 1 byte)
//   (+ N*H*W*C for the int8 idx when emit_idx).
// Fashion-256 stage 0 at N=8, bf16: ~308 MB -> ~92 us at 3.35 TB/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxParts = 32;

// f32 views of the compute dtype: load (exact), round (to T and back),
// store (exact for values that are already T values)
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

template <typename T, bool EMIT_IDX>
__global__ void __launch_bounds__(kThreads)
fold_place_kernel(const T* __restrict__ body, const T* __restrict__ wins,
                  const T* __restrict__ mwins,
                  const uint8_t* __restrict__ zero_nb,
                  const int32_t* __restrict__ offs, T* __restrict__ out,
                  int8_t* __restrict__ idx, int H, int W, int C, int P,
                  int SY, int SX) {
  constexpr int VEC = 16 / sizeof(T);   // channels per thread (16 bytes)
  __shared__ int s_offs[kMaxParts * 3];

  const int n = blockIdx.y;
  for (int i = threadIdx.x; i < P * 3; i += blockDim.x)
    s_offs[i] = offs[(int64_t)n * P * 3 + i];
  __syncthreads();

  const int cv = C / VEC;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= (int64_t)H * W * cv) return;
  const int pix = (int)(t / cv);
  const int c0 = (int)(t % cv) * VEC;
  const int y = pix / W;
  const int x = pix % W;
  const int64_t o = ((int64_t)n * H * W + pix) * C + c0;

  float acc[VEC];
  int8_t arg[VEC];
  {
    uint4 raw = *reinterpret_cast<const uint4*>(body + o);
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      acc[k] = Num<T>::load(v[k]);
      arg[k] = 0;
    }
  }

  for (int p = 0; p < P; ++p) {
    const int wy = y - s_offs[3 * p];
    const int wx = x - s_offs[3 * p + 1];
    if (wy < 0 || wy >= SY || wx < 0 || wx >= SX) continue;
    const int64_t wpix = (((int64_t)n * P + p) * SY + wy) * SX + wx;
    const float m = Num<T>::load(mwins[wpix]);
    uint4 raw = *reinterpret_cast<const uint4*>(wins + wpix * C + c0);
    const T* v = reinterpret_cast<const T*>(&raw);
    const int8_t part = (int8_t)s_offs[3 * p + 2];
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const float z = Num<T>::round(Num<T>::load(v[k]) * m);
      if (z > acc[k]) {
        acc[k] = z;
        if constexpr (EMIT_IDX) arg[k] = part;
      }
    }
  }

  const bool zero = zero_nb[(int64_t)n * H * W + pix] != 0;
  uint4 res;
  T* r = reinterpret_cast<T*>(&res);
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    if (zero && acc[k] < 0.0f) {
      acc[k] = 0.0f;
      arg[k] = -1;
    }
    r[k] = Num<T>::store(acc[k]);
  }
  *reinterpret_cast<uint4*>(out + o) = res;
  if constexpr (EMIT_IDX) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) idx[o + k] = arg[k];
  }
}

template <typename T, bool EMIT_IDX>
void launch(const void* body, const void* wins, const void* mwins,
            const void* zero_nb, const void* offs, void* out, void* idx,
            int N, int H, int W, int C, int P, int SY, int SX,
            cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int64_t per_sample = (int64_t)H * W * (C / VEC);
  dim3 grid((unsigned)((per_sample + kThreads - 1) / kThreads), (unsigned)N);
  fold_place_kernel<T, EMIT_IDX><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(body), static_cast<const T*>(wins),
      static_cast<const T*>(mwins), static_cast<const uint8_t*>(zero_nb),
      static_cast<const int32_t*>(offs), static_cast<T*>(out),
      static_cast<int8_t*>(idx), H, W, C, P, SY, SX);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 = success). Shapes and alignment are checked by the caller
// (pose_transfer_torch/ops/warp_fused.py): C % (16 / itemsize) == 0,
// P <= 32, every pointer 16-byte aligned, every tensor contiguous.
int fold_place(const void* body, const void* wins, const void* mwins,
               const void* zero_nb, const void* offs, void* out, void* idx,
               int N, int H, int W, int C, int P, int SY, int SX, int dtype,
               int emit_idx, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P > kMaxParts) return (int)cudaErrorInvalidValue;
  if (dtype == 0) {
    if (emit_idx)
      launch<float, true>(body, wins, mwins, zero_nb, offs, out, idx, N, H, W,
                          C, P, SY, SX, s);
    else
      launch<float, false>(body, wins, mwins, zero_nb, offs, out, idx, N, H,
                           W, C, P, SY, SX, s);
  } else if (dtype == 1) {
    if (emit_idx)
      launch<__nv_bfloat16, true>(body, wins, mwins, zero_nb, offs, out, idx,
                                  N, H, W, C, P, SY, SX, s);
    else
      launch<__nv_bfloat16, false>(body, wins, mwins, zero_nb, offs, out,
                                   idx, N, H, W, C, P, SY, SX, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* fold_place_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
