// Window placement of one part GROUP into an existing fold state (the
// part-streamed variant of fold_place).
//
// Replaces pose_transfer_tpu/ops/warp_fused.py::_place_stream_kernel
// (reached by fold_place_stream). Semantics, per sample n, in place:
//   for p = 0..Pg-1 (fold order), inside part p's (SY, SX) window at
//   (y0, x0) = offs[n, p, 0:2]:
//     z = round_T(f32(win) * f32(mwin))          (rounded BEFORE the compare)
//     if f32(z) > f32(acc): acc <- z, idx <- offs[n, p, 2]   (strict: the
//                                              earliest part wins ties)
// No body init, no zero pass, no idx reset: the caller initialises the
// state from the masked body warp (idx 0) and applies the zero pass after
// the last group. idx may be absent (the primal-only stream).
//
// Design. As csrc/fold_place.cu: the unit of parallel work is 16 bytes of
// channels of one (n, y, x) pixel, and each thread visits the group's parts
// in order, so two parts whose windows overlap never race and the earliest
// part keeps ties. A thread that no window of the group covers returns
// before touching device memory, so each launch reads and writes the state
// only over the group's windows. The TPU kernel aliased the state buffers
// (input_output_aliases); here the kernel updates acc and idx in place.
//
// Bound: memory. Bytes per launch = itemsize*(N*Pg*SY*SX*C + N*Pg*SY*SX)
//   + 2*covered*C*itemsize (+ 2*covered*C for the int8 idx), covered = the
//   pixels the group's windows cover (overlaps counted once).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxParts = 32;

// f32 views of the compute dtype, as in fold_place.cu
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

template <typename T, bool HAS_IDX>
__global__ void __launch_bounds__(kThreads)
fold_place_stream_kernel(T* __restrict__ acc, int8_t* __restrict__ idx,
                         const T* __restrict__ wins,
                         const T* __restrict__ mwins,
                         const int32_t* __restrict__ offs, int H, int W,
                         int C, int P, int SY, int SX) {
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

  bool covered = false;
  for (int p = 0; p < P && !covered; ++p) {
    const int wy = y - s_offs[3 * p];
    const int wx = x - s_offs[3 * p + 1];
    covered = wy >= 0 && wy < SY && wx >= 0 && wx < SX;
  }
  if (!covered) return;

  const int64_t o = ((int64_t)n * H * W + pix) * C + c0;
  float cur[VEC];
  int8_t arg[VEC];
  {
    uint4 raw = *reinterpret_cast<const uint4*>(acc + o);
    const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      cur[k] = Num<T>::load(v[k]);
      if constexpr (HAS_IDX) arg[k] = idx[o + k];
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
      if (z > cur[k]) {
        cur[k] = z;
        if constexpr (HAS_IDX) arg[k] = part;
      }
    }
  }

  uint4 res;
  T* r = reinterpret_cast<T*>(&res);
#pragma unroll
  for (int k = 0; k < VEC; ++k) r[k] = Num<T>::store(cur[k]);
  *reinterpret_cast<uint4*>(acc + o) = res;
  if constexpr (HAS_IDX) {
#pragma unroll
    for (int k = 0; k < VEC; ++k) idx[o + k] = arg[k];
  }
}

template <typename T, bool HAS_IDX>
void launch(void* acc, void* idx, const void* wins, const void* mwins,
            const void* offs, int N, int H, int W, int C, int P, int SY,
            int SX, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int64_t per_sample = (int64_t)H * W * (C / VEC);
  dim3 grid((unsigned)((per_sample + kThreads - 1) / kThreads), (unsigned)N);
  fold_place_stream_kernel<T, HAS_IDX><<<grid, kThreads, 0, stream>>>(
      static_cast<T*>(acc), static_cast<int8_t*>(idx),
      static_cast<const T*>(wins), static_cast<const T*>(mwins),
      static_cast<const int32_t*>(offs), H, W, C, P, SY, SX);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; idx NULL runs the primal-only stream.
// Returns cudaGetLastError() after the launch (0 = success). Shapes and
// alignment are checked by the caller (pose_transfer_torch/ops/
// warp_fused.py): C % (16 / itemsize) == 0, P <= 32, every pointer 16-byte
// aligned, every tensor contiguous.
int fold_place_stream(void* acc, void* idx, const void* wins,
                      const void* mwins, const void* offs, int N, int H,
                      int W, int C, int P, int SY, int SX, int dtype,
                      void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P > kMaxParts) return (int)cudaErrorInvalidValue;
  const bool has_idx = idx != nullptr;
  if (dtype == 0) {
    if (has_idx)
      launch<float, true>(acc, idx, wins, mwins, offs, N, H, W, C, P, SY, SX,
                          s);
    else
      launch<float, false>(acc, idx, wins, mwins, offs, N, H, W, C, P, SY,
                           SX, s);
  } else if (dtype == 1) {
    if (has_idx)
      launch<__nv_bfloat16, true>(acc, idx, wins, mwins, offs, N, H, W, C, P,
                                  SY, SX, s);
    else
      launch<__nv_bfloat16, false>(acc, idx, wins, mwins, offs, N, H, W, C,
                                   P, SY, SX, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* fold_place_stream_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
