// Backward router of the window-placement max fold.
//
// Replaces pose_transfer_tpu/ops/warp_fused.py::_route_kernel (reached by
// fold_route). Given the fold's cotangent g and the argmax idx that
// fold_place wrote (original part indices, 0 for the body, -1 where the
// zero pass won), per sample n:
//   gwins[n, p] = round_T(f32(g[n, win_p]) * f32(mwins[n, p]))
//                 where idx[n, win_p] == offs[n, p, 2], else +0 * mwins
//     with win_p the (SY, SX) window at (y0, x0) = offs[n, p, 0:2]
//   gbody[n]    = round_T(f32(where(idx[n] == 0, g[n], +0)) * f32(mask0[n]))
// The selected value is multiplied in f32 and rounded once to T. A
// deselected element is +0 times the mask (+0 for the nonnegative masks);
// a selected negative g times a zero mask is -0, as in the plain version.
//
// Design. The TPU kernel walks a sequential (sample, part) grid with the
// sample's g and idx blocks resident in VMEM and emits the body route at
// part 0. Here no output depends on another, so the OUTPUT ELEMENT is the
// unit of parallel work: one thread owns 16 bytes of channels (8 bf16 or 4
// f32) of one output pixel, of either a part window or the body map, in
// one grid (blockIdx.y = sample; the x range covers the sample's P*SY*SX
// window pixels, then its H*W body pixels). It loads 16 bytes of g, the
// matching VEC int8 idx lanes and one mask scalar, selects, multiplies and
// stores 16 bytes. The sample's offs are staged in shared memory.
//
// Bound: memory. One multiply and one compare per output element; g and
// idx are read for the body and again, inside the windows (L2 serves part
// of the overlap), for the parts. Least bytes per launch (each input read
// once, each output written once):
//   itemsize*(2*N*H*W*C + N*P*SY*SX*C + N*P*SY*SX + N*H*W)
//   + N*H*W*C (int8 idx) + 12*N*P (offs)
// Fashion-256 stage 0 at N=8, bf16: ~341 MB -> ~0.10 ms at 3.35 TB/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxParts = 32;

template <typename T>
struct Num;

template <>
struct Num<float> {
  static __device__ __forceinline__ float load(float v) { return v; }
  static __device__ __forceinline__ float store(float v) { return v; }
};

template <>
struct Num<__nv_bfloat16> {
  static __device__ __forceinline__ float load(__nv_bfloat16 v) {
    return __bfloat162float(v);
  }
  static __device__ __forceinline__ __nv_bfloat16 store(float v) {
    return __float2bfloat16_rn(v);
  }
};

// VEC int8 lanes of idx (VEC = 8: 8 bytes, VEC = 4: 4 bytes), aligned to
// their size because C % VEC == 0 and idx is 16-byte aligned
template <int VEC>
struct IdxLanes;

template <>
struct IdxLanes<8> {
  static __device__ __forceinline__ void load(const int8_t* p, int8_t* out) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const int8_t* v = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int k = 0; k < 8; ++k) out[k] = v[k];
  }
};

template <>
struct IdxLanes<4> {
  static __device__ __forceinline__ void load(const int8_t* p, int8_t* out) {
    const uint32_t raw = *reinterpret_cast<const uint32_t*>(p);
    const int8_t* v = reinterpret_cast<const int8_t*>(&raw);
#pragma unroll
    for (int k = 0; k < 4; ++k) out[k] = v[k];
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
fold_route_kernel(const T* __restrict__ g, const int8_t* __restrict__ idx,
                  const T* __restrict__ mask0, const T* __restrict__ mwins,
                  const int32_t* __restrict__ offs, T* __restrict__ gwins,
                  T* __restrict__ gbody, int H, int W, int C, int P, int SY,
                  int SX) {
  constexpr int VEC = 16 / sizeof(T);   // channels per thread (16 bytes)
  __shared__ int s_offs[kMaxParts * 3];

  const int n = blockIdx.y;
  for (int i = threadIdx.x; i < P * 3; i += blockDim.x)
    s_offs[i] = offs[(int64_t)n * P * 3 + i];
  __syncthreads();

  const int cv = C / VEC;
  const int64_t win_items = (int64_t)P * SY * SX * cv;
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= win_items + (int64_t)H * W * cv) return;

  int64_t src;     // (n, y, x, c0) offset into g and idx
  int64_t dst;     // offset into gwins or gbody
  float m;
  int part;
  T* out;
  if (t < win_items) {
    const int64_t wpix = t / cv;              // (p, wy, wx) within sample
    const int c0 = (int)(t % cv) * VEC;
    const int p = (int)(wpix / ((int64_t)SY * SX));
    const int r = (int)(wpix % ((int64_t)SY * SX));
    const int y = s_offs[3 * p] + r / SX;
    const int x = s_offs[3 * p + 1] + r % SX;
    part = s_offs[3 * p + 2];
    const int64_t gw = (int64_t)n * P * SY * SX + wpix;
    dst = gw * C + c0;
    out = gwins;
    if (y < 0 || y >= H || x < 0 || x >= W) {
      // a window outside the map (the caller's contract excludes it):
      // route nothing rather than read out of bounds
      *reinterpret_cast<uint4*>(out + dst) = make_uint4(0, 0, 0, 0);
      return;
    }
    m = Num<T>::load(mwins[gw]);
    src = (((int64_t)n * H + y) * W + x) * C + c0;
  } else {
    const int64_t b = t - win_items;
    const int pix = (int)(b / cv);
    const int c0 = (int)(b % cv) * VEC;
    part = 0;
    m = Num<T>::load(mask0[(int64_t)n * H * W + pix]);
    src = ((int64_t)n * H * W + pix) * C + c0;
    dst = src;
    out = gbody;
  }

  const uint4 raw = *reinterpret_cast<const uint4*>(g + src);
  const T* v = reinterpret_cast<const T*>(&raw);
  int8_t sel[VEC];
  IdxLanes<VEC>::load(idx + src, sel);
  uint4 res;
  T* o = reinterpret_cast<T*>(&res);
#pragma unroll
  for (int k = 0; k < VEC; ++k) {
    const float gv = ((int)sel[k] == part) ? Num<T>::load(v[k]) : 0.0f;
    o[k] = Num<T>::store(gv * m);
  }
  *reinterpret_cast<uint4*>(out + dst) = res;
}

template <typename T>
void launch(const void* g, const void* idx, const void* mask0,
            const void* mwins, const void* offs, void* gwins, void* gbody,
            int N, int H, int W, int C, int P, int SY, int SX,
            cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const int64_t per_sample = ((int64_t)P * SY * SX + (int64_t)H * W) *
                             (C / VEC);
  dim3 grid((unsigned)((per_sample + kThreads - 1) / kThreads), (unsigned)N);
  fold_route_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(g), static_cast<const int8_t*>(idx),
      static_cast<const T*>(mask0), static_cast<const T*>(mwins),
      static_cast<const int32_t*>(offs), static_cast<T*>(gwins),
      static_cast<T*>(gbody), H, W, C, P, SY, SX);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16. Returns cudaGetLastError() after the
// launch (0 = success). Shapes and alignment are checked by the caller
// (pose_transfer_torch/ops/warp_fused.py): C % (16 / itemsize) == 0,
// 1 <= P <= 32, windows in bounds, every pointer 16-byte aligned, every
// tensor contiguous.
int fold_route(const void* g, const void* idx, const void* mask0,
               const void* mwins, const void* offs, void* gwins, void* gbody,
               int N, int H, int W, int C, int P, int SY, int SX, int dtype,
               void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (P < 1 || P > kMaxParts) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    launch<float>(g, idx, mask0, mwins, offs, gwins, gbody, N, H, W, C, P, SY,
                  SX, s);
  else if (dtype == 1)
    launch<__nv_bfloat16>(g, idx, mask0, mwins, offs, gwins, gbody, N, H, W,
                          C, P, SY, SX, s);
  else
    return (int)cudaErrorInvalidValue;
  return (int)cudaGetLastError();
}

const char* fold_route_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
