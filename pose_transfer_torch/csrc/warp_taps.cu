// The fold's two-pass warp as taps: the windowed warp (warp_taps) and its
// transpose (warp_taps_t).
//
// Replaces no TPU kernel: the JAX package computes these two passes as
// banded-matrix dots on the MXU (pose_transfer_tpu/ops/warp.py,
// _warp_batch_win and _warp_batch_t_win_joint), and the port did the same
// with dense banded weights (ops/warp.py::_two_pass_weights) built anew on
// every call, which moved ~40 bytes of weights per window element. Each
// output of either pass has at most two nonzero taps, so these kernels
// compute the taps directly from the transforms.
//
// Semantics (ops/warp_fused.py::warp_taps_reference and
// ::warp_taps_t_reference), per sample n and part p, coef[n, p] = (m00,
// m01, tx, m10, m11, ty, y0, x0) in f32:
//   pos(a, s, b, t, c) = ((a*s + b*t) + c) - 0.5, each step rounded in f32
//   ramp(q, j)         = round_T(max(0, 1 - |q - j|))
//   the taps of q along an axis of L: j = floor(q), floor(q) + 1, those
//   in [0, L); the others contribute +0
// forward, window pixel (o, a): yo = (y0 + o) + 0.5, xo = (x0 + a) + 0.5,
//   u = pos(m00, xo, m01, yo, tx); for each tap x of u:
//     v = pos(m10, x + 0.5, m11, yo, ty)     (v at the SOURCE column x:
//                                             the two-pass approximation)
//     tmp_x = round_T(ramp(v, y0')*f[y0', x] + ramp(v, y1')*f[y1', x])
//   out = round_T(ramp(u, x0')*tmp_x0' + ramp(u, x1')*tmp_x1')
//   products and sums in f32 (__fmul_rn / __fadd_rn: nvcc would contract
//   a*b + c to an FMA and break bitwise equality with the plain version).
// transpose, feature pixel (y, x), same positions and weights:
//   dtmp(p, o, x) = round_T(sum over a of ramp(u(o, a), x) * g[p, o, a])
//   df[y, x] = sum over (p, o) of ramp(v(x, o), y) * dtmp(p, o, x), in f32:
//   f32 out when joint, else rounded to T.
//
// Design. The output element is the unit of parallel work: a thread owns
// VEC channels (16 bytes) of one output pixel. The forward gathers its 2x2
// taps (four 16-byte loads, neighbouring threads on neighbouring pixels,
// so L1/L2 serve the overlap). The transpose is written as a gather, with
// no float atomics, so it is deterministic: the window rows o whose
// vertical taps reach row y at column x are those with |v(x, o) - y| < 1,
// an interval in o of slope m11; the window columns a whose horizontal
// taps reach column x, an interval in a of slope m00. `bracket` bounds each
// interval from the real-valued line with a margin for the f32 rounding,
// and every tap inside is tested with the exact f32 formula. A slope at or
// near 0 (a degenerate part) gives all of the axis or none of it; a
// negative slope (a flip) swaps the interval's ends; windows that reach
// outside the map or transforms that map wholly outside need nothing more.
// Each block stages its sample's parts, with the slopes' reciprocals, in
// shared memory. (Measured on the card: skipping the parts whose reach
// misses a block's pixels, and issuing a window row's loads together, were
// slower, from the registers and the arithmetic they add.)
//
// Bound: memory. Least bytes per launch:
//   forward:   itemsize*(N*H*W*C + N*P*SY*SX*C) + 32*N*P
//   transpose: itemsize*N*P*SY*SX*C + out_itemsize*N*H*W*C + 32*N*P
// Fashion-256 stage 0 windows at N=32, P=9, bf16: forward ~948 MB, ~0.28 ms
// at 3.35 TB/s; transpose (f32 out) ~1.22 GB, ~0.36 ms. The transpose's
// interval search costs arithmetic once per (pixel, part) and per (pixel,
// part, window row), which the channel threads of a pixel repeat.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

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

// VEC elements (16 bytes) at p as f32
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(const T* p, float* out) {
  static_assert(VEC * sizeof(T) == 16, "one 16-byte load");
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int k = 0; k < VEC; ++k) out[k] = Num<T>::load(v[k]);
}

// VEC f32 values stored at p as T, 16 bytes at a time
template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* p, const float* in) {
  constexpr int kPer = 16 / sizeof(T);
  static_assert(VEC % kPer == 0, "whole 16-byte stores");
#pragma unroll
  for (int q = 0; q < VEC / kPer; ++q) {
    uint4 raw;
    T* v = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int k = 0; k < kPer; ++k) v[k] = Num<T>::store(in[q * kPer + k]);
    reinterpret_cast<uint4*>(p)[q] = raw;
  }
}

// ((a*s + b*t) + c) - 0.5 in f32, each step rounded: the banded code's order
__device__ __forceinline__ float pos(float a, float s, float b, float t,
                                     float c) {
  return __fsub_rn(__fadd_rn(__fadd_rn(__fmul_rn(a, s), __fmul_rn(b, t)), c),
                   0.5f);
}

// the bilinear weight of tap j at position q, rounded to T
template <typename T>
__device__ __forceinline__ float ramp(float q, float j) {
  return Num<T>::round(
      fmaxf(__fsub_rn(1.0f, fabsf(__fsub_rn(q, j))), 0.0f));
}

// Indices i in [0, n) at which |base + slope*i| may be below 1, when the
// f32 chain that computes that value is off from the real line by less
// than err/2: [lo, hi], empty when lo > hi. Within err/2 of flat, all of
// the axis or none of it; else inv is 1/slope.
__device__ __forceinline__ void bracket(float slope, float inv, float base,
                                        float err, int n, int& lo, int& hi) {
  const float r = 1.0f + err;
  if (fabsf(slope) * (float)n <= 0.5f * err) {
    lo = fabsf(base) < r ? 0 : n;
    hi = n - 1;
    return;
  }
  float a = (-r - base) * inv;
  float b = (r - base) * inv;
  if (a > b) {
    const float s = a;
    a = b;
    b = s;
  }
  // one index of margin for the rounding of the bounds; clamped in float
  // first, so that a far-off bound never overflows the int
  a = fminf(fmaxf(floorf(a) - 1.0f, 0.0f), (float)n);
  b = fmaxf(fminf(ceilf(b) + 1.0f, (float)(n - 1)), -1.0f);
  lo = (int)a;
  hi = (int)b;
}

// the f32 error allowance for a position chain whose terms are bounded by
// mag in magnitude: ~170 f32 ulps of it (the chain rounds six times),
// plus a floor
__device__ __forceinline__ float chain_err(float mag) {
  return 1e-5f * mag + 1e-4f;
}

template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads)
warp_taps_kernel(const T* __restrict__ f, const float* __restrict__ coef,
                 T* __restrict__ out, int H, int W, int C, int P, int SY,
                 int SX) {
  const int p = blockIdx.y;
  const int n = blockIdx.z;
  const int cv = C / VEC;
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (int64_t)SY * SX * cv) return;
  const float* k = coef + ((int64_t)n * P + p) * 8;
  const float m00 = __ldg(k), m01 = __ldg(k + 1), tx = __ldg(k + 2);
  const float m10 = __ldg(k + 3), m11 = __ldg(k + 4), ty = __ldg(k + 5);
  const int c0 = (int)(t % cv) * VEC;
  const int pix = (int)(t / cv);
  const int o = pix / SX;
  const int a = pix - o * SX;
  const float yo = __fadd_rn(__fadd_rn(__ldg(k + 6), (float)o), 0.5f);
  const float xo = __fadd_rn(__fadd_rn(__ldg(k + 7), (float)a), 0.5f);
  const float u = pos(m00, xo, m01, yo, tx);
  const float uj = floorf(u);
  const T* fn = f + (int64_t)n * H * W * C + c0;

  float q[2][VEC];
#pragma unroll
  for (int kx = 0; kx < 2; ++kx) {
    const float xj = uj + (float)kx;
#pragma unroll
    for (int c = 0; c < VEC; ++c) q[kx][c] = 0.0f;
    if (!(xj >= 0.0f && xj < (float)W)) continue;
    const float wx = ramp<T>(u, xj);
    const int xi = (int)xj;
    // pass 1 at the source column xj
    const float v = pos(m10, __fadd_rn(xj, 0.5f), m11, yo, ty);
    const float vj = floorf(v);
    float pr[2][VEC];
#pragma unroll
    for (int ky = 0; ky < 2; ++ky) {
      const float yj = vj + (float)ky;
#pragma unroll
      for (int c = 0; c < VEC; ++c) pr[ky][c] = 0.0f;
      if (!(yj >= 0.0f && yj < (float)H)) continue;
      const float wy = ramp<T>(v, yj);
      float val[VEC];
      load_vec<T, VEC>(fn + ((int64_t)(int)yj * W + xi) * C, val);
#pragma unroll
      for (int c = 0; c < VEC; ++c) pr[ky][c] = __fmul_rn(wy, val[c]);
    }
#pragma unroll
    for (int c = 0; c < VEC; ++c)
      q[kx][c] = __fmul_rn(wx, Num<T>::round(__fadd_rn(pr[0][c], pr[1][c])));
  }
  float res[VEC];
#pragma unroll
  for (int c = 0; c < VEC; ++c) res[c] = __fadd_rn(q[0][c], q[1][c]);
  store_vec<T, VEC>(out + (((int64_t)n * P + p) * SY * SX + pix) * C + c0,
                    res);
}

// One part's coefficients and the reciprocals of its slopes (0 for 0)
struct Part {
  float m00, m01, tx, m10, m11, ty, y0, x0, inv00, inv11;
};

__device__ __forceinline__ Part make_part(const float* k) {
  Part q;
  q.m00 = k[0]; q.m01 = k[1]; q.tx = k[2];
  q.m10 = k[3]; q.m11 = k[4]; q.ty = k[5];
  q.y0 = k[6]; q.x0 = k[7];
  q.inv00 = q.m00 != 0.0f ? 1.0f / q.m00 : 0.0f;
  q.inv11 = q.m11 != 0.0f ? 1.0f / q.m11 : 0.0f;
  return q;
}

template <typename T, int VEC, bool JOINT>
__global__ void __launch_bounds__(kThreads)
warp_taps_t_kernel(const T* __restrict__ g, const float* __restrict__ coef,
                   void* __restrict__ out, int H, int W, int C, int P,
                   int SY, int SX) {
  extern __shared__ Part s_part[];
  const int n = blockIdx.y;
  for (int i = threadIdx.x; i < P; i += blockDim.x)
    s_part[i] = make_part(coef + ((int64_t)n * P + i) * 8);
  __syncthreads();

  const int cv = C / VEC;
  const int64_t t = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (t >= (int64_t)H * W * cv) return;

  const int c0 = (int)(t % cv) * VEC;
  const int pix = (int)(t / cv);
  const int y = pix / W;
  const int x = pix - y * W;
  const float yf = (float)y;
  const float xf = (float)x;
  const float xs = xf + 0.5f;      // the source column's center

  float acc[VEC];
#pragma unroll
  for (int c = 0; c < VEC; ++c) acc[c] = 0.0f;
  for (int p = 0; p < P; ++p) {
    const Part q = s_part[p];
    // window rows o whose vertical taps at column x reach row y:
    // v(o) - y = (m10*xs + m11*(y0 + 0.5) + ty - 0.5 - y) + m11*o
    const float bv = q.m10 * xs + q.m11 * (q.y0 + 0.5f) + q.ty - 0.5f - yf;
    const float ev = chain_err(fabsf(q.m10 * xs) +
                               fabsf(q.m11) * (fabsf(q.y0) + (float)SY + 1.0f) +
                               fabsf(q.ty) + yf + 2.0f);
    int o_lo, o_hi;
    bracket(q.m11, q.inv11, bv, ev, SY, o_lo, o_hi);
    const T* gp = g + ((int64_t)n * P + p) * SY * SX * C + c0;
    for (int o = o_lo; o <= o_hi; ++o) {
      const float yo = __fadd_rn(__fadd_rn(q.y0, (float)o), 0.5f);
      const float wy = ramp<T>(pos(q.m10, xs, q.m11, yo, q.ty), yf);
      if (wy == 0.0f) continue;
      // window columns a whose horizontal taps reach column x:
      // u(a) - x = (m00*(x0 + 0.5) + m01*yo + tx - 0.5 - x) + m00*a
      const float bu = q.m00 * (q.x0 + 0.5f) + q.m01 * yo + q.tx - 0.5f - xf;
      const float eu = chain_err(
          fabsf(q.m00) * (fabsf(q.x0) + (float)SX + 1.0f) +
          fabsf(q.m01 * yo) + fabsf(q.tx) + xf + 2.0f);
      int a_lo, a_hi;
      bracket(q.m00, q.inv00, bu, eu, SX, a_lo, a_hi);
      float s[VEC];
#pragma unroll
      for (int c = 0; c < VEC; ++c) s[c] = 0.0f;
      const T* go = gp + (int64_t)o * SX * C;
      for (int a = a_lo; a <= a_hi; ++a) {
        const float xo = __fadd_rn(__fadd_rn(q.x0, (float)a), 0.5f);
        const float wx = ramp<T>(pos(q.m00, xo, q.m01, yo, q.tx), xf);
        if (wx == 0.0f) continue;
        float gv[VEC];
        load_vec<T, VEC>(go + (int64_t)a * C, gv);
#pragma unroll
        for (int c = 0; c < VEC; ++c)
          s[c] = __fadd_rn(s[c], __fmul_rn(wx, gv[c]));
      }
#pragma unroll
      for (int c = 0; c < VEC; ++c)
        acc[c] = __fadd_rn(acc[c], __fmul_rn(wy, Num<T>::round(s[c])));
    }
  }
  const int64_t dst = ((int64_t)n * H * W + pix) * C + c0;
  if constexpr (JOINT)
    store_vec<float, VEC>(static_cast<float*>(out) + dst, acc);
  else
    store_vec<T, VEC>(static_cast<T*>(out) + dst, acc);
}

template <typename T, int VEC>
void launch_fwd(const void* f, const void* coef, void* out, int N, int H,
                int W, int C, int P, int SY, int SX, cudaStream_t stream) {
  const int64_t items = (int64_t)SY * SX * (C / VEC);
  dim3 grid((unsigned)((items + kThreads - 1) / kThreads), (unsigned)P,
            (unsigned)N);
  warp_taps_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(f), static_cast<const float*>(coef),
      static_cast<T*>(out), H, W, C, P, SY, SX);
}

template <typename T, int VEC>
void launch_t(const void* g, const void* coef, void* out, int N, int H,
              int W, int C, int P, int SY, int SX, int joint,
              cudaStream_t stream) {
  const int64_t items = (int64_t)H * W * (C / VEC);
  dim3 grid((unsigned)((items + kThreads - 1) / kThreads), (unsigned)N);
  const size_t smem = (size_t)P * sizeof(Part);
  if (joint)
    warp_taps_t_kernel<T, VEC, true><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(g), static_cast<const float*>(coef), out, H, W,
        C, P, SY, SX);
  else
    warp_taps_t_kernel<T, VEC, false><<<grid, kThreads, smem, stream>>>(
        static_cast<const T*>(g), static_cast<const float*>(coef), out, H, W,
        C, P, SY, SX);
}

bool valid_args(int N, int H, int W, int C, int P, int SY, int SX,
                int dtype) {
  if (N < 1 || H < 1 || W < 1 || C < 1 || P < 1 || SY < 1 || SX < 1)
    return false;
  // P: the transpose's per-part table fits the default 48 KB of shared
  // memory
  if (N > 65535 || P > 512) return false;
  if (dtype != 0 && dtype != 1) return false;
  return C % (dtype == 0 ? 4 : 8) == 0;
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; a thread owns 16 bytes of channels,
// so C % (16 / itemsize) == 0. coef: (N, P, 8) f32 rows (m00, m01, tx,
// m10, m11, ty, y0, x0). Returns cudaGetLastError() after the launch (0 =
// success). The caller (pose_transfer_torch/ops/warp_fused.py) checks
// shapes, contiguity and 16-byte alignment.
int warp_taps(const void* f, const void* coef, void* out, int N, int H,
              int W, int C, int P, int SY, int SX, int dtype, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!valid_args(N, H, W, C, P, SY, SX, dtype))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    launch_fwd<float, 4>(f, coef, out, N, H, W, C, P, SY, SX, s);
  else
    launch_fwd<__nv_bfloat16, 8>(f, coef, out, N, H, W, C, P, SY, SX, s);
  return (int)cudaGetLastError();
}

// out: (N, H, W, C), f32 when joint, else the cotangents' dtype.
int warp_taps_t(const void* g, const void* coef, void* out, int N, int H,
                int W, int C, int P, int SY, int SX, int dtype, int joint,
                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!valid_args(N, H, W, C, P, SY, SX, dtype))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    launch_t<float, 4>(g, coef, out, N, H, W, C, P, SY, SX, joint, s);
  else
    launch_t<__nv_bfloat16, 8>(g, coef, out, N, H, W, C, P, SY, SX, joint, s);
  return (int)cudaGetLastError();
}

const char* warp_taps_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
