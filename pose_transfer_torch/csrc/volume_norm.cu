// The Block norm's whole-volume instance norm: the forward
// (volume_norm_fwd) and its gradient (volume_norm_bwd).
//
// Replaces no TPU kernel: the JAX package's norm
// (pose_transfer_tpu/ops/norm.py::volume_instance_norm) is plain jnp that
// XLA fuses under jit. Run op by op in PyTorch, the same function cast the
// volume to f32, took two means, squared, subtracted, multiplied by the
// rsqrt, applied the scalar affine and cast back: ~14 passes forward, ~20
// autograd nodes backward, each a full f32 pass over channels-last volumes
// as large as (32, 128, 256, 256) (the broadcast of per-sample statistics
// sends them to PyTorch's slow strided elementwise kernel), and autograd
// saved three f32 volumes a call. It was the largest device cost of every
// benchmark cell.
//
// Semantics (pose_transfer_torch/ops/norm.py::volume_instance_norm_reference;
// x is (N, M): a sample's M = C*H*W elements, one dense run of memory in
// both NCHW-contiguous and channels-last tensors, in bf16 or f32; w and b
// one f32 each):
//   mean = (sum of x) / M, msq = (sum of x*x) / M      (f32 sums)
//   d    = msq - mean*mean, var = d < 0 ? 0 : d        (the clamp at 0)
//   rstd = 1 / sqrt(var + eps)                         (correctly rounded)
//   xh   = (x - mean) * rstd, y = round_T(xh * w + b)  (each step rounded
//          in f32: __fsub_rn / __fmul_rn / __fadd_rn, no FMA contraction)
// gradient, g the output's cotangent (x's dtype), per sample:
//   sg = sum of g, sgx = sum of g * xh,  c = 1 where d >= 0 else 0 (the
//   clamp's own gradient rule: the variance term drops out where clamped)
//   dx = round_T((g - sg/M - c * xh * sgx/M) * (rstd * w))
//   dw = sum over samples of sgx,  db = sum over samples of sg
//
// Design. Bound by bytes (a few operations per element). A sample is one
// row of M elements, cut into S splits of `chunk` elements (a multiple of
// the 16-byte vector); the grid is (S, N) blocks of 256 threads, each
// thread moving 16 bytes a load, and S is chosen by the caller from N and
// M (ops/norm.py::plan) so that N*S blocks fill the card at every shape.
// Forward, two passes: volume_norm_fwd_stats writes each block's (sum,
// sum of squares) to a partial; volume_norm_fwd_apply sums its sample's S
// partials in a fixed order, derives mean and rstd (the split-0 block
// stores them, with c, for the backward) and writes y. Backward, two
// passes: volume_norm_bwd_partials writes each block's (sg, sgx), with xh
// recomputed from x and the saved statistics; volume_norm_bwd_apply sums
// its sample's partials and writes dx, and its first block sums every
// partial for (dw, db). No atomics: every sum has a fixed order, so a call
// repeats bit for bit. The apply passes walk the blocks in the reverse of
// the first passes' order, so that the chunks read last, still in the
// 50 MB L2, are read again first. A row whose length is not a multiple of
// the vector, or a base not 16-byte aligned, takes the same kernels with
// one element a load.
//
// Bound: memory. Least bytes per call (itemsize s, N*M elements):
//   forward:  2*s*N*M (x read once, y written once)
//   backward: 3*s*N*M (x and g read once, dx written once)
// At fashion-256's largest norm, (32, 128, 256, 256) bf16: 0.537 GB of x,
// forward 1.07 GB (0.32 ms at 3.35 TB/s), backward 1.61 GB (0.48 ms). The
// design reads x twice forward (3*s*N*M, 0.48 ms) and x and g twice
// backward (5*s*N*M, 0.80 ms); below ~40 MB a volume's second read comes
// from L2.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// V elements of T, aligned to their size: a 16-byte load or store where
// V * sizeof(T) == 16.
template <typename T, int V>
struct alignas(sizeof(T) * V) Pack {
  T e[V];
};

// The block's sums of (a, b), in a fixed order (shuffles, then the warps
// in order), on every thread.
__device__ __forceinline__ float2 block_sum2(float a, float b) {
  __shared__ float2 warp_sums[kThreads / 32];
  __shared__ float2 total;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    a += __shfl_down_sync(0xffffffffu, a, o);
    b += __shfl_down_sync(0xffffffffu, b, o);
  }
  if ((threadIdx.x & 31) == 0)
    warp_sums[threadIdx.x >> 5] = make_float2(a, b);
  __syncthreads();
  if (threadIdx.x == 0) {
    float2 t = warp_sums[0];
    for (int w = 1; w < kThreads / 32; ++w) {
      t.x += warp_sums[w].x;
      t.y += warp_sums[w].y;
    }
    total = t;
  }
  __syncthreads();
  return total;
}

// The sums of partial[0 .. count) in a fixed order, on every thread.
__device__ __forceinline__ float2 sum_partials(const float2* partial,
                                               int count) {
  float a = 0.f, b = 0.f;
  for (int k = threadIdx.x; k < count; k += kThreads) {
    const float2 p = partial[k];
    a += p.x;
    b += p.y;
  }
  return block_sum2(a, b);
}

// The block's sample and split: in launch order, or reversed.
struct Tile {
  int n, s;
  long long lo, hi;
};

__device__ __forceinline__ Tile tile(long long m, int splits,
                                     long long chunk, bool reversed) {
  int bid = blockIdx.x + splits * blockIdx.y;
  if (reversed) bid = splits * gridDim.y - 1 - bid;
  Tile t;
  t.n = bid / splits;
  t.s = bid % splits;
  t.lo = (long long)t.s * chunk;
  t.hi = min(t.lo + chunk, m);
  return t;
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
volume_norm_fwd_stats(const T* __restrict__ x, float2* __restrict__ partial,
                      long long m, int splits, long long chunk) {
  const Tile t = tile(m, splits, chunk, false);
  const T* row = x + (long long)t.n * m;
  float sx = 0.f, sq = 0.f;
#pragma unroll 4
  for (long long i = t.lo + (long long)threadIdx.x * V; i < t.hi;
       i += (long long)kThreads * V) {
    const Pack<T, V> p = *reinterpret_cast<const Pack<T, V>*>(row + i);
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float v = to_f(p.e[k]);
      a += v;
      b = fmaf(v, v, b);
    }
    sx += a;
    sq += b;
  }
  const float2 r = block_sum2(sx, sq);
  if (threadIdx.x == 0) partial[t.n * splits + t.s] = r;
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
volume_norm_fwd_apply(const T* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ b, T* __restrict__ y,
                      const float2* __restrict__ partial,
                      float4* __restrict__ stats, long long m, int splits,
                      long long chunk, float eps) {
  const Tile t = tile(m, splits, chunk, true);
  const float2 tot = sum_partials(partial + t.n * splits, splits);
  const float mean = __fdiv_rn(tot.x, (float)m);
  const float msq = __fdiv_rn(tot.y, (float)m);
  const float d = __fsub_rn(msq, __fmul_rn(mean, mean));
  const float var = d < 0.f ? 0.f : d;              // NaN stays NaN
  const float rstd = __frsqrt_rn(__fadd_rn(var, eps));
  if (t.s == 0 && threadIdx.x == 0)
    stats[t.n] = make_float4(mean, rstd, d >= 0.f ? 1.f : 0.f, 0.f);
  const float wv = __ldg(w), bv = __ldg(b);
  const T* xr = x + (long long)t.n * m;
  T* yr = y + (long long)t.n * m;
#pragma unroll 4
  for (long long i = t.lo + (long long)threadIdx.x * V; i < t.hi;
       i += (long long)kThreads * V) {
    const Pack<T, V> p = *reinterpret_cast<const Pack<T, V>*>(xr + i);
    Pack<T, V> o;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float xh = __fmul_rn(__fsub_rn(to_f(p.e[k]), mean), rstd);
      o.e[k] = from_f<T>(__fadd_rn(__fmul_rn(xh, wv), bv));
    }
    *reinterpret_cast<Pack<T, V>*>(yr + i) = o;
  }
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
volume_norm_bwd_partials(const T* __restrict__ x, const T* __restrict__ g,
                         const float4* __restrict__ stats,
                         float2* __restrict__ partial, long long m,
                         int splits, long long chunk) {
  const Tile t = tile(m, splits, chunk, false);
  const float4 st = stats[t.n];
  const T* xr = x + (long long)t.n * m;
  const T* gr = g + (long long)t.n * m;
  float sg = 0.f, sgx = 0.f;
#pragma unroll 4
  for (long long i = t.lo + (long long)threadIdx.x * V; i < t.hi;
       i += (long long)kThreads * V) {
    const Pack<T, V> px = *reinterpret_cast<const Pack<T, V>*>(xr + i);
    const Pack<T, V> pg = *reinterpret_cast<const Pack<T, V>*>(gr + i);
    float a = 0.f, b = 0.f;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float xh = __fmul_rn(__fsub_rn(to_f(px.e[k]), st.x), st.y);
      const float gv = to_f(pg.e[k]);
      a += gv;
      b = fmaf(gv, xh, b);
    }
    sg += a;
    sgx += b;
  }
  const float2 r = block_sum2(sg, sgx);
  if (threadIdx.x == 0) partial[t.n * splits + t.s] = r;
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads)
volume_norm_bwd_apply(const T* __restrict__ x, const T* __restrict__ g,
                      const float* __restrict__ w,
                      const float4* __restrict__ stats,
                      const float2* __restrict__ partial, T* __restrict__ dx,
                      float* __restrict__ dwb, long long m, int splits,
                      long long chunk) {
  const Tile t = tile(m, splits, chunk, true);
  if (blockIdx.x == 0 && blockIdx.y == 0) {
    // dw, db: every sample's partials, in order
    const float2 all = sum_partials(partial, splits * (int)gridDim.y);
    if (threadIdx.x == 0) {
      dwb[0] = all.y;
      dwb[1] = all.x;
    }
  }
  const float2 tot = sum_partials(partial + t.n * splits, splits);
  const float4 st = stats[t.n];
  const float mean_g = __fdiv_rn(tot.x, (float)m);
  const float mean_gx = st.z != 0.f ? __fdiv_rn(tot.y, (float)m) : 0.f;
  const float scale = __fmul_rn(st.y, __ldg(w));
  const T* xr = x + (long long)t.n * m;
  const T* gr = g + (long long)t.n * m;
  T* dr = dx + (long long)t.n * m;
#pragma unroll 4
  for (long long i = t.lo + (long long)threadIdx.x * V; i < t.hi;
       i += (long long)kThreads * V) {
    const Pack<T, V> px = *reinterpret_cast<const Pack<T, V>*>(xr + i);
    const Pack<T, V> pg = *reinterpret_cast<const Pack<T, V>*>(gr + i);
    Pack<T, V> o;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float xh = __fmul_rn(__fsub_rn(to_f(px.e[k]), st.x), st.y);
      const float v = __fsub_rn(__fsub_rn(to_f(pg.e[k]), mean_g),
                                __fmul_rn(xh, mean_gx));
      o.e[k] = from_f<T>(__fmul_rn(v, scale));
    }
    *reinterpret_cast<Pack<T, V>*>(dr + i) = o;
  }
}

bool valid_args(int n, int m, int splits, int chunk, int vec) {
  return n > 0 && n <= 65535 && m > 0 && splits > 0 && chunk > 0
      && vec > 0 && chunk % vec == 0 && m % vec == 0
      && (long long)(splits - 1) * chunk < m
      && (long long)splits * chunk >= m
      && (long long)splits * n <= 0x7fffffffLL;
}

template <typename T, int V>
int fwd(const void* x, const float* w, const float* b, void* y,
        float2* partial, float4* stats, int n, int m, int splits, int chunk,
        float eps, cudaStream_t st) {
  const dim3 grid(splits, n);
  volume_norm_fwd_stats<T, V><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), partial, m, splits, chunk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  volume_norm_fwd_apply<T, V><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), w, b, static_cast<T*>(y), partial, stats, m,
      splits, chunk, eps);
  return (int)cudaGetLastError();
}

template <typename T, int V>
int bwd(const void* x, const void* g, const float* w, const float4* stats,
        float2* partial, void* dx, float* dwb, int n, int m, int splits,
        int chunk, cudaStream_t st) {
  const dim3 grid(splits, n);
  volume_norm_bwd_partials<T, V><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), stats, partial, m,
      splits, chunk);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  volume_norm_bwd_apply<T, V><<<grid, kThreads, 0, st>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), w, stats, partial,
      static_cast<T*>(dx), dwb, m, splits, chunk);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; vec: elements a load, 16 / itemsize
// (m % vec == 0, every pointer 16-byte aligned) or 1; the (splits, chunk)
// plan of ops/norm.py::plan. partial: N*splits float2 of scratch; stats:
// N float4 (mean, rstd, c, 0) written for the backward; eps as the bits of
// an f32. Returns cudaGetLastError() after the launches (0 = success). The
// caller (pose_transfer_torch/ops/norm.py) checks devices, dtypes, layouts
// and alignment.
int volume_norm_fwd(const void* x, const void* w, const void* b, void* y,
                    void* partial, void* stats, int n, int m, int splits,
                    int chunk, int vec, int dtype, int eps_bits,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!valid_args(n, m, splits, chunk, vec))
    return (int)cudaErrorInvalidValue;
  float eps;
  memcpy(&eps, &eps_bits, sizeof(eps));
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(b);
  float2* p = static_cast<float2*>(partial);
  float4* s = static_cast<float4*>(stats);
  if (dtype == 0 && vec == 4)
    return fwd<float, 4>(x, wf, bf, y, p, s, n, m, splits, chunk, eps, st);
  if (dtype == 0 && vec == 1)
    return fwd<float, 1>(x, wf, bf, y, p, s, n, m, splits, chunk, eps, st);
  if (dtype == 1 && vec == 8)
    return fwd<__nv_bfloat16, 8>(x, wf, bf, y, p, s, n, m, splits, chunk,
                                 eps, st);
  if (dtype == 1 && vec == 1)
    return fwd<__nv_bfloat16, 1>(x, wf, bf, y, p, s, n, m, splits, chunk,
                                 eps, st);
  return (int)cudaErrorInvalidValue;
}

// As volume_norm_fwd; g the output's cotangent in x's dtype and layout,
// stats the forward's; dwb: 2 f32, (dw, db).
int volume_norm_bwd(const void* x, const void* g, const void* w,
                    const void* stats, void* partial, void* dx, void* dwb,
                    int n, int m, int splits, int chunk, int vec, int dtype,
                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!valid_args(n, m, splits, chunk, vec))
    return (int)cudaErrorInvalidValue;
  const float* wf = static_cast<const float*>(w);
  const float4* s = static_cast<const float4*>(stats);
  float2* p = static_cast<float2*>(partial);
  float* o = static_cast<float*>(dwb);
  if (dtype == 0 && vec == 4)
    return bwd<float, 4>(x, g, wf, s, p, dx, o, n, m, splits, chunk, st);
  if (dtype == 0 && vec == 1)
    return bwd<float, 1>(x, g, wf, s, p, dx, o, n, m, splits, chunk, st);
  if (dtype == 1 && vec == 8)
    return bwd<__nv_bfloat16, 8>(x, g, wf, s, p, dx, o, n, m, splits, chunk,
                                 st);
  if (dtype == 1 && vec == 1)
    return bwd<__nv_bfloat16, 1>(x, g, wf, s, p, dx, o, n, m, splits, chunk,
                                 st);
  return (int)cudaErrorInvalidValue;
}

const char* volume_norm_error_string(int rc) {
  return cudaGetErrorString(static_cast<cudaError_t>(rc));
}

}  // extern "C"
