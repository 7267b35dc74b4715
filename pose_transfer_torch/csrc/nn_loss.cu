// The content loss's nearest-neighbour distance: the forward (nn_loss_fwd)
// and the prediction's cotangent (nn_loss_bwd).
//
// Replaces no TPU kernel: the JAX package leaves the chain of shifts of
// pose_transfer_tpu/ops/nn_loss.py to XLA to fuse under jit. Run op by op,
// each shift materialises a full-size difference, its abs and a channel
// sum: at area 5, N = 32, 256x256x64 f32, ~67 GB of traffic a forward,
// where reading each input once needs 1.08 GB.
//
// Semantics (pose_transfer_torch/ops/nn_loss.py::NNLoss; P the prediction,
// G the target, both (N, H, W, C) f32, the area nh x nw):
//   G_pad(n, y, x, c) = G(n, y - nw/2, x - nh/2, c) inside the map, else
//     -10000 (the reference's swapped pad axes: nw/2 rows, nh/2 columns;
//     no padded copy is made)
//   norm_k(n, y, x)   = sum over c of |G_pad(n, y + i, x + j, c) -
//     P(n, y, x, c)|, k = i*nw + j, in f32 (the channels summed in another
//     order than the plain version's)
//   idx(n, y, x)      = the first k of least norm (a strict < in k order)
//   loss              = the mean of the least norms: each block's sum in
//     f64, the blocks' sums added in block order by the last block to
//     finish (an integer counter, no float atomics: two calls agree bit
//     for bit), divided by N*H*W and rounded to f32 once
//   dP(n, y, x, c)    = (-scale) * sign(G_pad(n, y + i, x + j, c) -
//     P(n, y, x, c)) at the saved shift k = i*nw + j, with scale = g/(N*H*W)
//     read from the device, as the caller computed it with the plain
//     backward's own op
//
// Design. Forward, nn_loss_fwd_tile<A> (square areas A = 1, 3, 5, C a
// multiple of 16): a block owns 8 rows x 32 columns of one sample, a thread
// one pixel. The channels go 16 at a time: the block stages the target's
// tile and its halo, (8 + A - 1) x (32 + A - 1) pixels of 16 channels, in
// shared memory as four planes of float4 (a warp's 32 pixels read 512
// contiguous bytes: no bank conflicts), with the pad value where the halo
// leaves the map; each thread keeps its pixel's A*A running sums in
// registers and reads its own 16 prediction channels once. The least norm
// is taken after the last channel, in shift order. nn_loss_fwd_any takes
// every other area (up to 256 shifts, a uint8 index) and C a multiple of 4:
// a thread per pixel, the shifts in order, each summing its channels from
// global memory. Backward, nn_loss_bwd: a thread per 4 channels of a pixel,
// one pass over the prediction, the index and the target at the saved
// shift.
//
// Bound: memory. Least bytes per launch (f32):
//   forward:  2*N*H*W*C*4 + N*H*W (the index)     = 1.076 GB at the
//             benchmark cell's N = 32, 256x256x64: 0.321 ms at 3.35 TB/s;
//   backward: (2*N*H*W + R)*C*4 + N*H*W, R the target pixels inside the
//             map that the index reaches (several pixels may pick the
//             same one): 1.076 GB + R*256 B, 0.321-0.481 ms.
// Operations of the forward: 3*nh*nw*N*H*W*C (a subtract, an abs and an
// add), 10.1 GFLOP at the cell's shape: 0.150 ms at 67 TFLOP/s f32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTX = 32;              // tile columns (a warp)
constexpr int kTY = 8;               // tile rows
constexpr int kThreads = kTX * kTY;
constexpr int kCC = 16;              // channels a stage holds
constexpr float kPad = -10000.0f;

__device__ __forceinline__ float dist4(const float4 g, const float4 p,
                                       float acc) {
  acc += fabsf(g.x - p.x);
  acc += fabsf(g.y - p.y);
  acc += fabsf(g.z - p.z);
  acc += fabsf(g.w - p.w);
  return acc;
}

// The sum of every thread's v, in f64, in a fixed order; on thread 0.
__device__ __forceinline__ double block_sum(double v) {
  __shared__ double warp_sums[kThreads / 32];
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  __syncthreads();                   // warp_sums free from an earlier call
  if ((tid & 31) == 0) warp_sums[tid >> 5] = v;
  __syncthreads();
  double s = 0.0;
  if (tid == 0)
    for (int w = 0; w < kThreads / 32; ++w) s += warp_sums[w];
  return s;
}

// Each block adds its pixels' least norms and writes the sum to
// partial[block]; the last block to finish adds the partials in block
// order and writes the mean.
__device__ void finish_mean(double mine, double* partial, unsigned* count,
                            float* loss, int nblocks, long long total) {
  __shared__ bool last;
  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int bid = blockIdx.x + gridDim.x * (blockIdx.y + gridDim.y *
                                            blockIdx.z);
  const double s = block_sum(mine);
  if (tid == 0) {
    partial[bid] = s;
    __threadfence();
    last = atomicAdd(count, 1u) == (unsigned)(nblocks - 1);
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  double t = 0.0;
  for (int b = tid; b < nblocks; b += kThreads) t += __ldcg(partial + b);
  t = block_sum(t);
  if (tid == 0) *loss = (float)(t / (double)total);
}

template <int A>
__global__ void __launch_bounds__(kThreads)
nn_loss_fwd_tile(const float* __restrict__ P, const float* __restrict__ G,
                 uint8_t* __restrict__ idx, double* partial,
                 unsigned* count, float* loss, int H, int W, int C,
                 int nblocks, long long total) {
  constexpr int HR = kTY + A - 1, HC = kTX + A - 1, Q = kCC / 4;
  __shared__ float4 tile[Q][HR][HC];
  const int tx = threadIdx.x, ty = threadIdx.y, tid = ty * kTX + tx;
  const int n = blockIdx.z;
  const int x = blockIdx.x * kTX + tx, y = blockIdx.y * kTY + ty;
  const bool inside = x < W && y < H;
  const int gy0 = blockIdx.y * kTY - A / 2, gx0 = blockIdx.x * kTX - A / 2;
  const long long plane = (long long)H * W;
  const float* Gn = G + n * plane * C;
  const float4* Pp = reinterpret_cast<const float4*>(
      P + (n * plane + (inside ? (long long)y * W + x : 0)) * C);

  float acc[A * A];
#pragma unroll
  for (int k = 0; k < A * A; ++k) acc[k] = 0.0f;

  for (int c0 = 0; c0 < C; c0 += kCC) {
    __syncthreads();                 // the last stage's reads are done
    for (int e = tid; e < HR * HC * Q; e += kThreads) {
      const int q = e % Q, pix = e / Q;
      const int r = pix / HC, col = pix - r * HC;
      const int gy = gy0 + r, gx = gx0 + col;
      float4 v = make_float4(kPad, kPad, kPad, kPad);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W)
        v = __ldg(reinterpret_cast<const float4*>(
                      Gn + ((long long)gy * W + gx) * C + c0) + q);
      tile[q][r][col] = v;
    }
    __syncthreads();
    if (inside) {
#pragma unroll
      for (int q = 0; q < Q; ++q) {
        const float4 p = __ldg(Pp + c0 / 4 + q);
#pragma unroll
        for (int i = 0; i < A; ++i)
#pragma unroll
          for (int j = 0; j < A; ++j)
            acc[i * A + j] = dist4(tile[q][ty + i][tx + j], p,
                                   acc[i * A + j]);
      }
    }
  }

  double mine = 0.0;
  if (inside) {
    float best = acc[0];
    int k = 0;
#pragma unroll
    for (int s = 1; s < A * A; ++s)
      if (acc[s] < best) {           // strict: the first shift wins a tie
        best = acc[s];
        k = s;
      }
    idx[n * plane + (long long)y * W + x] = (uint8_t)k;
    mine = best;
  }
  finish_mean(mine, partial, count, loss, nblocks, total);
}

__global__ void __launch_bounds__(kThreads)
nn_loss_fwd_any(const float* __restrict__ P, const float* __restrict__ G,
                uint8_t* __restrict__ idx, double* partial, unsigned* count,
                float* loss, int H, int W, int C, int nh, int nw,
                int nblocks, long long total) {
  const long long pix = (long long)blockIdx.x * kThreads + threadIdx.x;
  double mine = 0.0;
  if (pix < total) {
    const int x = (int)(pix % W);
    const long long rest = pix / W;
    const int y = (int)(rest % H);
    const long long n = rest / H;
    const float4* Pp = reinterpret_cast<const float4*>(P + pix * C);
    float best = 0.0f;
    int bestk = 0;
    for (int i = 0; i < nh; ++i)
      for (int j = 0; j < nw; ++j) {
        const int gy = y + i - nw / 2, gx = x + j - nh / 2;
        const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
        const float4* Gp = reinterpret_cast<const float4*>(
            G + ((n * H + (in ? gy : 0)) * W + (in ? gx : 0)) * C);
        const float4 pad = make_float4(kPad, kPad, kPad, kPad);
        float s = 0.0f;
        for (int q = 0; q < C / 4; ++q)
          s = dist4(in ? __ldg(Gp + q) : pad, __ldg(Pp + q), s);
        const int k = i * nw + j;
        if (k == 0 || s < best) {    // strict: the first shift wins a tie
          best = s;
          bestk = k;
        }
      }
    idx[pix] = (uint8_t)bestk;
    mine = best;
  }
  finish_mean(mine, partial, count, loss, nblocks, total);
}

__device__ __forceinline__ float sgn(float d) {
  return d > 0.0f ? 1.0f : (d < 0.0f ? -1.0f : 0.0f);
}

__global__ void __launch_bounds__(kThreads)
nn_loss_bwd_kernel(const float* __restrict__ P, const float* __restrict__ G,
                   const uint8_t* __restrict__ idx,
                   const float* __restrict__ scale, float* __restrict__ dP,
                   int H, int W, int C, int nh, int nw, long long total4) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (t >= total4) return;
  const int cv = C / 4;
  const long long pix = t / cv;
  const int q = (int)(t - pix * cv);
  const int x = (int)(pix % W);
  const long long rest = pix / W;
  const int y = (int)(rest % H);
  const long long n = rest / H;
  const int k = idx[pix];
  const int gy = y + k / nw - nw / 2, gx = x + k % nw - nh / 2;
  float4 g = make_float4(kPad, kPad, kPad, kPad);
  if (gy >= 0 && gy < H && gx >= 0 && gx < W)
    g = __ldg(reinterpret_cast<const float4*>(
                  G + ((n * H + gy) * W + gx) * C) + q);
  const float4 p = __ldg(reinterpret_cast<const float4*>(P) + t);
  const float ns = -__ldg(scale);
  // (-scale) * sign, as the plain backward multiplies: -0 where the two
  // values are equal and scale > 0
  reinterpret_cast<float4*>(dP)[t] =
      make_float4(ns * sgn(g.x - p.x), ns * sgn(g.y - p.y),
                  ns * sgn(g.z - p.z), ns * sgn(g.w - p.w));
}

bool valid_args(int N, int H, int W, int C, int nh, int nw) {
  if (N < 1 || H < 1 || W < 1 || C < 1 || nh < 1 || nw < 1) return false;
  if (nh * nw > 256 || C % 4 != 0) return false;
  // the plain version's windows stay inside its padded copy
  return nh - 1 <= 2 * (nw / 2) && nw - 1 <= 2 * (nh / 2);
}

// The tiled forward takes this shape and area (else nn_loss_fwd_any).
bool tiled(int N, int C, int nh, int nw) {
  return nh == nw && (nh == 1 || nh == 3 || nh == 5) && C % kCC == 0 &&
         N <= 65535;
}

template <int A>
void launch_tile(const float* P, const float* G, uint8_t* idx,
                 double* partial, unsigned* count, float* loss, int N, int H,
                 int W, int C, cudaStream_t s) {
  const dim3 grid((W + kTX - 1) / kTX, (H + kTY - 1) / kTY, N);
  const int nblocks = grid.x * grid.y * grid.z;
  nn_loss_fwd_tile<A><<<grid, dim3(kTX, kTY), 0, s>>>(
      P, G, idx, partial, count, loss, H, W, C, nblocks,
      (long long)N * H * W);
}

}  // namespace

extern "C" {

// The number of f64 partial sums the forward needs in `partial` for this
// shape and area (its blocks).
int nn_loss_fwd_blocks(int N, int H, int W, int C, int nh, int nw) {
  if (tiled(N, C, nh, nw))
    return ((W + kTX - 1) / kTX) * ((H + kTY - 1) / kTY) * N;
  const long long total = (long long)N * H * W;
  return (int)((total + kThreads - 1) / kThreads);
}

// P, G: (N, H, W, C) f32, contiguous, 16-byte aligned. idx: (N, H, W)
// uint8 out; partial: nn_loss_fwd_blocks() f64; count: one u32, zero on
// entry; loss: one f32 out. Returns cudaGetLastError() after the launch
// (0 = success). The caller (pose_transfer_torch/ops/nn_loss.py) checks
// dtypes, shapes, contiguity and alignment.
int nn_loss_fwd(const void* P, const void* G, void* idx, void* partial,
                void* count, void* loss, int N, int H, int W, int C, int nh,
                int nw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!valid_args(N, H, W, C, nh, nw)) return (int)cudaErrorInvalidValue;
  const float* p = static_cast<const float*>(P);
  const float* g = static_cast<const float*>(G);
  uint8_t* ix = static_cast<uint8_t*>(idx);
  double* part = static_cast<double*>(partial);
  unsigned* cnt = static_cast<unsigned*>(count);
  float* out = static_cast<float*>(loss);
  const int nblocks = nn_loss_fwd_blocks(N, H, W, C, nh, nw);
  const long long total = (long long)N * H * W;
  if (tiled(N, C, nh, nw)) {
    switch (nh) {
      case 1: launch_tile<1>(p, g, ix, part, cnt, out, N, H, W, C, s); break;
      case 3: launch_tile<3>(p, g, ix, part, cnt, out, N, H, W, C, s); break;
      default: launch_tile<5>(p, g, ix, part, cnt, out, N, H, W, C, s);
    }
  } else {
    nn_loss_fwd_any<<<nblocks, kThreads, 0, s>>>(
        p, g, ix, part, cnt, out, H, W, C, nh, nw, nblocks, total);
  }
  return (int)cudaGetLastError();
}

// dP: (N, H, W, C) f32 out; scale: one f32 on the device, g / (N*H*W).
int nn_loss_bwd(const void* P, const void* G, const void* idx,
                const void* scale, void* dP, int N, int H, int W, int C,
                int nh, int nw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (!valid_args(N, H, W, C, nh, nw)) return (int)cudaErrorInvalidValue;
  const long long total4 = (long long)N * H * W * (C / 4);
  const long long blocks = (total4 + kThreads - 1) / kThreads;
  nn_loss_bwd_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(
      static_cast<const float*>(P), static_cast<const float*>(G),
      static_cast<const uint8_t*>(idx), static_cast<const float*>(scale),
      static_cast<float*>(dP), H, W, C, nh, nw, total4);
  return (int)cudaGetLastError();
}

const char* nn_loss_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
