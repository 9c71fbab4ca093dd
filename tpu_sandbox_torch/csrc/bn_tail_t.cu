// Fused train-mode BatchNorm-apply + ReLU + 2x2 block max-pool in the
// transposed layout [N, H, C, W], and its backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of tpu_sandbox/ops/pallas_bn_tail_t.py:
//   bn_tail_t_fwd         <- _fwd_kernel (:75), launched by _forward (:216)
//   bn_tail_t_bwd_reduce  <- _bwd_reduce_kernel (:97), launched by bwd_reduce (:258)
//   bn_tail_t_bwd_apply   <- _bwd_apply_kernel (:123), launched by _vjp_bwd (:317)
//
// Channel c = (a*blk + b)*co + k, C = blk*blk*co. A pool window is the
// representative channel r = (2*a1*blk + 2*b1)*co + k and its partners
// r+co, r+blk*co, r+blk*co+co; its output channel is o = (a1*(blk/2) +
// b1)*co + k. The TPU rolls the [C, W] row along sublanes to line the
// partners up and compacts the representatives with a selection matmul;
// here one thread owns one window at one w and reads its four channel
// rows directly (a gather), so neither exists.
//
// Arithmetic, as the Pallas kernels and the plain PyTorch versions do it:
//   z   = max(round(y*a + b), 0), rounded to y's dtype BEFORE the ReLU,
//         the max and the routing; the mul and the add round separately
//         (no FMA), as two PyTorch ops do
//   fwd: out[o] = max of the window's four z
//   bwd: the pooled cotangent g goes to the pair max first (at offset
//        blk*co), then inside each pair (offset co), with weights
//        0.5*((x > xb) + (x >= xb)): an exact tie splits 0.5/0.5; masked
//        by z > 0. t = (y - mu)*inv.
//        reduce: s1[c] = sum dz, s2[c] = sum dz*t over (n, h, w)
//        apply:  dy = gi*((dz - c1) - t*c2), rounded once to y's dtype
// Per-channel vectors (a, b, mu, inv, gi, c1, c2) come in as f32 columns
// of C, as the Pallas kernels take them.
//
// What bounds them on the H100: all three are bytes-bound passes (a few
// flops per byte). At 3000x3000, batch 5 (bn1: C 256, co 16, blk 4;
// bn2: C 128, co 32, blk 2), each input read once and each output written
// once at 3.35 TB/s:
//   fwd    y + out       1.80 / 0.90 GB -> 0.537 / 0.269 ms
//   reduce y + g         1.80 / 0.90 GB -> 0.537 / 0.269 ms
//   apply  y + g + dy    3.24 / 1.62 GB -> 0.967 / 0.484 ms
// The design reads y and g once per pass with neighbouring threads on
// neighbouring w (coalesced, scalar loads: a channel row of 750 bf16 is
// only 4-byte aligned). The reduce keeps its sums in registers over a
// slab of rows, combines the block's threads by a fixed tree in shared
// memory and writes one partial per slab; reduce_partials (reduce.cuh)
// adds the partials in a fixed order. No float atomics: two runs are
// bitwise equal. Vector loads and fusing reduce with apply are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "reduce.cuh"

namespace {

constexpr int kThreads = 256;       // along W, one window each
constexpr int kSlabRows = 8;        // rows of (n, h) per block of the reduce

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// The four channels of output channel o's window: r, r+co, r+blk*co,
// r+blk*co+co.
__device__ __forceinline__ void window(int o, int co, int blk, int ch[4]) {
  const int k = o % co, ab = o / co, half = blk / 2;
  const int r = (2 * (ab / half) * blk + 2 * (ab % half)) * co + k;
  ch[0] = r;
  ch[1] = r + co;
  ch[2] = r + blk * co;
  ch[3] = r + blk * co + co;
}

template <typename T>
__device__ __forceinline__ float rounded_relu(float y, float a, float b) {
  return fmaxf(to_f(from_f<T>(__fadd_rn(__fmul_rn(y, a), b))), 0.f);
}

__device__ __forceinline__ float tie_weight(float x, float xb) {
  return 0.5f * ((x > xb ? 1.f : 0.f) + (x >= xb ? 1.f : 0.f));
}

// The pool VJP of one window: g to the pair maxima, then inside each
// pair; masked by the ReLU. Every weight is 0, 0.5 or 1: exact.
__device__ __forceinline__ void route(const float z[4], float g, float dz[4]) {
  const float w2 = tie_weight(fmaxf(z[0], z[1]), fmaxf(z[2], z[3]));
  const float da = g * w2, db = g * (1.f - w2);
  const float w1a = tie_weight(z[0], z[1]), w1b = tie_weight(z[2], z[3]);
  dz[0] = da * w1a;
  dz[1] = da * (1.f - w1a);
  dz[2] = db * w1b;
  dz[3] = db * (1.f - w1b);
#pragma unroll
  for (int i = 0; i < 4; ++i) dz[i] = z[i] > 0.f ? dz[i] : 0.f;
}

// The window's four y at (row, w) in f32, and their z.
template <typename T>
__device__ __forceinline__ void load_window(const T* __restrict__ y, size_t row_off,
                                            int W, int w, const int ch[4],
                                            const float* __restrict__ a,
                                            const float* __restrict__ b,
                                            float yf[4], float z[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    yf[i] = to_f(y[row_off + (size_t)ch[i] * W + w]);
    z[i] = rounded_relu<T>(yf[i], a[ch[i]], b[ch[i]]);
  }
}

// grid (ceil(W / kThreads), Cout, N*H)
template <typename T>
__global__ void __launch_bounds__(kThreads)
tail_fwd_kernel(const T* __restrict__ y, const float* __restrict__ a,
                const float* __restrict__ b, T* __restrict__ out, int C, int co,
                int blk, int W) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  const int o = blockIdx.y, row = blockIdx.z, Cout = gridDim.y;
  int ch[4];
  window(o, co, blk, ch);
  float yf[4], z[4];
  load_window<T>(y, (size_t)row * C * W, W, w, ch, a, b, yf, z);
  const float m = fmaxf(fmaxf(z[0], z[1]), fmaxf(z[2], z[3]));
  out[((size_t)row * Cout + o) * W + w] = from_f<T>(m);
}

// grid (slabs, Cout); part f32 [slabs, 2*C] (s1 then s2 per channel).
template <typename T>
__global__ void __launch_bounds__(kThreads)
tail_bwd_reduce_kernel(const T* __restrict__ y, const T* __restrict__ g,
                       const float* __restrict__ a, const float* __restrict__ b,
                       const float* __restrict__ mu, const float* __restrict__ inv,
                       float* __restrict__ part, int NH, int C, int co, int blk,
                       int W) {
  __shared__ float red[8][kThreads];
  const int tid = threadIdx.x;
  const int o = blockIdx.y, slab = blockIdx.x, Cout = gridDim.y;
  int ch[4];
  window(o, co, blk, ch);
  float s1[4] = {0.f, 0.f, 0.f, 0.f}, s2[4] = {0.f, 0.f, 0.f, 0.f};
  const int r_end = min(NH, (slab + 1) * kSlabRows);
  for (int row = slab * kSlabRows; row < r_end; ++row) {
    for (int w = tid; w < W; w += kThreads) {
      float yf[4], z[4], dz[4];
      load_window<T>(y, (size_t)row * C * W, W, w, ch, a, b, yf, z);
      route(z, to_f(g[((size_t)row * Cout + o) * W + w]), dz);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float t = __fmul_rn(__fsub_rn(yf[i], mu[ch[i]]), inv[ch[i]]);
        s1[i] += dz[i];
        s2[i] += dz[i] * t;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    red[i][tid] = s1[i];
    red[4 + i][tid] = s2[i];
  }
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half /= 2) {
    if (tid < half) {
#pragma unroll
      for (int v = 0; v < 8; ++v) red[v][tid] += red[v][tid + half];
    }
    __syncthreads();
  }
  if (tid < 8) {
    float* out = part + (size_t)slab * 2 * C;
    out[(tid / 4) * C + ch[tid % 4]] = red[tid][0];
  }
}

// grid (ceil(W / kThreads), Cout, N*H)
template <typename T>
__global__ void __launch_bounds__(kThreads)
tail_bwd_apply_kernel(const T* __restrict__ y, const T* __restrict__ g,
                      const float* __restrict__ a, const float* __restrict__ b,
                      const float* __restrict__ mu, const float* __restrict__ inv,
                      const float* __restrict__ gi, const float* __restrict__ c1,
                      const float* __restrict__ c2, T* __restrict__ dy, int C,
                      int co, int blk, int W) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= W) return;
  const int o = blockIdx.y, row = blockIdx.z, Cout = gridDim.y;
  int ch[4];
  window(o, co, blk, ch);
  const size_t row_off = (size_t)row * C * W;
  float yf[4], z[4], dz[4];
  load_window<T>(y, row_off, W, w, ch, a, b, yf, z);
  route(z, to_f(g[((size_t)row * Cout + o) * W + w]), dz);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = ch[i];
    const float t = __fmul_rn(__fsub_rn(yf[i], mu[c]), inv[c]);
    const float v = __fsub_rn(__fsub_rn(dz[i], c1[c]), __fmul_rn(t, c2[c]));
    dy[row_off + (size_t)c * W + w] = from_f<T>(__fmul_rn(gi[c], v));
  }
}

template <typename T>
cudaError_t fwd(const void* y, const float* a, const float* b, void* out, int NH,
                int C, int co, int blk, int W, cudaStream_t st) {
  const dim3 grid((W + kThreads - 1) / kThreads, C / 4, NH);
  tail_fwd_kernel<T><<<grid, kThreads, 0, st>>>((const T*)y, a, b, (T*)out, C,
                                                co, blk, W);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_reduce(const void* y, const void* g, const float* a,
                       const float* b, const float* mu, const float* inv,
                       float* part, float* sums, int NH, int C, int co, int blk,
                       int W, cudaStream_t st) {
  const int slabs = (NH + kSlabRows - 1) / kSlabRows;
  tail_bwd_reduce_kernel<T><<<dim3(slabs, C / 4), kThreads, 0, st>>>(
      (const T*)y, (const T*)g, a, b, mu, inv, part, NH, C, co, blk, W);
  return reduce_partials(part, sums, slabs, 2 * C, st);
}

template <typename T>
cudaError_t bwd_apply(const void* y, const void* g, const float* a,
                      const float* b, const float* mu, const float* inv,
                      const float* gi, const float* c1, const float* c2, void* dy,
                      int NH, int C, int co, int blk, int W, cudaStream_t st) {
  const dim3 grid((W + kThreads - 1) / kThreads, C / 4, NH);
  tail_bwd_apply_kernel<T><<<grid, kThreads, 0, st>>>(
      (const T*)y, (const T*)g, a, b, mu, inv, gi, c1, c2, (T*)dy, C, co, blk, W);
  return cudaGetLastError();
}

bool bad_geometry(int NH, int C, int co, int blk) {
  return blk < 2 || blk % 2 || co < 1 || C != blk * blk * co || NH > 65535;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. y [N*H, C, W] of dtype, C =
// blk*blk*co; a, b f32 [C]; out [N*H, C/4, W] of dtype.
extern "C" int bn_tail_t_fwd(int dtype, const void* y, const float* a,
                             const float* b, void* out, int NH, int C, int co,
                             int blk, int W, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bad_geometry(NH, C, co, blk)) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)fwd<float>(y, a, b, out, NH, C, co, blk, W, st);
  if (dtype == 1) return (int)fwd<__nv_bfloat16>(y, a, b, out, NH, C, co, blk, W, st);
  return (int)cudaErrorInvalidValue;
}

// Rows of (n, h) per slab of bn_tail_t_bwd_reduce: the wrapper sizes
// ``part`` as ceil(N*H / rows) * 2 * C floats.
extern "C" int bn_tail_t_reduce_rows(void) { return kSlabRows; }

// y [N*H, C, W], g [N*H, C/4, W] of dtype; a, b, mu, inv f32 [C]; sums
// f32 [2*C] = s1 then s2 per channel.
extern "C" int bn_tail_t_bwd_reduce(int dtype, const void* y, const void* g,
                                    const float* a, const float* b,
                                    const float* mu, const float* inv,
                                    float* part, float* sums, int NH, int C,
                                    int co, int blk, int W, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bad_geometry(NH, C, co, blk)) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)bwd_reduce<float>(y, g, a, b, mu, inv, part, sums, NH, C, co,
                                  blk, W, st);
  if (dtype == 1)
    return (int)bwd_reduce<__nv_bfloat16>(y, g, a, b, mu, inv, part, sums, NH,
                                          C, co, blk, W, st);
  return (int)cudaErrorInvalidValue;
}

// As the reduce, plus gi, c1, c2 f32 [C]; dy [N*H, C, W] of dtype.
extern "C" int bn_tail_t_bwd_apply(int dtype, const void* y, const void* g,
                                   const float* a, const float* b,
                                   const float* mu, const float* inv,
                                   const float* gi, const float* c1,
                                   const float* c2, void* dy, int NH, int C,
                                   int co, int blk, int W, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bad_geometry(NH, C, co, blk)) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)bwd_apply<float>(y, g, a, b, mu, inv, gi, c1, c2, dy, NH, C, co,
                                 blk, W, st);
  if (dtype == 1)
    return (int)bwd_apply<__nv_bfloat16>(y, g, a, b, mu, inv, gi, c1, c2, dy,
                                         NH, C, co, blk, W, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
