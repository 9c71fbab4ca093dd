// Fused train-mode BatchNorm-apply + ReLU + 2x2 block max-pool in the
// transposed layout [N, H, C, W], and its backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of tpu_sandbox/ops/pallas_bn_tail_t.py:
//   bn_tail_t_fwd         <- _fwd_kernel (:75), launched by _forward (:216)
//   bn_tail_t_bwd_reduce  <- _bwd_reduce_kernel (:97), launched by bwd_reduce (:258)
//   bn_tail_t_bwd_apply   <- _bwd_apply_kernel (:123), launched by _vjp_bwd (:317)
//
// The per-window arithmetic (window, z, the pool routing with exact
// 0.5/0.5 ties, dy) is in tail_math.cuh, shared with the fused conv1+tail
// weight gradient (conv1_tail_t.cu).
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
#include "tail_math.cuh"

namespace {

constexpr int kThreads = 256;       // along W, one window each
constexpr int kSlabRows = 8;        // rows of (n, h) per block of the reduce

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
  T d[4];
  window_dy<T>(y, row_off, W, w, ch, to_f(g[((size_t)row * Cout + o) * W + w]), a, b,
               mu, inv, gi, c1, c2, d);
#pragma unroll
  for (int i = 0; i < 4; ++i) dy[row_off + (size_t)ch[i] * W + w] = d[i];
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. y [N*H, C, W] of dtype, C =
// blk*blk*co; a, b f32 [C]; out [N*H, C/4, W] of dtype.
extern "C" int bn_tail_t_fwd(int dtype, const void* y, const float* a,
                             const float* b, void* out, int NH, int C, int co,
                             int blk, int W, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bad_tail_geometry(NH, C, co, blk)) return (int)cudaErrorInvalidValue;
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
  if (bad_tail_geometry(NH, C, co, blk)) return (int)cudaErrorInvalidValue;
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
  if (bad_tail_geometry(NH, C, co, blk)) return (int)cudaErrorInvalidValue;
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
