// Fused train-mode BatchNorm-apply + ReLU + 2x2 block max-pool in the NHWC
// layout [N, H, W, C], and its backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of tpu_sandbox/ops/pallas_bn_tail.py:
//   bn_tail_fwd         <- _fwd_kernel (:114), launched by _forward (:255)
//   bn_tail_bwd_reduce  <- _bwd_reduce_kernel (:136), launched by _vjp_bwd (:294)
//   bn_tail_bwd_apply   <- _bwd_apply_kernel (:162), launched by _vjp_bwd (:327)
//
// The per-window arithmetic is tail_math.cuh's, unchanged and shared with
// the transposed tail (bn_tail_t.cu): window, rounded_relu, tie_weight,
// route and window_dy. In NHWC a pool window's four partners are channels
// of ONE pixel, so the loaders below address y at pixel*C + channel (the
// header's row stride is 1): the TPU's rolls along the lane dim and its
// selection matmul have no counterpart.
//
// What bounds them on the H100: all three are bytes-bound passes (a few
// flops per byte). At 3000x3000, batch 5 (bn1: C 256, co 16, blk 4;
// bn2: C 128, co 32, blk 2), each input read once and each output written
// once at 3.35 TB/s:
//   fwd    y + out       1.80 / 0.90 GB -> 0.537 / 0.269 ms
//   reduce y + g         1.80 / 0.90 GB -> 0.537 / 0.269 ms
//   apply  y + g + dy    3.24 / 1.62 GB -> 0.967 / 0.484 ms
// Design: a thread owns one window (output channel o) of one pixel, and
// the C/4 threads of a pixel are neighbours, so a warp reads a pixel's
// C-vector (512 B at C 256 bf16) as contiguous runs, and writes the pooled
// out and dy the same way. The reduce keeps each thread's sums in
// registers over a slab of pixels, combines the threads of a window in a
// fixed order in shared memory and writes one partial per slab;
// reduce_partials (reduce.cuh) adds the partials in a fixed order. No
// float atomics: two runs are bitwise equal. Vector loads and fusing the
// reduce with the apply are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "reduce.cuh"
#include "tail_math.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSlabPixels = 2048;   // pixels per block of the reduce

// one thread per (pixel, o); grid over NHW * Cout threads
template <typename T>
__global__ void __launch_bounds__(kThreads)
tail_fwd_kernel(const T* __restrict__ y, const float* __restrict__ a,
                const float* __restrict__ b, T* __restrict__ out, long long total, int C,
                int co, int blk) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const int Cout = C / 4;
  const long long p = i / Cout;
  const int o = (int)(i % Cout);
  int ch[4];
  window(o, co, blk, ch);
  float yf[4], z[4];
  load_window<T>(y, (size_t)p * C, 1, 0, ch, a, b, yf, z);
  out[i] = from_f<T>(fmaxf(fmaxf(z[0], z[1]), fmaxf(z[2], z[3])));
}

// grid (slabs); thread t owns window o = t % Cout of every (256/Cout)-th
// pixel of the slab; part f32 [slabs, 2*C] (s1 then s2 per channel).
template <typename T>
__global__ void __launch_bounds__(kThreads)
tail_bwd_reduce_kernel(const T* __restrict__ y, const T* __restrict__ g,
                       const float* __restrict__ a, const float* __restrict__ b,
                       const float* __restrict__ mu, const float* __restrict__ inv,
                       float* __restrict__ part, long long NHW, int C, int co, int blk) {
  __shared__ float red[8][kThreads];
  const int tid = threadIdx.x;
  const int Cout = C / 4, lanes = kThreads / Cout;    // pixels in flight
  const int o = tid % Cout, q = tid / Cout;
  int ch[4];
  window(o, co, blk, ch);
  float s1[4] = {0.f, 0.f, 0.f, 0.f}, s2[4] = {0.f, 0.f, 0.f, 0.f};
  if (q < lanes) {
    const long long p_end = min(NHW, (long long)(blockIdx.x + 1) * kSlabPixels);
    for (long long p = (long long)blockIdx.x * kSlabPixels + q; p < p_end; p += lanes) {
      float yf[4], z[4], dz[4];
      load_window<T>(y, (size_t)p * C, 1, 0, ch, a, b, yf, z);
      route(z, to_f(g[p * Cout + o]), dz);
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
  if (tid < Cout) {
    float* out = part + (size_t)blockIdx.x * 2 * C;
#pragma unroll
    for (int v = 0; v < 8; ++v) {
      float s = 0.f;
      for (int r = 0; r < lanes; ++r) s += red[v][r * Cout + tid];
      out[(v / 4) * C + ch[v % 4]] = s;
    }
  }
}

// one thread per (pixel, o), as the forward
template <typename T>
__global__ void __launch_bounds__(kThreads)
tail_bwd_apply_kernel(const T* __restrict__ y, const T* __restrict__ g,
                      const float* __restrict__ a, const float* __restrict__ b,
                      const float* __restrict__ mu, const float* __restrict__ inv,
                      const float* __restrict__ gi, const float* __restrict__ c1,
                      const float* __restrict__ c2, T* __restrict__ dy, long long total,
                      int C, int co, int blk) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  const int Cout = C / 4;
  const size_t row_off = (size_t)(i / Cout) * C;
  int ch[4];
  window((int)(i % Cout), co, blk, ch);
  T d[4];
  window_dy<T>(y, row_off, 1, 0, ch, to_f(g[i]), a, b, mu, inv, gi, c1, c2, d);
#pragma unroll
  for (int k = 0; k < 4; ++k) dy[row_off + ch[k]] = d[k];
}

bool bad_geometry(int C, int co, int blk) {
  return bad_tail_geometry(0, C, co, blk) || C / 4 > kThreads;
}

unsigned blocks(long long total) { return (unsigned)((total + kThreads - 1) / kThreads); }

template <typename T>
cudaError_t fwd(const void* y, const float* a, const float* b, void* out, long long NHW,
                int C, int co, int blk, cudaStream_t st) {
  const long long total = NHW * (C / 4);
  tail_fwd_kernel<T><<<blocks(total), kThreads, 0, st>>>((const T*)y, a, b, (T*)out, total,
                                                         C, co, blk);
  return cudaGetLastError();
}

int reduce_slabs(long long NHW) { return (int)((NHW + kSlabPixels - 1) / kSlabPixels); }

template <typename T>
cudaError_t bwd_reduce(const void* y, const void* g, const float* a, const float* b,
                       const float* mu, const float* inv, float* part, float* sums,
                       long long NHW, int C, int co, int blk, cudaStream_t st) {
  const int slabs = reduce_slabs(NHW);
  tail_bwd_reduce_kernel<T><<<slabs, kThreads, 0, st>>>(
      (const T*)y, (const T*)g, a, b, mu, inv, part, NHW, C, co, blk);
  return reduce_partials(part, sums, slabs, 2 * C, st);
}

template <typename T>
cudaError_t bwd_apply(const void* y, const void* g, const float* a, const float* b,
                      const float* mu, const float* inv, const float* gi, const float* c1,
                      const float* c2, void* dy, long long NHW, int C, int co, int blk,
                      cudaStream_t st) {
  const long long total = NHW * (C / 4);
  tail_bwd_apply_kernel<T><<<blocks(total), kThreads, 0, st>>>(
      (const T*)y, (const T*)g, a, b, mu, inv, gi, c1, c2, (T*)dy, total, C, co, blk);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. y [N*H*W, C] of dtype, C =
// blk*blk*co <= 1024; a, b f32 [C]; out [N*H*W, C/4] of dtype.
extern "C" int bn_tail_fwd(int dtype, const void* y, const float* a, const float* b,
                           void* out, long long NHW, int C, int co, int blk,
                           void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bad_geometry(C, co, blk)) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)fwd<float>(y, a, b, out, NHW, C, co, blk, st);
  if (dtype == 1) return (int)fwd<__nv_bfloat16>(y, a, b, out, NHW, C, co, blk, st);
  return (int)cudaErrorInvalidValue;
}

// Slabs of bn_tail_bwd_reduce for N*H*W pixels: the wrapper sizes
// ``part`` as slabs * 2 * C floats.
extern "C" int bn_tail_reduce_slabs(long long NHW) { return reduce_slabs(NHW); }

// y [N*H*W, C], g [N*H*W, C/4] of dtype; a, b, mu, inv f32 [C]; sums f32
// [2*C] = s1 then s2 per channel.
extern "C" int bn_tail_bwd_reduce(int dtype, const void* y, const void* g, const float* a,
                                  const float* b, const float* mu, const float* inv,
                                  float* part, float* sums, long long NHW, int C, int co,
                                  int blk, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bad_geometry(C, co, blk)) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)bwd_reduce<float>(y, g, a, b, mu, inv, part, sums, NHW, C, co, blk, st);
  if (dtype == 1)
    return (int)bwd_reduce<__nv_bfloat16>(y, g, a, b, mu, inv, part, sums, NHW, C, co, blk,
                                          st);
  return (int)cudaErrorInvalidValue;
}

// As the reduce, plus gi, c1, c2 f32 [C]; dy [N*H*W, C] of dtype.
extern "C" int bn_tail_bwd_apply(int dtype, const void* y, const void* g, const float* a,
                                 const float* b, const float* mu, const float* inv,
                                 const float* gi, const float* c1, const float* c2,
                                 void* dy, long long NHW, int C, int co, int blk,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bad_geometry(C, co, blk)) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)bwd_apply<float>(y, g, a, b, mu, inv, gi, c1, c2, dy, NHW, C, co, blk, st);
  if (dtype == 1)
    return (int)bwd_apply<__nv_bfloat16>(y, g, a, b, mu, inv, gi, c1, c2, dy, NHW, C, co,
                                         blk, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
