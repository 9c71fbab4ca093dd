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
// neighbouring w (coalesced). fwd and apply: one window at one w a
// thread, scalar loads. The reduce gives each block one window over a
// slab of whole rows, sized on the host to about two waves of the card,
// and walks the slab's (row, w pair) items with bf16x2 (float2) loads
// where rows are 4-byte (8-byte) aligned and scalar loads at odd W, one
// round of items in flight while the one before is added; the window's
// columns stay in registers. It keeps its sums in registers, combines a
// warp by a shuffle butterfly and the warps in a fixed order, and writes
// one partial per slab; reduce_partials (reduce.cuh) adds the partials in
// a fixed order. No float atomics: two runs are bitwise equal. Vector
// loads in fwd and apply, and fusing the reduce with the apply, are later
// work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include "mma.cuh"
#include "reduce.cuh"
#include "tail_math.cuh"

namespace {

constexpr int kThreads = 256;       // along W, one window each
constexpr int kRedUnroll = 2;       // items a reduce thread takes a round
constexpr int kRedMinBlocks = 4;    // reduce blocks an SM: 64 registers a thread
constexpr int kRedWaves = 2;        // reduce blocks: twice those resident at once

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

// The reduce's loads: V elements of a channel row in one access (V 2: a
// bf16x2 or float2 word, for rows 2V-byte aligned; V 1: one element).
template <typename T, int V>
struct Vec {
  using type = T;
};
template <>
struct Vec<__nv_bfloat16, 2> {
  using type = __nv_bfloat162;
};
template <>
struct Vec<float, 2> {
  using type = float2;
};

__device__ __forceinline__ float elem(float v, int) { return v; }
__device__ __forceinline__ float elem(__nv_bfloat16 v, int) { return __bfloat162float(v); }
__device__ __forceinline__ float elem(float2 v, int e) { return e ? v.y : v.x; }
__device__ __forceinline__ float elem(__nv_bfloat162 v, int e) {
  return e ? __high2float(v) : __low2float(v);
}

// One item's V elements added to s1 and s2 (per channel of the window):
// z = relu(round(y*a + b)), dz routed (tail_math.cuh), t = (y - mu)*inv,
// s1 += dz and s2 += dz*t, element by element.
template <typename T, int V, typename VT>
__device__ __forceinline__ void add_item(const VT (&yv)[4], VT gv, const float (&ca)[4],
                                         const float (&cb)[4], const float (&cm)[4],
                                         const float (&ci)[4], float (&s1)[4],
                                         float (&s2)[4]) {
#pragma unroll
  for (int e = 0; e < V; ++e) {
    float yf[4], z[4], dz[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      yf[i] = elem(yv[i], e);
      z[i] = rounded_relu<T>(yf[i], ca[i], cb[i]);
    }
    route(z, elem(gv, e), dz);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float t = __fmul_rn(__fsub_rn(yf[i], cm[i]), ci[i]);
      s1[i] += dz[i];
      s2[i] += dz[i] * t;
    }
  }
}

// The same for a bf16 pair, with z, the routing and dz in packed bf16x2
// arithmetic: z and g are bf16 values and every weight is 0, 0.5 or 1, so
// each packed max, comparison, sum and product is exact and dz is route's
// value for value; the pair's rounding to bf16 is one conversion. The
// ReLU's mask is taken once for the window: a member whose z is 0 gets a
// nonzero weight only where the window's max is 0, and then every member
// is masked.
template <>
__device__ __forceinline__ void add_item<__nv_bfloat16, 2, __nv_bfloat162>(
    const __nv_bfloat162 (&yv)[4], __nv_bfloat162 gv, const float (&ca)[4],
    const float (&cb)[4], const float (&cm)[4], const float (&ci)[4], float (&s1)[4],
    float (&s2)[4]) {
  const __nv_bfloat162 zero = __float2bfloat162_rn(0.f), one = __float2bfloat162_rn(1.f);
  const __nv_bfloat162 half = __float2bfloat162_rn(0.5f);
  auto tie = [&](__nv_bfloat162 x, __nv_bfloat162 xb) {
    return __hmul2(__hadd2(__hgt2(x, xb), __hge2(x, xb)), half);
  };
  float2 yf[4];
  __nv_bfloat162 z[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    yf[i] = __bfloat1622float2(yv[i]);
    z[i] = __hmax2(__floats2bfloat162_rn(__fadd_rn(__fmul_rn(yf[i].x, ca[i]), cb[i]),
                                         __fadd_rn(__fmul_rn(yf[i].y, ca[i]), cb[i])),
                   zero);
  }
  const __nv_bfloat162 m01 = __hmax2(z[0], z[1]), m23 = __hmax2(z[2], z[3]);
  const __nv_bfloat162 gm = __hmul2(gv, __hgt2(__hmax2(m01, m23), zero));
  const __nv_bfloat162 w2 = tie(m01, m23), w1a = tie(z[0], z[1]), w1b = tie(z[2], z[3]);
  const __nv_bfloat162 da = __hmul2(gm, w2), db = __hmul2(gm, __hsub2(one, w2));
  float2 dz[4];
  dz[0] = __bfloat1622float2(__hmul2(da, w1a));
  dz[1] = __bfloat1622float2(__hmul2(da, __hsub2(one, w1a)));
  dz[2] = __bfloat1622float2(__hmul2(db, w1b));
  dz[3] = __bfloat1622float2(__hmul2(db, __hsub2(one, w1b)));
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float t = __fmul_rn(__fsub_rn(yf[i].x, cm[i]), ci[i]);
    s1[i] += dz[i].x;
    s2[i] += dz[i].x * t;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float t = __fmul_rn(__fsub_rn(yf[i].y, cm[i]), ci[i]);
    s1[i] += dz[i].y;
    s2[i] += dz[i].y * t;
  }
}

// grid (slabs, Cout); part f32 [slabs, 2*C] (s1 then s2 per channel).
// Block (slab, o) owns window o over rows_per_slab rows: the slab's
// (row, V-element) items are spread over the threads, neighbouring
// threads on neighbouring items (coalesced). A thread takes kRedUnroll
// items a round (5 words each: the window's four y rows and g), and the
// next round's loads are in flight while it adds the round before (two
// register buffers). The window's a, b, mu and inv sit in registers. Each
// thread adds its items in order; the warp's lanes combine by a shuffle
// butterfly and the warps in order, and the block writes its four
// channels' s1 and s2. What bounds it at the main path's shapes is the
// arithmetic a word, not the bytes (four blocks of 64 registers an SM;
// more items in flight or fewer blocks were slower): hence the packed
// bf16 routing.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, kRedMinBlocks)
tail_bwd_reduce_kernel(const T* __restrict__ y, const T* __restrict__ g,
                       const float* __restrict__ a, const float* __restrict__ b,
                       const float* __restrict__ mu, const float* __restrict__ inv,
                       float* __restrict__ part, int NH, int C, int co, int blk, int W,
                       int rows_per_slab) {
  using VT = typename Vec<T, V>::type;
  __shared__ float red[kThreads / 32][8];
  const int tid = threadIdx.x, o = blockIdx.y, Cout = gridDim.y;
  int ch[4];
  window(o, co, blk, ch);
  float ca[4], cb[4], cm[4], ci[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    ca[i] = a[ch[i]];
    cb[i] = b[ch[i]];
    cm[i] = mu[ch[i]];
    ci[i] = inv[ch[i]];
  }
  const int r0 = blockIdx.x * rows_per_slab;
  const int per_row = W / V;
  const int items = (min(NH, r0 + rows_per_slab) - r0) * per_row;
  const T* yb = y + (size_t)r0 * C * W;
  const T* gb = g + ((size_t)r0 * Cout + o) * W;
  float s1[4] = {0.f, 0.f, 0.f, 0.f}, s2[4] = {0.f, 0.f, 0.f, 0.f};
  // the kRedUnroll items it0, it0 + kThreads, ... of a round: loads, then sums
  auto load = [&](int it0, VT (&ys)[kRedUnroll][4], VT (&gs)[kRedUnroll]) {
#pragma unroll
    for (int u = 0; u < kRedUnroll; ++u) {
      const int it = it0 + u * kThreads;
      if (it >= items) continue;
      const int r = it / per_row, e = (it - r * per_row) * V;
      const T* yr = yb + (size_t)r * C * W + e;
#pragma unroll
      for (int i = 0; i < 4; ++i) ys[u][i] = *reinterpret_cast<const VT*>(yr + (size_t)ch[i] * W);
      gs[u] = *reinterpret_cast<const VT*>(gb + (size_t)r * Cout * W + e);
    }
  };
  auto add = [&](int it0, const VT (&ys)[kRedUnroll][4], const VT (&gs)[kRedUnroll]) {
#pragma unroll
    for (int u = 0; u < kRedUnroll; ++u)
      if (it0 + u * kThreads < items) add_item<T, V>(ys[u], gs[u], ca, cb, cm, ci, s1, s2);
  };
  // two register buffers: a round's loads are in flight while the round
  // before it is added
  constexpr int R = kRedUnroll * kThreads;
  VT yv[2][kRedUnroll][4], gv[2][kRedUnroll];
  load(tid, yv[0], gv[0]);
  for (int it0 = tid; it0 < items; it0 += 2 * R) {
    load(it0 + R, yv[1], gv[1]);
    add(it0, yv[0], gv[0]);
    load(it0 + 2 * R, yv[0], gv[0]);
    add(it0 + R, yv[1], gv[1]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      s1[i] += __shfl_xor_sync(0xffffffffu, s1[i], off);
      s2[i] += __shfl_xor_sync(0xffffffffu, s2[i], off);
    }
  if (tid % 32 == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      red[tid / 32][i] = s1[i];
      red[tid / 32][4 + i] = s2[i];
    }
  }
  __syncthreads();
  if (tid < 8) {
    float s = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) s += red[w][tid];
    const int c = tid % 4 == 0 ? ch[0] : tid % 4 == 1 ? ch[1] : tid % 4 == 2 ? ch[2] : ch[3];
    part[(size_t)blockIdx.x * 2 * C + (tid / 4) * C + c] = s;
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
                       int W, int slabs, int rows_per_slab, cudaStream_t st) {
  const dim3 grid(slabs, C / 4);
  const uintptr_t pair = 2 * sizeof(T);
  if (W % 2 == 0 && (uintptr_t)y % pair == 0 && (uintptr_t)g % pair == 0)
    tail_bwd_reduce_kernel<T, 2><<<grid, kThreads, 0, st>>>(
        (const T*)y, (const T*)g, a, b, mu, inv, part, NH, C, co, blk, W, rows_per_slab);
  else
    tail_bwd_reduce_kernel<T, 1><<<grid, kThreads, 0, st>>>(
        (const T*)y, (const T*)g, a, b, mu, inv, part, NH, C, co, blk, W, rows_per_slab);
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

// Blocks of bn_tail_t_bwd_reduce the card should hold: kRedWaves times
// those resident at once (0 if the device cannot be asked). The wrapper
// splits the N*H rows into slabs of whole rows, about this many blocks in
// all over the C/4 windows (ops/conv_t.py::wgrad_slabs), and sizes
// ``part`` as slabs * 2 * C floats.
extern "C" int bn_tail_t_reduce_slots(void) {
  return kRedWaves * device_slots(tail_bwd_reduce_kernel<__nv_bfloat16, 2>, 0);
}

// y [N*H, C, W], g [N*H, C/4, W] of dtype; a, b, mu, inv f32 [C]; part
// f32 [slabs, 2*C] scratch; sums f32 [2*C] = s1 then s2 per channel.
extern "C" int bn_tail_t_bwd_reduce(int dtype, const void* y, const void* g,
                                    const float* a, const float* b,
                                    const float* mu, const float* inv,
                                    float* part, float* sums, int NH, int C,
                                    int co, int blk, int W, int slabs,
                                    int rows_per_slab, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bad_tail_geometry(NH, C, co, blk) || slabs < 1 || rows_per_slab < 1 ||
      (long long)rows_per_slab * W >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)bwd_reduce<float>(y, g, a, b, mu, inv, part, sums, NH, C, co,
                                  blk, W, slabs, rows_per_slab, st);
  if (dtype == 1)
    return (int)bwd_reduce<__nv_bfloat16>(y, g, a, b, mu, inv, part, sums, NH,
                                          C, co, blk, W, slabs, rows_per_slab, st);
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
