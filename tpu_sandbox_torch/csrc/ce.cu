// Fused softmax cross-entropy forward for Hopper (sm_90a): per row
//   loss[n] = logsumexp(logits[n, :]) - logits[n, label[n]]
// logits [N, C] float32 or bfloat16, labels [N] int64, loss [N] float32
// (the mean is taken outside, as the JAX package takes it).
//
// Replaces tpu_sandbox/ops/pallas_ce.py::_ce_kernel (:36), launched by
// _forward (pallas_call at :94) for pallas_cross_entropy (:49).
//
// What bounds it on the H100: bytes. At the LM's shapes (N = 16 * 2048 =
// 32768 rows, C = 32768, bf16) it reads the logits once, 2.15 GB, 0.64 ms
// at 3.35 TB/s; the 1.07e9 exps and adds are far below the card's rates.
//
// Design: one block per row, one pass over it. Each thread walks the row
// in 16-byte vectors (8 bf16 or 4 f32 values, neighbouring threads on
// neighbouring vectors) and keeps a running (max, sum of exp) pair, so no
// second read of the row is needed; the pairs are combined by warp
// shuffles, then across the warps in a fixed order by thread 0, which
// reads the label's logit and writes the row's loss. Rows whose byte width
// is not a multiple of 16 (C = 4097) take a scalar walk.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "dtypes.cuh"

namespace {

constexpr int kThreads = 256;

// 16 bytes of T as floats; the T* argument only picks the overload
__device__ __forceinline__ void unpack16(uint4 r, float*, float* o) {
  o[0] = __uint_as_float(r.x); o[1] = __uint_as_float(r.y);
  o[2] = __uint_as_float(r.z); o[3] = __uint_as_float(r.w);
}

__device__ __forceinline__ void unpack16(uint4 r, __nv_bfloat16*, float* o) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

// (m, s) <- the pair of the union of two element sets, s = sum exp(x - m)
__device__ __forceinline__ void combine(float& m, float& s, float m2, float s2) {
  if (m2 == -INFINITY) return;          // nothing on the other side
  if (m == -INFINITY) {
    m = m2;
    s = s2;
    return;
  }
  const float mn = fmaxf(m, m2);
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

template <typename T, bool VEC>
__global__ void __launch_bounds__(kThreads)
ce_fwd_kernel(const T* __restrict__ logits, const long long* __restrict__ labels,
              float* __restrict__ loss, int C) {
  const T* x = logits + (size_t)blockIdx.x * C;
  float m = -INFINITY, s = 0.f;
  if constexpr (VEC) {
    constexpr int V = 16 / sizeof(T);
    const uint4* x4 = reinterpret_cast<const uint4*>(x);
    for (int i = threadIdx.x; i < C / V; i += kThreads) {
      float f[V];
      unpack16(__ldg(x4 + i), (T*)nullptr, f);
      float mx = f[0];
#pragma unroll
      for (int e = 1; e < V; ++e) mx = fmaxf(mx, f[e]);
      const float mn = fmaxf(m, mx);
      s *= expf(m - mn);                // 0 while m is still -inf
#pragma unroll
      for (int e = 0; e < V; ++e) s += expf(f[e] - mn);
      m = mn;
    }
  } else {
    for (int i = threadIdx.x; i < C; i += kThreads) {
      const float f = to_f(x[i]);
      const float mn = fmaxf(m, f);
      s = s * expf(m - mn) + expf(f - mn);
      m = mn;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    const float m2 = __shfl_xor_sync(0xffffffffu, m, off);
    const float s2 = __shfl_xor_sync(0xffffffffu, s, off);
    combine(m, s, m2, s2);
  }
  __shared__ float wm[kThreads / 32], ws[kThreads / 32];
  if (threadIdx.x % 32 == 0) {
    wm[threadIdx.x / 32] = m;
    ws[threadIdx.x / 32] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float M = wm[0], S = ws[0];
    for (int w = 1; w < kThreads / 32; ++w) combine(M, S, wm[w], ws[w]);
    const float lse = logf(S) + M;
    const long long lab = labels[blockIdx.x];
    // a label outside [0, C) picks nothing, as the Pallas kernel's iota
    // compare does
    const float picked = (lab >= 0 && lab < C) ? to_f(x[lab]) : 0.f;
    loss[blockIdx.x] = lse - picked;
  }
}

template <typename T>
cudaError_t launch(const void* logits, const void* labels, void* loss, int N, int C,
                   cudaStream_t st) {
  const bool vec = ((size_t)C * sizeof(T)) % 16 == 0 && (uintptr_t)logits % 16 == 0;
  if (vec)
    ce_fwd_kernel<T, true><<<N, kThreads, 0, st>>>(
        (const T*)logits, (const long long*)labels, (float*)loss, C);
  else
    ce_fwd_kernel<T, false><<<N, kThreads, 0, st>>>(
        (const T*)logits, (const long long*)labels, (float*)loss, C);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of the logits). labels int64 [N],
// loss float32 [N].
extern "C" int ce_fwd(int dtype, const void* logits, const void* labels, void* loss,
                      int N, int C, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (N < 1 || C < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)launch<float>(logits, labels, loss, N, C, st);
  if (dtype == 1) return (int)launch<__nv_bfloat16>(logits, labels, loss, N, C, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
