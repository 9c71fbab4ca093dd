// Input gradient of the transposed plan's fc head, for Hopper (sm_90a):
//   dy[n, f] = sum_k g[n, k] * wT[k, f],   f = (h, c, w) flattened,
// g f32 [N, K], wT [K, F] and dy [N, F] of dtype T, f32 accumulation.
//
// Replaces tpu_sandbox/ops/pallas_fc_t.py::_dgrad_kernel (:63), launched by
// fc_dgrad_t (:71, pallas_call at :79).
//
// What bounds it on the H100: bytes. At 3000x3000 batch 5 (F = 18,000,000,
// K = 10, bf16) it reads wT once (360 MB) and writes dy once (180 MB):
// 0.54 GB over 3.35 TB/s = 0.16 ms; its 0.9 GFLOP are nothing.
//
// Design: a streaming pass. g (N*K scalars) sits in shared memory. A
// thread owns 16 bytes of the flat f axis (8 bf16 or 4 f32 values), loads
// that vector from each of the K rows of wT once, and keeps the N output
// vectors in registers, so every byte of wT and dy crosses device memory
// once, in 16-byte coalesced accesses. What matters is the bytes each
// thread has in flight: the main path's shape (K 10, N <= 8) takes a body
// specialised at compile time, fc_dgrad_t_fixed_kernel<T, K, N>, in which a
// thread owns one vector, issues its K loads at once (160 bytes in flight)
// before the first FMA, holds exactly N accumulator rows and streams wT in
// and dy out past the caches (ld.global.cs / st.global.cs: each byte is
// touched once); the grid has one thread a vector, so the last wave is a
// part of one block's work, not of a thread's loop. Every other N, K
// keeps the general body (N taken kNB rows at a time, a grid-stride loop).
// Both add the K products of an output in k order from 0 with fmaf and
// round once, so the two bodies give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kNB = 8;           // batch rows held in registers per pass

template <typename T> struct Vec;

template <> struct Vec<float> {
  static constexpr int V = 4;
  __device__ static void unpack(uint4 r, float* o) {
    o[0] = __uint_as_float(r.x); o[1] = __uint_as_float(r.y);
    o[2] = __uint_as_float(r.z); o[3] = __uint_as_float(r.w);
  }
  __device__ static uint4 pack(const float* a) {
    return make_uint4(__float_as_uint(a[0]), __float_as_uint(a[1]),
                      __float_as_uint(a[2]), __float_as_uint(a[3]));
  }
};

template <> struct Vec<__nv_bfloat16> {
  static constexpr int V = 8;
  __device__ static float2 two(uint32_t u) {
    __nv_bfloat162 b = *reinterpret_cast<__nv_bfloat162*>(&u);
    return __bfloat1622float2(b);
  }
  __device__ static uint32_t one(float a, float b) {
    __nv_bfloat162 p = __floats2bfloat162_rn(a, b);
    return *reinterpret_cast<uint32_t*>(&p);
  }
  __device__ static void unpack(uint4 r, float* o) {
    float2 t;
    t = two(r.x); o[0] = t.x; o[1] = t.y;
    t = two(r.y); o[2] = t.x; o[3] = t.y;
    t = two(r.z); o[4] = t.x; o[5] = t.y;
    t = two(r.w); o[6] = t.x; o[7] = t.y;
  }
  __device__ static uint4 pack(const float* a) {
    return make_uint4(one(a[0], a[1]), one(a[2], a[3]), one(a[4], a[5]),
                      one(a[6], a[7]));
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
fc_dgrad_t_kernel(const float* __restrict__ g, const T* __restrict__ wt,
                  T* __restrict__ dy, int N, int K, long long nvec) {
  constexpr int V = Vec<T>::V;
  extern __shared__ float gs[];          // [N, K]
  for (int i = threadIdx.x; i < N * K; i += blockDim.x) gs[i] = g[i];
  __syncthreads();

  const uint4* w4 = reinterpret_cast<const uint4*>(wt);
  uint4* d4 = reinterpret_cast<uint4*>(dy);
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long v = (long long)blockIdx.x * blockDim.x + threadIdx.x; v < nvec;
       v += stride) {
    for (int n0 = 0; n0 < N; n0 += kNB) {
      const int nb = min(kNB, N - n0);
      float acc[kNB][V];
#pragma unroll
      for (int n = 0; n < kNB; ++n)
#pragma unroll
        for (int e = 0; e < V; ++e) acc[n][e] = 0.f;
      for (int k = 0; k < K; ++k) {
        float wv[V];
        Vec<T>::unpack(__ldg(w4 + (size_t)k * nvec + v), wv);
#pragma unroll
        for (int n = 0; n < kNB; ++n) {
          if (n < nb) {
            const float gk = gs[(n0 + n) * K + k];
#pragma unroll
            for (int e = 0; e < V; ++e) acc[n][e] = fmaf(gk, wv[e], acc[n][e]);
          }
        }
      }
#pragma unroll
      for (int n = 0; n < kNB; ++n)
        if (n < nb) d4[(size_t)(n0 + n) * nvec + v] = Vec<T>::pack(acc[n]);
    }
  }
}

// The main path's body: K and N fixed, one vector a thread. Blocks an SM:
// two where the K raw vectors and the N accumulator rows leave room (128
// registers a thread), else one.
template <typename T, int K, int N>
__global__ void __launch_bounds__(kThreads, N * Vec<T>::V + 4 * K <= 96 ? 2 : 1)
fc_dgrad_t_fixed_kernel(const float* __restrict__ g, const T* __restrict__ wt,
                        T* __restrict__ dy, long long nvec) {
  constexpr int V = Vec<T>::V;
  __shared__ float gs[N * K];
  if (threadIdx.x < N * K) gs[threadIdx.x] = g[threadIdx.x];
  __syncthreads();
  const long long v = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (v >= nvec) return;
  const uint4* w4 = reinterpret_cast<const uint4*>(wt) + v;
  uint4 raw[K];
#pragma unroll
  for (int k = 0; k < K; ++k) raw[k] = __ldcs(w4 + (size_t)k * nvec);
  float acc[N][V];
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int e = 0; e < V; ++e) acc[n][e] = 0.f;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float wv[V];
    Vec<T>::unpack(raw[k], wv);
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const float gk = gs[n * K + k];
#pragma unroll
      for (int e = 0; e < V; ++e) acc[n][e] = fmaf(gk, wv[e], acc[n][e]);
    }
  }
  uint4* d4 = reinterpret_cast<uint4*>(dy) + v;
#pragma unroll
  for (int n = 0; n < N; ++n) __stcs(d4 + (size_t)n * nvec, Vec<T>::pack(acc[n]));
}

constexpr int kFixedK = 10;   // the classes of the main path's fc

template <typename T, int N>
cudaError_t launch_fixed(const float* g, const void* wt, void* dy, long long nvec,
                         cudaStream_t st) {
  const long long blocks = (nvec + kThreads - 1) / kThreads;
  fc_dgrad_t_fixed_kernel<T, kFixedK, N><<<(unsigned)blocks, kThreads, 0, st>>>(
      g, (const T*)wt, (T*)dy, nvec);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const float* g, const void* wt, void* dy, int N, int K,
                   long long F, cudaStream_t st) {
  const long long nvec = F / Vec<T>::V;
  if (K == kFixedK && nvec > 0) {
    switch (N) {
      case 1: return launch_fixed<T, 1>(g, wt, dy, nvec, st);
      case 2: return launch_fixed<T, 2>(g, wt, dy, nvec, st);
      case 3: return launch_fixed<T, 3>(g, wt, dy, nvec, st);
      case 4: return launch_fixed<T, 4>(g, wt, dy, nvec, st);
      case 5: return launch_fixed<T, 5>(g, wt, dy, nvec, st);
      case 6: return launch_fixed<T, 6>(g, wt, dy, nvec, st);
      case 7: return launch_fixed<T, 7>(g, wt, dy, nvec, st);
      case 8: return launch_fixed<T, 8>(g, wt, dy, nvec, st);
      default: break;
    }
  }
  long long blocks = (nvec + kThreads - 1) / kThreads;
  if (blocks > 132 * 32) blocks = 132 * 32;
  if (blocks < 1) blocks = 1;
  fc_dgrad_t_kernel<T><<<(unsigned)blocks, kThreads, N * K * sizeof(float), st>>>(
      g, (const T*)wt, (T*)dy, N, K, nvec);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of wt and dy; g is always f32).
// F * sizeof(dtype) must be a multiple of 16 and every pointer 16-byte
// aligned (the wrapper checks both).
extern "C" int fc_dgrad_t(int dtype, const void* g, const void* wt, void* dy,
                          int N, int K, long long F, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) return launch<float>((const float*)g, wt, dy, N, K, F, st);
  if (dtype == 1) return launch<__nv_bfloat16>((const float*)g, wt, dy, N, K, F, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
