// Flash attention for Hopper (sm_90a): the online-softmax forward and the
// two backward kernels, on [B*H, S, D] tensors (heads folded into the
// batch, S padded by the caller, D in {32, 64, 128}), with global position
// offsets for queries and keys, the key-length mask and the causal mask.
//
// Replaces the Pallas TPU kernels of tpu_sandbox/ops/pallas_attention.py:
//   flash_fwd      <- _fwd_kernel (:70), launched by _flash_fwd (pallas_call
//                     at :166): out in the input dtype and lse [B*H, S] f32
//   flash_bwd_dkv  <- _bwd_dkv_kernel (:199), launched by _flash_bwd
//                     (pallas_call at :361): dk, dv, kv-major
//   flash_bwd_dq   <- _bwd_dq_kernel (:262), launched by _flash_bwd
//                     (pallas_call at :379): dq, q-major
//
// What bounds them on the H100, at the LM's shapes (B 16, H 8, S 2048,
// D 128, causal, bf16): operations. The forward's two products over the
// causal half are 4*B*H*S^2*D/2 = 1.37e11 FLOP, 0.139 ms at 989 TFLOP/s
// bf16, against 0.27 GB of q, k, v and out (0.08 ms at 3.35 TB/s). The
// backward adds, per kernel, the bf16 q.k^T (and do.v^T) at the bf16 rate
// and its f32 products at 67 TFLOP/s: dk/dv about 2.19 ms, dq 1.17 ms.
//
// Design. A block owns one 64-row tile of its loop-invariant side (q rows
// for the forward and dq, key rows for dk/dv) in shared memory and walks
// the other side in 64-row tiles, skipping tiles wholly past kv_len and,
// with causal, wholly above the block diagonal (the Pallas kernels'
// should_run predicate). Nothing is carried between blocks and there are
// no atomics: every sum runs in a fixed order, so two runs are bitwise
// equal.
// - Forward: s = q.k^T on the tensor cores (bf16 WMMA, f32 accumulation)
//   into a shared f32 tile; four threads per row keep the running max and
//   sum in registers; p is rounded to v's dtype before p.v (as :120), and
//   the f32 output accumulator lives in shared memory, rescaled by alpha
//   before each p.v product on the tensor cores. out = acc / max(l, 1e-30),
//   lse = m + log(max(l, 1e-30)).
// - Backward: q.k^T and do.v^T are bf16 operands, whose products f32 holds
//   exactly, so they run on the tensor cores with f32 accumulation. The
//   products with p or ds (p^T.do, ds^T.q, ds.k) have an f32 operand and
//   stay in f32 on the CUDA cores, as the Pallas kernels compute them;
//   each thread owns a 4 x D/16 accumulator tile in registers.
// - float32 inputs run every product on the CUDA cores in f32: they are
//   the tight check against the plain version.
// Not yet done: wgmma, TMA, a pipelined ring of kv tiles, and bf16
// products for the f32 operands of the backward.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include <type_traits>

#include "dtypes.cuh"

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;   // 8 warps; thread (ty, tx) = (tid / 16, tid % 16)
constexpr int kB = 64;          // rows of a q tile and of a kv tile
constexpr int kSLd = kB + 4;    // leading dim of the f32 [64, 64] score tiles
constexpr int kPLd = kB + 8;    // leading dim of the forward's p tile
constexpr float kNeg = -1e30f;  // the mask filler, pallas_common.NEG

// leading dim of a [64, D] tile of T in shared memory: f32 rows get an odd
// stride, so that walks down a column (k^T on the CUDA cores) hit distinct
// banks; bf16 rows are padded by 8 (WMMA wants multiples of 8 and 32-byte
// aligned fragments)
template <typename T, int D> struct Ld { static constexpr int v = D + 1; };
template <int D> struct Ld<bf16, D> { static constexpr int v = D + 8; };

__host__ __device__ constexpr size_t align128(size_t b) { return (b + 127) / 128 * 128; }

template <typename T, int D>
constexpr size_t tile_bytes() { return align128(sizeof(T) * kB * Ld<T, D>::v); }
constexpr size_t kScoreBytes = align128(sizeof(float) * kB * kSLd);
constexpr size_t kRowBytes = align128(sizeof(float) * kB);

template <typename T, int D>
constexpr size_t fwd_bytes() {
  return 3 * tile_bytes<T, D>() + kScoreBytes + align128(sizeof(T) * kB * kPLd) +
         2 * kRowBytes +
         (std::is_same<T, bf16>::value ? align128(sizeof(float) * kB * (D + 4)) : 0);
}

template <typename T, int D>
constexpr size_t bwd_bytes() { return 4 * tile_bytes<T, D>() + 2 * kScoreBytes + 2 * kRowBytes; }

// hands out 128-byte aligned pieces of the dynamic shared memory, in the
// order the byte counts above add them up
struct Carve {
  unsigned char* p;
  template <typename U>
  __device__ U* take(size_t n) {
    U* r = reinterpret_cast<U*>(p);
    p += align128(n * sizeof(U));
    return r;
  }
};

// rows [r0, r0 + 64) of a [S, D] matrix of T (row stride D) into a shared
// tile with leading dim Ld<T, D>; rows at or past S are zero
template <typename T, int D>
__device__ __forceinline__ void load_rows(T* dst, const T* __restrict__ src, int r0, int S) {
  constexpr int LD = Ld<T, D>::v, V = 16 / sizeof(T), VPR = D / V;
  for (int i = threadIdx.x; i < kB * VPR; i += kThreads) {
    const int r = i / VPR, c = (i % VPR) * V;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < S) val = __ldg(reinterpret_cast<const uint4*>(src + (size_t)(r0 + r) * D + c));
    if constexpr (sizeof(T) == 2) {
      *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
    } else {
      T* d = dst + r * LD + c;
      d[0] = __uint_as_float(val.x);
      d[1] = __uint_as_float(val.y);
      d[2] = __uint_as_float(val.z);
      d[3] = __uint_as_float(val.w);
    }
  }
}

// rows [r0, r0 + 64) of a per-row f32 vector; zero at or past S
__device__ __forceinline__ void load_vec(float* dst, const float* __restrict__ src, int r0,
                                         int S) {
  for (int i = threadIdx.x; i < kB; i += kThreads) dst[i] = r0 + i < S ? src[r0 + i] : 0.f;
}

// C[64 x N] (f32, shared, leading dim ldc) = (ACC ? C : 0) + A[64 x K] B[K x N]
// on the tensor cores: bf16 fragments, f32 accumulation. A is row-major
// (a[m * lda + k]); B is b[n * ldb + k] when B_COL, else b[k * ldb + n]. The
// 8 warps share the 4 x N/16 output fragments.
template <int N, int K, bool B_COL, bool ACC>
__device__ __forceinline__ void tc_tile(float* c, int ldc, const bf16* a, int lda,
                                        const bf16* b, int ldb) {
  using LB = typename std::conditional<B_COL, wmma::col_major, wmma::row_major>::type;
  const int warp = threadIdx.x / 32;
  for (int f = warp; f < 4 * (N / 16); f += kThreads / 32) {
    const int rb = f % 4, cb = f / 4;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
    if (ACC)
      wmma::load_matrix_sync(acc, c + rb * 16 * ldc + cb * 16, ldc, wmma::mem_row_major);
    else
      wmma::fill_fragment(acc, 0.f);
#pragma unroll
    for (int k = 0; k < K / 16; ++k) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, LB> fb;
      wmma::load_matrix_sync(fa, a + rb * 16 * lda + k * 16, lda);
      wmma::load_matrix_sync(fb, B_COL ? b + cb * 16 * ldb + k * 16 : b + k * 16 * ldb + cb * 16,
                             ldb);
      wmma::mma_sync(acc, fa, fb, acc);
    }
    wmma::store_matrix_sync(c + rb * 16 * ldc + cb * 16, acc, ldc, wmma::mem_row_major);
  }
}

// acc += sum_k a(m, k) b(k, n) over a 64 x N tile on the CUDA cores in f32,
// k in order: thread (ty, tx) owns rows ty*4 + i and columns tx + 16*j
template <int N, int K, class FA, class FB>
__device__ __forceinline__ void fma_tile(float (&acc)[4][N / 16], FA a, FB b) {
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
#pragma unroll 4
  for (int k = 0; k < K; ++k) {
    float av[4], bv[N / 16];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a(ty * 4 + i, k);
#pragma unroll
    for (int j = 0; j < N / 16; ++j) bv[j] = b(k, tx + 16 * j);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < N / 16; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// the [64, 64] product x.y^T of two [64, D] tiles into the shared f32 tile
// s: bf16 on the tensor cores, f32 on the CUDA cores
template <typename T, int D>
__device__ __forceinline__ void scores(float* s, const T* x, const T* y) {
  constexpr int LD = Ld<T, D>::v;
  if constexpr (std::is_same<T, bf16>::value) {
    tc_tile<kB, D, true, false>(s, kSLd, x, LD, y, LD);
  } else {
    const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
    float acc[4][kB / 16] = {};
    fma_tile<kB, D>(acc, [&](int m, int k) { return x[m * LD + k]; },
                    [&](int k, int n) { return y[n * LD + k]; });
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kB / 16; ++j) s[(ty * 4 + i) * kSLd + tx + 16 * j] = acc[i][j];
  }
}

// number of kv tiles a q tile starting at q0 visits: up to kv_len and, with
// causal, up to the last tile whose first key it may see
__device__ __forceinline__ int kv_tiles(int q0, int Sk, int causal, int kv_len, int q_off,
                                        int kv_off) {
  int n = (min(kv_len, Sk) + kB - 1) / kB;
  if (causal) {
    const int last = q_off + q0 + kB - 1 - kv_off;   // last visible local key
    n = last < 0 ? 0 : min(n, last / kB + 1);
  }
  return n;
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ out, float* __restrict__ lse, int Sq, int Sk, float scale,
                 int causal, int kv_len, int q_off, int kv_off) {
  constexpr int LD = Ld<T, D>::v, LO = D + 4;
  constexpr bool TC = std::is_same<T, bf16>::value;
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  T* qs = cv.take<T>(kB * LD);
  T* ks = cv.take<T>(kB * LD);
  T* vs = cv.take<T>(kB * LD);
  float* ss = cv.take<float>(kB * kSLd);
  T* ps = cv.take<T>(kB * kPLd);
  float* alpha_s = cv.take<float>(kB);
  float* l_s = cv.take<float>(kB);
  float* os = TC ? cv.take<float>(kB * LO) : nullptr;   // bf16: the output accumulator

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kB;     // the longest causal rows first
  const size_t bh = blockIdx.y;
  q += bh * Sq * D;
  k += bh * Sk * D;
  v += bh * Sk * D;
  out += bh * Sq * D;
  lse += bh * Sq;

  load_rows<T, D>(qs, q, q0, Sq);
  if constexpr (TC)
    for (int i = tid; i < kB * LO; i += kThreads) os[i] = 0.f;
  float oacc[4][D / 16] = {};                           // f32: the output accumulator

  // softmax rows: thread (row, part) owns the row's columns part + 4*c
  const int row = tid / 4, part = tid % 4;
  const int qpos = q_off + q0 + row;
  float m_run = kNeg, l_run = 0.f;
  const int n_kv = kv_tiles(q0, Sk, causal, kv_len, q_off, kv_off);
  for (int j = 0; j < n_kv; ++j) {
    __syncthreads();                                    // k, v, p free again
    load_rows<T, D>(ks, k, j * kB, Sk);
    load_rows<T, D>(vs, v, j * kB, Sk);
    __syncthreads();
    scores<T, D>(ss, qs, ks);
    __syncthreads();
    float sv[kB / 4];
    float mx = kNeg;
#pragma unroll
    for (int c = 0; c < kB / 4; ++c) {
      const int kcol = j * kB + part + 4 * c;
      const float s = ss[row * kSLd + part + 4 * c] * scale;
      const bool valid = kcol < kv_len && (!causal || qpos >= kv_off + kcol);
      sv[c] = valid ? s : kNeg;
      mx = fmaxf(mx, sv[c]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m_run, mx);
    float psum = 0.f;
#pragma unroll
    for (int c = 0; c < kB / 4; ++c) {
      const float p = expf(sv[c] - m_new);
      psum += p;
      ps[row * kPLd + part + 4 * c] = from_f<T>(p);     // p in v's dtype
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    const float alpha = expf(m_run - m_new);
    l_run = alpha * l_run + psum;
    m_run = m_new;
    if (part == 0) alpha_s[row] = alpha;
    __syncthreads();
    if constexpr (TC) {
      for (int i = tid; i < kB * D; i += kThreads) os[(i / D) * LO + i % D] *= alpha_s[i / D];
      __syncthreads();
      tc_tile<D, kB, false, true>(os, LO, ps, kPLd, vs, LD);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = alpha_s[ty * 4 + i];
#pragma unroll
        for (int jj = 0; jj < D / 16; ++jj) oacc[i][jj] *= a;
      }
      fma_tile<D, kB>(oacc, [&](int m, int kk) { return to_f(ps[m * kPLd + kk]); },
                      [&](int kk, int n) { return to_f(vs[kk * LD + n]); });
    }
  }

  const float l = fmaxf(l_run, 1e-30f);
  if (part == 0) {
    l_s[row] = l;
    if (q0 + row < Sq) lse[q0 + row] = m_run + logf(l);
  }
  __syncthreads();
  if constexpr (TC) {
    for (int i = tid; i < kB * D; i += kThreads) {
      const int r = i / D, c = i % D;
      if (q0 + r < Sq) out[(size_t)(q0 + r) * D + c] = from_f<T>(os[r * LO + c] / l_s[r]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      if (q0 + r < Sq)
#pragma unroll
        for (int jj = 0; jj < D / 16; ++jj)
          out[(size_t)(q0 + r) * D + tx + 16 * jj] = from_f<T>(oacc[i][jj] / l_s[r]);
    }
  }
}

// p = exp(s * scale - lse) where the key is visible, else 0, and
// ds = p * (dp - delta) * scale, over the [64 q rows, 64 keys] tiles: p
// into s (when KEEP_P) and ds into dp
template <bool KEEP_P>
__device__ __forceinline__ void p_and_ds(float* s, float* dp, const float* lse_s,
                                         const float* delta_s, int q0, int k0, float scale,
                                         int causal, int kv_len, int q_off, int kv_off) {
  for (int e = threadIdx.x; e < kB * kB; e += kThreads) {
    const int r = e / kB, c = e % kB, kcol = k0 + c;
    const bool valid = kcol < kv_len && (!causal || q_off + q0 + r >= kv_off + kcol);
    const float p = valid ? expf(s[r * kSLd + c] * scale - lse_s[r]) : 0.f;
    if (KEEP_P) s[r * kSLd + c] = p;
    dp[r * kSLd + c] = p * (dp[r * kSLd + c] - delta_s[r]) * scale;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ g, const float* __restrict__ lse,
                     const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
                     int Sq, int Sk, float scale, int causal, int kv_len, int q_off,
                     int kv_off) {
  constexpr int LD = Ld<T, D>::v;
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  T* ks = cv.take<T>(kB * LD);
  T* vs = cv.take<T>(kB * LD);
  T* qs = cv.take<T>(kB * LD);
  T* gs = cv.take<T>(kB * LD);
  float* ss = cv.take<float>(kB * kSLd);
  float* dps = cv.take<float>(kB * kSLd);
  float* lse_s = cv.take<float>(kB);
  float* delta_s = cv.take<float>(kB);

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int k0 = blockIdx.x * kB;                       // the longest causal columns first
  const size_t bh = blockIdx.y;
  q += bh * Sq * D;
  g += bh * Sq * D;
  k += bh * Sk * D;
  v += bh * Sk * D;
  dk += bh * Sk * D;
  dv += bh * Sk * D;
  lse += bh * Sq;
  delta += bh * Sq;

  load_rows<T, D>(ks, k, k0, Sk);
  load_rows<T, D>(vs, v, k0, Sk);
  float dk_acc[4][D / 16] = {}, dv_acc[4][D / 16] = {};

  // q tiles that see some key of this tile: with causal from the first one
  // whose last row reaches the tile's first key; none past kv_len
  const int n_q = (Sq + kB - 1) / kB;
  int i0 = 0;
  if (causal) {
    const int t = kv_off + k0 - q_off + 1;              // rows needed: (i+1)*kB >= t
    if (t > 0) i0 = (t + kB - 1) / kB - 1;
  }
  if (k0 >= kv_len) i0 = n_q;
  for (int i = i0; i < n_q; ++i) {
    const int q0 = i * kB;
    __syncthreads();
    load_rows<T, D>(qs, q, q0, Sq);
    load_rows<T, D>(gs, g, q0, Sq);
    load_vec(lse_s, lse, q0, Sq);
    load_vec(delta_s, delta, q0, Sq);
    __syncthreads();
    scores<T, D>(ss, qs, ks);                           // q.k^T
    scores<T, D>(dps, gs, vs);                          // do.v^T
    __syncthreads();
    p_and_ds<true>(ss, dps, lse_s, delta_s, q0, k0, scale, causal, kv_len, q_off, kv_off);
    __syncthreads();
    fma_tile<D, kB>(dv_acc, [&](int m, int kk) { return ss[kk * kSLd + m]; },
                    [&](int kk, int n) { return to_f(gs[kk * LD + n]); });    // p^T.do
    fma_tile<D, kB>(dk_acc, [&](int m, int kk) { return dps[kk * kSLd + m]; },
                    [&](int kk, int n) { return to_f(qs[kk * LD + n]); });    // ds^T.q
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + ty * 4 + i;
    if (r < Sk)
#pragma unroll
      for (int jj = 0; jj < D / 16; ++jj) {
        dk[(size_t)r * D + tx + 16 * jj] = from_f<T>(dk_acc[i][jj]);
        dv[(size_t)r * D + tx + 16 * jj] = from_f<T>(dv_acc[i][jj]);
      }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ g, const float* __restrict__ lse,
                    const float* __restrict__ delta, T* __restrict__ dq, int Sq, int Sk,
                    float scale, int causal, int kv_len, int q_off, int kv_off) {
  constexpr int LD = Ld<T, D>::v;
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  T* qs = cv.take<T>(kB * LD);
  T* gs = cv.take<T>(kB * LD);
  T* ks = cv.take<T>(kB * LD);
  T* vs = cv.take<T>(kB * LD);
  float* ss = cv.take<float>(kB * kSLd);
  float* dps = cv.take<float>(kB * kSLd);
  float* lse_s = cv.take<float>(kB);
  float* delta_s = cv.take<float>(kB);

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kB;     // the longest causal rows first
  const size_t bh = blockIdx.y;
  q += bh * Sq * D;
  g += bh * Sq * D;
  dq += bh * Sq * D;
  k += bh * Sk * D;
  v += bh * Sk * D;
  lse += bh * Sq;
  delta += bh * Sq;

  load_rows<T, D>(qs, q, q0, Sq);
  load_rows<T, D>(gs, g, q0, Sq);
  load_vec(lse_s, lse, q0, Sq);
  load_vec(delta_s, delta, q0, Sq);
  float dq_acc[4][D / 16] = {};
  const int n_kv = kv_tiles(q0, Sk, causal, kv_len, q_off, kv_off);
  for (int j = 0; j < n_kv; ++j) {
    __syncthreads();
    load_rows<T, D>(ks, k, j * kB, Sk);
    load_rows<T, D>(vs, v, j * kB, Sk);
    __syncthreads();
    scores<T, D>(ss, qs, ks);
    scores<T, D>(dps, gs, vs);
    __syncthreads();
    p_and_ds<false>(ss, dps, lse_s, delta_s, q0, j * kB, scale, causal, kv_len, q_off, kv_off);
    __syncthreads();
    fma_tile<D, kB>(dq_acc, [&](int m, int kk) { return dps[m * kSLd + kk]; },
                    [&](int kk, int n) { return to_f(ks[kk * LD + n]); });    // ds.k
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r < Sq)
#pragma unroll
      for (int jj = 0; jj < D / 16; ++jj)
        dq[(size_t)r * D + tx + 16 * jj] = from_f<T>(dq_acc[i][jj]);
  }
}

struct Args {
  const void *q, *k, *v, *g, *lse_in, *delta;
  void *o0, *o1;
  float* lse_out;
  int BH, Sq, Sk;
  float scale;
  int causal, kv_len, q_off, kv_off;
};

// which: 0 the forward, 1 dk/dv, 2 dq
template <typename T, int D>
cudaError_t run(int which, const Args& a, cudaStream_t st) {
  size_t bytes;
  int tiles;
  cudaError_t e;
  if (which == 0) {
    bytes = fwd_bytes<T, D>();
    tiles = (a.Sq + kB - 1) / kB;
    e = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
    flash_fwd_kernel<T, D><<<dim3(tiles, a.BH), kThreads, bytes, st>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (T*)a.o0, a.lse_out, a.Sq, a.Sk,
        a.scale, a.causal, a.kv_len, a.q_off, a.kv_off);
  } else if (which == 1) {
    bytes = bwd_bytes<T, D>();
    tiles = (a.Sk + kB - 1) / kB;
    e = cudaFuncSetAttribute(flash_bwd_dkv_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
    flash_bwd_dkv_kernel<T, D><<<dim3(tiles, a.BH), kThreads, bytes, st>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.g, (const float*)a.lse_in,
        (const float*)a.delta, (T*)a.o0, (T*)a.o1, a.Sq, a.Sk, a.scale, a.causal, a.kv_len,
        a.q_off, a.kv_off);
  } else {
    bytes = bwd_bytes<T, D>();
    tiles = (a.Sq + kB - 1) / kB;
    e = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (e != cudaSuccess) return e;
    flash_bwd_dq_kernel<T, D><<<dim3(tiles, a.BH), kThreads, bytes, st>>>(
        (const T*)a.q, (const T*)a.k, (const T*)a.v, (const T*)a.g, (const float*)a.lse_in,
        (const float*)a.delta, (T*)a.o0, a.Sq, a.Sk, a.scale, a.causal, a.kv_len, a.q_off,
        a.kv_off);
  }
  return cudaGetLastError();
}

template <typename T>
cudaError_t run_d(int which, int d, const Args& a, cudaStream_t st) {
  if (d == 32) return run<T, 32>(which, a, st);
  if (d == 64) return run<T, 64>(which, a, st);
  if (d == 128) return run<T, 128>(which, a, st);
  return cudaErrorInvalidValue;
}

int dispatch(int which, int dtype, int d, const Args& a, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (a.BH < 1 || a.BH > 65535 || a.Sq < 1 || a.Sk < 1) return (int)cudaErrorInvalidValue;
  if (dtype == 0) return (int)run_d<float>(which, d, a, st);
  if (dtype == 1) return (int)run_d<bf16>(which, d, a, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of q, k, v, do and of the outputs);
// d: the head width, 32, 64 or 128; q, do, out, dq [BH, Sq, d]; k, v, dk,
// dv [BH, Sk, d]; lse, delta [BH, Sq] float32. Every pointer 16-byte aligned
// (the wrapper checks).
extern "C" int flash_fwd(int dtype, int d, const void* q, const void* k, const void* v,
                         void* out, float* lse, int BH, int Sq, int Sk, float scale,
                         int causal, int kv_len, int q_off, int kv_off, void* stream) {
  Args a{q, k, v, nullptr, nullptr, nullptr, out, nullptr, lse, BH, Sq, Sk,
         scale, causal, kv_len, q_off, kv_off};
  return dispatch(0, dtype, d, a, stream);
}

extern "C" int flash_bwd_dkv(int dtype, int d, const void* q, const void* k, const void* v,
                             const void* g, const float* lse, const float* delta, void* dk,
                             void* dv, int BH, int Sq, int Sk, float scale, int causal,
                             int kv_len, int q_off, int kv_off, void* stream) {
  Args a{q, k, v, g, lse, delta, dk, dv, nullptr, BH, Sq, Sk,
         scale, causal, kv_len, q_off, kv_off};
  return dispatch(1, dtype, d, a, stream);
}

extern "C" int flash_bwd_dq(int dtype, int d, const void* q, const void* k, const void* v,
                            const void* g, const float* lse, const float* delta, void* dq,
                            int BH, int Sq, int Sk, float scale, int causal, int kv_len,
                            int q_off, int kv_off, void* stream) {
  Args a{q, k, v, g, lse, delta, dq, nullptr, nullptr, BH, Sq, Sk,
         scale, causal, kv_len, q_off, kv_off};
  return dispatch(2, dtype, d, a, stream);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
