// Flash attention for Hopper (sm_90a): the online-softmax forward and the
// two backward kernels, on [B*H, S, D] tensors (heads folded into the
// batch, S padded by the caller, D in {32, 64, 128}), with global position
// offsets for queries and keys, the key-length mask and the causal mask.
//
// Replaces the Pallas TPU kernels of tpu_sandbox/ops/pallas_attention.py:
//   flash_fwd      <- _fwd_kernel (:70), launched by _flash_fwd (pallas_call
//                     at :166): out and lse [B*H, S] f32
//   flash_bwd_dkv  <- _bwd_dkv_kernel (:199), launched by _flash_bwd
//                     (pallas_call at :361): dk, dv, kv-major
//   flash_bwd_dq   <- _bwd_dq_kernel (:262), launched by _flash_bwd
//                     (pallas_call at :379): dq, q-major
// Every output is in the input dtype or, as _flash_fwd's and _flash_bwd's
// out_dtype allow, float32 for bfloat16 inputs (flash_attention_lse's
// partials are float32).
//
// What bounds them on the H100, at the LM's shapes (B 16, H 8, S 2048,
// D 128, causal, bf16; P = B*H*S*(S+1)/2 visible pairs): operations. The
// forward's two products are 4*P*D = 1.37e11 FLOP, 0.139 ms at 989 TFLOP/s
// bf16, against 0.27 GB of q, k, v and out (0.08 ms at 3.35 TB/s). The
// bf16 backward runs every product on the tensor cores, each of the three
// with an f32 operand as two: dk/dv 12*P*D FLOP (0.417 ms), dq 8*P*D
// (0.278 ms), against about 0.41 GB each (0.12 ms).
//
// float32 inputs (flash_fwd_kernel, flash_bwd_dkv_kernel,
// flash_bwd_dq_kernel) run every product on the CUDA cores in f32: a block
// owns one 64-row tile of its loop-invariant side (q rows for the forward
// and dq, key rows for dk/dv) in shared memory and walks the other side in
// 64-row tiles, skipping tiles wholly past kv_len and, with causal, wholly
// above the block diagonal (the Pallas kernels' should_run predicate);
// each thread owns a 4 x D/16 accumulator tile. They are the tight check
// against the plain version.
//
// bfloat16 inputs run on warpgroup MMA (wgmma.cuh):
// - Layout. A tile is whole rows (16-byte aligned, D*2 bytes) stored as
//   128-byte swizzled halves of 64 columns; D 32 runs on 64 with zero lanes.
// - Blocks. Two warpgroups of 64 rows of the block's side (128 q rows for
//   the forward and dq, 128 keys for dk/dv), one block an SM. Masks only
//   on tiles that cross the diagonal or kv_len; a warpgroup skips the
//   tiles it cannot see, a block those neither warpgroup sees. The longest
//   causal blocks start first.
// - Forward (flash_fwd_tc_kernel). k and v come in tiles of kN = 128 keys
//   by tensor map (TMA, one thread issues them, zeros past S and past D)
//   into a 3-stage ring, one tile ahead, with a full and an empty barrier
//   (mbarrier) a stage instead of a block barrier a tile. S = Q.K^T is a
//   chain of m64n128k16 wgmmas into registers (Q and K from shared
//   memory). The online softmax runs in the accumulator registers: s *
//   scale * log2(e) minus the running max is one fma, p = exp2 of it on the
//   special function unit; the row max combines the four threads of a row
//   by shuffles, while l stays a per-thread partial of the unrounded f32 p
//   (as _fwd_kernel's l, :118), summed over the four threads once at the
//   end. p is rounded once to bf16 (p in v's dtype, :120) and is the
//   register A operand of O += P.V, V read MN-major; the f32 O accumulator
//   (DP/2 registers a thread) is rescaled by alpha in registers, and not at
//   all when no row's max moved. Step t issues S_t and then P_{t-1}.V_{t-1},
//   so the softmax of tile t runs beside that product. out = O / max(l,
//   1e-30) in the output type (bf16, or f32 for flash_attention_lse's
//   partials), lse = m ln 2 + log(max(l, 1e-30)), or NEG + log(max(l,
//   1e-30)) where the row has seen no visible key (a ring hop wholly in its
//   future writes out 0 and lse NEG + log(1e-30), the Pallas kernel's
//   values). A masked score is -2^100 before scaling, whose scaled value is
//   exact, so a row that has seen only masked keys gets p = 1 from them, as
//   the Pallas kernel's mask filler gives. What bounds it now: the two warpgroups run their softmax at the
//   same time, so the tensor cores idle then (ping-pong scheduling of the
//   warpgroups by named barriers measured slower, as a warpgroup alone
//   issues its chain of products at well under the card's rate).
// - Backward products. q.k^T and do.v^T have bf16 operands, whose products
//   f32 holds exactly: bf16 wgmma, f32 accumulation. p^T.do, ds^T.q and
//   ds.k have one f32 operand x (p or ds, as the Pallas kernels compute
//   them) and one bf16 operand y. x is split into hi = bf16(x) and lo =
//   bf16(x - hi), and hi.y + lo.y run as two bf16 wgmmas into one f32
//   accumulator, hi then lo at each 16-wide k-step. |x - hi - lo| <= 2^-18
//   |x| and y is exact, so each term is within about 2^-17 of its f32 value
//   (TF32 would be 2^-11, one bf16 rounding of p or ds 2^-9).
// - Backward registers hold p and ds. dk/dv computes S^T = K.Q^T and dP^T =
//   V.dO^T with the block's keys as M, so p^T and ds^T come out in
//   accumulator registers, whose hi/lo pairs are the A operands of dv +=
//   P^T.dO and dk += dS^T.Q; lse and delta index the columns. dq computes
//   S = Q.K^T and dP = dO.V^T with q rows as M, and dS is the A operand of
//   dq += dS.K. The walked side's tiles are B from shared memory, K-major
//   for the scores and MN-major (transposed) for the gradients. No score
//   tile goes through shared memory.
// - Each backward warpgroup issues its two score products (S and dP), and
//   then its two gradient products (dk/dv), as two chains of dependent
//   k-steps in turn. The backward's walked side (q, do, lse and delta for
//   dk/dv; k and v for dq) streams through a cp.async ring, two 64-row
//   tiles ahead of the one in use, with one block barrier a tile; dq's
//   ring has a fourth stage, so that a tile's dS.K product runs on while
//   the next tile starts. Registers at D 128 (ptxas): dk/dv 254 a thread,
//   dq 212, no spills.
// No atomics anywhere: every sum runs in a fixed order, so two runs are
// bitwise equal.
// Not yet done: TMA and a producer warp with setmaxnreg in the backward,
// and overlap of one warpgroup's softmax (exp, split) with the other's
// products. The backward's score products read both operands from shared
// memory (4 KB a k-step), which holds them near the shared-memory rate.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma.cuh"
#include "wgmma.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;   // 8 warps; thread (ty, tx) = (tid / 16, tid % 16)
constexpr int kB = 64;          // rows of a q tile and of a kv tile
constexpr int kSLd = kB + 4;    // leading dim of the f32 [64, 64] score tiles
constexpr int kPLd = kB + 8;    // leading dim of the forward's p tile
constexpr float kNeg = -1e30f;  // the mask filler, pallas_common.NEG

// leading dim of a [64, D] f32 tile in shared memory: an odd stride, so
// that walks down a column (k^T on the CUDA cores) hit distinct banks
template <int D> struct Ld { static constexpr int v = D + 1; };

__host__ __device__ constexpr size_t align128(size_t b) { return (b + 127) / 128 * 128; }

template <int D>
constexpr size_t tile_bytes() { return align128(sizeof(float) * kB * Ld<D>::v); }
constexpr size_t kScoreBytes = align128(sizeof(float) * kB * kSLd);
constexpr size_t kRowBytes = align128(sizeof(float) * kB);

// the float32 forward
template <int D>
constexpr size_t fwd_bytes() {
  return 3 * tile_bytes<D>() + kScoreBytes + align128(sizeof(float) * kB * kPLd) +
         2 * kRowBytes;
}

// the float32 backward
template <int D>
constexpr size_t bwd_bytes() {
  return 4 * tile_bytes<D>() + 2 * kScoreBytes + 2 * kRowBytes;
}

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

// rows [r0, r0 + 64) of a [S, D] f32 matrix (row stride D) into a shared
// tile with leading dim Ld<D>; rows at or past S are zero
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* __restrict__ src, int r0,
                                          int S) {
  constexpr int LD = Ld<D>::v, VPR = D / 4;
  for (int i = threadIdx.x; i < kB * VPR; i += kThreads) {
    const int r = i / VPR, c = (i % VPR) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r0 + r < S) val = __ldg(reinterpret_cast<const float4*>(src + (size_t)(r0 + r) * D + c));
    float* d = dst + r * LD + c;
    d[0] = val.x;
    d[1] = val.y;
    d[2] = val.z;
    d[3] = val.w;
  }
}

// rows [r0, r0 + 64) of a per-row f32 vector; zero at or past S
__device__ __forceinline__ void load_vec(float* dst, const float* __restrict__ src, int r0,
                                         int S) {
  for (int i = threadIdx.x; i < kB; i += kThreads) dst[i] = r0 + i < S ? src[r0 + i] : 0.f;
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

// the [64, 64] product x.y^T of two [64, D] f32 tiles into the shared f32
// tile s, on the CUDA cores
template <int D>
__device__ __forceinline__ void scores(float* s, const float* x, const float* y) {
  constexpr int LD = Ld<D>::v;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  float acc[4][kB / 16] = {};
  fma_tile<kB, D>(acc, [&](int m, int k) { return x[m * LD + k]; },
                  [&](int k, int n) { return y[n * LD + k]; });
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kB / 16; ++j) s[(ty * 4 + i) * kSLd + tx + 16 * j] = acc[i][j];
}

// number of TN-key tiles that q rows up to local row q_last visit: up to
// kv_len and, with causal, up to the last tile whose first key they may see
template <int TN = kB>
__device__ __forceinline__ int kv_tiles(int q_last, int Sk, int causal, int kv_len, int q_off,
                                        int kv_off) {
  int n = (min(kv_len, Sk) + TN - 1) / TN;
  if (causal) {
    const int last = q_off + q_last - kv_off;          // last visible local key
    n = last < 0 ? 0 : min(n, last / TN + 1);
  }
  return n;
}

// the first 64-row q tile that sees some key from local key k0 on: with
// causal the first whose last row reaches k0; n_q (none) past kv_len
__device__ __forceinline__ int first_q_tile(int k0, int n_q, int causal, int kv_len, int q_off,
                                            int kv_off) {
  if (k0 >= kv_len) return n_q;
  const int t = kv_off + k0 - q_off + 1;               // rows needed: (i+1)*kB >= t
  return causal && t > 0 ? min(n_q, (t + kB - 1) / kB - 1) : 0;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ out, float* __restrict__ lse,
                 int Sq, int Sk, float scale, int causal, int kv_len, int q_off, int kv_off) {
  constexpr int LD = Ld<D>::v;
  extern __shared__ __align__(128) unsigned char smem[];
  Carve cv{smem};
  float* qs = cv.take<float>(kB * LD);
  float* ks = cv.take<float>(kB * LD);
  float* vs = cv.take<float>(kB * LD);
  float* ss = cv.take<float>(kB * kSLd);
  float* ps = cv.take<float>(kB * kPLd);
  float* alpha_s = cv.take<float>(kB);
  float* l_s = cv.take<float>(kB);

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kB;     // the longest causal rows first
  const size_t bh = blockIdx.y;
  q += bh * Sq * D;
  k += bh * Sk * D;
  v += bh * Sk * D;
  out += bh * Sq * D;
  lse += bh * Sq;

  load_rows<D>(qs, q, q0, Sq);
  float oacc[4][D / 16] = {};

  // softmax rows: thread (row, part) owns the row's columns part + 4*c
  const int row = tid / 4, part = tid % 4;
  const int qpos = q_off + q0 + row;
  float m_run = kNeg, l_run = 0.f;
  const int n_kv = kv_tiles(q0 + kB - 1, Sk, causal, kv_len, q_off, kv_off);
  for (int j = 0; j < n_kv; ++j) {
    __syncthreads();                                    // k, v, p free again
    load_rows<D>(ks, k, j * kB, Sk);
    load_rows<D>(vs, v, j * kB, Sk);
    __syncthreads();
    scores<D>(ss, qs, ks);
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
      ps[row * kPLd + part + 4 * c] = p;
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    const float alpha = expf(m_run - m_new);
    l_run = alpha * l_run + psum;
    m_run = m_new;
    if (part == 0) alpha_s[row] = alpha;
    __syncthreads();
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = alpha_s[ty * 4 + i];
#pragma unroll
      for (int jj = 0; jj < D / 16; ++jj) oacc[i][jj] *= a;
    }
    fma_tile<D, kB>(oacc, [&](int m, int kk) { return ps[m * kPLd + kk]; },
                    [&](int kk, int n) { return vs[kk * LD + n]; });
  }

  const float l = fmaxf(l_run, 1e-30f);
  if (part == 0) {
    l_s[row] = l;
    if (q0 + row < Sq) lse[q0 + row] = m_run + logf(l);
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (q0 + r < Sq)
#pragma unroll
      for (int jj = 0; jj < D / 16; ++jj)
        out[(size_t)(q0 + r) * D + tx + 16 * jj] = oacc[i][jj] / l_s[r];
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

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ g,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     float* __restrict__ dk, float* __restrict__ dv, int Sq, int Sk, float scale,
                     int causal, int kv_len, int q_off, int kv_off) {
  using T = float;
  constexpr int LD = Ld<D>::v;
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

  load_rows<D>(ks, k, k0, Sk);
  load_rows<D>(vs, v, k0, Sk);
  float dk_acc[4][D / 16] = {}, dv_acc[4][D / 16] = {};

  const int n_q = (Sq + kB - 1) / kB;
  for (int i = first_q_tile(k0, n_q, causal, kv_len, q_off, kv_off); i < n_q; ++i) {
    const int q0 = i * kB;
    __syncthreads();
    load_rows<D>(qs, q, q0, Sq);
    load_rows<D>(gs, g, q0, Sq);
    load_vec(lse_s, lse, q0, Sq);
    load_vec(delta_s, delta, q0, Sq);
    __syncthreads();
    scores<D>(ss, qs, ks);                           // q.k^T
    scores<D>(dps, gs, vs);                          // do.v^T
    __syncthreads();
    p_and_ds<true>(ss, dps, lse_s, delta_s, q0, k0, scale, causal, kv_len, q_off, kv_off);
    __syncthreads();
    fma_tile<D, kB>(dv_acc, [&](int m, int kk) { return ss[kk * kSLd + m]; },
                    [&](int kk, int n) { return gs[kk * LD + n]; });          // p^T.do
    fma_tile<D, kB>(dk_acc, [&](int m, int kk) { return dps[kk * kSLd + m]; },
                    [&](int kk, int n) { return qs[kk * LD + n]; });          // ds^T.q
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = k0 + ty * 4 + i;
    if (r < Sk)
#pragma unroll
      for (int jj = 0; jj < D / 16; ++jj) {
        dk[(size_t)r * D + tx + 16 * jj] = dk_acc[i][jj];
        dv[(size_t)r * D + tx + 16 * jj] = dv_acc[i][jj];
      }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v, const float* __restrict__ g,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    float* __restrict__ dq, int Sq, int Sk, float scale, int causal, int kv_len,
                    int q_off, int kv_off) {
  using T = float;
  constexpr int LD = Ld<D>::v;
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

  load_rows<D>(qs, q, q0, Sq);
  load_rows<D>(gs, g, q0, Sq);
  load_vec(lse_s, lse, q0, Sq);
  load_vec(delta_s, delta, q0, Sq);
  float dq_acc[4][D / 16] = {};
  const int n_kv = kv_tiles(q0 + kB - 1, Sk, causal, kv_len, q_off, kv_off);
  for (int j = 0; j < n_kv; ++j) {
    __syncthreads();
    load_rows<D>(ks, k, j * kB, Sk);
    load_rows<D>(vs, v, j * kB, Sk);
    __syncthreads();
    scores<D>(ss, qs, ks);
    scores<D>(dps, gs, vs);
    __syncthreads();
    p_and_ds<false>(ss, dps, lse_s, delta_s, q0, j * kB, scale, causal, kv_len, q_off, kv_off);
    __syncthreads();
    fma_tile<D, kB>(dq_acc, [&](int m, int kk) { return dps[m * kSLd + kk]; },
                    [&](int kk, int n) { return ks[kk * LD + n]; });          // ds.k
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = q0 + ty * 4 + i;
    if (r < Sq)
#pragma unroll
      for (int jj = 0; jj < D / 16; ++jj) dq[(size_t)r * D + tx + 16 * jj] = dq_acc[i][jj];
  }
}

// ---- bfloat16 on wgmma ---------------------------------------------------

constexpr int kWG = 2;                   // warpgroups a block, 64 rows each
constexpr int kTcThreads = 128 * kWG;
constexpr int kAhead = 2;                // walked-side tiles in flight ahead of the one in use
constexpr int kDkvStages = kAhead + 1;   // ring stages; dq's has one more, as a tile's last
constexpr int kDqStages = kAhead + 2;    // product still reads it while the next tile starts
// the forward's kv tiles: 128 keys, three stages (the tile of the scores,
// the tile of the P.V product, the tile in flight)
constexpr int kN = 128;
constexpr int kFwdStages = 3;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
// the forward's masked score, before scaling: a power of two, so that its
// product with scale * log2(e) is exact and a row that has seen only masked
// keys gets p = exp2(0) = 1 from them (the mask filler's effect in the
// Pallas kernel) rather than the rounding error of a huge product
constexpr float kMaskRaw = -0x1p100f;

// the bf16 kernels' head width: D 32 runs on 64 with zero lanes
template <int D> struct Dp { static constexpr int v = D < 64 ? 64 : D; };

template <int D>
__host__ __device__ constexpr size_t tile_sw_bytes(int rows) { return (size_t)rows * Dp<D>::v * 2; }

// shared memory: 1024 bytes to align the base, the block's two tiles, the
// ring's tiles and (dk/dv) after them each stage's lse and delta, so that
// every tile stays 1024-byte aligned
template <int D>
constexpr size_t dkv_tc_bytes() {
  return 1024 + 2 * tile_sw_bytes<D>(64 * kWG) +
         kDkvStages * (2 * tile_sw_bytes<D>(kB) + 2 * kB * 4);
}

template <int D>
constexpr size_t fwd_tc_bytes() {
  return 1024 + tile_sw_bytes<D>(64 * kWG) + kFwdStages * 2 * tile_sw_bytes<D>(kN) +
         2 * kFwdStages * 8;                          // and each stage's two barriers
}

template <int D>
constexpr size_t dq_tc_bytes() {
  return 1024 + 2 * tile_sw_bytes<D>(64 * kWG) + kDqStages * 2 * tile_sw_bytes<D>(kB);
}

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// rows [r0, r0 + R) of a [S, D] bf16 matrix into an R-row swizzled tile at
// dst (1024-byte aligned): column half h at dst + h * R * 128, row r at
// + r * 128, its 16-byte chunk c at chunk c ^ (r % 8). Rows at or past S
// and columns at or past D are zero. Asynchronous: the caller commits.
template <int R, int D>
__device__ __forceinline__ void load_sw(unsigned char* dst, const bf16* __restrict__ src, int r0,
                                        int S) {
  constexpr int CPR = Dp<D>::v / 8;                     // 16-byte chunks a row
  for (int i = threadIdx.x; i < R * CPR; i += kTcThreads) {
    const int r = i / CPR, c = i % CPR;
    const bool ok = r0 + r < S && c * 8 < D;
    cp_async16(dst + (c / 8) * (R * 128) + r * 128 + (((c % 8) ^ (r % 8)) << 4),
               ok ? src + (size_t)(r0 + r) * D + c * 8 : src, ok ? 16 : 0);
  }
}

// entries [r0, r0 + 64) of a per-row f32 vector, zero at or past S
__device__ __forceinline__ void load_vec_async(float* dst, const float* __restrict__ src, int r0,
                                               int S) {
  const int i = threadIdx.x;
  if (i < kB) cp_async4(dst + i, r0 + i < S ? src + r0 + i : src, r0 + i < S ? 4 : 0);
}

// descriptor of k-step kk of an R-row swizzled tile read K-major from row r0
template <int R>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int r0, int kk) {
  return gmma_desc(tile + (kk / 4) * (R * 128) + r0 * 128 + (kk % 4) * 32, 16, 1024);
}

// descriptor of k-step kk (rows 16kk ..) of a 64-row swizzled tile read
// MN-major (its columns the N of the product)
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return gmma_desc(tile + kk * 16 * 128, kB * 128, 1024);
}

// a[64 x 64] = X Y^T and b[64 x 64] = U V^T over DP columns: X, U rows r0 ..
// of RX-row tiles, Y, V 64-row tiles. The two chains of dependent k-steps
// are issued in turn, so each wgmma has the other chain's to hide behind;
// committed as one group.
template <int RX, int DP>
__device__ __forceinline__ void wg_scores(float (&a)[32], float (&b)[32], uint32_t x, uint32_t u,
                                          int r0, uint32_t y, uint32_t v) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk) {
    wgmma_ss_n64(a, desc_k<RX>(x, r0, kk), desc_k<kB>(y, 0, kk), kk > 0);
    wgmma_ss_n64(b, desc_k<RX>(u, r0, kk), desc_k<kB>(v, 0, kk), kk > 0);
  }
  wg_commit();
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 h) {
  return *reinterpret_cast<uint32_t*>(&h);
}

// X (64 x 64 f32, accumulator layout) as the A fragments of its 4 k-steps,
// hi = bf16(X) and lo = bf16(X - hi): |X - hi - lo| <= 2^-18 |X|
__device__ __forceinline__ void split(const float (&x)[32], uint32_t (&hi)[4][4],
                                      uint32_t (&lo)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float x0 = x[8 * kk + 2 * r], x1 = x[8 * kk + 2 * r + 1];
      const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
      const float2 hf = __bfloat1622float2(h);
      hi[kk][r] = bf16x2_bits(h);
      lo[kk][r] = bf16x2_bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
    }
}

// acc[64 x DP] += X[64 x 64] Y[64 x DP] for X split into hi and lo and Y
// the 64-row tile y (MN-major): two bf16 wgmmas a k-step, hi then lo, into
// the same accumulator; not committed
template <int DP>
__device__ __forceinline__ void wg_split_step(float (&acc)[DP / 2], const uint32_t (&hi)[4],
                                              const uint32_t (&lo)[4], uint64_t y) {
  if constexpr (DP == 128) {
    wgmma_rs_n128(acc, hi, y);
    wgmma_rs_n128(acc, lo, y);
  } else {
    wgmma_rs_n64(acc, hi, y);
    wgmma_rs_n64(acc, lo, y);
  }
}

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

// rows r0 + 16 w + g (+ 8) of an accumulator of DP columns into a [S, D]
// matrix, columns below D, rows below S
template <int D, typename OutT>
__device__ __forceinline__ void store_acc(OutT* __restrict__ out, const float (&acc)[Dp<D>::v / 2],
                                          int r0, int S) {
  const int lane = threadIdx.x % 32, w = (threadIdx.x / 32) % 4;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = r0 + 16 * w + lane / 4 + 8 * h;
    if (r < S)
#pragma unroll
      for (int j = 0; j < Dp<D>::v / 8; ++j) {
        const int c = 8 * j + 2 * (lane % 4);
        if (c < D) store2(out + (size_t)r * D + c, acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
      }
  }
}

// dk, dv for 128 keys a block: warpgroup wg owns keys k0 + 64 wg .. and
// walks the q tiles that see any key of the block
template <int D, typename OutT>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ g,
                        const float* __restrict__ lse, const float* __restrict__ delta,
                        OutT* __restrict__ dk, OutT* __restrict__ dv, int Sq, int Sk, float scale,
                        int causal, int kv_len, int q_off, int kv_off) {
  constexpr int DP = Dp<D>::v, KR = 64 * kWG;
  constexpr int TILE = (int)tile_sw_bytes<D>(kB), STAGE = 2 * TILE;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* ks = align1024(smem_raw);
  unsigned char* vs = ks + tile_sw_bytes<D>(KR);
  unsigned char* ring = vs + tile_sw_bytes<D>(KR);
  float* vecs = reinterpret_cast<float*>(ring + kDkvStages * STAGE);   // a stage's lse, delta

  const int tid = threadIdx.x, wg = tid / 128, w = (tid / 32) % 4, lane = tid % 32;
  const int k0 = blockIdx.x * KR;                       // the longest causal columns first
  const size_t bh = blockIdx.y;
  q += bh * Sq * D;
  g += bh * Sq * D;
  k += bh * Sk * D;
  v += bh * Sk * D;
  dk += bh * Sk * D;
  dv += bh * Sk * D;
  lse += bh * Sq;
  delta += bh * Sq;

  const int n_q = (Sq + kB - 1) / kB;
  const int i0 = first_q_tile(k0, n_q, causal, kv_len, q_off, kv_off);
  auto load_stage = [&](int i) {
    const int slot = (i - i0) % kDkvStages;
    load_sw<kB, D>(ring + slot * STAGE, q, i * kB, Sq);
    load_sw<kB, D>(ring + slot * STAGE + TILE, g, i * kB, Sq);
    load_vec_async(vecs + slot * 2 * kB, lse, i * kB, Sq);
    load_vec_async(vecs + slot * 2 * kB + kB, delta, i * kB, Sq);
  };
  load_sw<KR, D>(ks, k, k0, Sk);
  load_sw<KR, D>(vs, v, k0, Sk);
#pragma unroll
  for (int s = 0; s < kAhead; ++s) {
    if (i0 + s < n_q) load_stage(i0 + s);
    cp_async_commit();
  }

  float dk_acc[DP / 2], dv_acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
  const int kw0 = k0 + 64 * wg;                         // this warpgroup's first key
  const float sl = scale * kLog2e;
  const uint32_t ks_a = smem_u32(ks), vs_a = smem_u32(vs);
  for (int i = i0; i < n_q; ++i) {
    cp_async_wait<kAhead - 1>();
    fence_proxy_async();                                // cp.async writes -> wgmma reads
    __syncthreads();                                    // tile i landed; tile i-1's stage free
    if (i + kAhead < n_q) load_stage(i + kAhead);
    cp_async_commit();
    const int q0 = i * kB;
    if (kw0 >= kv_len || (causal && q_off + q0 + kB - 1 < kv_off + kw0)) continue;
    const bool full = kw0 + kB <= kv_len && (!causal || q_off + q0 >= kv_off + kw0 + kB - 1);
    const int slot = (i - i0) % kDkvStages;
    const uint32_t qs_a = smem_u32(ring + slot * STAGE), gs_a = qs_a + TILE;
    const float* lse_s = vecs + slot * 2 * kB;
    const float* delta_s = lse_s + kB;

    float s[32], dp[32];
    wg_fence();
    wg_scores<KR, DP>(s, dp, ks_a, vs_a, 64 * wg, qs_a, gs_a);   // S^T = K.Q^T, dP^T = V.dO^T
    wg_wait<0>();
    fence_regs(s);
    fence_regs(dp);
#pragma unroll
    for (int e = 0; e < 32; ++e) {                      // p^T, ds^T: rows keys, columns q rows
      const int col = 8 * (e / 4) + 2 * (lane % 4) + (e & 1);
      float p = exp2f(fmaf(s[e], sl, -lse_s[col] * kLog2e));
      if (!full) {
        const int key = kw0 + 16 * w + lane / 4 + 8 * ((e >> 1) & 1);
        if (key >= kv_len || (causal && q_off + q0 + col < kv_off + key)) p = 0.f;
      }
      s[e] = p;
      dp[e] = p * (dp[e] - delta_s[col]) * scale;
    }
    uint32_t phi[4][4], plo[4][4], dhi[4][4], dlo[4][4];
    split(s, phi, plo);
    split(dp, dhi, dlo);
    fence_regs(dv_acc);
    fence_regs(dk_acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {                    // the two chains in turn:
      wg_split_step<DP>(dv_acc, phi[kk], plo[kk], desc_mn(gs_a, kk));   // dV += P^T.dO
      wg_split_step<DP>(dk_acc, dhi[kk], dlo[kk], desc_mn(qs_a, kk));   // dK += dS^T.Q
    }
    wg_commit();
    wg_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
  }
  cp_async_wait<0>();
  store_acc<D>(dk, dk_acc, kw0, Sk);
  store_acc<D>(dv, dv_acc, kw0, Sk);
}

// dq for 128 q rows a block: warpgroup wg owns rows q0 + 64 wg .. and walks
// the kv tiles that the block's rows see
template <int D, typename OutT>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ g,
                       const float* __restrict__ lse, const float* __restrict__ delta,
                       OutT* __restrict__ dq, int Sq, int Sk, float scale, int causal, int kv_len,
                       int q_off, int kv_off) {
  constexpr int DP = Dp<D>::v, QR = 64 * kWG;
  constexpr int TILE = (int)tile_sw_bytes<D>(kB), STAGE = 2 * TILE;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* qs = align1024(smem_raw);
  unsigned char* gs = qs + tile_sw_bytes<D>(QR);
  unsigned char* ring = gs + tile_sw_bytes<D>(QR);

  const int tid = threadIdx.x, wg = tid / 128, w = (tid / 32) % 4, lane = tid % 32;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * QR;     // the longest causal rows first
  const size_t bh = blockIdx.y;
  q += bh * Sq * D;
  g += bh * Sq * D;
  dq += bh * Sq * D;
  k += bh * Sk * D;
  v += bh * Sk * D;
  lse += bh * Sq;
  delta += bh * Sq;

  const int n_kv = kv_tiles(q0 + QR - 1, Sk, causal, kv_len, q_off, kv_off);
  auto load_stage = [&](int j) {
    unsigned char* st = ring + (j % kDqStages) * STAGE;
    load_sw<kB, D>(st, k, j * kB, Sk);
    load_sw<kB, D>(st + TILE, v, j * kB, Sk);
  };
  load_sw<QR, D>(qs, q, q0, Sq);
  load_sw<QR, D>(gs, g, q0, Sq);
#pragma unroll
  for (int s = 0; s < kAhead; ++s) {
    if (s < n_kv) load_stage(s);
    cp_async_commit();
  }

  const int qw0 = q0 + 64 * wg;                         // this warpgroup's first row
  float lse2[2], dl[2];                                 // of rows qw0 + 16 w + lane / 4 (+ 8)
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = qw0 + 16 * w + lane / 4 + 8 * h;
    lse2[h] = r < Sq ? lse[r] * kLog2e : 0.f;
    dl[h] = r < Sq ? delta[r] : 0.f;
  }
  float dq_acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq_acc[i] = 0.f;
  const float sl = scale * kLog2e;
  const uint32_t qs_a = smem_u32(qs), gs_a = smem_u32(gs);
  uint32_t hi[4][4], lo[4][4];                          // dS of the product in flight
  for (int j = 0; j < n_kv; ++j) {
    cp_async_wait<kAhead - 1>();
    fence_proxy_async();
    __syncthreads();                                    // tile j landed; tile j-2's stage free
    if (j + kAhead < n_kv) load_stage(j + kAhead);
    cp_async_commit();
    const int c0 = j * kB;                              // the tile's first key
    if (c0 >= kv_len || (causal && q_off + qw0 + kB - 1 < kv_off + c0)) {
      wg_wait<0>();                                     // tile j-1's product ends here
      continue;
    }
    const bool full = c0 + kB <= kv_len && (!causal || q_off + qw0 >= kv_off + c0 + kB - 1);
    const uint32_t ks_a = smem_u32(ring + (j % kDqStages) * STAGE), vs_a = ks_a + TILE;

    float s[32], dp[32];
    wg_fence();
    wg_scores<QR, DP>(s, dp, qs_a, gs_a, 64 * wg, ks_a, vs_a);   // S = Q.K^T, dP = dO.V^T
    wg_wait<0>();                                       // and tile j-1's dQ product
    fence_regs(s);
    fence_regs(dp);
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int h = (e >> 1) & 1;
      float p = exp2f(fmaf(s[e], sl, -lse2[h]));
      if (!full) {
        const int key = c0 + 8 * (e / 4) + 2 * (lane % 4) + (e & 1);
        const int row = qw0 + 16 * w + lane / 4 + 8 * h;
        if (key >= kv_len || (causal && q_off + row < kv_off + key)) p = 0.f;
      }
      dp[e] = p * (dp[e] - dl[h]) * scale;
    }
    split(dp, hi, lo);
    fence_regs(dq_acc);
    wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wg_split_step<DP>(dq_acc, hi[kk], lo[kk], desc_mn(ks_a, kk));      // dQ += dS.K
    wg_commit();                                        // waited for with the next tile's S, dP
  }
  wg_wait<0>();
  fence_regs(dq_acc);
  cp_async_wait<0>();
  store_acc<D>(dq, dq_acc, qw0, Sq);
}

// 2^x on the special function unit (relative error about 2^-22; results
// below 2^-126 flush to zero)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the forward for 128 q rows a block: warpgroup wg owns rows q0 + 64 wg ..
// and walks the kN-key tiles that its rows see. k and v tiles arrive by
// tensor map into a ring of kFwdStages stages, one tile ahead, issued by
// thread 0: a stage's full barrier completes when its bytes have landed,
// its empty barrier when all 256 threads are done with it. No block barrier
// in the loop. Step t issues S_t = Q.K_t^T and then O += P_{t-1}.V_{t-1},
// so the softmax of tile t runs beside the warpgroup's own P.V product.
template <int D, typename OutT>
__global__ void __launch_bounds__(kTcThreads, 1)
flash_fwd_tc_kernel(const __grid_constant__ CUtensorMap tmk, const __grid_constant__ CUtensorMap tmv,
                    const bf16* __restrict__ q, OutT* __restrict__ out, float* __restrict__ lse,
                    int Sq, int Sk, float scale, int causal, int kv_len, int q_off, int kv_off) {
  constexpr int DP = Dp<D>::v, QR = 64 * kWG;
  constexpr int TILE = (int)tile_sw_bytes<D>(kN), STAGE = 2 * TILE;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* qs = align1024(smem_raw);
  unsigned char* ring = qs + tile_sw_bytes<D>(QR);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kFwdStages * STAGE);
  uint64_t* empty = full + kFwdStages;

  const int tid = threadIdx.x, wg = tid / 128, w = (tid / 32) % 4, lane = tid % 32;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * QR;     // the longest causal rows first
  const int bh = blockIdx.y;
  q += (size_t)bh * Sq * D;
  out += (size_t)bh * Sq * D;
  lse += (size_t)bh * Sq;

  const int qw0 = q0 + 64 * wg;                         // this warpgroup's first row
  const int n_kv = kv_tiles<kN>(q0 + QR - 1, Sk, causal, kv_len, q_off, kv_off);
  const int n_wg = kv_tiles<kN>(qw0 + 63, Sk, causal, kv_len, q_off, kv_off);
  auto load_stage = [&](int j) {                        // thread 0: tile j's k and v
    unsigned char* st = ring + (j % kFwdStages) * STAGE;
    uint64_t* bar = full + j % kFwdStages;
    mbar_expect_tx(bar, STAGE);
#pragma unroll
    for (int h = 0; h < DP / 64; ++h) {                 // 64-column halves
      tma_load_3d(st + h * kN * 128, &tmk, 64 * h, j * kN, bh, bar);
      tma_load_3d(st + TILE + h * kN * 128, &tmv, 64 * h, j * kN, bh, bar);
    }
  };
  if (tid == 0) {
    for (int i = 0; i < kFwdStages; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, kTcThreads);
    }
    mbar_fence_init();
  }
  load_sw<QR, D>(qs, q, q0, Sq);
  cp_async_commit();
  cp_async_wait<0>();
  fence_proxy_async();                                  // cp.async writes -> wgmma reads
  __syncthreads();                                      // Q landed; the barriers set up
  if (tid == 0 && n_kv > 0) load_stage(0);

  const float sl = scale * kLog2e;
  // rows qw0 + 16 w + lane / 4 + 8 h: the running max in the exp2 domain,
  // and this thread's part of the running sum (its 32 columns of a tile)
  float m2[2] = {kMaskRaw * sl, kMaskRaw * sl}, l[2] = {0.f, 0.f};
  float o[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
  float s[kN / 2];                                      // S_t, then P_t in f32
  uint32_t pa[kN / 16][4];                              // P_{t-1}, rounded to bf16
  const uint32_t qs_a = smem_u32(qs);
  for (int t = 0; t <= n_kv; ++t) {
    // thread 0 refills the stage of tile t-2 (every thread was done with it
    // by the end of step t-1) with tile t+1
    if (tid == 0 && t + 1 < n_kv) {
      const int j = t + 1;
      if (j >= kFwdStages) mbar_wait(empty + j % kFwdStages, (j / kFwdStages - 1) & 1);
      load_stage(j);
    }
    const bool has_s = t < n_wg, has_pv = t >= 1 && t - 1 < n_wg;
    if (has_s) mbar_wait(full + t % kFwdStages, (t / kFwdStages) & 1);
    const uint32_t ks_a = smem_u32(ring + (t % kFwdStages) * STAGE);
    const uint32_t vs_a = smem_u32(ring + ((t + kFwdStages - 1) % kFwdStages) * STAGE) + TILE;
    wg_fence();
    if (has_s) {
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)              // S_t = Q.K_t^T
        wgmma_ss_n128(s, desc_k<QR>(qs_a, 64 * wg, kk), desc_k<kN>(ks_a, 0, kk), kk > 0);
      wg_commit();
    }
    if (has_pv) {
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk) {            // O += P_{t-1}.V_{t-1}
        const uint64_t dv = gmma_desc(vs_a + kk * 16 * 128, kN * 128, 1024);
        if constexpr (DP == 128)
          wgmma_rs_n128(o, pa[kk], dv);
        else
          wgmma_rs_n64(o, pa[kk], dv);
      }
      wg_commit();
    }
    float alpha[2] = {1.f, 1.f};
    if (has_s) {
      if (has_pv)
        wg_wait<1>();                                   // S_t; the O product runs on
      else
        wg_wait<0>();
      fence_regs(s);
      const int c0 = t * kN;                            // the tile's first key
      const bool full_tile = c0 + kN <= kv_len && (!causal || q_off + qw0 >= kv_off + c0 + kN - 1);
      if (!full_tile) {                                 // the tiles on the diagonal or kv_len
        const int key0 = c0 + 2 * (lane % 4), row0 = q_off + qw0 + 16 * w + lane / 4 - kv_off;
#pragma unroll
        for (int e = 0; e < kN / 2; ++e) {
          const int key = key0 + 8 * (e / 4) + (e & 1);
          if (key >= kv_len || (causal && row0 + 8 * ((e >> 1) & 1) < key)) s[e] = kMaskRaw;
        }
      }
      // x = s * scale * log2(e) is taken by one fma with the max subtracted;
      // sl > 0, so the max of x is the max of s times sl
      float mx[2] = {kMaskRaw, kMaskRaw};
#pragma unroll
      for (int e = 0; e < kN / 2; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], s[e]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 1));
        mx[h] = fmaxf(mx[h], __shfl_xor_sync(0xffffffffu, mx[h], 2));
        const float m_new = fmaxf(m2[h], mx[h] * sl);
        alpha[h] = ex2(m2[h] - m_new);
        m2[h] = m_new;
        l[h] *= alpha[h];
      }
#pragma unroll
      for (int e = 0; e < kN / 2; ++e) {
        const float p = ex2(fmaf(s[e], sl, -m2[(e >> 1) & 1]));
        l[(e >> 1) & 1] += p;                           // l sums the unrounded p
        s[e] = p;
      }
    }
    wg_wait<0>();                                       // P_{t-1}.V_{t-1}
    fence_regs(o);
    if (t >= 1 && t - 1 < n_kv) mbar_arrive(empty + (t - 1) % kFwdStages);   // tile t-1 done
    if (has_s) {
      if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f))
#pragma unroll
        for (int i = 0; i < DP / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
      for (int kk = 0; kk < kN / 16; ++kk)              // p in v's dtype, rounded once
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = bf16x2_bits(__floats2bfloat162_rn(s[8 * kk + 2 * r], s[8 * kk + 2 * r + 1]));
    }
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
    l[h] = fmaxf(l[h], 1e-30f);
  }
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) o[i] /= l[(i >> 1) & 1];
  store_acc<D>(out, o, qw0, Sq);
  // a row that has seen no visible key (a causal ring hop wholly in its
  // future, or only masked keys) keeps the initial max: its lse is the mask
  // filler's, kNeg + log(l), as _fwd_kernel's m = NEG gives (:84-91), not
  // the scaled kMaskRaw, so that every kernel and the plain version agree.
  // Each branch is a whole expression, so that the other rows' lse compiles
  // to the same arithmetic as without the branch (a select of m alone
  // before one add rounds it otherwise)
  if (lane % 4 == 0)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = qw0 + 16 * w + lane / 4 + 8 * h;
      if (r < Sq)
        lse[r] = m2[h] == kMaskRaw * sl ? kNeg + logf(l[h]) : m2[h] * kLn2 + logf(l[h]);
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

template <typename K>
cudaError_t launch_setup(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// the float32 kernels: which 0 the forward, 1 dk/dv, 2 dq
template <int D>
cudaError_t run(int which, const Args& a, cudaStream_t st) {
  const size_t bytes = which == 0 ? fwd_bytes<D>() : bwd_bytes<D>();
  cudaError_t e;
  if (which == 0) {
    e = launch_setup(flash_fwd_kernel<D>, bytes);
    if (e != cudaSuccess) return e;
    flash_fwd_kernel<D><<<dim3((a.Sq + kB - 1) / kB, a.BH), kThreads, bytes, st>>>(
        (const float*)a.q, (const float*)a.k, (const float*)a.v, (float*)a.o0, a.lse_out, a.Sq,
        a.Sk, a.scale, a.causal, a.kv_len, a.q_off, a.kv_off);
  } else if (which == 1) {
    e = launch_setup(flash_bwd_dkv_kernel<D>, bytes);
    if (e != cudaSuccess) return e;
    flash_bwd_dkv_kernel<D><<<dim3((a.Sk + kB - 1) / kB, a.BH), kThreads, bytes, st>>>(
        (const float*)a.q, (const float*)a.k, (const float*)a.v, (const float*)a.g,
        (const float*)a.lse_in, (const float*)a.delta, (float*)a.o0, (float*)a.o1, a.Sq, a.Sk,
        a.scale, a.causal, a.kv_len, a.q_off, a.kv_off);
  } else {
    e = launch_setup(flash_bwd_dq_kernel<D>, bytes);
    if (e != cudaSuccess) return e;
    flash_bwd_dq_kernel<D><<<dim3((a.Sq + kB - 1) / kB, a.BH), kThreads, bytes, st>>>(
        (const float*)a.q, (const float*)a.k, (const float*)a.v, (const float*)a.g,
        (const float*)a.lse_in, (const float*)a.delta, (float*)a.o0, a.Sq, a.Sk, a.scale,
        a.causal, a.kv_len, a.q_off, a.kv_off);
  }
  return cudaGetLastError();
}

// A tensor map of a [BH, S, d] bf16 tensor (d 32, 64 or 128) in boxes of
// 64 columns x kN rows of one (batch, head), 128-byte swizzled as wgmma
// reads them; columns past d and rows past S load as zeros.
cudaError_t kv_tensor_map(CUtensorMap* map, const void* base, int d, int S, int BH) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                              const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                              const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult res;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &res) !=
            cudaSuccess ||
        res != cudaDriverEntryPointSuccess || fn == nullptr)
      return cudaErrorNotSupported;
    encode = reinterpret_cast<Encode>(fn);
  }
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)S, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)S * d * 2};
  const cuuint32_t box[3] = {64, kN, 1}, elem[3] = {1, 1, 1};
  const CUresult r = encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(base),
                            dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// the bfloat16 kernels, outputs in OutT: which 0 the forward, 1 dk/dv, 2 dq
template <int D, typename OutT>
cudaError_t run_tc(int which, const Args& a, cudaStream_t st) {
  constexpr int rows = 64 * kWG;
  cudaError_t e;
  if (which == 0) {
    constexpr size_t bytes = fwd_tc_bytes<D>();
    CUtensorMap tmk, tmv;
    e = kv_tensor_map(&tmk, a.k, D, a.Sk, a.BH);
    if (e == cudaSuccess) e = kv_tensor_map(&tmv, a.v, D, a.Sk, a.BH);
    if (e == cudaSuccess) e = launch_setup(flash_fwd_tc_kernel<D, OutT>, bytes);
    if (e != cudaSuccess) return e;
    flash_fwd_tc_kernel<D, OutT><<<dim3((a.Sq + rows - 1) / rows, a.BH), kTcThreads, bytes,
                                   st>>>(tmk, tmv, (const bf16*)a.q, (OutT*)a.o0, a.lse_out,
                                         a.Sq, a.Sk, a.scale, a.causal, a.kv_len, a.q_off,
                                         a.kv_off);
  } else if (which == 1) {
    constexpr size_t bytes = dkv_tc_bytes<D>();
    e = launch_setup(flash_bwd_dkv_tc_kernel<D, OutT>, bytes);
    if (e != cudaSuccess) return e;
    flash_bwd_dkv_tc_kernel<D, OutT><<<dim3((a.Sk + rows - 1) / rows, a.BH), kTcThreads, bytes,
                                       st>>>(
        (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v, (const bf16*)a.g,
        (const float*)a.lse_in, (const float*)a.delta, (OutT*)a.o0, (OutT*)a.o1, a.Sq, a.Sk,
        a.scale, a.causal, a.kv_len, a.q_off, a.kv_off);
  } else {
    constexpr size_t bytes = dq_tc_bytes<D>();
    e = launch_setup(flash_bwd_dq_tc_kernel<D, OutT>, bytes);
    if (e != cudaSuccess) return e;
    flash_bwd_dq_tc_kernel<D, OutT><<<dim3((a.Sq + rows - 1) / rows, a.BH), kTcThreads, bytes,
                                      st>>>(
        (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v, (const bf16*)a.g,
        (const float*)a.lse_in, (const float*)a.delta, (OutT*)a.o0, a.Sq, a.Sk, a.scale,
        a.causal, a.kv_len, a.q_off, a.kv_off);
  }
  return cudaGetLastError();
}

// dtype, out_dtype: 0 float32, 1 bfloat16; bfloat16 inputs run on wgmma
// and write either, float32 inputs write float32
int dispatch(int which, int dtype, int out_dtype, int d, const Args& a, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (a.BH < 1 || a.BH > 65535 || a.Sq < 1 || a.Sk < 1 || (d != 32 && d != 64 && d != 128))
    return (int)cudaErrorInvalidValue;
  if (dtype == 1 && out_dtype == 1)
    return (int)(d == 32 ? run_tc<32, bf16>(which, a, st)
                 : d == 64 ? run_tc<64, bf16>(which, a, st)
                           : run_tc<128, bf16>(which, a, st));
  if (dtype == 1 && out_dtype == 0)
    return (int)(d == 32 ? run_tc<32, float>(which, a, st)
                 : d == 64 ? run_tc<64, float>(which, a, st)
                           : run_tc<128, float>(which, a, st));
  if (dtype == 0 && out_dtype == 0)
    return (int)(d == 32 ? run<32>(which, a, st)
                 : d == 64 ? run<64>(which, a, st)
                           : run<128>(which, a, st));
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16, of q, k, v and do; out_dtype: that of
// the outputs (out, dk, dv, dq), dtype or (for bfloat16 inputs) 0; d: the
// head width, 32, 64 or 128; q, do, out, dq [BH, Sq, d]; k, v, dk, dv [BH,
// Sk, d]; lse, delta [BH, Sq] float32. Every pointer 16-byte aligned (the
// wrapper checks).
extern "C" int flash_fwd(int dtype, int out_dtype, int d, const void* q, const void* k,
                         const void* v, void* out, float* lse, int BH, int Sq, int Sk,
                         float scale, int causal, int kv_len, int q_off, int kv_off,
                         void* stream) {
  Args a{q, k, v, nullptr, nullptr, nullptr, out, nullptr, lse, BH, Sq, Sk,
         scale, causal, kv_len, q_off, kv_off};
  return dispatch(0, dtype, out_dtype, d, a, stream);
}

extern "C" int flash_bwd_dkv(int dtype, int out_dtype, int d, const void* q, const void* k,
                             const void* v, const void* g, const float* lse, const float* delta,
                             void* dk, void* dv, int BH, int Sq, int Sk, float scale, int causal,
                             int kv_len, int q_off, int kv_off, void* stream) {
  Args a{q, k, v, g, lse, delta, dk, dv, nullptr, BH, Sq, Sk,
         scale, causal, kv_len, q_off, kv_off};
  return dispatch(1, dtype, out_dtype, d, a, stream);
}

extern "C" int flash_bwd_dq(int dtype, int out_dtype, int d, const void* q, const void* k,
                            const void* v, const void* g, const float* lse, const float* delta,
                            void* dq, int BH, int Sq, int Sk, float scale, int causal, int kv_len,
                            int q_off, int kv_off, void* stream) {
  Args a{q, k, v, g, lse, delta, dq, nullptr, nullptr, BH, Sq, Sk,
         scale, causal, kv_len, q_off, kv_off};
  return dispatch(2, dtype, out_dtype, d, a, stream);
}

// registers a thread and local memory bytes a thread (spills included) of
// the loaded bfloat16-input wgmma kernel at D 128: which 0 the forward, 1
// dk/dv, 2 dq; out_dtype 0 float32, 1 bfloat16
extern "C" int flash_tc_attrs(int which, int out_dtype, int* regs, int* local_bytes) {
  cudaFuncAttributes fa;
  cudaError_t e = cudaErrorInvalidValue;
  const bool bo = out_dtype == 1;
  if (out_dtype != 0 && out_dtype != 1)
    e = cudaErrorInvalidValue;
  else if (which == 0)
    e = bo ? cudaFuncGetAttributes(&fa, flash_fwd_tc_kernel<128, bf16>)
           : cudaFuncGetAttributes(&fa, flash_fwd_tc_kernel<128, float>);
  else if (which == 1)
    e = bo ? cudaFuncGetAttributes(&fa, flash_bwd_dkv_tc_kernel<128, bf16>)
           : cudaFuncGetAttributes(&fa, flash_bwd_dkv_tc_kernel<128, float>);
  else if (which == 2)
    e = bo ? cudaFuncGetAttributes(&fa, flash_bwd_dq_tc_kernel<128, bf16>)
           : cudaFuncGetAttributes(&fa, flash_bwd_dq_tc_kernel<128, float>);
  if (e != cudaSuccess) return (int)e;
  *regs = fa.numRegs;
  *local_bytes = (int)fa.localSizeBytes;
  return 0;
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
