// 3x3 stride-1 SAME convolution in the transposed layout [N, H, C, W] for
// Hopper (sm_90a): forward (also used for the input gradient on flipped
// weights), the forward with fused BN statistics, and the fused
// weight+bias gradient.
//
// Replaces the Pallas TPU kernels of tpu_sandbox/ops/pallas_conv_t.py:
//   conv3x3_t_fwd        <- _fwd_kernel (:133), launched by _conv_call
//                           (:220/243) for conv3x3_t (:267) and its dgrad (:336)
//   conv3x3_t_fwd_stats  <- _fwd_stats_kernel (:140), the stats branch of
//                           _conv_call (:226-237) for conv3x3_t_stats (:347)
//   conv3x3_t_wgrad      <- _wgrad_kernel (:167), launched by conv3x3_t_wgrad (:293)
//
// What bounds it on the H100, at the 3000x3000 batch-5 shapes
// (N*H*W = 2,812,500 output pixels):
//   conv1 fwd   16->256 ch: 207 GFLOP, 1.53 GB   -> bytes bound 0.46 ms
//   conv2 fwd   64->128 ch: 415 GFLOP, 1.08 GB   -> operations bound 0.42 ms
//   conv2 dgrad 128->64 ch: 415 GFLOP, 1.08 GB   -> operations bound 0.42 ms
//   wgrad conv1 / conv2:    207 / 415 GFLOP      -> 0.46 / 0.42 ms
// The stats variant has the same bounds (its sums add 2 KB of output).
// Both bounds assume the bf16 tensor cores. This first version is the
// simple, right one: bf16 runs an implicit GEMM on the tensor cores
// through WMMA (mma.sync, f32 accumulation) with scalar activation loads
// and two barriers per 16-channel step, so it is bound by those loads,
// far above the bounds; fp32 runs the same tiling on the CUDA cores (FMA
// peak 67 TFLOP/s) and is the tight check against the plain version.
// wgmma, TMA and a pipelined smem ring are later work.
//
// Design (forward). Per output row (n, h) the conv is the GEMM
//   y[co, w] = b[co] + sum_{k=(dy,dx,c)} wt[co, k] * x[n, h+dy-1, c, w+dx-1]
// with K = 9C. A block owns a W tile, a CO tile and a slab of rows (one
// row for the plain forward). The K loop walks dy (3) and 16-channel
// chunks; for each it stages ONE haloed x slab [16][BW+2] (zeros outside
// the image: the H halo and the W edge are masked here, no padded copy of
// x exists) and the three dx taps' weights, and the three dx taps read
// the same slab at shifts 0/1/2, so x is read once per dy instead of once
// per tap. Accumulation is f32; the bias is added in f32 and the result
// is rounded once to the output dtype. fp32: 256 threads hold a TCO x 4
// register tile each of a 64-column, 16*TCO-channel tile. bf16: 8 warps
// hold 32x32 WMMA accumulators (see the tensor-core section).
//
// Design (stats). BN's batch statistics, sum and sum of squares per
// channel of the ROUNDED output, are an epilogue of the forward: y is
// never read back. The TPU carries them across its sequential grid in
// VMEM; here each block sums its tile over its slab of rows in registers,
// combines its threads in a fixed order and writes one partial per (slab,
// W tile); reduce_partials (reduce.cuh) adds the partials in a fixed
// order. Slabs of kStatsRows rows keep the partials small (11.5 MB at
// conv1). No float atomics: two runs are bitwise equal.
//
// Design (wgrad). dwT[co, k] = sum_{n,h,w} g[n,h,co,w] * x[n,h+dy-1,c,w+dx-1]
// and db[co] = sum g. The TPU version carries the sum across its
// sequential grid in VMEM scratch; here blocks run in parallel, so each
// block owns a 64x64 (co, k) tile and a slab of (n, h) rows and writes a
// partial sum; reduce_partials (reduce.cuh) adds the partials in a fixed
// order. No float atomics: repeated runs are bitwise equal.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "reduce.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTX = 16;          // threads along W
constexpr int kTY = 16;          // threads along CO
constexpr int kKC = 16;          // channels per K step
constexpr int kBW = 64;          // output columns per block (4 per thread)

// fp32 forward on the CUDA cores. A block walks the rows of its slab; with
// STATS each thread also sums its outputs and their squares per channel
// over the slab, and the 16 threads of a channel row combine theirs by a
// fixed shuffle tree at the end.
template <int TCO, bool STATS>
__global__ void __launch_bounds__(kThreads)
conv3x3_t_fwd_kernel(const float* __restrict__ x, const float* __restrict__ wt,
                     const float* __restrict__ bias, float* __restrict__ y,
                     float* __restrict__ part, int NH, int H, int C, int CO,
                     int W, int rows_per_slab) {
  constexpr int BCO = kTY * TCO;
  __shared__ float xs[kKC][kBW + 2];
  __shared__ float ws[3][kKC][BCO];

  const int tid = threadIdx.x;
  const int tx = tid % kTX, ty = tid / kTX;
  const int w0 = blockIdx.x * kBW;
  const int co0 = blockIdx.y * BCO;
  const int K9 = 9 * C;
  const int r_begin = blockIdx.z * rows_per_slab;
  const int r_end = min(NH, r_begin + rows_per_slab);

  float st[TCO], st2[TCO];
#pragma unroll
  for (int i = 0; i < TCO; ++i) st[i] = st2[i] = 0.f;

  for (int row = r_begin; row < r_end; ++row) {   // row = n * H + h
    const int h = row % H;
    const int n = row / H;

    float acc[TCO][4];
#pragma unroll
    for (int i = 0; i < TCO; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int dy = 0; dy < 3; ++dy) {
      const int hh = h + dy - 1;
      const bool row_ok = hh >= 0 && hh < H;
      const size_t xrow = row_ok ? (size_t)(n * H + hh) * C * W : 0;
      for (int c0 = 0; c0 < C; c0 += kKC) {
        for (int i = tid; i < kKC * (kBW + 2); i += kThreads) {
          const int c = i / (kBW + 2), j = i % (kBW + 2);
          const int cc = c0 + c, ww = w0 - 1 + j;
          float v = 0.f;
          if (row_ok && cc < C && ww >= 0 && ww < W) v = x[xrow + (size_t)cc * W + ww];
          xs[c][j] = v;
        }
        for (int i = tid; i < 3 * kKC * BCO; i += kThreads) {
          const int co = i / (3 * kKC), r = i % (3 * kKC);
          const int dx = r / kKC, c = r % kKC;
          const int cc = c0 + c, gco = co0 + co;
          float v = 0.f;
          if (cc < C && gco < CO) v = wt[(size_t)gco * K9 + (dy * 3 + dx) * C + cc];
          ws[dx][c][co] = v;
        }
        __syncthreads();
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
#pragma unroll
          for (int c = 0; c < kKC; ++c) {
            float a[TCO], b[4];
#pragma unroll
            for (int i = 0; i < TCO; ++i) a[i] = ws[dx][c][ty * TCO + i];
#pragma unroll
            for (int j = 0; j < 4; ++j) b[j] = xs[c][tx + kTX * j + dx];
#pragma unroll
            for (int i = 0; i < TCO; ++i)
#pragma unroll
              for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
          }
        }
        __syncthreads();
      }
    }

#pragma unroll
    for (int i = 0; i < TCO; ++i) {
      const int co = co0 + ty * TCO + i;
      if (co >= CO) continue;
      const float bv = bias[co];
      float* yrow = y + ((size_t)row * CO + co) * W;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int w = w0 + tx + kTX * j;
        if (w < W) {
          const float v = acc[i][j] + bv;
          yrow[w] = v;
          if (STATS) {
            st[i] += v;
            st2[i] += v * v;
          }
        }
      }
    }
  }

  if (STATS) {
    // lanes 0-15 and 16-31 of a warp are two channel rows (ty); xor
    // offsets below 16 stay inside one
#pragma unroll
    for (int i = 0; i < TCO; ++i)
#pragma unroll
      for (int off = kTX / 2; off > 0; off /= 2) {
        st[i] += __shfl_xor_sync(0xffffffffu, st[i], off);
        st2[i] += __shfl_xor_sync(0xffffffffu, st2[i], off);
      }
    float* out = part + ((size_t)blockIdx.z * gridDim.x + blockIdx.x) * 2 * CO;
#pragma unroll
    for (int i = 0; i < TCO; ++i) {
      const int co = co0 + ty * TCO + i;
      if (tx == 0 && co < CO) {
        out[co] = st[i];
        out[CO + co] = st2[i];
      }
    }
  }
}

constexpr int kWB = 32;          // reduction chunk along W (wgrad)
constexpr int kWT = 64;          // co and k tile edge (wgrad)
constexpr int kStatsRows = 8;    // rows per slab of the stats variant

// fp32 wgrad on the CUDA cores.
__global__ void __launch_bounds__(kThreads)
conv3x3_t_wgrad_kernel(const float* __restrict__ x, const float* __restrict__ g,
                       float* __restrict__ part, int NH, int H, int C, int CO,
                       int W, int rows_per_slab) {
  __shared__ float gs[kWB][kWT + 1];     // [w][co]
  __shared__ float xs[kWB][kWT + 1];     // [w][k]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int k0 = blockIdx.x * kWT;
  const int co0 = blockIdx.y * kWT;
  const int slab = blockIdx.z;
  const int K9 = 9 * C;
  const size_t M = (size_t)CO * K9 + CO;   // one slab's partial: dwT then db
  const bool db_block = blockIdx.x == 0;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  float dbacc = 0.f;

  const int r_begin = slab * rows_per_slab;
  const int r_end = min(NH, r_begin + rows_per_slab);
  for (int r = r_begin; r < r_end; ++r) {
    const int n = r / H, h = r % H;
    for (int w0 = 0; w0 < W; w0 += kWB) {
      for (int i = tid; i < kWT * kWB; i += kThreads) {
        const int co = i / kWB, wl = i % kWB;
        const int gco = co0 + co, w = w0 + wl;
        float v = 0.f;
        if (gco < CO && w < W) v = g[((size_t)r * CO + gco) * W + w];
        gs[wl][co] = v;
      }
      for (int i = tid; i < kWT * kWB; i += kThreads) {
        const int kl = i / kWB, wl = i % kWB;
        const int k = k0 + kl;
        float v = 0.f;
        if (k < K9) {
          const int tap = k / C, c = k - tap * C;
          const int hh = h + tap / 3 - 1, ww = w0 + wl + tap % 3 - 1;
          if (hh >= 0 && hh < H && ww >= 0 && ww < W)
            v = x[((size_t)(n * H + hh) * C + c) * W + ww];
        }
        xs[wl][kl] = v;
      }
      __syncthreads();
      if (db_block && tid < kWT) {
#pragma unroll 8
        for (int wl = 0; wl < kWB; ++wl) dbacc += gs[wl][tid];
      }
#pragma unroll 8
      for (int wl = 0; wl < kWB; ++wl) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = gs[wl][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = xs[wl][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  float* out = part + (size_t)slab * M;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int co = co0 + ty * 4 + i;
    if (co >= CO) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int k = k0 + tx + 16 * j;
      if (k < K9) out[(size_t)co * K9 + k] = acc[i][j];
    }
  }
  if (db_block && tid < kWT && co0 + tid < CO) out[(size_t)CO * K9 + co0 + tid] = dbacc;
}

// ---- bf16 on the tensor cores (WMMA 16x16x16, f32 accumulation) --------
//
// The same two GEMMs on mma.sync through the WMMA API, for bf16 only
// (fp32 stays on the CUDA-core kernels above, which are the tight check).
// Forward: a block owns 128 output channels and 64 columns of each row of
// its slab; its 8 warps each hold a 32x32 accumulator (2x2 fragments). Per
// (dy, 16-channel chunk) the block stages the haloed x slab once and
// builds the three dx-shifted copies in shared memory (a fragment must
// start on a 32-byte boundary, so the shift cannot be a pointer offset).

constexpr int kALd = kKC + 8;    // padded leading dims (multiples of 8)
constexpr int kCLd = kBW + 4;    // f32 epilogue tile (wgrad)

// BCO output channels x BW columns per block; 8 warps of 32x32 each
// (BCO = 128: 4x2 warps over 64 columns; BCO = 64, for the 64-channel
// input gradient of conv2: 2x4 warps over 128 columns).
template <int BCO>
struct FwdTc {
  static constexpr int WCO = BCO / 32, WW = 8 / WCO, BW = WW * 32;
  static constexpr int BLd = BW + 8, CLd = BW + 4;
  // threads per channel in the stats epilogue, and the columns each sums
  static constexpr int TPC = kThreads / BCO, CPT = BW / TPC;
  struct Smem {
    __nv_bfloat16 a[3][BCO][kALd];
    __nv_bfloat16 b[3][kKC][BLd];
    __nv_bfloat16 raw[kKC][BW + 2];
  };
  static constexpr size_t kBytes = sizeof(Smem) > sizeof(float) * BCO * CLd
                                       ? sizeof(Smem)
                                       : sizeof(float) * BCO * CLd;
};

// With STATS the epilogue leaves the rounded row tile in shared memory,
// and TPC threads per channel each add CPT of its columns (and their
// squares) to registers that run over the slab; at the end the TPC
// threads of a channel (neighbouring lanes) combine by a fixed shuffle
// tree.
template <int BCO, bool STATS>
__global__ void __launch_bounds__(kThreads)
conv3x3_t_fwd_tc_kernel(const __nv_bfloat16* __restrict__ x,
                        const __nv_bfloat16* __restrict__ wt,
                        const __nv_bfloat16* __restrict__ bias,
                        __nv_bfloat16* __restrict__ y, float* __restrict__ part,
                        int NH, int H, int C, int CO, int W, int rows_per_slab) {
  using namespace nvcuda;
  using P = FwdTc<BCO>;
  constexpr int BW = P::BW, BLd = P::BLd, CLd = P::CLd;
  __shared__ __align__(128) unsigned char smem[P::kBytes];
  typename P::Smem& s = *reinterpret_cast<typename P::Smem*>(smem);
  float* cs = reinterpret_cast<float*>(smem);    // reused after the K loop

  const int tid = threadIdx.x, warp = tid / 32;
  const int wco = warp / P::WW, wwc = warp % P::WW;   // warp's 32x32 sub-tile
  const int w0 = blockIdx.x * BW;
  const int co0 = blockIdx.y * BCO;
  const int K9 = 9 * C;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
  const int r_begin = blockIdx.z * rows_per_slab;
  const int r_end = min(NH, r_begin + rows_per_slab);
  float st = 0.f, st2 = 0.f;

  for (int row = r_begin; row < r_end; ++row) {   // row = n * H + h
    const int h = row % H, n = row / H;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

    for (int dy = 0; dy < 3; ++dy) {
      const int hh = h + dy - 1;
      const bool row_ok = hh >= 0 && hh < H;
      const size_t xrow = row_ok ? (size_t)(n * H + hh) * C * W : 0;
      for (int c0 = 0; c0 < C; c0 += kKC) {
        for (int i = tid; i < kKC * (BW + 2); i += kThreads) {
          const int c = i / (BW + 2), j = i % (BW + 2);
          const int ww = w0 - 1 + j;
          s.raw[c][j] = (row_ok && ww >= 0 && ww < W) ? x[xrow + (size_t)(c0 + c) * W + ww]
                                                      : zero;
        }
        // weights: 16 contiguous channels per (co, tap) = two 16-byte vectors
        for (int i = tid; i < 3 * BCO * 2; i += kThreads) {
          const int dx = i / (BCO * 2), r = i % (BCO * 2);
          const int co = r / 2, half = r % 2;
          const int gco = co0 + co;
          uint4 v = make_uint4(0, 0, 0, 0);
          if (gco < CO)
            v = *reinterpret_cast<const uint4*>(
                wt + (size_t)gco * K9 + (dy * 3 + dx) * C + c0 + half * 8);
          *reinterpret_cast<uint4*>(&s.a[dx][co][half * 8]) = v;
        }
        __syncthreads();
        for (int i = tid; i < 3 * kKC * BW; i += kThreads) {
          const int dx = i / (kKC * BW), r = i % (kKC * BW);
          const int c = r / BW, j = r % BW;
          s.b[dx][c][j] = s.raw[c][j + dx];
        }
        __syncthreads();
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2];
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
          for (int i = 0; i < 2; ++i)
            wmma::load_matrix_sync(fa[i], &s.a[dx][wco * 32 + i * 16][0], kALd);
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::load_matrix_sync(fb[j], &s.b[dx][0][wwc * 32 + j * 16], BLd);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
        }
        __syncthreads();
      }
    }

#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(cs + (wco * 32 + i * 16) * CLd + wwc * 32 + j * 16,
                                acc[i][j], CLd, wmma::mem_row_major);
    __syncthreads();
    for (int i = tid; i < BCO * BW; i += kThreads) {
      const int co = i / BW, j = i % BW;
      const int gco = co0 + co, w = w0 + j;
      float v = 0.f;
      if (gco < CO && w < W) {
        const __nv_bfloat16 r = __float2bfloat16_rn(cs[co * CLd + j] +
                                                    __bfloat162float(bias[gco]));
        y[((size_t)row * CO + gco) * W + w] = r;
        v = __bfloat162float(r);
      }
      if (STATS) cs[co * CLd + j] = v;
    }
    if (STATS) {
      __syncthreads();
      const float* crow = cs + (tid / P::TPC) * CLd + (tid % P::TPC) * P::CPT;
      for (int j = 0; j < P::CPT; ++j) {
        st += crow[j];
        st2 += crow[j] * crow[j];
      }
    }
    // the next row's staging overwrites the epilogue tile
    __syncthreads();
  }

  if (STATS) {
#pragma unroll
    for (int off = P::TPC / 2; off > 0; off /= 2) {
      st += __shfl_xor_sync(0xffffffffu, st, off);
      st2 += __shfl_xor_sync(0xffffffffu, st2, off);
    }
    const int gco = co0 + tid / P::TPC;
    if (tid % P::TPC == 0 && gco < CO) {
      float* out = part + ((size_t)blockIdx.z * gridDim.x + blockIdx.x) * 2 * CO;
      out[gco] = st;
      out[CO + gco] = st2;
    }
  }
}

// Wgrad on the tensor cores: the block's 64x64 (co, k) tile is 8 warps of
// 16x32; per row and 64-column chunk the block stages g [64 co][64 w] and
// the gathered taps x [64 k][64 w], and multiplies g by x^T (x read as a
// column-major B). Slabs and the fixed-order reduction as above.

constexpr int kTcWB = 64;        // reduction chunk along W
constexpr int kGLd = kTcWB + 8;

struct WgTcSmem {
  __nv_bfloat16 g[kWT][kGLd];
  __nv_bfloat16 x[kWT][kGLd];
};
constexpr size_t kWgTcBytes =
    sizeof(WgTcSmem) > sizeof(float) * kWT * kCLd ? sizeof(WgTcSmem)
                                                  : sizeof(float) * kWT * kCLd;

__global__ void __launch_bounds__(kThreads)
conv3x3_t_wgrad_tc_kernel(const __nv_bfloat16* __restrict__ x,
                          const __nv_bfloat16* __restrict__ g,
                          float* __restrict__ part, int NH, int H, int C, int CO,
                          int W, int rows_per_slab) {
  using namespace nvcuda;
  __shared__ __align__(128) unsigned char smem[kWgTcBytes];
  WgTcSmem& s = *reinterpret_cast<WgTcSmem*>(smem);
  float* cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x, warp = tid / 32;
  const int wco = warp / 2, wk = warp % 2;       // warp's 16x32 sub-tile
  const int k0 = blockIdx.x * kWT;
  const int co0 = blockIdx.y * kWT;
  const int slab = blockIdx.z;
  const int K9 = 9 * C;
  const size_t M = (size_t)CO * K9 + CO;
  const bool db_block = blockIdx.x == 0;
  const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);
  float dbacc = 0.f;

  const int r_begin = slab * rows_per_slab;
  const int r_end = min(NH, r_begin + rows_per_slab);
  for (int r = r_begin; r < r_end; ++r) {
    const int n = r / H, h = r % H;
    for (int w0 = 0; w0 < W; w0 += kTcWB) {
      for (int i = tid; i < kWT * kTcWB; i += kThreads) {
        const int co = i / kTcWB, wl = i % kTcWB;
        const int gco = co0 + co, w = w0 + wl;
        s.g[co][wl] = (gco < CO && w < W) ? g[((size_t)r * CO + gco) * W + w] : zero;
      }
      for (int i = tid; i < kWT * kTcWB; i += kThreads) {
        const int kl = i / kTcWB, wl = i % kTcWB;
        const int k = k0 + kl;
        __nv_bfloat16 v = zero;
        if (k < K9) {
          const int tap = k / C, c = k - tap * C;
          const int hh = h + tap / 3 - 1, ww = w0 + wl + tap % 3 - 1;
          if (hh >= 0 && hh < H && ww >= 0 && ww < W)
            v = x[((size_t)(n * H + hh) * C + c) * W + ww];
        }
        s.x[kl][wl] = v;
      }
      __syncthreads();
      if (db_block && tid < kWT) {
        for (int wl = 0; wl < kTcWB; ++wl) dbacc += __bfloat162float(s.g[tid][wl]);
      }
#pragma unroll
      for (int ks = 0; ks < kTcWB / 16; ++ks) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, &s.g[wco * 16][ks * 16], kGLd);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
          wmma::load_matrix_sync(fb, &s.x[wk * 32 + j * 16][ks * 16], kGLd);
          wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(cs + (wco * 16) * kCLd + wk * 32 + j * 16, acc[j], kCLd,
                            wmma::mem_row_major);
  __syncthreads();
  float* out = part + (size_t)slab * M;
  for (int i = tid; i < kWT * kWT; i += kThreads) {
    const int co = i / kWT, kl = i % kWT;
    if (co0 + co < CO && k0 + kl < K9) out[(size_t)(co0 + co) * K9 + k0 + kl] = cs[co * kCLd + kl];
  }
  if (db_block && tid < kWT && co0 + tid < CO) out[(size_t)CO * K9 + co0 + tid] = dbacc;
}

// The forward launches. ``part`` null: one row per block (grid z = N*H);
// else slabs of kStatsRows rows and one stats partial per (slab, W tile),
// added into ``sums`` [2*CO] (sum, then sum of squares).
template <bool STATS>
cudaError_t launch_fwd_f32(const float* x, const float* wt, const float* b,
                           float* y, float* part, int N, int H, int C, int CO,
                           int W, cudaStream_t st) {
  const int NH = N * H, rows = STATS ? kStatsRows : 1;
  const int slabs = (NH + rows - 1) / rows;
  const int wtiles = (W + kBW - 1) / kBW;
  if (CO > 64) {
    const dim3 grid(wtiles, (CO + 127) / 128, slabs);
    conv3x3_t_fwd_kernel<8, STATS><<<grid, kThreads, 0, st>>>(
        x, wt, b, y, part, NH, H, C, CO, W, rows);
  } else {
    const dim3 grid(wtiles, (CO + 63) / 64, slabs);
    conv3x3_t_fwd_kernel<4, STATS><<<grid, kThreads, 0, st>>>(
        x, wt, b, y, part, NH, H, C, CO, W, rows);
  }
  return cudaGetLastError();
}

template <int BCO, bool STATS>
void launch_fwd_tc(const __nv_bfloat16* x, const __nv_bfloat16* wt,
                   const __nv_bfloat16* b, __nv_bfloat16* y, float* part, int N,
                   int H, int C, int CO, int W, cudaStream_t st) {
  const int NH = N * H, rows = STATS ? kStatsRows : 1;
  constexpr int BW = FwdTc<BCO>::BW;
  const dim3 grid((W + BW - 1) / BW, (CO + BCO - 1) / BCO, (NH + rows - 1) / rows);
  conv3x3_t_fwd_tc_kernel<BCO, STATS><<<grid, kThreads, 0, st>>>(
      x, wt, b, y, part, NH, H, C, CO, W, rows);
}

template <bool STATS>
cudaError_t launch_fwd_bf16(const __nv_bfloat16* x, const __nv_bfloat16* wt,
                            const __nv_bfloat16* b, __nv_bfloat16* y,
                            float* part, int N, int H, int C, int CO, int W,
                            cudaStream_t st) {
  if (C % kKC) return cudaErrorInvalidValue;   // whole 16-channel K steps
  if (CO > 64)
    launch_fwd_tc<128, STATS>(x, wt, b, y, part, N, H, C, CO, W, st);
  else
    launch_fwd_tc<64, STATS>(x, wt, b, y, part, N, H, C, CO, W, st);
  return cudaGetLastError();
}

// W tiles of the forward's grid for this dtype and CO (the stats partials
// per slab).
int fwd_wtiles(int dtype, int CO, int W) {
  const int bw = (dtype == 1 && CO <= 64) ? FwdTc<64>::BW : kBW;
  return (W + bw - 1) / bw;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (C a multiple of 16). x [N,H,C,W],
// wt [CO, 9C] (tap-major, then c), bias [CO], y [N,H,CO,W]; all of dtype,
// contiguous.
extern "C" int conv3x3_t_fwd(int dtype, const void* x, const void* wt,
                             const void* bias, void* y, int N, int H, int C,
                             int CO, int W, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_fwd_f32<false>((const float*)x, (const float*)wt,
                                 (const float*)bias, (float*)y, nullptr, N, H,
                                 C, CO, W, st);
  if (dtype == 1)
    return launch_fwd_bf16<false>((const __nv_bfloat16*)x,
                                  (const __nv_bfloat16*)wt,
                                  (const __nv_bfloat16*)bias,
                                  (__nv_bfloat16*)y, nullptr, N, H, C, CO, W, st);
  return (int)cudaErrorInvalidValue;
}

// Rows of (n, h) per slab of conv3x3_t_fwd_stats, and its partials per
// slab: the wrapper sizes ``part`` as slabs * partials * 2 * CO floats.
extern "C" int conv3x3_t_stats_rows(void) { return kStatsRows; }
extern "C" int conv3x3_t_stats_wtiles(int dtype, int CO, int W) {
  return fwd_wtiles(dtype, CO, W);
}

// conv3x3_t_fwd plus the f32 per-channel sums of the rounded y: sums
// [2*CO] = sum over (n, h, w) of y, then of y*y. part f32 [slabs *
// wtiles, 2*CO] scratch, slabs = ceil(N*H / conv3x3_t_stats_rows()).
extern "C" int conv3x3_t_fwd_stats(int dtype, const void* x, const void* wt,
                                   const void* bias, void* y, void* part,
                                   void* sums, int N, int H, int C, int CO,
                                   int W, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (dtype == 0)
    err = launch_fwd_f32<true>((const float*)x, (const float*)wt,
                               (const float*)bias, (float*)y, (float*)part, N,
                               H, C, CO, W, st);
  else if (dtype == 1)
    err = launch_fwd_bf16<true>((const __nv_bfloat16*)x, (const __nv_bfloat16*)wt,
                                (const __nv_bfloat16*)bias, (__nv_bfloat16*)y,
                                (float*)part, N, H, C, CO, W, st);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  const int slabs = (N * H + kStatsRows - 1) / kStatsRows;
  return (int)reduce_partials((const float*)part, (float*)sums,
                              slabs * fwd_wtiles(dtype, CO, W), 2 * CO, st);
}

// x [N,H,C,W], g [N,H,CO,W] of dtype; part f32 [slabs, CO*9C + CO]
// (scratch); out f32 [CO*9C + CO] = dwT [CO, 9C] followed by db [CO].
extern "C" int conv3x3_t_wgrad(int dtype, const void* x, const void* g,
                               void* part, void* out, int N, int H, int C,
                               int CO, int W, int slabs, int rows_per_slab,
                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid((9 * C + kWT - 1) / kWT, (CO + kWT - 1) / kWT, slabs);
  if (dtype == 0)
    conv3x3_t_wgrad_kernel<<<grid, kThreads, 0, st>>>(
        (const float*)x, (const float*)g, (float*)part, N * H, H, C, CO, W,
        rows_per_slab);
  else if (dtype == 1)
    conv3x3_t_wgrad_tc_kernel<<<grid, kThreads, 0, st>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)g, (float*)part, N * H, H,
        C, CO, W, rows_per_slab);
  else
    return (int)cudaErrorInvalidValue;
  return (int)reduce_partials((const float*)part, (float*)out, slabs,
                              CO * 9 * C + CO, st);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
