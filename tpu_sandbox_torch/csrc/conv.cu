// 3x3 stride-1 SAME convolution in the NHWC layout [N, H, W, C] for Hopper
// (sm_90a): forward (also used for the input gradient on flipped weights),
// the forward with fused BN statistics, and the fused weight+bias gradient.
//
// Replaces the Pallas TPU kernels of tpu_sandbox/ops/pallas_conv.py:
//   conv3x3_fwd        <- _fwd_kernel (:135), launched by _conv_call (:217)
//                         for conv3x3 (:241) and its dgrad (:259)
//   conv3x3_fwd_stats  <- _fwd_stats_kernel (:142), the stats branch of
//                         _conv_call (:200-211) for conv3x3_stats (:290)
//   conv3x3_wgrad      <- _wgrad_kernel (:170), launched by _conv_vjp_bwd (:263)
//
// What bounds it on the H100, at the 3000x3000 batch-5 shapes (N*H*W =
// 2,812,500 output pixels), each input read once and each output written
// once, the products on the bf16 tensor cores:
//   conv1 fwd   16->256 ch: 207 GFLOP, 1.53 GB   -> bytes bound 0.46 ms
//   conv2 fwd   64->128 ch: 415 GFLOP, 1.08 GB   -> operations bound 0.42 ms
//   conv2 dgrad 128->64 ch: 415 GFLOP, 1.08 GB   -> operations bound 0.42 ms
//   wgrad conv1 / conv2:    207 / 415 GFLOP      -> 0.46 / 0.42 ms
// The stats variant has the forward's bounds (its sums add 2 KB).
//
// Design (forward). Per output row (n, h) the conv is the implicit GEMM
//   y[w, co] = b[co] + sum_{k=(dy,dx,c)} x[n, h+dy-1, w+dx-1, c] * wm[k, co]
// with M = the row's pixels, K = 9C and N = CO; wm is w [3,3,C,CO] read as
// [9C, CO], JAX's (dy, dx, C) row order. NHWC keeps a pixel's channels
// contiguous, so a block stages, per 16-channel chunk, the 3-row x
// (BW+2)-pixel halo strip of those channels in shared memory with 16-byte
// loads (32 bytes a pixel; zeros outside the image, which is SAME's
// padding at all four edges: no padded copy of x exists). The tap tile of
// (dy, dx) is the strip row dy shifted by dx pixels: a pointer offset,
// never a copy, and never an im2col tensor in device memory. bf16 runs on
// the tensor cores (WMMA, mma.sync, f32 accumulation): 8 warps of 32
// pixels x 32 channels, A from the strip, B straight from wm (it is small
// and stays in L1/L2). fp32 runs the same tiling on the CUDA cores (FMA
// peak 67 TFLOP/s) and is the tight check against the plain version. The
// bias is added in f32 and the result rounded once.
//
// Design (stats). BN's sum and sum of squares per channel of the ROUNDED
// output are an epilogue of the forward: y is never read back. Each block
// walks a slab of kStatsRows rows, sums its tile's rounded outputs in
// registers, combines its threads in a fixed order and writes one partial
// per (slab, W tile); reduce_partials (reduce.cuh) adds the partials in a
// fixed order. No float atomics: two runs are bitwise equal.
//
// Design (wgrad). dw[k=(dy,dx,c), co] = sum_{n,h,w} x[n,h+dy-1,w+dx-1,c] *
// g[n,h,w,co] and db[co] = sum g. The TPU carries the sum across its
// sequential grid in VMEM; here a block owns a 16-channel chunk (all nine
// taps) and a 128-channel co tile over a slab of (n, h) rows and writes a
// partial; reduce_partials adds the partials in a fixed order. bf16: per
// row and 64-pixel chunk the block stages the halo strip and g's [64 pixel,
// 128 co] tile; each warp owns 16 co and all nine taps (nine accumulators)
// and contracts over the pixels with the strip read as a column-major A.
// fp32: 64x64 (k, co) tiles on the CUDA cores.
//
// This is the simple, right version: no cp.async or TMA pipeline, no
// wgmma, one barrier pair per 16-channel chunk. Those are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "reduce.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kKC = 16;          // channels per staged chunk
constexpr int kStatsRows = 8;    // rows per slab of the stats variant

// ---- fp32 on the CUDA cores ---------------------------------------------

constexpr int kTX = 16;          // threads along W
constexpr int kTY = 16;          // threads along CO
constexpr int kBW = 64;          // output pixels per block (4 per thread)

// A block owns kBW pixels of each row of its slab (one row without STATS)
// and 16*TCO output channels; thread (tx, ty) holds pixels tx + 16j and
// channels ty*TCO + i. With STATS each thread sums its outputs and their
// squares per channel over the slab, and the 16 threads of a channel row
// combine theirs by a fixed shuffle tree at the end.
template <int TCO, bool STATS>
__global__ void __launch_bounds__(kThreads)
conv3x3_fwd_kernel(const float* __restrict__ x, const float* __restrict__ wm,
                   const float* __restrict__ bias, float* __restrict__ y,
                   float* __restrict__ part, int NH, int H, int W, int C, int CO,
                   int rows_per_slab) {
  constexpr int BCO = kTY * TCO;
  __shared__ float xs[kBW + 2][kKC + 1];   // [pixel][channel]
  __shared__ float ws[3][kKC][BCO];        // [dx][channel][co]

  const int tid = threadIdx.x;
  const int tx = tid % kTX, ty = tid / kTX;
  const int w0 = blockIdx.x * kBW;
  const int co0 = blockIdx.y * BCO;
  const int r_begin = blockIdx.z * rows_per_slab;
  const int r_end = min(NH, r_begin + rows_per_slab);

  float st[TCO], st2[TCO];
#pragma unroll
  for (int i = 0; i < TCO; ++i) st[i] = st2[i] = 0.f;

  for (int row = r_begin; row < r_end; ++row) {   // row = n * H + h
    const int h = row % H, n = row / H;
    float acc[TCO][4];
#pragma unroll
    for (int i = 0; i < TCO; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

    for (int dy = 0; dy < 3; ++dy) {
      const int hh = h + dy - 1;
      const bool row_ok = hh >= 0 && hh < H;
      const size_t xrow = row_ok ? (size_t)(n * H + hh) * W * C : 0;
      for (int c0 = 0; c0 < C; c0 += kKC) {
        for (int i = tid; i < (kBW + 2) * kKC; i += kThreads) {
          const int j = i / kKC, c = i % kKC;
          const int cc = c0 + c, ww = w0 - 1 + j;
          float v = 0.f;
          if (row_ok && cc < C && ww >= 0 && ww < W) v = x[xrow + (size_t)ww * C + cc];
          xs[j][c] = v;
        }
        for (int i = tid; i < 3 * kKC * BCO; i += kThreads) {
          const int dx = i / (kKC * BCO), r = i % (kKC * BCO);
          const int c = r / BCO, co = r % BCO;
          const int cc = c0 + c, gco = co0 + co;
          float v = 0.f;
          if (cc < C && gco < CO) v = wm[((size_t)(dy * 3 + dx) * C + cc) * CO + gco];
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
            for (int j = 0; j < 4; ++j) b[j] = xs[tx + kTX * j + dx][c];
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
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int w = w0 + tx + kTX * j;
        if (w < W) {
          const float v = acc[i][j] + bv;
          y[((size_t)row * W + w) * CO + co] = v;
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

constexpr int kWB = 32;          // pixels per chunk (fp32 wgrad)
constexpr int kWT = 64;          // k and co tile edge (fp32 wgrad)

// fp32 wgrad on the CUDA cores: a block owns a 64x64 (k, co) tile of dw
// [9C, CO] and a slab of rows; per row and 32-pixel chunk it stages g
// [pixel][co] and the gathered taps x [pixel][k]. Block x == 0 also sums
// db over its co tile.
__global__ void __launch_bounds__(kThreads)
conv3x3_wgrad_kernel(const float* __restrict__ x, const float* __restrict__ g,
                     float* __restrict__ part, int NH, int H, int W, int C,
                     int CO, int rows_per_slab) {
  __shared__ float gs[kWB][kWT + 1];     // [pixel][co]
  __shared__ float xs[kWB][kWT + 1];     // [pixel][k]

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int k0 = blockIdx.x * kWT;
  const int co0 = blockIdx.y * kWT;
  const int slab = blockIdx.z;
  const int K9 = 9 * C;
  const size_t M = (size_t)K9 * CO + CO;   // one slab's partial: dw then db
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
        const int wl = i / kWT, co = i % kWT;
        const int gco = co0 + co, w = w0 + wl;
        float v = 0.f;
        if (gco < CO && w < W) v = g[((size_t)r * W + w) * CO + gco];
        gs[wl][co] = v;
      }
      for (int i = tid; i < kWT * kWB; i += kThreads) {
        const int wl = i / kWT, kl = i % kWT;
        const int k = k0 + kl;
        float v = 0.f;
        if (k < K9) {
          const int tap = k / C, c = k - tap * C;
          const int hh = h + tap / 3 - 1, ww = w0 + wl + tap % 3 - 1;
          if (hh >= 0 && hh < H && ww >= 0 && ww < W)
            v = x[((size_t)(n * H + hh) * W + ww) * C + c];
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
        for (int i = 0; i < 4; ++i) a[i] = xs[wl][ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = gs[wl][tx + 16 * j];
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
    const int k = k0 + ty * 4 + i;
    if (k >= K9) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int co = co0 + tx + 16 * j;
      if (co < CO) out[(size_t)k * CO + co] = acc[i][j];
    }
  }
  if (db_block && tid < kWT && co0 + tid < CO) out[(size_t)K9 * CO + co0 + tid] = dbacc;
}

// ---- bf16 on the tensor cores (WMMA 16x16x16, f32 accumulation) --------

// The halo strip of one 16-channel chunk: rows h-1..h+1 of image n, pixels
// w0-1 .. w0+BW, 32 bytes a pixel (two 16-byte loads), zero outside the
// image. s[dy][j][c] holds pixel w0-1+j; a row of 16 bf16 is 32 bytes, so
// every pixel of the strip starts on a WMMA-aligned (256-bit) address.
template <int BW>
__device__ __forceinline__ void stage_strip(const bf16* __restrict__ x, bf16 (*s)[BW + 2][kKC],
                                            int n, int h, int H, int W, int C, int w0,
                                            int c0) {
  for (int i = threadIdx.x; i < 3 * (BW + 2) * 2; i += kThreads) {
    const int dy = i / ((BW + 2) * 2), r = i % ((BW + 2) * 2);
    const int j = r / 2, half = r % 2;
    const int hh = h + dy - 1, ww = w0 - 1 + j;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (hh >= 0 && hh < H && ww >= 0 && ww < W)
      v = *reinterpret_cast<const uint4*>(x + ((size_t)(n * H + hh) * W + ww) * C + c0 +
                                          half * 8);
    *reinterpret_cast<uint4*>(&s[dy][j][half * 8]) = v;
  }
}

// Forward tiling: BCO output channels x BW pixels per block, 8 warps of
// 32x32 (BCO = 128: 2 pixel warps x 4 channel warps over 64 pixels; BCO =
// 64, for the 64-channel input gradient of conv2: 4 x 2 over 128 pixels).
template <int BCO>
struct FwdTc {
  static constexpr int WCO = BCO / 32, WP = 8 / WCO, BW = WP * 32;
  static constexpr int CLd = BCO + 4;                 // f32 epilogue tile
  static constexpr int TPC = kThreads / BCO;          // stats threads a channel
  static constexpr size_t kStrip = sizeof(bf16) * 3 * (BW + 2) * kKC;
  static constexpr size_t kTile = sizeof(float) * BW * CLd;
  static constexpr size_t kBytes = kStrip > kTile ? kStrip : kTile;
};

// With STATS the epilogue leaves the rounded tile in shared memory, and
// TPC threads per channel each add BW/TPC of its pixels (and their
// squares) to registers that run over the slab; at the end the TPC
// threads of a channel combine in a fixed order through shared memory.
template <int BCO, bool STATS>
__global__ void __launch_bounds__(kThreads)
conv3x3_fwd_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wm,
                      const bf16* __restrict__ bias, bf16* __restrict__ y,
                      float* __restrict__ part, int NH, int H, int W, int C, int CO,
                      int rows_per_slab) {
  using namespace nvcuda;
  using P = FwdTc<BCO>;
  constexpr int BW = P::BW, CLd = P::CLd;
  __shared__ __align__(128) unsigned char smem[P::kBytes];
  auto strip = reinterpret_cast<bf16(*)[BW + 2][kKC]>(smem);
  float* cs = reinterpret_cast<float*>(smem);    // reused after the K loop

  const int tid = threadIdx.x, warp = tid / 32;
  const int wco = warp % P::WCO, wp = warp / P::WCO;   // warp's 32x32 sub-tile
  const int w0 = blockIdx.x * BW;
  const int co0 = blockIdx.y * BCO;
  const int r_begin = blockIdx.z * rows_per_slab;
  const int r_end = min(NH, r_begin + rows_per_slab);
  // a 16-wide column group of wm is whole or absent: CO is a multiple of 16
  bool col_ok[2];
#pragma unroll
  for (int j = 0; j < 2; ++j) col_ok[j] = co0 + wco * 32 + j * 16 < CO;
  float st = 0.f, st2 = 0.f;

  for (int row = r_begin; row < r_end; ++row) {   // row = n * H + h
    const int h = row % H, n = row / H;
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);

    for (int c0 = 0; c0 < C; c0 += kKC) {
      stage_strip<BW>(x, strip, n, h, H, W, C, w0, c0);
      __syncthreads();
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap % 3;
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[2];
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[2];
#pragma unroll
        for (int i = 0; i < 2; ++i)
          wmma::load_matrix_sync(fa[i], &strip[dy][wp * 32 + i * 16 + dx][0], kKC);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          if (!col_ok[j]) continue;
          wmma::load_matrix_sync(
              fb[j], wm + ((size_t)tap * C + c0) * CO + co0 + wco * 32 + j * 16, CO);
#pragma unroll
          for (int i = 0; i < 2; ++i) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
        }
      }
      __syncthreads();
    }

#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(cs + (wp * 32 + i * 16) * CLd + wco * 32 + j * 16, acc[i][j],
                                CLd, wmma::mem_row_major);
    __syncthreads();
    // 8 channels (16 bytes of y) a thread and step; neighbouring threads on
    // neighbouring channels of one pixel
    for (int i = tid; i < BW * BCO / 8; i += kThreads) {
      const int p = i / (BCO / 8), cg = (i % (BCO / 8)) * 8;
      const int w = w0 + p, co = co0 + cg;
      const bool ok = w < W && co < CO;
      __align__(16) bf16 out[8];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        float v = 0.f;
        if (ok) {
          out[k] = __float2bfloat16_rn(cs[p * CLd + cg + k] + __bfloat162float(bias[co + k]));
          v = __bfloat162float(out[k]);
        }
        if (STATS) cs[p * CLd + cg + k] = v;
      }
      if (ok) *reinterpret_cast<uint4*>(y + ((size_t)row * W + w) * CO + co) =
          *reinterpret_cast<const uint4*>(out);
    }
    if (STATS) {
      __syncthreads();
      const int ch = tid % BCO, q = tid / BCO;
      for (int p = q * (BW / P::TPC); p < (q + 1) * (BW / P::TPC); ++p) {
        const float v = cs[p * CLd + ch];
        st += v;
        st2 += v * v;
      }
    }
    // the next row's staging overwrites the epilogue tile
    __syncthreads();
  }

  if (STATS) {
    cs[tid] = st;
    cs[kThreads + tid] = st2;
    __syncthreads();
    const int gco = co0 + tid;
    if (tid < BCO && gco < CO) {
      float s = 0.f, s2 = 0.f;
      for (int q = 0; q < P::TPC; ++q) {
        s += cs[q * BCO + tid];
        s2 += cs[kThreads + q * BCO + tid];
      }
      float* out = part + ((size_t)blockIdx.z * gridDim.x + blockIdx.x) * 2 * CO;
      out[gco] = s;
      out[CO + gco] = s2;
    }
  }
}

// Wgrad on the tensor cores. A block owns one 16-channel chunk c0 (all
// nine taps: 144 rows of dw) and kWgCO output channels over a slab of
// rows; warp w owns channels co0 + 16w and holds the nine taps' 16x16
// accumulators. Per row and kWgBW-pixel chunk the block stages the halo
// strip and g's [pixel][co] tile; per 16-pixel step each warp loads its g
// fragment once and multiplies the nine tap fragments (the strip read as
// a column-major [channel][pixel] A) into it. Block x == 0 also sums db.
constexpr int kWgBW = 64;        // pixels per chunk
constexpr int kWgCO = 128;       // output channels per block (16 a warp)
constexpr int kWgGLd = kWgCO + 8;

struct WgTcSmem {
  bf16 strip[3][kWgBW + 2][kKC];
  bf16 g[kWgBW][kWgGLd];
};

__global__ void __launch_bounds__(kThreads)
conv3x3_wgrad_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                        float* __restrict__ part, int NH, int H, int W, int C, int CO,
                        int rows_per_slab) {
  using namespace nvcuda;
  __shared__ __align__(128) WgTcSmem s;

  const int tid = threadIdx.x, warp = tid / 32;
  const int c0 = blockIdx.x * kKC;
  const int co0 = blockIdx.y * kWgCO;
  const int cw = co0 + warp * 16;                // this warp's channels
  const bool warp_ok = cw < CO;                  // CO is a multiple of 16
  const int slab = blockIdx.z;
  const size_t M = (size_t)9 * C * CO + CO;
  const bool db_block = blockIdx.x == 0;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[9];
#pragma unroll
  for (int t = 0; t < 9; ++t) wmma::fill_fragment(acc[t], 0.f);
  float dbacc = 0.f;

  const int r_begin = slab * rows_per_slab;
  const int r_end = min(NH, r_begin + rows_per_slab);
  for (int r = r_begin; r < r_end; ++r) {
    const int n = r / H, h = r % H;
    for (int w0 = 0; w0 < W; w0 += kWgBW) {
      stage_strip<kWgBW>(x, s.strip, n, h, H, W, C, w0, c0);
      for (int i = tid; i < kWgBW * kWgCO / 8; i += kThreads) {
        const int p = i / (kWgCO / 8), cg = (i % (kWgCO / 8)) * 8;
        const int w = w0 + p, co = co0 + cg;
        uint4 v = make_uint4(0, 0, 0, 0);
        if (w < W && co < CO)
          v = *reinterpret_cast<const uint4*>(g + ((size_t)r * W + w) * CO + co);
        *reinterpret_cast<uint4*>(&s.g[p][cg]) = v;
      }
      __syncthreads();
      if (db_block && tid < kWgCO) {
        for (int p = 0; p < kWgBW; ++p) dbacc += __bfloat162float(s.g[p][tid]);
      }
      if (warp_ok) {
#pragma unroll
        for (int ks = 0; ks < kWgBW / 16; ++ks) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb;
          wmma::load_matrix_sync(fb, &s.g[ks * 16][warp * 16], kWgGLd);
#pragma unroll
          for (int t = 0; t < 9; ++t) {
            wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major> fa;
            wmma::load_matrix_sync(fa, &s.strip[t / 3][ks * 16 + t % 3][0], kKC);
            wmma::mma_sync(acc[t], fa, fb, acc[t]);
          }
        }
      }
      __syncthreads();
    }
  }

  float* out = part + (size_t)slab * M;
  if (warp_ok) {
#pragma unroll
    for (int t = 0; t < 9; ++t)
      wmma::store_matrix_sync(out + ((size_t)t * C + c0) * CO + cw, acc[t], CO,
                              wmma::mem_row_major);
  }
  if (db_block && tid < kWgCO && co0 + tid < CO) out[(size_t)9 * C * CO + co0 + tid] = dbacc;
}

// ---- launches ------------------------------------------------------------

// W tiles of the forward's grid for this dtype and CO (stats partials per
// slab).
int fwd_wtiles(int dtype, int CO, int W) {
  const int bw = dtype == 0 ? kBW : (CO > 64 ? FwdTc<128>::BW : FwdTc<64>::BW);
  return (W + bw - 1) / bw;
}

// ``part`` null: one row per block (grid z = N*H); else slabs of
// kStatsRows rows and one stats partial per (slab, W tile).
template <bool STATS>
cudaError_t launch_fwd_f32(const float* x, const float* wm, const float* b, float* y,
                           float* part, int N, int H, int W, int C, int CO,
                           cudaStream_t st) {
  const int NH = N * H, rows = STATS ? kStatsRows : 1;
  const int slabs = (NH + rows - 1) / rows;
  const int wtiles = fwd_wtiles(0, CO, W);
  if (CO > 64) {
    const dim3 grid(wtiles, (CO + 127) / 128, slabs);
    conv3x3_fwd_kernel<8, STATS><<<grid, kThreads, 0, st>>>(x, wm, b, y, part, NH, H, W,
                                                            C, CO, rows);
  } else {
    const dim3 grid(wtiles, (CO + 63) / 64, slabs);
    conv3x3_fwd_kernel<4, STATS><<<grid, kThreads, 0, st>>>(x, wm, b, y, part, NH, H, W,
                                                            C, CO, rows);
  }
  return cudaGetLastError();
}

template <bool STATS>
cudaError_t launch_fwd_bf16(const bf16* x, const bf16* wm, const bf16* b, bf16* y,
                            float* part, int N, int H, int W, int C, int CO,
                            cudaStream_t st) {
  if (C % kKC || CO % 16) return cudaErrorInvalidValue;
  const int NH = N * H, rows = STATS ? kStatsRows : 1;
  const int slabs = (NH + rows - 1) / rows;
  const int wtiles = fwd_wtiles(1, CO, W);
  if (CO > 64) {
    const dim3 grid(wtiles, (CO + 127) / 128, slabs);
    conv3x3_fwd_tc_kernel<128, STATS><<<grid, kThreads, 0, st>>>(x, wm, b, y, part, NH,
                                                                 H, W, C, CO, rows);
  } else {
    const dim3 grid(wtiles, 1, slabs);
    conv3x3_fwd_tc_kernel<64, STATS><<<grid, kThreads, 0, st>>>(x, wm, b, y, part, NH,
                                                                H, W, C, CO, rows);
  }
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (C and CO multiples of 16). x
// [N,H,W,C], wm [9C, CO] (w [3,3,C,CO] flattened), bias [CO], y
// [N,H,W,CO]; all of dtype, contiguous, 32-byte aligned.
extern "C" int conv3x3_fwd(int dtype, const void* x, const void* wm, const void* bias,
                           void* y, int N, int H, int W, int C, int CO, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)launch_fwd_f32<false>((const float*)x, (const float*)wm,
                                      (const float*)bias, (float*)y, nullptr, N, H, W, C,
                                      CO, st);
  if (dtype == 1)
    return (int)launch_fwd_bf16<false>((const bf16*)x, (const bf16*)wm, (const bf16*)bias,
                                       (bf16*)y, nullptr, N, H, W, C, CO, st);
  return (int)cudaErrorInvalidValue;
}

// Stats partials of conv3x3_fwd_stats: the wrapper sizes ``part`` as this
// many rows of 2*CO floats.
extern "C" int conv3x3_stats_parts(int dtype, int N, int H, int W, int CO) {
  return (N * H + kStatsRows - 1) / kStatsRows * fwd_wtiles(dtype, CO, W);
}

// conv3x3_fwd plus the f32 per-channel sums of the rounded y: sums [2*CO]
// = sum over (n, h, w) of y, then of y*y. part f32 [conv3x3_stats_parts,
// 2*CO] scratch.
extern "C" int conv3x3_fwd_stats(int dtype, const void* x, const void* wm,
                                 const void* bias, void* y, void* part, void* sums, int N,
                                 int H, int W, int C, int CO, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (dtype == 0)
    err = launch_fwd_f32<true>((const float*)x, (const float*)wm, (const float*)bias,
                               (float*)y, (float*)part, N, H, W, C, CO, st);
  else if (dtype == 1)
    err = launch_fwd_bf16<true>((const bf16*)x, (const bf16*)wm, (const bf16*)bias,
                                (bf16*)y, (float*)part, N, H, W, C, CO, st);
  else
    return (int)cudaErrorInvalidValue;
  if (err != cudaSuccess) return (int)err;
  return (int)reduce_partials((const float*)part, (float*)sums,
                              conv3x3_stats_parts(dtype, N, H, W, CO), 2 * CO, st);
}

// x [N,H,W,C], g [N,H,W,CO] of dtype (bf16: C and CO multiples of 16,
// 32-byte aligned); part f32 [slabs, 9C*CO + CO] (scratch); out f32
// [9C*CO + CO] = dw [9C, CO] in (dy, dx, C) row order, then db [CO].
extern "C" int conv3x3_wgrad(int dtype, const void* x, const void* g, void* part,
                             void* out, int N, int H, int W, int C, int CO, int slabs,
                             int rows_per_slab, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    const dim3 grid((9 * C + kWT - 1) / kWT, (CO + kWT - 1) / kWT, slabs);
    conv3x3_wgrad_kernel<<<grid, kThreads, 0, st>>>((const float*)x, (const float*)g,
                                                    (float*)part, N * H, H, W, C, CO,
                                                    rows_per_slab);
  } else if (dtype == 1) {
    if (C % kKC || CO % 16) return (int)cudaErrorInvalidValue;
    const dim3 grid(C / kKC, (CO + kWgCO - 1) / kWgCO, slabs);
    conv3x3_wgrad_tc_kernel<<<grid, kThreads, 0, st>>>((const bf16*)x, (const bf16*)g,
                                                       (float*)part, N * H, H, W, C, CO,
                                                       rows_per_slab);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)reduce_partials((const float*)part, (float*)out, slabs, 9 * C * CO + CO, st);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
