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
// [9C, CO], JAX's (dy, dx, C) row order. Zeros outside the image are made
// while staging (SAME's padding at all four edges: no padded copy of x, no
// im2col tensor in device memory). The bias is added in f32 and the result
// rounded once.
// - bf16 (conv3x3_fwd_tc_kernel) runs on warpgroup MMA (wgmma.cuh), with
//   the weights as B: persistent blocks, one an SM and channel tile, each
//   walking a contiguous run of the (image, W tile, h) output rows down
//   the rows, its [9C, BCO] weight tile resident in shared memory for the
//   whole run (147,456 bytes at conv2 and at the dgrad; re-read from L2 for
//   every row it would be about 6.6 GB a conv2 pass). Input rows stream
//   through a 4-slot cp.async ring: the 3-row halo window slides, so each
//   output row loads one new input row (x is read once, plus two rows a
//   run). A pixel's channels are contiguous in NHWC, so the tap (dy, dx) is
//   the staged row dy shifted by dx whole pixels: each warp loads its A
//   fragments with ldmatrix at that shift (pixel pitch an odd number of
//   16-byte chunks: no bank conflicts at any shift) and the warpgroup
//   issues wgmma.m64nBCOk16 with A from registers. The epilogue runs from
//   the accumulator registers. Tiles: C <= 64, two warpgroups of 64 pixels
//   and BCO 128 (64 for CO <= 64); C up to 128 (the dgrad), one warpgroup
//   and BCO 64, which fits the weights and the ring in one block's shared
//   memory (215 KiB at C 128). What bounds it now: each warpgroup issues
//   its 9 C/16 products of a row, then waits for them before its epilogue,
//   and a block barrier a row keeps the ring in step; no TMA or producer
//   warp.
// - fp32 runs a 64-pixel x 16*TCO-channel register tiling on the CUDA cores
//   (FMA peak 67 TFLOP/s), 16-channel chunks of the 3-row halo strip and
//   of the weights staged in shared memory; it is the tight check against
//   the plain version.
//
// Design (stats). BN's sum and sum of squares per channel of the ROUNDED
// output are an epilogue of the forward: y is never read back, and the
// stats y is the forward's y bitwise (one body). bf16: each thread adds its
// rounded outputs and their squares per channel to registers over its
// block's run, in order; at the end the 8 rows of a warp combine by a fixed
// shuffle tree and the warps in a fixed order through shared memory, and
// the block writes one partial row. fp32: one partial per slab of
// kStatsRows rows and W tile. reduce_partials (reduce.cuh) adds the
// partials in a fixed order. No float atomics: two runs are bitwise equal.
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
// The wgrad is the simple, right version: no cp.async or TMA pipeline, no
// wgmma, one barrier pair per 16-channel chunk. Those are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "mma.cuh"
#include "reduce.cuh"
#include "wgmma.cuh"

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

// ---- bf16 on the tensor cores ---------------------------------------------

// The halo strip of one 16-channel chunk (the wgrad's): rows h-1..h+1 of
// image n, pixels w0-1 .. w0+BW, 32 bytes a pixel (two 16-byte loads),
// zero outside the image. s[dy][j][c] holds pixel w0-1+j; a row of 16 bf16
// is 32 bytes, so every pixel of the strip starts on a WMMA-aligned
// (256-bit) address.
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

// Forward on warpgroup MMA. A block of NWG warpgroups owns a BCO-channel
// tile of the output and a contiguous run of output rows of the flattened
// (column, h) space, a column being (image n, W tile of BW = 64 NWG
// pixels); warpgroup wg computes pixels w0 + 64 wg .. of each row. The
// block's [9C, BCO] weight tile sits in shared memory for the whole run,
// as the B operand of wgmma (MN-major, 128-byte swizzled 64-column groups:
// group g at + g * 9C * 128 bytes, row k at + k * 128, its 16-byte chunk
// c at chunk c ^ (k % 8)). Input rows of BW + 2 pixels (zero outside the
// image) stream through a ring of kRing slots, one new row per output row,
// loaded by cp.async one row ahead; a pixel's C channels are followed by 16
// bytes of padding, so a pitch of an odd number of 16-byte chunks puts the
// 8 pixels an ldmatrix reads on distinct banks at any tap shift dx. Per
// output row and tap (dy, dx), each warp loads the m16n8k16 A fragments of
// its 16 pixels (shifted by dx) with ldmatrix and the warpgroup issues C/16
// wgmma.m64nBCOk16 with A from registers into the f32 accumulators; the A
// registers of two taps alternate, so one tap's loads overlap the other's
// products. The epilogue runs from the accumulators: bias in f32, one
// rounding, bf16 pairs stored to y, and with STATS the rounded values and
// their squares added per channel to registers in a fixed order.
constexpr int kRing = 4;         // input row slots: rows h-1, h, h+1 and h+2 in flight
constexpr int kMaxBf16C = 128;   // C the resident weight tile and ring fit for

template <int BCO, int NWG, int KSMAX>
struct FwdTc {
  static constexpr int kThr = 128 * NWG, BW = 64 * NWG, BJ = BW + 2;   // staged pixels
  __host__ __device__ static constexpr int pitch(int C) { return 2 * C + 16; }   // bytes a pixel
  static size_t bytes(int C) {
    return 1024 + (size_t)9 * C * BCO * 2 + (size_t)kRing * BJ * pitch(C) + BCO * 4;
  }
};

__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

// a segment of the block's run: column col, output rows h0 .. h0+len-1;
// load k (0 .. len+1) brings input row h0 - 1 + k. col < 0: the run is over.
struct Seg {
  int col, h0, len, k;
};

template <int BCO, int NWG, int KSMAX, bool STATS>
__global__ void __launch_bounds__(128 * NWG, 1)
conv3x3_fwd_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wm,
                      const bf16* __restrict__ bias, bf16* __restrict__ y,
                      float* __restrict__ part, int N, int H, int W, int C, int CO, int per) {
  using P = FwdTc<BCO, NWG, KSMAX>;
  constexpr int NT = P::kThr, BW = P::BW, BJ = P::BJ;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* ws = align1024(smem_raw);
  const int K9 = 9 * C, KS = C / 16, CPR = C / 8, pitch = P::pitch(C);
  unsigned char* ring = ws + (size_t)K9 * BCO * 2;
  float* bs = reinterpret_cast<float*>(ring + kRing * BJ * pitch);

  const int tid = threadIdx.x, wg = tid / 128, w = (tid / 32) % 4, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int co0 = blockIdx.y * BCO;
  const int wtiles = (W + BW - 1) / BW;
  const int total = N * wtiles * H;
  const int fb = min(total, (int)blockIdx.x * per), fe = min(total, fb + per);

  for (int i = tid; i < K9 * (BCO / 8); i += NT) {
    const int kr = i / (BCO / 8), c = i % (BCO / 8);
    const bool ok = co0 + 8 * c < CO;
    cp_async16(ws + (c / 8) * (K9 * 128) + kr * 128 + (((c % 8) ^ (kr % 8)) << 4),
               ok ? wm + (size_t)kr * CO + co0 + 8 * c : wm, ok ? 16 : 0);
  }
  for (int i = tid; i < BCO; i += NT)
    bs[i] = co0 + i < CO ? __bfloat162float(bias[co0 + i]) : 0.f;

  auto seg_at = [&](int f) -> Seg {
    if (f >= fe) return Seg{-1, 0, 0, 0};
    const int col = f / H, h0 = f - col * H;
    return Seg{col, h0, min(H - h0, fe - f), 0};
  };
  auto advance = [&](Seg s) -> Seg {
    if (s.k <= s.len) {
      ++s.k;
      return s;
    }
    return seg_at(s.col * H + s.h0 + s.len);
  };
  auto issue = [&](const Seg& s, int slot) {      // load s.k of segment s into a slot
    const int n = s.col / wtiles, w0 = (s.col - n * wtiles) * BW, hh = s.h0 - 1 + s.k;
    const bool row_ok = hh >= 0 && hh < H;
    const bf16* src = x + (size_t)(n * H + (row_ok ? hh : 0)) * W * C;
    unsigned char* dst = ring + slot * BJ * pitch;
    for (int i = tid; i < BJ * CPR; i += NT) {
      const int j = i / CPR, c = i - j * CPR, ww = w0 - 1 + j;
      const bool ok = row_ok && ww >= 0 && ww < W;
      cp_async16(dst + j * pitch + c * 16, ok ? src + (size_t)ww * C + c * 8 : x, ok ? 16 : 0);
    }
  };

  float acc[BCO / 2];
#pragma unroll
  for (int i = 0; i < BCO / 2; ++i) acc[i] = 0.f;
  // channels 8 j + 2 t + e of this thread's columns: index 2 j + e
  float st[STATS ? BCO / 4 : 1], st2[STATS ? BCO / 4 : 1];
#pragma unroll
  for (int i = 0; i < (STATS ? BCO / 4 : 1); ++i) st[i] = st2[i] = 0.f;

  const uint32_t ws_a = smem_u32(ws);
  const uint32_t lbo = (uint32_t)K9 * 128;          // between 64-column groups of the weights
  const int pix = 64 * wg + 16 * w + (lane & 15);  // the pixel this lane's ldmatrix row reads
  uint32_t a[2][KSMAX][4];                         // two taps' A fragments
  Seg cur = seg_at(fb);
  if (cur.col >= 0) issue(cur, 0);
  cp_async_commit();                               // with the weights
  for (int i = 0; cur.col >= 0; ++i) {
    cp_async_wait<0>();
    fence_proxy_async();                           // cp.async writes -> wgmma reads
    __syncthreads();                               // load i landed; slot (i+1) % kRing free
    const Seg nxt = advance(cur);
    if (nxt.col >= 0) issue(nxt, (i + 1) % kRing);
    cp_async_commit();
    if (cur.k >= 2) {                              // output row h0 + k - 2: loads i-2, i-1, i
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {
        const int dy = tap / 3, dx = tap % 3, b = tap & 1;
        if (tap >= 2) wg_wait<1>();                // tap-2's products read a[b]
        const unsigned char* arow = ring + ((i - 2 + dy) % kRing) * BJ * pitch +
                                    (pix + dx) * pitch + (lane >> 4) * 16;
#pragma unroll
        for (int kc = 0; kc < KSMAX; ++kc)
          if (kc < KS) ldsm_x4(a[b][kc], arow + kc * 32);
        wg_fence();
#pragma unroll
        for (int kc = 0; kc < KSMAX; ++kc) {
          if (kc >= KS) continue;
          const uint64_t db = gmma_desc(ws_a + (tap * KS + kc) * 16 * 128, lbo, 1024);
          if constexpr (BCO == 128)
            wgmma_rs_n128(acc, a[b][kc], db);
          else
            wgmma_rs_n64(acc, a[b][kc], db);
        }
        wg_commit();
      }
      wg_wait<0>();
      fence_regs(acc);

      const int n = cur.col / wtiles, w0 = (cur.col - n * wtiles) * BW;
      bf16* yr = y + (size_t)(n * H + cur.h0 + cur.k - 2) * W * CO + co0;
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int wpx = w0 + 64 * wg + 16 * w + g + 8 * hf;
#pragma unroll
        for (int j = 0; j < BCO / 8; ++j) {
          const int c = 8 * j + 2 * t;
          const __nv_bfloat162 v = __floats2bfloat162_rn(acc[4 * j + 2 * hf] + bs[c],
                                                         acc[4 * j + 2 * hf + 1] + bs[c + 1]);
          acc[4 * j + 2 * hf] = acc[4 * j + 2 * hf + 1] = 0.f;
          if (wpx >= W) continue;
          if (co0 + c < CO) *reinterpret_cast<__nv_bfloat162*>(yr + (size_t)wpx * CO + c) = v;
          if constexpr (STATS) {
            const float2 f = __bfloat1622float2(v);
            st[2 * j] += f.x;
            st2[2 * j] += f.x * f.x;
            st[2 * j + 1] += f.y;
            st2[2 * j + 1] += f.y * f.y;
          }
        }
      }
    }
    cur = nxt;
  }

  if constexpr (STATS) {
    // the 8 rows of a warp's column (lanes g), then the warps in order
#pragma unroll
    for (int i = 0; i < BCO / 4; ++i)
#pragma unroll
      for (int off = 4; off < 32; off *= 2) {
        st[i] += __shfl_xor_sync(0xffffffffu, st[i], off);
        st2[i] += __shfl_xor_sync(0xffffffffu, st2[i], off);
      }
    cp_async_wait<0>();
    __syncthreads();                               // the ring is free: [NWG*4][BCO][2] sums
    float* red = reinterpret_cast<float*>(ring);
    if (g == 0)
#pragma unroll
      for (int i = 0; i < BCO / 4; ++i) {
        const int c = 8 * (i / 2) + 2 * t + (i & 1);
        red[((wg * 4 + w) * BCO + c) * 2] = st[i];
        red[((wg * 4 + w) * BCO + c) * 2 + 1] = st2[i];
      }
    __syncthreads();
    for (int c = tid; c < BCO; c += NT) {
      if (co0 + c >= CO) continue;
      float s = 0.f, s2 = 0.f;
      for (int k = 0; k < NWG * 4; ++k) {
        s += red[(k * BCO + c) * 2];
        s2 += red[(k * BCO + c) * 2 + 1];
      }
      float* out = part + (size_t)blockIdx.x * 2 * CO;
      out[co0 + c] = s;
      out[CO + co0 + c] = s2;
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

// W tiles of the fp32 forward's grid (stats partials per slab)
int fwd_wtiles_f32(int W) { return (W + kBW - 1) / kBW; }

// blocks of the bf16 forward a channel tile (and its stats partials): one
// an SM, each with a contiguous run of output rows; 0 if it cannot be
// asked
int fwd_blocks_bf16() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return sms;
}

// ``part`` null: one row per block (grid z = N*H); else slabs of
// kStatsRows rows and one stats partial per (slab, W tile).
template <bool STATS>
cudaError_t launch_fwd_f32(const float* x, const float* wm, const float* b, float* y,
                           float* part, int N, int H, int W, int C, int CO,
                           cudaStream_t st) {
  const int NH = N * H, rows = STATS ? kStatsRows : 1;
  const int slabs = (NH + rows - 1) / rows;
  const int wtiles = fwd_wtiles_f32(W);
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

template <int BCO, int NWG, int KSMAX, bool STATS>
cudaError_t launch_fwd_tc(const bf16* x, const bf16* wm, const bf16* b, bf16* y, float* part,
                          int N, int H, int W, int C, int CO, cudaStream_t st) {
  auto kernel = conv3x3_fwd_tc_kernel<BCO, NWG, KSMAX, STATS>;
  const size_t bytes = FwdTc<BCO, NWG, KSMAX>::bytes(C);
  const int blocks = fwd_blocks_bf16();
  if (blocks == 0) return cudaErrorInvalidValue;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return e;
  const int bw = FwdTc<BCO, NWG, KSMAX>::BW;
  const long long total = (long long)N * ((W + bw - 1) / bw) * H;
  if (total > 0x7fffffff) return cudaErrorInvalidValue;
  const int per = (int)((total + blocks - 1) / blocks);
  kernel<<<dim3(blocks, (CO + BCO - 1) / BCO), 128 * NWG, bytes, st>>>(x, wm, b, y, part, N, H,
                                                                     W, C, CO, per);
  return cudaGetLastError();
}

// the instance for C: C 16 one k-step a tap, C up to 64 two warpgroups of
// 64 pixels and (CO > 64) 128-channel tiles, C up to kMaxBf16C one
// warpgroup and 64-channel tiles (the weights and the ring fit then)
template <bool STATS>
cudaError_t launch_fwd_bf16(const bf16* x, const bf16* wm, const bf16* b, bf16* y,
                            float* part, int N, int H, int W, int C, int CO,
                            cudaStream_t st) {
  if (C % kKC || CO % 16 || C > kMaxBf16C) return cudaErrorInvalidValue;
  if (C > 64) return launch_fwd_tc<64, 1, 8, STATS>(x, wm, b, y, part, N, H, W, C, CO, st);
  if (CO > 64)
    return C == 16 ? launch_fwd_tc<128, 2, 1, STATS>(x, wm, b, y, part, N, H, W, C, CO, st)
                   : launch_fwd_tc<128, 2, 4, STATS>(x, wm, b, y, part, N, H, W, C, CO, st);
  return C == 16 ? launch_fwd_tc<64, 2, 1, STATS>(x, wm, b, y, part, N, H, W, C, CO, st)
                 : launch_fwd_tc<64, 2, 4, STATS>(x, wm, b, y, part, N, H, W, C, CO, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (C and CO multiples of 16, C at most
// 128). x [N,H,W,C], wm [9C, CO] (w [3,3,C,CO] flattened), bias [CO], y
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
// many rows of 2*CO floats (fp32: one per slab and W tile; bf16: one per
// block, 0 if the device cannot be asked).
extern "C" int conv3x3_stats_parts(int dtype, int N, int H, int W, int CO) {
  if (dtype == 1) return fwd_blocks_bf16();
  return (N * H + kStatsRows - 1) / kStatsRows * fwd_wtiles_f32(W);
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
