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
// Both bounds assume the bf16 tensor cores; they are what the bf16
// bodies below are measured against (PERF.md section 6, rows 1, 1b, 2).
// fp32 runs on the CUDA cores (FMA peak 67 TFLOP/s) with simple tilings
// and is the tight check against the plain version; only the bf16 bodies
// are tuned.
//
// Design (forward). Per output row (n, h) the conv is the GEMM
//   y[co, w] = b[co] + sum_{k=(dy,dx,c)} wt[co, k] * x[n, h+dy-1, c, w+dx-1]
// with K = 9C. Zeros outside the image are made while staging (the H halo
// and the W edge are masked; no padded copy of x exists), and each staged
// x row serves the three dx taps, so x is read once per dy, not per tap.
// Accumulation is f32; the bias is added in f32 and the result rounded
// once to the output dtype. bf16: the weight tile is resident in shared
// memory (re-staged per row and chunk it would be ~6.6 GB of L2 reads a
// conv2 pass) and x streams through a cp.async ring, transposed once in
// shared memory so that the dx shift is a whole-row offset for ldmatrix;
// products on mma.sync, 32x64 a warp (the tensor-core section says why
// not wgmma). fp32: 256 threads hold a TCO x 4 register tile each of a
// 64-column, 16*TCO-channel tile, per row of a slab.
//
// Design (stats). BN's batch statistics, sum and sum of squares per
// channel of the ROUNDED output, are an epilogue of the forward: y is
// never read back, and the stats y is the plain forward's y bitwise (one
// body, the same K order). The TPU carries the sums across its sequential
// grid in VMEM; here each block sums its outputs in registers in a fixed
// order over its units (bf16: one partial row per block; fp32: one per
// slab of kStatsRows rows and W tile), and reduce_partials (reduce.cuh)
// adds the partials in a fixed order. No float atomics: two runs are
// bitwise equal.
//
// Design (wgrad). dwT[co, k] = sum_{n,h,w} g[n,h,co,w] * x[n,h+dy-1,c,w+dx-1]
// and db[co] = sum g. The TPU version carries the sum across its
// sequential grid in VMEM scratch; here blocks run in parallel over slabs
// of (n, h) rows and each writes a partial; reduce_partials adds the
// partials in a fixed order, so repeated runs are bitwise equal. bf16: a
// block owns a KC-channel chunk with all nine taps and a BCO-channel co
// tile, so each operand is read once per block and chunk (a 64x64 (co, k)
// tile per block would fetch every x element 18 times and every g element
// 9 times); the operands come through a cp.async ring, and each warp
// keeps nine tap accumulators that share one g fragment; the slabs are
// sized by the wrapper so that tiles x slabs is one wave of the card.
// fp32: a 64x64 (co, k) tile per block on the CUDA cores.
//
// Rows of [N,H,C,W] are 2W bytes: at the main path's W 750 only 4-byte
// aligned, at odd W only 2-byte aligned, so neither TMA (16-byte strides)
// nor a 16-byte cp.async of the row window itself applies. The bf16
// bodies copy the 16-byte aligned chunks around each row's window
// (stage_rows in mma.cuh): a row lands in shared memory shifted by its
// start's offset mod 16 (0, 2, 4 or 6 elements), and the consumers read
// it at that shift with 32-bit loads; the chunk that holds a row's start
// brings the previous row's tail, which is masked, and the chunk that
// holds its end is copied only up to it. 4-byte copies of the window
// itself would need four times the copy instructions, and those limited
// the staging more than the bytes did. Odd W falls back to 2-byte loads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"
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

// ---- bf16 on the tensor cores (mma.sync m16n8k16, f32 accumulation) ----
//
// Why mma.sync and not wgmma: both bodies need one operand shifted by a
// single bf16 element per tap (dx). In the forward the shift lies along
// the GEMM's N (the W columns), in the wgrad along its K (the pixels);
// a wgmma shared-memory descriptor and an ldmatrix row address move in
// 16-byte steps, so a shifted operand would need three copies in shared
// memory, and rows staged at their misaligned shift (see above) are not
// 16-byte aligned either.
// mma.sync takes its operands from registers: the forward transposes x
// once in shared memory to [w][c], where a shift of dx columns is a shift
// of whole 48- or 80-byte rows (ldmatrix-aligned), and the wgrad builds
// its fragments from 32-bit shared loads, the dx shifts with one
// byte-permute each. wgmma with A from registers (the shifted operand)
// is later work.

using bf16 = __nv_bfloat16;

// Forward. A block keeps its [BCO, 9C] weight tile resident in shared
// memory (loaded once, 147 KB at conv2 and at the dgrad) and walks a
// contiguous run of (row, W tile) units; per unit the K loop is 3 dy x
// C/KC pieces of KC channels (32 where C allows it and the shared memory
// holds it, else 16) of one x row, each used by the three dx taps. A
// piece goes global -> raw ring (cp.async, 4 stages, as [c][w] rows of
// the image, zero outside it) -> transposed buffer [w][c] (2 stages;
// byte-permutes of 32-bit loads at each row's shift) -> ldmatrix. One
// barrier per piece: loads run three pieces ahead of the transpose, which
// runs one ahead of the products. 8 warps of 32 co x 64 columns (2 x 8
// mma tiles, 64 f32 accumulators a thread): BCO 128 is 4 x 2 warps over
// 128 columns, BCO 64 (the dgrad of conv2) 2 x 4 warps over 256.
template <int BCO, int KC>
struct FwdTc {
  static constexpr int WCO = BCO / 32, WW = 8 / WCO, BW = WW * 64;
  // raw and transposed x are indexed by j = w - w0 + 8 (columns w0-8 ..
  // w0+BW+15); the products read j = 7 .. BW+8
  static constexpr int RP = BW + 24;       // raw row pitch (a 16-byte multiple)
  static constexpr int XJ = BW + 16;       // transposed rows
  static constexpr int XP = KC + 8;        // transposed row pitch (48 or 80 bytes)
  static constexpr int kStages = 4;
  static size_t bytes(int C) {
    return sizeof(bf16) * ((size_t)BCO * (9 * C + 8) + (size_t)kStages * KC * RP +
                           2 * (size_t)XJ * XP);
  }
};

// With STATS each thread adds the rounded outputs of its four channel rows
// (and their squares) to registers over all its units, in order; at the
// end the four lanes of a row combine by a fixed shuffle tree and the
// warps along W in a fixed order through shared memory, and the block
// writes its partial row of [2*CO].
template <int BCO, int KC, int MODE, bool STATS>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_t_fwd_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ wt,
                        const bf16* __restrict__ bias, bf16* __restrict__ y,
                        float* __restrict__ part, int H, int C, int CO, int W,
                        int units, int per) {
  using P = FwdTc<BCO, KC>;
  constexpr int BW = P::BW, RP = P::RP, XP = P::XP, XJ = P::XJ, NS = P::kStages;
  extern __shared__ __align__(128) unsigned char smem[];
  const int K9 = 9 * C, WP = K9 + 8;
  bf16* ws = reinterpret_cast<bf16*>(smem);
  bf16* raw = ws + (size_t)BCO * WP;
  bf16* xt = raw + NS * KC * RP;     // [2][XJ][XP]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int wco = warp / P::WW, wwp = warp % P::WW;
  const int co0 = blockIdx.y * BCO;
  const int wtiles = (W + BW - 1) / BW;
  const int u_begin = blockIdx.x * per, u_end = min(units, u_begin + per);
  const int nc = C / KC, ppu = 3 * nc;
  const int npieces = max(0, u_end - u_begin) * ppu;

  // the weight tile: rows of 9C bf16 are whole 16-byte vectors
  for (int i = tid; i < BCO * (K9 / 8); i += kThreads) {
    const int r = i / (K9 / 8), v = i - r * (K9 / 8);
    const bool ok = co0 + r < CO;
    cp_async16(ws + r * WP + v * 8, ok ? wt + (size_t)(co0 + r) * K9 + v * 8 : wt, ok ? 16 : 0);
  }

  auto issue = [&](int p) {          // piece p into raw slot p % NS
    if (p < npieces) {
      const int u = u_begin + p / ppu, q = p % ppu;
      const int dy = q / nc, cc = q - dy * nc;
      const int row = u / wtiles, w0 = (u - row * wtiles) * BW;
      const int n = row / H, hh = row - n * H + dy - 1;
      const bool ok = hh >= 0 && hh < H;
      stage_rows<MODE, BW + 16>(raw + (p % NS) * KC * RP, RP,
                                ok ? x + ((size_t)(n * H + hh) * C + cc * KC) * W : x, KC,
                                ok ? KC : 0, W, w0 - 8);
    }
    cp_async_commit();
  };
  // raw slot p % NS (channel c's column w at j + row_shift, j = w - w0 +
  // 8) -> xt[p % 2] [j][c]: one byte-permute pair per two channels and two
  // columns. A warp takes 4 channel pairs x 8 column pairs (reads of one
  // row are consecutive words), and a thread keeps its channel pair, so
  // its two rows' shifts are taken once a piece. Columns left of the
  // image are zeroed here (under kShift16 the raw row holds the previous
  // row's tail there).
  constexpr int CPG = KC / 8;                     // groups of 4 channel pairs
  static_assert((kThreads / 32) % CPG == 0, "a thread keeps its channel pair");
  const int tcp = (warp % CPG) * 4 + lane / 8;    // this thread's channel pair
  constexpr int kPairs = BW / 2 + 2;              // column pairs w0-2 .. w0+BW+1
  constexpr int kStep = (kThreads / 32) / CPG;    // blocks of 8 pairs a step
  constexpr int kIt = ((kPairs + 7) / 8 + kStep - 1) / kStep;
  auto transpose = [&](int p) {
    if (p >= npieces) return;
    const int u = u_begin + p / ppu, q = p % ppu;
    const int dy = q / nc, cc = q - dy * nc;
    const int row = u / wtiles, w0 = (u - row * wtiles) * BW;
    const int n = row / H, hh = min(max(row - n * H + dy - 1, 0), H - 1);
    const bf16* x0 = x + ((size_t)(n * H + hh) * C + cc * KC + 2 * tcp) * W;
    const bf16* r0 = raw + (p % NS) * KC * RP + 2 * tcp * RP + 6 + row_shift<MODE>(x0);
    const bf16* r1 = raw + (p % NS) * KC * RP + (2 * tcp + 1) * RP + 6 + row_shift<MODE>(x0 + W);
    uint32_t* xd = reinterpret_cast<uint32_t*>(xt + (p % 2) * XJ * XP) + tcp;
    // all loads first, then the permutes and stores: no load waits on a
    // store of the same thread
    uint32_t va[kIt], vb[kIt];
#pragma unroll
    for (int k = 0; k < kIt; ++k) {
      const int pp = (warp / CPG + k * kStep) * 8 + lane % 8;   // columns w0-2+2pp, +1
      if (pp < kPairs) {
        va[k] = *reinterpret_cast<const uint32_t*>(r0 + 2 * pp);
        vb[k] = *reinterpret_cast<const uint32_t*>(r1 + 2 * pp);
      }
    }
#pragma unroll
    for (int k = 0; k < kIt; ++k) {
      const int pp = (warp / CPG + k * kStep) * 8 + lane % 8;
      if (pp >= kPairs) continue;
      const bool in = w0 - 2 + 2 * pp >= 0;
      const uint32_t a = in ? va[k] : 0u, b = in ? vb[k] : 0u;
      xd[(6 + 2 * pp) * (XP / 2)] = __byte_perm(a, b, 0x5410);
      xd[(7 + 2 * pp) * (XP / 2)] = __byte_perm(a, b, 0x7632);
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;
  float bv[4], st[4] = {0.f, 0.f, 0.f, 0.f}, st2[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int k = 0; k < 4; ++k) {      // rows wco*32 + (k/2)*16 + (k%2)*8 + g
    const int co = co0 + wco * 32 + (k / 2) * 16 + (k % 2) * 8 + g;
    bv[k] = co < CO ? __bfloat162float(bias[co]) : 0.f;
  }

  for (int p = 0; p < NS; ++p) issue(p);   // the first with the weights
  cp_async_wait<NS - 1>();
  __syncthreads();
  transpose(0);
  for (int p = 0; p < npieces; ++p) {
    cp_async_wait<NS - 2>();         // piece p+1 (this thread's copies)
    __syncthreads();                 // ... everyone's; xt[p % 2]; products of p-1 done
    transpose(p + 1);
    issue(p + NS);
    const int q = p % ppu, dy = q / nc, cc = q - dy * nc;
    const bf16* xb = xt + (p % 2) * XJ * XP;
#pragma unroll
    for (int dk = 0; dk < 3 * (KC / 16); ++dk) {   // dx, then 16 of the KC channels
      const int dx = dk / (KC / 16), kk = dk % (KC / 16);
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi)
        ldsm_x4(a[mi], ws + (wco * 32 + mi * 16 + (lane & 15)) * WP + (dy * 3 + dx) * C +
                           cc * KC + kk * 16 + (lane >> 4) * 8);
#pragma unroll
      for (int nb = 0; nb < 4; ++nb) {
        uint32_t b[4];
        // x column w0 + col + dx - 1 is j = col + dx + 7
        ldsm_x4(b, xb + (wwp * 64 + nb * 16 + dx + 7 + (lane & 7) + ((lane >> 4) << 3)) * XP +
                       kk * 16 + ((lane >> 3) & 1) * 8);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) {
          mma_bf16(acc[mi][2 * nb], a[mi], b[0], b[1]);
          mma_bf16(acc[mi][2 * nb + 1], a[mi], b[2], b[3]);
        }
      }
    }
    if (q != ppu - 1) continue;

    // the unit's epilogue: bias in f32, one rounding, y from registers
    const int u = u_begin + p / ppu;
    const int row = u / wtiles, w0 = (u - row * wtiles) * BW;
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int k = mi * 2 + hi;
        const int co = co0 + wco * 32 + mi * 16 + hi * 8 + g;
        bf16* yr = y + ((size_t)row * CO + (co < CO ? co : 0)) * W;
#pragma unroll
        for (int nj = 0; nj < 8; ++nj) {
          const int w = w0 + wwp * 64 + nj * 8 + 2 * t;
          const bf16 v0 = __float2bfloat16_rn(acc[mi][nj][2 * hi] + bv[k]);
          const bf16 v1 = __float2bfloat16_rn(acc[mi][nj][2 * hi + 1] + bv[k]);
          acc[mi][nj][2 * hi] = acc[mi][nj][2 * hi + 1] = 0.f;
          if (co >= CO) continue;
          if ((W & 1) == 0) {        // rows 4-byte aligned; w even, so w+1 < W too
            if (w < W) *reinterpret_cast<__nv_bfloat162*>(yr + w) = __halves2bfloat162(v0, v1);
          } else {
            if (w < W) yr[w] = v0;
            if (w + 1 < W) yr[w + 1] = v1;
          }
          if (STATS) {
            const float f0 = w < W ? __bfloat162float(v0) : 0.f;
            const float f1 = w + 1 < W ? __bfloat162float(v1) : 0.f;
            st[k] += f0;
            st2[k] += f0 * f0;
            st[k] += f1;
            st2[k] += f1 * f1;
          }
        }
      }
  }

  if (STATS) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int off = 1; off < 4; off *= 2) {
        st[k] += __shfl_xor_sync(0xffffffffu, st[k], off);
        st2[k] += __shfl_xor_sync(0xffffffffu, st2[k], off);
      }
    cp_async_wait<0>();
    __syncthreads();                 // the raw ring is free: [WW][BCO][2] sums
    float* red = reinterpret_cast<float*>(raw);
    if (t == 0) {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int col = wco * 32 + (k / 2) * 16 + (k % 2) * 8 + g;
        red[(wwp * BCO + col) * 2] = st[k];
        red[(wwp * BCO + col) * 2 + 1] = st2[k];
      }
    }
    __syncthreads();
    if (tid < BCO && co0 + tid < CO) {
      float s = 0.f, s2 = 0.f;
      for (int i = 0; i < P::WW; ++i) {
        s += red[(i * BCO + tid) * 2];
        s2 += red[(i * BCO + tid) * 2 + 1];
      }
      float* out = part + (size_t)blockIdx.x * 2 * CO;
      out[co0 + tid] = s;
      out[CO + co0 + tid] = s2;
    }
  }
}

// Wgrad. dwT[co, (dy,dx,c)] = sum over pixels of g[co, w] x[c, w+dx-1] on
// row h+dy-1: per 64-pixel chunk of a row, A is the g tile [co][w] and B
// the x strip [c][w] shifted by dx-1 along the contraction. A block owns
// BCO output channels and a KC-channel chunk with all nine taps, over a
// slab of rows: 8 warps of 64 co x 8 channels, each holding the nine
// taps' 64x8 accumulators (144 f32 a thread). Per 16 pixels a warp loads
// its four g fragments once (16 32-bit shared loads a thread, at each
// row's shift) and, per dy, four words of its x row per thread, from
// which byte-permutes make the three dx fragments: 36 mma per 28 shared
// loads. The k order inside a 16-pixel step is permuted alike in A and B
// (a thread's k 2t, 2t+1, 2t+8, 2t+9 are pixels 4t .. 4t+3), so that a
// thread's pixels are contiguous and its dx fragments share words. The g tile and the three x rows of a chunk come through a
// 3-stage cp.async ring, one barrier a chunk. db is one more mma per g fragment against a B of ones,
// in the warps of channel chunk 0. Fixed-order per-slab partials, added
// by reduce_partials: no float atomics.
template <int BCO, int KC>
struct WgTc {
  static constexpr int WCO = BCO / 64, WOCT = KC / 8;
  static_assert(WCO * WOCT == kThreads / 32, "8 warps");
  static constexpr int BWC = 64;                 // pixels a chunk
  static constexpr int GP = BWC + 8;             // g row pitch (144 bytes)
  static constexpr int XPP = BWC + 24;           // x row pitch: 44 words, conflict-free
  static constexpr int kStages = 3;
  static constexpr int kStage = BCO * GP + 3 * KC * XPP;
  static constexpr size_t kBytes = sizeof(bf16) * kStages * kStage;
};

template <int BCO, int KC, int MODE>
__global__ void __launch_bounds__(kThreads, 1)
conv3x3_t_wgrad_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ g,
                          float* __restrict__ part, int NH, int H, int C, int CO, int W,
                          int rows_per_slab) {
  using P = WgTc<BCO, KC>;
  constexpr int GP = P::GP, XPP = P::XPP, NS = P::kStages;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sm = reinterpret_cast<bf16*>(smem);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gq = lane / 4, t = lane % 4;
  const int wco = warp / P::WOCT, oct = warp % P::WOCT;
  const int c0 = blockIdx.x * KC, co0 = blockIdx.y * BCO, slab = blockIdx.z;
  const int K9 = 9 * C;
  const size_t M = (size_t)CO * K9 + CO;
  const bool warp_ok = co0 + wco * 64 < CO;
  const bool db_warp = blockIdx.x == 0 && oct == 0;
  const int r_begin = slab * rows_per_slab, r_end = min(NH, r_begin + rows_per_slab);
  const int nwc = (W + P::BWC - 1) / P::BWC;
  const int nchunks = max(0, r_end - r_begin) * nwc;

  auto issue = [&](int i) {          // chunk i into stage i % NS
    if (i < nchunks) {
      bf16* s = sm + (i % NS) * P::kStage;
      const int r = r_begin + i / nwc, w0 = (i % nwc) * P::BWC;
      const int n = r / H, h = r - n * H;
      stage_rows<MODE, P::BWC>(s, GP, g + ((size_t)r * CO + co0) * W, BCO, CO - co0, W, w0);
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const int hh = h + dy - 1;
        const bool ok = hh >= 0 && hh < H;
        stage_rows<MODE, P::BWC + 16>(s + BCO * GP + dy * KC * XPP, XPP,
                                      ok ? x + ((size_t)(n * H + hh) * C + c0) * W : x, KC,
                                      ok ? KC : 0, W, w0 - 8);
      }
    }
    cp_async_commit();
  };

  float acc[4][9][4], dacc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int k = 0; k < 4; ++k) dacc[i][k] = 0.f;
#pragma unroll
    for (int j = 0; j < 9; ++j)
#pragma unroll
      for (int k = 0; k < 4; ++k) acc[i][j][k] = 0.f;
  }
  const uint32_t ones = 0x3F803F80u;   // two bf16 1.0

  for (int i = 0; i < NS - 1; ++i) issue(i);
  for (int i = 0; i < nchunks; ++i) {
    cp_async_wait<NS - 2>();         // chunk i (this thread's copies)
    __syncthreads();                 // ... everyone's; products of i-1 done
    issue(i + NS - 1);
    if (!warp_ok) continue;
    const bf16* gs = sm + (i % NS) * P::kStage;
    const uint32_t* gw = reinterpret_cast<const uint32_t*>(gs);
    const uint32_t* xs =
        reinterpret_cast<const uint32_t*>(gs + BCO * GP + (oct * 8 + gq) * XPP);
    // this thread's rows land shifted (row_shift, even): g rows ra(mi) =
    // wco*64 + mi*16 + gq and ra+8, x row c0+oct*8+gq of each dy
    const int r = r_begin + i / nwc, w0 = (i % nwc) * P::BWC;
    const int n = r / H, h = r - n * H;
    int ga[4][2], xq[3];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int ra = wco * 64 + mi * 16 + hi * 8 + gq;
        const int sh = row_shift<MODE>(g + ((size_t)r * CO + co0 + ra) * W);
        ga[mi][hi] = (ra * GP + 4 * t + sh) / 2;   // word of pixels 4t, 4t+1
      }
#pragma unroll
    for (int dy = 0; dy < 3; ++dy) {
      const int hh = min(max(h + dy - 1, 0), H - 1);
      const int sh = row_shift<MODE>(x + ((size_t)(n * H + hh) * C + c0 + oct * 8 + gq) * W);
      xq[dy] = 2 * t + 4 + sh / 2;   // the word of row dy at j = 4t + 8
    }
#pragma unroll
    for (int ks = 0; ks < P::BWC / 16; ++ks) {
      uint32_t a[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        a[mi][0] = gw[ga[mi][0] + ks * 8];
        a[mi][1] = gw[ga[mi][1] + ks * 8];
        a[mi][2] = gw[ga[mi][0] + ks * 8 + 1];
        a[mi][3] = gw[ga[mi][1] + ks * 8 + 1];
      }
      if (db_warp) {
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) mma_bf16(dacc[mi], a[mi], ones, ones);
      }
      // B column gq is x row c0+oct*8+gq; its rows are the same pixels
      // shifted by dx-1: x columns w0+ks*16+4t+dx-1 .. +2, at shared column
      // j = w - w0 + 8 (plus the row's shift); column w0-1 < 0 is masked
#pragma unroll
      for (int dy = 0; dy < 3; ++dy) {
        const uint32_t* xd = xs + dy * KC * (XPP / 2);
        const int q = xq[dy] + ks * 8;
        const uint32_t vm = (w0 == 0 && ks == 0 && t == 0) ? 0u : xd[q - 1];
        const uint32_t v0 = xd[q], v1 = xd[q + 1], v2 = xd[q + 2];
        const uint32_t b[3][2] = {{__byte_perm(vm, v0, 0x5432), __byte_perm(v0, v1, 0x5432)},
                                  {v0, v1},
                                  {__byte_perm(v0, v1, 0x5432), __byte_perm(v1, v2, 0x5432)}};
#pragma unroll
        for (int dx = 0; dx < 3; ++dx)
#pragma unroll
          for (int mi = 0; mi < 4; ++mi) mma_bf16(acc[mi][dy * 3 + dx], a[mi], b[dx][0], b[dx][1]);
      }
    }
  }
  cp_async_wait<0>();

  if (!warp_ok) return;
  float* out = part + (size_t)slab * M;
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int co = co0 + wco * 64 + mi * 16 + hi * 8 + gq;
      if (co >= CO) continue;
      float* orow = out + (size_t)co * K9 + c0 + oct * 8 + 2 * t;
#pragma unroll
      for (int tap = 0; tap < 9; ++tap) {   // scalar: a slab's offset may be odd
        orow[tap * C] = acc[mi][tap][2 * hi];
        orow[tap * C + 1] = acc[mi][tap][2 * hi + 1];
      }
      if (db_warp && t == 0) out[(size_t)CO * K9 + co] = dacc[mi][2 * hi];
    }
}

// ---- launches ------------------------------------------------------------

// The fp32 forward: ``part`` null: one row per block (grid z = N*H); else
// slabs of kStatsRows rows and one stats partial per (slab, W tile).
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

constexpr size_t kSmemMax = 232448;   // a block's shared memory on sm_90

// The bf16 forward's tile for (C, CO): the channel tile BCO 128 where
// CO > 64, else 64, and the channel piece KC 32 where C % 32 == 0, else
// 16, taking the larger piece, then the smaller tile, whose shared memory
// fits; {0, 0} where none does.
struct FwdShape {
  int bco, kc;
};
FwdShape fwd_shape(int C, int CO) {
  if (C % kKC) return {0, 0};
  const bool kc32 = C % 32 == 0;
  if (CO > 64) {
    if (kc32 && FwdTc<128, 32>::bytes(C) <= kSmemMax) return {128, 32};
    if (FwdTc<128, 16>::bytes(C) <= kSmemMax) return {128, 16};
  }
  if (kc32 && FwdTc<64, 32>::bytes(C) <= kSmemMax) return {64, 32};
  if (FwdTc<64, 16>::bytes(C) <= kSmemMax) return {64, 16};
  return {0, 0};
}

template <int BCO, int KC, int MODE, bool STATS>
cudaError_t launch_fwd_tc(const bf16* x, const bf16* wt, const bf16* b, bf16* y, float* part,
                          int H, int C, int CO, int W, int blocks, int per, int units,
                          cudaStream_t st) {
  auto kernel = conv3x3_t_fwd_tc_kernel<BCO, KC, MODE, STATS>;
  const size_t bytes = FwdTc<BCO, KC>::bytes(C);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(blocks, (CO + BCO - 1) / BCO);
  kernel<<<grid, kThreads, bytes, st>>>(x, wt, b, y, part, H, C, CO, W, units, per);
  return cudaGetLastError();
}

// blocks x per units of (row, W tile) cover N*H rows times the W tiles.
template <bool STATS>
cudaError_t launch_fwd_bf16(const bf16* x, const bf16* wt, const bf16* b, bf16* y,
                            float* part, int N, int H, int C, int CO, int W, int blocks,
                            int per, cudaStream_t st) {
  const FwdShape f = fwd_shape(C, CO);
  if (f.bco == 0 || blocks <= 0 || per <= 0) return cudaErrorInvalidValue;
  const int bw = f.bco == 128 ? FwdTc<128, 16>::BW : FwdTc<64, 16>::BW;
  const int units = N * H * ((W + bw - 1) / bw);
  if ((long long)blocks * per < units) return cudaErrorInvalidValue;
  const int mode = stage_mode((uintptr_t)x, W);
#define CONV_T_FWD(BCO_, KC_, MODE_)                                                       \
  if (f.bco == BCO_ && f.kc == KC_ && mode == MODE_)                                       \
    return launch_fwd_tc<BCO_, KC_, MODE_, STATS>(x, wt, b, y, part, H, C, CO, W, blocks, \
                                                  per, units, st);
  CONV_T_FWD(128, 32, kShift16) CONV_T_FWD(128, 32, kElem)
  CONV_T_FWD(128, 16, kShift16) CONV_T_FWD(128, 16, kElem)
  CONV_T_FWD(64, 32, kShift16) CONV_T_FWD(64, 32, kElem)
  CONV_T_FWD(64, 16, kShift16) CONV_T_FWD(64, 16, kElem)
#undef CONV_T_FWD
  return cudaErrorInvalidValue;
}

// The bf16 wgrad's tile for (C, CO): KC 32 channels x BCO 128 where C %
// 32 == 0, else 16 x 256.
int wgrad_kc(int C) { return C % 32 == 0 ? 32 : 16; }

template <int BCO, int KC, int MODE>
cudaError_t launch_wgrad_tc(const bf16* x, const bf16* g, float* part, int N, int H, int C,
                            int CO, int W, int slabs, int rows, cudaStream_t st) {
  auto kernel = conv3x3_t_wgrad_tc_kernel<BCO, KC, MODE>;
  constexpr size_t bytes = WgTc<BCO, KC>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(C / KC, (CO + BCO - 1) / BCO, slabs);
  kernel<<<grid, kThreads, bytes, st>>>(x, g, part, N * H, H, C, CO, W, rows);
  return cudaGetLastError();
}

cudaError_t launch_wgrad_bf16(const bf16* x, const bf16* g, float* part, int N, int H, int C,
                              int CO, int W, int slabs, int rows, cudaStream_t st) {
  if (C % kKC) return cudaErrorInvalidValue;
  const int kc = wgrad_kc(C);
  const int mode = stage_mode((uintptr_t)x | (uintptr_t)g, W);
#define CONV_T_WGRAD(KC_, BCO_, MODE_)                                                    \
  if (kc == KC_ && mode == MODE_)                                                         \
    return launch_wgrad_tc<BCO_, KC_, MODE_>(x, g, part, N, H, C, CO, W, slabs, rows, st);
  CONV_T_WGRAD(32, 128, kShift16) CONV_T_WGRAD(32, 128, kElem)
  CONV_T_WGRAD(16, 256, kShift16) CONV_T_WGRAD(16, 256, kElem)
#undef CONV_T_WGRAD
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (C a multiple of 16, the [BCO, 9C]
// weight tile within a block's shared memory: C <= 144). x [N,H,C,W],
// wt [CO, 9C] (tap-major, then c), bias [CO], y [N,H,CO,W]; all of dtype,
// contiguous. bf16: ``blocks`` blocks of ``per`` (row, W tile) units each
// (conv3x3_t_fwd_plan), covering all N*H rows; fp32 ignores both.
extern "C" int conv3x3_t_fwd(int dtype, const void* x, const void* wt,
                             const void* bias, void* y, int N, int H, int C,
                             int CO, int W, int blocks, int per, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_fwd_f32<false>((const float*)x, (const float*)wt,
                                 (const float*)bias, (float*)y, nullptr, N, H,
                                 C, CO, W, st);
  if (dtype == 1)
    return launch_fwd_bf16<false>((const bf16*)x, (const bf16*)wt, (const bf16*)bias,
                                  (bf16*)y, nullptr, N, H, C, CO, W, blocks, per, st);
  return (int)cudaErrorInvalidValue;
}

// The bf16 forward's plan for (C, CO): which 0 -> its W tile (columns a
// unit), 1 -> its channel tile, 2 -> the blocks resident on the current
// device at once. 0 where the shape is not supported.
extern "C" int conv3x3_t_fwd_plan(int C, int CO, int which) {
  const FwdShape f = fwd_shape(C, CO);
  if (f.bco == 0) return 0;
  if (which == 0) return f.bco == 128 ? FwdTc<128, 16>::BW : FwdTc<64, 16>::BW;
  if (which == 1) return f.bco;
#define CONV_T_SLOTS(BCO_, KC_)                                                  \
  if (f.bco == BCO_ && f.kc == KC_)                                              \
    return device_slots(conv3x3_t_fwd_tc_kernel<BCO_, KC_, kShift16, true>,      \
                        FwdTc<BCO_, KC_>::bytes(C));
  CONV_T_SLOTS(128, 32) CONV_T_SLOTS(128, 16) CONV_T_SLOTS(64, 32) CONV_T_SLOTS(64, 16)
#undef CONV_T_SLOTS
  return 0;
}

// The fp32 stats variant's slabs: rows of (n, h) per slab and W tiles
// (one partial per slab and W tile).
extern "C" int conv3x3_t_stats_rows(void) { return kStatsRows; }
extern "C" int conv3x3_t_stats_wtiles(int W) { return (W + kBW - 1) / kBW; }

// conv3x3_t_fwd plus the f32 per-channel sums of the rounded y: sums
// [2*CO] = sum over (n, h, w) of y, then of y*y. part f32 [parts, 2*CO]
// scratch: bf16 one row per block (parts = blocks); fp32 one per slab and
// W tile (conv3x3_t_stats_rows, conv3x3_t_stats_wtiles).
extern "C" int conv3x3_t_fwd_stats(int dtype, const void* x, const void* wt,
                                   const void* bias, void* y, void* part,
                                   void* sums, int N, int H, int C, int CO,
                                   int W, int blocks, int per, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  int parts;
  if (dtype == 0) {
    err = launch_fwd_f32<true>((const float*)x, (const float*)wt,
                               (const float*)bias, (float*)y, (float*)part, N,
                               H, C, CO, W, st);
    parts = (N * H + kStatsRows - 1) / kStatsRows * ((W + kBW - 1) / kBW);
  } else if (dtype == 1) {
    err = launch_fwd_bf16<true>((const bf16*)x, (const bf16*)wt, (const bf16*)bias, (bf16*)y,
                                (float*)part, N, H, C, CO, W, blocks, per, st);
    parts = blocks;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)reduce_partials((const float*)part, (float*)sums, parts, 2 * CO, st);
}

// The wgrad's plan for (dtype, C, CO): which 0 -> its (co, k) tiles (the
// blocks of one slab), 1 -> the blocks resident on the current device at
// once. 0 where the shape is not supported.
extern "C" int conv3x3_t_wgrad_plan(int dtype, int C, int CO, int which) {
  if (dtype == 0) {
    if (which == 0) return ((9 * C + kWT - 1) / kWT) * ((CO + kWT - 1) / kWT);
    return device_slots(conv3x3_t_wgrad_kernel, 0);
  }
  if (dtype != 1 || C % kKC) return 0;
  if (wgrad_kc(C) == 32) {
    if (which == 0) return (C / 32) * ((CO + 127) / 128);
    return device_slots(conv3x3_t_wgrad_tc_kernel<128, 32, kShift16>, WgTc<128, 32>::kBytes);
  }
  if (which == 0) return (C / 16) * ((CO + 255) / 256);
  return device_slots(conv3x3_t_wgrad_tc_kernel<256, 16, kShift16>, WgTc<256, 16>::kBytes);
}

// x [N,H,C,W], g [N,H,CO,W] of dtype (bf16: C a multiple of 16); part f32
// [slabs, CO*9C + CO] (scratch); out f32 [CO*9C + CO] = dwT [CO, 9C]
// followed by db [CO]. Slab s sums rows s*rows_per_slab onwards.
extern "C" int conv3x3_t_wgrad(int dtype, const void* x, const void* g,
                               void* part, void* out, int N, int H, int C,
                               int CO, int W, int slabs, int rows_per_slab,
                               void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    const dim3 grid((9 * C + kWT - 1) / kWT, (CO + kWT - 1) / kWT, slabs);
    conv3x3_t_wgrad_kernel<<<grid, kThreads, 0, st>>>(
        (const float*)x, (const float*)g, (float*)part, N * H, H, C, CO, W,
        rows_per_slab);
  } else if (dtype == 1) {
    const cudaError_t err = launch_wgrad_bf16((const bf16*)x, (const bf16*)g, (float*)part, N,
                                              H, C, CO, W, slabs, rows_per_slab, st);
    if (err != cudaSuccess) return (int)err;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)reduce_partials((const float*)part, (float*)out, slabs,
                              CO * 9 * C + CO, st);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
