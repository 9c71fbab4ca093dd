// Sparse-tap conv1 of the transposed space-to-depth plan for Hopper
// (sm_90a): the 5x5 conv of the one-channel image, run on its 4x4-blocked
// form x [N, H4, 16, W4] as one [CO, 64] x [64, W] product per output row
// against the union tap tile (union_tile.cuh), its variant with fused BN
// statistics, and its weight+bias gradient.
//
// Replaces the Pallas TPU kernels of tpu_sandbox/ops/pallas_conv5_t.py:
//   conv1_s2d_t_fwd        <- _fwd_kernel (:123), launched by _conv_call
//                             (:207/230) for conv1_s2d_t (:300)
//   conv1_s2d_t_fwd_stats  <- _fwd_stats_kernel (:130), the stats branch of
//                             _conv_call for conv1_s2d_t_stats (:366)
//   conv1_s2d_t_wgrad      <- _wgrad_kernel (:154), launched by
//                             conv1_s2d_t_wgrad (:309, pallas_call at :321)
//
// What bounds them on the H100, at the 3000x3000 batch-5 shapes (x
// [5,750,16,750], W1 [256,64], y [5,750,256,750], bf16): each moves x
// (90 MB) and y or g (1.44 GB) once, 1.53 GB -> 0.457 ms at 3.35 TB/s;
// the executed 2*N*H4*W4*256*64 = 92.2 GFLOP take 0.093 ms at 989 TFLOP/s
// bf16. All three are bytes-bound, and almost all of the bytes are y's
// store (the forward) or g's load (the wgrad). The scattered-3x3 form of
// the same conv (conv_t.cu) contracts 144 taps where this one contracts 64.
//
// What the bf16 bodies do about it (below and in union_tile.cuh): one
// persistent block per SM covers all of CO, so x is staged once per unit
// of (row, 64 columns) whatever CO is; the rows come through a cp.async
// ring of shifted 16-byte chunks (rows of 1500 bytes are only 4-byte
// aligned, too little for TMA's 16-byte strides); the tensor-core
// fragments are read straight from the staged rows (no tap tile is
// built); y leaves through a staging buffer in 16-byte stores, and the BN
// sums come from the accumulators' rounded values in registers. The fp32
// bodies (CUDA cores, slabs of rows) are the tight check against the plain
// versions; only the bf16 bodies are tuned.
//
// Stats: BN's per-channel sum and sum of squares of the ROUNDED y are an
// epilogue of the forward (one partial per block, bf16, or per slab and W
// tile, fp32), added in a fixed order by reduce_partials (reduce.cuh). The
// stats variant is the same kernel as the forward, so its y is the
// forward's bit for bit.
//
// Wgrad: union_tile.cuh's kernels with g read from device memory
// (GradRows), partials added by reduce_partials in a fixed order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma.cuh"
#include "reduce.cuh"
#include "union_tile.cuh"

namespace {

constexpr int kThreads = kUThreads;
constexpr int kBCO = 128;        // fp32: output channels per block
constexpr int kBW = 64;          // fp32: output columns per block
constexpr int kSW = kBW + 2;     // fp32: strip columns
constexpr int kSlabRows = 8;     // fp32: rows of (n, h) per block

// fp32 forward on the CUDA cores, grid (slabs, W tiles, CO tiles): thread
// (tx, ty) holds channels ty*8 .. ty*8+7 at columns tx + 16*j. With STATS
// the 16 threads of a channel row (lanes 0-15 or 16-31 of a warp) combine
// their sums by a fixed shuffle tree.
template <bool STATS>
__global__ void __launch_bounds__(kThreads)
conv1_fwd_f32_kernel(const float* __restrict__ x, const float* __restrict__ w1,
                     const float* __restrict__ bias, float* __restrict__ y,
                     float* __restrict__ part, int NH, int H, int CO, int W) {
  constexpr int TCO = kBCO / 16;
  __shared__ float ws[kNT][kBCO];                 // [t][co]
  __shared__ float strip[3 * kC16 * kSW];
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int w0 = blockIdx.y * kBW;
  const int co0 = blockIdx.z * kBCO;
  const int r_begin = blockIdx.x * kSlabRows;
  const int r_end = min(NH, r_begin + kSlabRows);

  for (int i = tid; i < kNT * kBCO; i += kThreads) {
    const int co = i / kNT, t = i % kNT, gco = co0 + co;
    ws[t][co] = gco < CO ? w1[(size_t)gco * kNT + t] : 0.f;
  }

  float st[TCO], st2[TCO];
#pragma unroll
  for (int i = 0; i < TCO; ++i) st[i] = st2[i] = 0.f;

  for (int row = r_begin; row < r_end; ++row) {
    const int h = row % H, n = row / H;
    __syncthreads();                              // the strip is free
    stage_strip(x, strip, n, h, H, W, w0, kSW);
    __syncthreads();
    float acc[TCO][4];
#pragma unroll
    for (int i = 0; i < TCO; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
    for (int t = 0; t < kNT; ++t) {
      int rr, ch, dc;
      union_tap(t, rr, ch, dc);
      const float* srow = strip + (rr * kC16 + ch) * kSW + dc + tx;
      float a[TCO], b[4];
#pragma unroll
      for (int i = 0; i < TCO; ++i) a[i] = ws[t][ty * TCO + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = srow[16 * j];
#pragma unroll
      for (int i = 0; i < TCO; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < TCO; ++i) {
      const int co = co0 + ty * TCO + i;
      if (co >= CO) continue;
      const float bv = bias[co];
      float* yrow = y + ((size_t)row * CO + co) * W;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int w = w0 + tx + 16 * j;
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
#pragma unroll
    for (int i = 0; i < TCO; ++i)
#pragma unroll
      for (int off = 8; off > 0; off /= 2) {
        st[i] += __shfl_xor_sync(0xffffffffu, st[i], off);
        st2[i] += __shfl_xor_sync(0xffffffffu, st2[i], off);
      }
    float* out = part + ((size_t)blockIdx.x * gridDim.y + blockIdx.y) * 2 * CO;
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

// ---- bf16 forward on the tensor cores (mma.sync m16n8k16, f32 accumulation)
//
// A persistent block covers all of CO (up to 256) and walks a contiguous
// run of (row, 64-column) units (ops/conv_t.py fwd_units). The weight
// lives in registers as mma fragments for the whole kernel: 8 warps of 64
// channels x 32 columns (4 x 4 mma tiles), warps past CO idle. Per unit:
// 1. the three x block rows (16 channels, columns w0-8 .. w0+71 each)
//    come through a 4-stage cp.async ring of shifted 16-byte chunks
//    (stage_rows, mma.cuh), three units ahead;
// 2. one shared-memory transform turns them into [block row][column][16
//    channels] (byte-permutes of 32-bit loads at each row's shift), one
//    unit ahead. Taps 2p and 2p+1 share their block row and column offset
//    and are channels 2q, 2q+1 (union_tap), so a B register (two
//    consecutive taps at one column) is one aligned 32-bit load of that
//    buffer, at the column shifted by the tap's offset: no tap tile is
//    built, and the 0-2 column shifts cost nothing. A column is 10 words
//    (16 channels and 4 of padding), so a warp's B loads are free of bank
//    conflicts;
// 3. 64 mma a warp, the bias added in f32 to the accumulators and
//    rounded once;
// 4. the rounded tile goes to a shared staging slot (three, in turn),
//    each row at its global start's offset mod 16, and the next
//    iteration writes it out: a thread a channel row, in one bulk copy
//    (cp.async.bulk: the copy engine moves it, no registers). A row's
//    1500 bytes put a tile's edge inside a 16-byte chunk, so a unit ends
//    each row at its last 16-byte boundary and the block's next unit (the
//    row's next 64 columns) copies the rest in front of its own tile:
//    only the ends of rows and of a block's run take 2-byte stores. On the
//    H100, 16-byte chunks written in two parts by two units, with the
//    instructions that split them, took y's store about twice its time.
// One barrier a unit: the loads of unit p+3, the transform of p+1, the
// products of p and the stores of p-1 are in flight together.
// STATS: each thread adds its rounded outputs (and their squares) per
// channel row in registers over all its units, in order; the four lanes
// of a row combine by a fixed shuffle tree, the two column warps in order
// through shared memory, and the block writes one partial row of [2*CO].
// The plain forward is the same kernel without STATS, so the two y agree
// bit for bit.
// What holds it back now: every warp runs every phase of a unit in turn,
// so the loads, the transform, the products, the staging and the store
// issue of one block add up rather than overlap. A split into two
// warpgroups (products and staging; loads, transform and stores) with
// named barriers measured slower on the H100.

using bf16 = __nv_bfloat16;

constexpr int kFW = 64;                  // columns a unit
constexpr int kFMaxCO = 256;             // channels a block: all of CO
constexpr int kFXN = kFW + 16;           // x columns staged: w0-8 .. w0+71
constexpr int kFRP = kFXN + 8;           // raw row pitch (176 bytes)
constexpr int kFJX = kFW + 4;            // transformed columns w0-2 .. w0+65
constexpr int kFPW = 10;                 // words a transformed column
constexpr int kFSP = kFW + 16;           // staging row pitch (160 bytes)
constexpr int kFStages = 4;
constexpr int kFRaw = 3 * kC16 * kFRP;   // elements a raw stage
constexpr int kFXt = 3 * kFJX * kFPW;    // words a transformed buffer
static_assert(kFW == kWgWB, "one unit width for the forward and the wgrad");
constexpr size_t kFwdTcBytes = sizeof(bf16) * kFStages * kFRaw + 4 * 2 * kFXt +
                               sizeof(bf16) * 3 * kFMaxCO * kFSP;

__device__ __forceinline__ uint32_t pack_bf16(const bf16* p) {
  return (uint32_t)__bfloat16_as_ushort(p[0]) | ((uint32_t)__bfloat16_as_ushort(p[1]) << 16);
}

template <int MODE, bool STATS>
__global__ void __launch_bounds__(kThreads, 1)
conv1_fwd_tc_kernel(const bf16* __restrict__ x, const bf16* __restrict__ w1,
                    const bf16* __restrict__ bias, bf16* __restrict__ y,
                    float* __restrict__ part, int H, int CO, int W, int units, int per) {
  constexpr int NS = kFStages;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* raw = reinterpret_cast<bf16*>(smem);                  // [NS][48][kFRP]
  uint32_t* xt = reinterpret_cast<uint32_t*>(raw + NS * kFRaw);  // [2][3][kFJX][kFPW]
  bf16* stg = reinterpret_cast<bf16*>(xt + 2 * kFXt);         // [3][kFMaxCO][kFSP]

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, t = lane % 4;
  const int wco = warp / 2, wcol = warp % 2;    // 64 channels x 32 columns
  const bool warp_ok = wco * 64 < CO;
  const int wtiles = (W + kFW - 1) / kFW;
  const int u_begin = blockIdx.x * per, u_end = min(units, u_begin + per);
  const int nu = max(0, u_end - u_begin);

  // A fragments of rows wco*64 + mi*16 + (g, g+8), taps ks*16 + (2t, 2t+8)
  uint32_t af[4][4][4];
  float bv[4][2];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int co = wco * 64 + mi * 16 + hi * 8 + g;
      bv[mi][hi] = co < CO ? __bfloat162float(bias[co]) : 0.f;
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const bf16* wr = w1 + (size_t)co * kNT + ks * 16 + 2 * t;
        af[mi][ks][hi] = co < CO ? pack_bf16(wr) : 0u;
        af[mi][ks][2 + hi] = co < CO ? pack_bf16(wr + 8) : 0u;
      }
    }
  }
  // B: pair p = ks*8 + t + 4*hb holds taps 2p, 2p+1; its word of column n
  // is boff + n * kFPW
  int boff[4][2];
#pragma unroll
  for (int ks = 0; ks < 4; ++ks)
#pragma unroll
    for (int hb = 0; hb < 2; ++hb) {
      int rr, ch, dc;
      union_tap(2 * (ks * 8 + t + 4 * hb), rr, ch, dc);
      boff[ks][hb] = (rr * kFJX + dc + 1) * kFPW + ch / 2;
    }

  auto unit = [&](int p, int& row, int& w0) {
    const int u = u_begin + p;
    row = u / wtiles;
    w0 = (u - row * wtiles) * kFW;
  };
  auto issue = [&](int p) {          // unit p's x rows into raw slot p % NS
    if (p < nu) {
      int row, w0;
      unit(p, row, w0);
      const int n = row / H, h = row - n * H;
#pragma unroll
      for (int rr = 0; rr < 3; ++rr) {
        const int hh = h + rr - 1;
        const bool ok = hh >= 0 && hh < H;
        stage_rows<MODE, kFXN>(raw + (p % NS) * kFRaw + rr * kC16 * kFRP, kFRP,
                               ok ? x + (size_t)(n * H + hh) * kC16 * W : x, kC16,
                               ok ? kC16 : 0, W, w0 - 8);
      }
    }
    cp_async_commit();
  };
  // raw slot p % NS -> xt[p % 2]: column w = w0 - 2 + j of channels 2cp,
  // 2cp+1 to word (rr*kFJX + j)*kFPW + cp. A warp takes 4 channel pairs x
  // 8 column pairs; columns left of the image are zeroed (under kShift16
  // the raw row holds the previous row's tail there).
  auto transform = [&](int p) {
    if (p >= nu) return;
    int row, w0;
    unit(p, row, w0);
    const int n = row / H, h = row - n * H;
    uint32_t* xd = xt + (p % 2) * kFXt;
    for (int i = warp; i < 3 * 2 * 5; i += kThreads / 32) {
      const int rr = i / 10, cp = ((i / 5) % 2) * 4 + lane / 8, pp = (i % 5) * 8 + lane % 8;
      if (pp >= kFJX / 2) continue;
      const int hh = min(max(h + rr - 1, 0), H - 1);
      const bf16* x0 = x + ((size_t)(n * H + hh) * kC16 + 2 * cp) * W;
      const bf16* r0 = raw + (p % NS) * kFRaw + (rr * kC16 + 2 * cp) * kFRP + 6;
      uint32_t a = *reinterpret_cast<const uint32_t*>(r0 + row_shift<MODE>(x0) + 2 * pp);
      uint32_t b = *reinterpret_cast<const uint32_t*>(r0 + kFRP + row_shift<MODE>(x0 + W) + 2 * pp);
      if (w0 - 2 + 2 * pp < 0) a = b = 0u;
      xd[(rr * kFJX + 2 * pp) * kFPW + cp] = __byte_perm(a, b, 0x5410);
      xd[(rr * kFJX + 2 * pp + 1) * kFPW + cp] = __byte_perm(a, b, 0x7632);
    }
  };
  // staging slot p % 3 -> y, a thread a channel row. Row co of the slot
  // holds element w0 + r of the row at 8 + sh + r, sh the row's 16-byte
  // shift at w0, so its 16-byte chunks are those of y. Where the block
  // staged the row's previous 64 columns (unit p-1, slot (p-1) % 3), the
  // thread copies their last sh elements in front of its own, and the
  // unit writes from the 16-byte boundary at or before w0; where the
  // block goes on along the row, it stops at the last boundary at or
  // before its end and leaves the rest to unit p+1. The whole chunks go
  // in one bulk copy; only the ends of rows and of a block's run take
  // 2-byte stores.
  auto write_out = [&](int p) {
    const int co = tid;
    if (co >= CO) return;
    int row, w0;
    unit(p, row, w0);
    const int seg = min(kFW, W - w0);
    bf16* yr = y + ((size_t)row * CO + co) * W + w0;
    const int sh = (int)((reinterpret_cast<uintptr_t>(yr) >> 1) & 7);
    bf16* s = stg + ((p % 3) * kFMaxCO + co) * kFSP + 8 + sh;
    int lo = 0;
    if (p > 0 && w0 > 0) {
      // the chunk at slot index 8 takes its first sh elements from the
      // previous slot's chunk at index 72 (elements 64-sh .. 63 of unit p-1)
      uint4* d = reinterpret_cast<uint4*>(s - sh);
      const uint4 pv = *reinterpret_cast<const uint4*>(
          stg + (((p + 2) % 3) * kFMaxCO + co) * kFSP + 8 + kFW);
      uint4 v = *d;
      const uint32_t* pw = reinterpret_cast<const uint32_t*>(&pv);
      uint32_t* vw = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        if (2 * m + 1 < sh) vw[m] = pw[m];
        else if (2 * m < sh) vw[m] = __byte_perm(pw[m], vw[m], 0x7610);
      }
      *d = v;
      lo = -sh;
    }
    const int hi = p + 1 < nu && w0 + seg < W ? seg - ((sh + seg) & 7) : seg;
    const int a = min(hi, lo + ((8 - ((sh + lo) & 7)) & 7));   // first boundary
    const int b = max(a, hi - ((sh + hi) & 7));                 // last boundary
    for (int r = lo; r < a; ++r) yr[r] = s[r];
    if (b > a) {
      fence_proxy_async();
      bulk_store(yr + a, s + a, 2 * (b - a));
    }
    for (int r = b; r < hi; ++r) yr[r] = s[r];
  };

  float st[4][2], st2[4][2];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi) st[mi][0] = st[mi][1] = st2[mi][0] = st2[mi][1] = 0.f;

  for (int p = 0; p < NS; ++p) issue(p);
  cp_async_wait<NS - 1>();
  __syncthreads();
  transform(0);
  for (int p = 0; p < nu; ++p) {
    cp_async_wait<NS - 2>();         // unit p+1 (this thread's copies)
    bulk_wait_read<1>();             // the bulk copies out of slot p % 3
    __syncthreads();                 // ... everyone's; xt[p % 2]; products of p-1 done
    if (p > 0) write_out(p - 1);
    bulk_commit();
    transform(p + 1);
    issue(p + NS);
    if (!warp_ok) continue;

    float acc[4][4][4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int nj = 0; nj < 4; ++nj)
#pragma unroll
        for (int k = 0; k < 4; ++k) acc[mi][nj][k] = 0.f;
    const uint32_t* xb = xt + (p % 2) * kFXt + (wcol * 32 + g) * kFPW;
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
#pragma unroll
      for (int nj = 0; nj < 4; ++nj) {
        const uint32_t b0 = xb[boff[ks][0] + nj * 8 * kFPW];
        const uint32_t b1 = xb[boff[ks][1] + nj * 8 * kFPW];
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) mma_bf16(acc[mi][nj], af[mi][ks], b0, b1);
      }

    int row, w0;
    unit(p, row, w0);
    bf16* sb = stg + (p % 3) * kFMaxCO * kFSP;
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int co = wco * 64 + mi * 16 + hi * 8 + g;
        if (co >= CO) continue;
        const bf16* yr = y + ((size_t)row * CO + co) * W + w0;
        const int sh = (int)((reinterpret_cast<uintptr_t>(yr) >> 1) & 7);
        bf16* s = sb + co * kFSP + 8 + sh;
#pragma unroll
        for (int nj = 0; nj < 4; ++nj) {
          const int col = wcol * 32 + nj * 8 + 2 * t;
          const __nv_bfloat162 v = __floats2bfloat162_rn(acc[mi][nj][2 * hi] + bv[mi][hi],
                                                         acc[mi][nj][2 * hi + 1] + bv[mi][hi]);
          const bf16 v0 = __low2bfloat16(v), v1 = __high2bfloat16(v);
          if (sh & 1) {
            s[col] = v0;
            s[col + 1] = v1;
          } else {
            *reinterpret_cast<__nv_bfloat162*>(s + col) = v;
          }
          if (STATS) {
            const float f0 = w0 + col < W ? __bfloat162float(v0) : 0.f;
            const float f1 = w0 + col + 1 < W ? __bfloat162float(v1) : 0.f;
            st[mi][hi] += f0;
            st2[mi][hi] += f0 * f0;
            st[mi][hi] += f1;
            st2[mi][hi] += f1 * f1;
          }
        }
      }
    fence_proxy_async();             // the staged tile, for the bulk copies
  }
  bulk_wait_read<1>();
  __syncthreads();
  if (nu > 0) write_out(nu - 1);
  bulk_commit();
  bulk_wait<0>();

  if (STATS) {
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi)
#pragma unroll
        for (int off = 1; off < 4; off *= 2) {
          st[mi][hi] += __shfl_xor_sync(0xffffffffu, st[mi][hi], off);
          st2[mi][hi] += __shfl_xor_sync(0xffffffffu, st2[mi][hi], off);
        }
    cp_async_wait<0>();
    __syncthreads();                 // the raw ring is free: [2][kFMaxCO][2] sums
    float* red = reinterpret_cast<float*>(raw);
    if (warp_ok && t == 0) {
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int hi = 0; hi < 2; ++hi) {
          const int co = wco * 64 + mi * 16 + hi * 8 + g;
          red[(wcol * kFMaxCO + co) * 2] = st[mi][hi];
          red[(wcol * kFMaxCO + co) * 2 + 1] = st2[mi][hi];
        }
    }
    __syncthreads();
    float* out = part + (size_t)blockIdx.x * 2 * CO;
    for (int co = tid; co < CO; co += kThreads) {
      out[co] = red[co * 2] + red[(kFMaxCO + co) * 2];
      out[CO + co] = red[co * 2 + 1] + red[(kFMaxCO + co) * 2 + 1];
    }
  }
}

// The fp32 forward over grid (slabs, W tiles, CO tiles).
template <bool STATS>
cudaError_t launch_fwd_f32(const float* x, const float* w1, const float* bias, float* y,
                           float* part, int N, int H, int CO, int W, cudaStream_t st) {
  const dim3 grid((N * H + kSlabRows - 1) / kSlabRows, (W + kBW - 1) / kBW,
                  (CO + kBCO - 1) / kBCO);
  conv1_fwd_f32_kernel<STATS><<<grid, kThreads, 0, st>>>(x, w1, bias, y, part, N * H, H, CO,
                                                         W);
  return cudaGetLastError();
}

int fwd_units_total(int N, int H, int W) { return N * H * ((W + kFW - 1) / kFW); }

// The bf16 forward: ``blocks`` blocks of ``per`` units each, covering
// fwd_units_total.
template <bool STATS>
cudaError_t launch_fwd_bf16(const bf16* x, const bf16* w1, const bf16* bias, bf16* y,
                            float* part, int N, int H, int CO, int W, int blocks, int per,
                            cudaStream_t st) {
  const int units = fwd_units_total(N, H, W);
  if (CO > kFMaxCO || blocks <= 0 || per <= 0 || (long long)blocks * per < units)
    return cudaErrorInvalidValue;
  auto launch = [&](auto kernel) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kFwdTcBytes);
    if (err != cudaSuccess) return err;
    kernel<<<blocks, kThreads, kFwdTcBytes, st>>>(x, w1, bias, y, part, H, CO, W, units, per);
    return cudaGetLastError();
  };
  if (stage_mode((uintptr_t)x, W) == kShift16)
    return launch(conv1_fwd_tc_kernel<kShift16, STATS>);
  return launch(conv1_fwd_tc_kernel<kElem, STATS>);
}

template <bool STATS>
cudaError_t launch_fwd(int dtype, const void* x, const void* w1, const void* bias, void* y,
                       float* part, int N, int H, int CO, int W, int blocks, int per,
                       cudaStream_t st) {
  if (dtype == 0)
    return launch_fwd_f32<STATS>((const float*)x, (const float*)w1, (const float*)bias,
                                 (float*)y, part, N, H, CO, W, st);
  if (dtype == 1)
    return launch_fwd_bf16<STATS>((const bf16*)x, (const bf16*)w1, (const bf16*)bias,
                                  (bf16*)y, part, N, H, CO, W, blocks, per, st);
  return cudaErrorInvalidValue;
}

// The wgrad's cotangent rows read from g [N*H, CO, W]. f32: tile row i is
// channel blockIdx.y*64 + i. bf16: row c is channel c.
template <typename T>
struct GradRows {
  const T* g;
  int CO, W;
  static constexpr int kExtra = 0;
  __device__ int chan(int i) const {
    const int c = blockIdx.y * kNT + i;
    return c < CO ? c : -1;
  }
  __device__ void load(T* tile, int ld, int r, int w0, int WB) const {
    for (int i = threadIdx.x; i < kNT * WB; i += blockDim.x) {
      const int row = i / WB, wl = i % WB;
      const int c = blockIdx.y * kNT + row, w = w0 + wl;
      tile[row * ld + wl] =
          (c < CO && w < W) ? g[((size_t)r * CO + c) * W + w] : from_f<T>(0.f);
    }
  }
  template <int MODE>
  __device__ void stage(bf16* a, bf16*, int r, int w0, int ar) const {
    stage_rows<MODE, kWgWB>(a, kWgAP, g + (size_t)r * CO * W, ar, CO, W, w0);
  }
  struct Cache {};
  __device__ void init(Cache&) const {}
  template <int MODE>
  __device__ void prepare(const Cache&, bf16*, const bf16*, int, int) const {}
  __device__ const T* a_row(int r, int c) const { return g + ((size_t)r * CO + c) * W; }
};

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (CO <= 256). x [N,H,16,W], w1 [CO, 64]
// (the scattered 5x5 kernel, tap t = (m'+2)*8 + (j+2)), bias [CO], y
// [N,H,CO,W]; all of dtype, contiguous. bf16: ``blocks`` blocks of ``per``
// (row, 64-column) units each (conv1_s2d_t_fwd_plan), covering all N*H rows;
// fp32 ignores both.
extern "C" int conv1_s2d_t_fwd(int dtype, const void* x, const void* w1,
                               const void* bias, void* y, int N, int H, int CO, int W,
                               int blocks, int per, void* stream) {
  return (int)launch_fwd<false>(dtype, x, w1, bias, y, nullptr, N, H, CO, W, blocks, per,
                                (cudaStream_t)stream);
}

// The bf16 forward's plan: which 0 -> the columns of a unit, 1 -> its
// blocks resident on the current device at once, 2 -> the most output
// channels it takes.
extern "C" int conv1_s2d_t_fwd_plan(int which) {
  if (which == 0) return kFW;
  if (which == 1) return device_slots(conv1_fwd_tc_kernel<kShift16, true>, kFwdTcBytes);
  return which == 2 ? kFMaxCO : 0;
}

// The same for the bf16 wgrad.
extern "C" int conv1_s2d_t_wgrad_plan(int which) {
  if (which == 0) return kWgWB;
  if (which == 1) return union_wgrad_slots<GradRows<bf16>>();
  return which == 2 ? kWgMaxCO : 0;
}

// Rows of (n, h) per slab of the fp32 conv1_s2d_t_fwd_stats and its W
// tiles: the wrapper sizes ``part`` as slabs * wtiles * 2 * CO floats.
extern "C" int conv1_s2d_t_stats_rows(void) { return kSlabRows; }
extern "C" int conv1_s2d_t_stats_wtiles(int W) { return (W + kBW - 1) / kBW; }

// conv1_s2d_t_fwd plus the f32 per-channel sums of the rounded y: sums
// [2*CO] = sum over (n, h, w) of y, then of y*y. part f32 [parts, 2*CO]
// scratch: bf16 one row per block (parts = blocks); fp32 one per slab and
// W tile.
extern "C" int conv1_s2d_t_fwd_stats(int dtype, const void* x, const void* w1,
                                     const void* bias, void* y, void* part, void* sums,
                                     int N, int H, int CO, int W, int blocks, int per,
                                     void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err = launch_fwd<true>(dtype, x, w1, bias, y, (float*)part, N, H, CO, W,
                                           blocks, per, st);
  if (err != cudaSuccess) return (int)err;
  const int parts = dtype == 1 ? blocks
                               : (N * H + kSlabRows - 1) / kSlabRows * ((W + kBW - 1) / kBW);
  return (int)reduce_partials((const float*)part, (float*)sums, parts, 2 * CO, st);
}

// x [N,H,16,W], g [N,H,CO,W] of dtype; part f32 [parts, CO*64 + CO]
// (scratch); out f32 [CO*64 + CO] = dW1 [CO, 64] followed by db [CO].
// fp32: ``parts`` slabs of ``per`` rows; bf16 (CO <= 256): ``parts``
// blocks of ``per`` (row, 64-column) units (conv1_s2d_t_wgrad_plan).
extern "C" int conv1_s2d_t_wgrad(int dtype, const void* x, const void* g, void* part,
                                 void* out, int N, int H, int CO, int W, int parts, int per,
                                 void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err;
  if (dtype == 0) {
    const GradRows<float> ld{(const float*)g, CO, W};
    err = launch_union_wgrad((const float*)x, ld, (float*)part, N * H, H, CO, W, parts, per,
                             (CO + kNT - 1) / kNT, st);
  } else if (dtype == 1) {
    const GradRows<bf16> ld{(const bf16*)g, CO, W};
    err = launch_union_wgrad((const bf16*)x, ld, (float*)part, N * H, H, CO, W, parts, per,
                             (uintptr_t)x | (uintptr_t)g, st);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  if (err != cudaSuccess) return (int)err;
  return (int)reduce_partials((const float*)part, (float*)out, parts, CO * kNT + CO, st);
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
