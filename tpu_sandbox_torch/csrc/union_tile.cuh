// The union tap tile of the sparse-tap conv1 and the weight gradient built
// on it, shared by conv5_t.cu (the conv and its wgrad) and conv1_tail_t.cu
// (the wgrad fed by the BN tail's dy computed on chip).
//
// conv1 runs on the space-to-depth image x [N, H4, 16, W4], channel p*4+q
// the in-block position (p, q) of a 4x4 block. Seen from an output block,
// the original 5x5 conv reads the full-resolution rows m' and columns j in
// -2..5 around it: 8 x 8 = 64 taps, the union tile
//   T[(m'+2)*8 + (j+2), w4] =
//       x[n, h4 + floor(m'/4), (m' mod 4)*4 + (j mod 4), w4 + floor(j/4)],
// zero outside the image, with floor and mod toward -inf (as Python's):
// m'+4 and j+4 are never negative, so the code divides those. Each of the
// 16*f1 output channels (a', b', co) needs 25 of the 64 rows, so one
// [CO, 64] x [64, W] product per output row computes the whole row, with
// the 5x5 kernel scattered into W1 [CO, 64] (ops/conv5_t.py).
//
// The f32 bodies stage the x halo strip a block needs once in shared
// memory, 3 block rows x 16 channels x (its W tile + 2) columns, and read
// the tile from it by index arithmetic: tile row t is strip row rr,
// channel ch, shifted by dc columns (union_tap). The bf16 bodies stage the
// same rows through a cp.async ring (mma.cuh) and build their tensor-core
// fragments from them directly: the tile is never written out.
//
// The weight gradient dW1[c, t] = sum_{n,h,w} g[n,h,c,w] * T[t, w] and
// db[c] = sum g runs as one kernel template over a Loader that provides
// the cotangent rows: GradRows (conv5_t.cu) reads g from device memory,
// TailDy (conv1_tail_t.cu) computes it from the BN tail's inputs. Blocks
// write partials [CO*64 + CO] (f32: one per slab of rows and 64-channel
// tile; bf16: one per persistent block) and reduce_partials (reduce.cuh)
// adds them in a fixed order. No float atomics: two runs are bitwise
// equal.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "dtypes.cuh"
#include "mma.cuh"

namespace {

constexpr int kNT = 64;          // union tile rows
constexpr int kC16 = 16;         // input channels: the 4x4 block
constexpr int kUThreads = 256;

// Tile row t reads strip row rr (block row h4 + rr - 1), channel ch, at
// column w4 + dc - 1.
__device__ __forceinline__ void union_tap(int t, int& rr, int& ch, int& dc) {
  const int m4 = t / 8 + 2, j4 = t % 8 + 2;    // m' + 4 and j + 4
  rr = m4 / 4;
  dc = j4 / 4;
  ch = (m4 % 4) * 4 + j4 % 4;
}

// strip[(rr*16 + c)*SW + j] = x[n, h+rr-1, c, w0-1+j] for j < SW, zero
// outside the image. Neighbouring threads read neighbouring columns.
template <typename T>
__device__ __forceinline__ void stage_strip(const T* __restrict__ x, T* strip, int n,
                                            int h, int H, int W, int w0, int SW) {
  const T zero = from_f<T>(0.f);
  for (int i = threadIdx.x; i < 3 * kC16 * SW; i += blockDim.x) {
    const int j = i % SW, rc = i / SW, c = rc % kC16, rr = rc / kC16;
    const int hh = h + rr - 1, ww = w0 - 1 + j;
    strip[i] = (hh >= 0 && hh < H && ww >= 0 && ww < W)
                   ? x[((size_t)(n * H + hh) * kC16 + c) * W + ww]
                   : zero;
  }
}

// ---- the weight gradient --------------------------------------------------
//
// The f32 body takes a Loader with
//   int chan(int i): the channel of the block's tile row i (< 64), or -1;
//   void load(T* tile, int ld, int r, int w0, int WB): every thread of the
//     block fills tile[i*ld + wl] = g[r, chan(i), w0 + wl] for i < 64 and
//     wl < WB, zero where there is no channel or w0 + wl >= W,
// and writes, per slab, part[slab * (CO*64 + CO) + chan*64 + t] = dW1, then
// db at CO*64 + chan.
//
// The bf16 body takes a Loader with
//   kExtra: rows of its second staged tensor (0 for none);
//   stage<MODE>(a, e, r, w0, ar): issues the cp.async copies (stage_rows,
//     mma.cuh) of the cotangent's source rows for row r, columns w0 ..
//     w0+63: ar rows into a (pitch kWgAP; rows >= CO zero), kExtra rows
//     into e;
//   Cache, init(Cache&): what a thread keeps in registers for prepare
//     over the whole kernel;
//   prepare<MODE>(cache, a, e, r, w0): turns the landed rows into the
//     cotangent g[r, c, w0 + j] at a[c*kWgAP + j + shift of row c], zero at
//     w0 + j >= W (run by every thread, after a barrier that follows the
//     copies);
//   a_row(r, c): the address whose 16-byte offset is row c's shift.

constexpr int kWgWB = 64;             // bf16: columns a unit
constexpr int kWgMaxCO = 256;         // bf16: channels a block (all of CO)
constexpr int kWgAP = kWgWB + 8;      // cotangent row pitch (144 bytes)
constexpr int kWgXN = kWgWB + 16;     // x columns staged: w0-8 .. w0+71
constexpr int kWgXP = kWgXN + 8;      // x row pitch (176 bytes)
constexpr int kWgStages = 4;

template <class Loader>
struct WgTc {
  static constexpr int kStage = kWgMaxCO * kWgAP + Loader::kExtra * kWgAP + 3 * kC16 * kWgXP;
  static constexpr size_t kBytes = sizeof(__nv_bfloat16) * kWgStages * kStage;
};

// bf16 on the tensor cores (mma.sync m16n8k16, f32 accumulation). One
// block covers all of CO (up to 256) and the 64 taps, over a contiguous
// run of (row, 64-column) units (ops/conv_t.py fwd_units): per unit the
// x strip is staged and its taps read once, whatever CO is. 8 warps of
// 64 channels x 32 taps (4 x 4 mma tiles, 64 f32 accumulators a thread);
// warps past CO idle. The cotangent rows and the three x block rows of a
// unit come through a 4-stage cp.async ring of shifted 16-byte chunks
// (stage_rows): rows of 1500 bytes land at their start's offset mod 16,
// and the fragments are built from 32-bit loads at that shift. The k
// order inside a 16-pixel step is permuted alike in A and B (a thread's k
// 2t, 2t+1, 2t+8, 2t+9 are pixels 4t .. 4t+3), so a thread's pixels are
// contiguous: an A fragment is two words of a cotangent row, a B fragment
// three words of the tap's x row, shifted by the tap's column offset
// (and the row's shift) with two byte-permutes. db is one more mma per A
// fragment against a B of ones, in the warps of taps 0-31. The Loader's
// prepare runs one unit ahead of the products, so a unit's cotangent is
// ready at its barrier: one barrier a unit. One partial per block; no
// float atomics.
template <class Loader, int MODE>
__global__ void __launch_bounds__(kUThreads, 1)
union_wgrad_tc_kernel(const __nv_bfloat16* __restrict__ x, Loader ld,
                      float* __restrict__ part, int H, int CO, int W, int units, int per) {
  using P = WgTc<Loader>;
  constexpr int NS = kWgStages;
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* sm = reinterpret_cast<__nv_bfloat16*>(smem);

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int gq = lane / 4, t = lane % 4;
  const int wco = warp / 2, wtp = warp % 2;     // 64 channels x 32 taps
  const bool warp_ok = wco * 64 < CO;
  const int ar = (CO + 63) / 64 * 64;           // cotangent rows staged
  const int wsteps = (W + kWgWB - 1) / kWgWB;
  const int u_begin = blockIdx.x * per, u_end = min(units, u_begin + per);
  const int nu = max(0, u_end - u_begin);

  auto slot = [&](int i) { return sm + (i % NS) * P::kStage; };
  auto xrows = [&](int i) { return slot(i) + (kWgMaxCO + Loader::kExtra) * kWgAP; };
  auto issue = [&](int i) {          // unit i into slot i % NS
    if (i < nu) {
      const int u = u_begin + i, r = u / wsteps, w0 = (u - r * wsteps) * kWgWB;
      const int n = r / H, h = r - n * H;
      ld.template stage<MODE>(slot(i), slot(i) + kWgMaxCO * kWgAP, r, w0, ar);
#pragma unroll
      for (int rr = 0; rr < 3; ++rr) {
        const int hh = h + rr - 1;
        const bool ok = hh >= 0 && hh < H;
        stage_rows<MODE, kWgXN>(xrows(i) + rr * kC16 * kWgXP, kWgXP,
                                ok ? x + (size_t)(n * H + hh) * kC16 * W : x, kC16,
                                ok ? kC16 : 0, W, w0 - 8);
      }
    }
    cp_async_commit();
  };
  typename Loader::Cache cache;
  ld.init(cache);
  auto prepare = [&](int i) {
    if (i < nu) {
      const int u = u_begin + i, r = u / wsteps, w0 = (u - r * wsteps) * kWgWB;
      ld.template prepare<MODE>(cache, slot(i), slot(i) + kWgMaxCO * kWgAP, r, w0);
    }
  };

  // this lane's four taps (one per 8-tap mma tile): strip row and column
  // offset
  int xrow[4], xdc[4];
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    int rr, ch, dc;
    union_tap(wtp * 32 + nt * 8 + gq, rr, ch, dc);
    xrow[nt] = rr * kC16 + ch;
    xdc[nt] = dc;
  }

  float acc[4][4][4], dacc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      dacc[i][k] = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j][k] = 0.f;
    }
  const uint32_t ones = 0x3F803F80u;   // two bf16 1.0

  for (int i = 0; i < NS - 1; ++i) issue(i);
  cp_async_wait<NS - 2>();           // unit 0
  __syncthreads();
  prepare(0);
  for (int i = 0; i < nu; ++i) {
    cp_async_wait<NS - 3>();         // unit i+1 (this thread's copies)
    __syncthreads();                 // ... everyone's; prepare(i) and products of i-1 done
    issue(i + NS - 1);               // into the slot of unit i-1
    prepare(i + 1);
    if (!warp_ok) continue;
    const int u = u_begin + i, r = u / wsteps, w0 = (u - r * wsteps) * kWgWB;
    const int n = r / H, h = r - n * H;
    const uint32_t* aw = reinterpret_cast<const uint32_t*>(slot(i));
    const uint32_t* xw = reinterpret_cast<const uint32_t*>(xrows(i));
    int ga[4][2], xe[4];
#pragma unroll
    for (int mi = 0; mi < 4; ++mi)
#pragma unroll
      for (int hi = 0; hi < 2; ++hi) {
        const int c = wco * 64 + mi * 16 + hi * 8 + gq;
        const int sh = c < CO ? row_shift<MODE>(ld.a_row(r, c)) : 0;
        ga[mi][hi] = (c * kWgAP + 4 * t + sh) / 2;   // word of pixels 4t, 4t+1
      }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      // tap column w0 + j + dc - 1 lands at e = j + dc + 7 (+ the row's shift)
      const int rr = xrow[nt] / kC16, hh = min(max(h + rr - 1, 0), H - 1);
      const int sh = row_shift<MODE>(x + ((size_t)(n * H + hh) * kC16 + xrow[nt] % kC16) * W);
      xe[nt] = xrow[nt] * kWgXP + 4 * t + xdc[nt] + 7 + sh;
    }
#pragma unroll
    for (int ks = 0; ks < kWgWB / 16; ++ks) {
      uint32_t a[4][4];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        a[mi][0] = aw[ga[mi][0] + ks * 8];
        a[mi][1] = aw[ga[mi][1] + ks * 8];
        a[mi][2] = aw[ga[mi][0] + ks * 8 + 1];
        a[mi][3] = aw[ga[mi][1] + ks * 8 + 1];
      }
      if (wtp == 0) {
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) mma_bf16(dacc[mi], a[mi], ones, ones);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int e = xe[nt] + ks * 16, q = e >> 1;
        // column w0 - 1 < 0 (tap column offset 0, first pixel of the row)
        // holds the previous row's tail under kShift16: masked
        const uint32_t v0 = (w0 == 0 && ks == 0 && t == 0 && xdc[nt] == 0) ? 0u : xw[q];
        const uint32_t v1 = xw[q + 1], v2 = xw[q + 2];
        const uint32_t sel = (e & 1) ? 0x5432u : 0x3210u;
        const uint32_t b0 = __byte_perm(v0, v1, sel), b1 = __byte_perm(v1, v2, sel);
#pragma unroll
        for (int mi = 0; mi < 4; ++mi) mma_bf16(acc[mi][nt], a[mi], b0, b1);
      }
    }
  }
  cp_async_wait<0>();

  if (!warp_ok) return;
  float* out = part + (size_t)blockIdx.x * ((size_t)CO * kNT + CO);
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int c = wco * 64 + mi * 16 + hi * 8 + gq;
      if (c >= CO) continue;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
        *reinterpret_cast<float2*>(out + (size_t)c * kNT + wtp * 32 + nt * 8 + 2 * t) =
            make_float2(acc[mi][nt][2 * hi], acc[mi][nt][2 * hi + 1]);
      if (wtp == 0 && t == 0) out[(size_t)CO * kNT + c] = dacc[mi][2 * hi];
    }
}

constexpr int kWfWB = 32;             // f32: columns per step

struct WfSmem {
  float g[kNT][kWfWB + 1];
  float strip[3 * kC16 * (kWfWB + 2)];
};

// f32 on the CUDA cores: 16 x 16 threads each hold a 4 x 4 register tile
// of the 64 x 64 (row, t) tile and read their four taps straight from the
// strip (offsets fixed per thread), so there is no tile to build.
template <class Loader>
__global__ void __launch_bounds__(kUThreads)
union_wgrad_f32_kernel(const float* __restrict__ x, Loader ld, float* __restrict__ part,
                       int NH, int H, int CO, int W, int rows_per_slab) {
  __shared__ WfSmem s;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const int slab = blockIdx.x;
  int off[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    int rr, ch, dc;
    union_tap(tx + 16 * j, rr, ch, dc);
    off[j] = (rr * kC16 + ch) * (kWfWB + 2) + dc;
  }

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
    for (int w0 = 0; w0 < W; w0 += kWfWB) {
      ld.load(&s.g[0][0], kWfWB + 1, r, w0, kWfWB);
      stage_strip(x, s.strip, n, h, H, W, w0, kWfWB + 2);
      __syncthreads();
      if (tid < kNT) {
        for (int wl = 0; wl < kWfWB; ++wl) dbacc += s.g[tid][wl];
      }
#pragma unroll 8
      for (int wl = 0; wl < kWfWB; ++wl) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = s.g[ty * 4 + i][wl];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = s.strip[off[j] + wl];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

  float* out = part + (size_t)slab * ((size_t)CO * kNT + CO);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int c = ld.chan(ty * 4 + i);
    if (c < 0) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) out[(size_t)c * kNT + tx + 16 * j] = acc[i][j];
  }
  if (tid < kNT) {
    const int c = ld.chan(tid);
    if (c >= 0) out[(size_t)CO * kNT + c] = dbacc;
  }
}

// One launch of the wgrad over grid (slabs, tiles), tiles = the number of
// 64-row tiles of the Loader: f32 on the CUDA cores, bf16 on the tensor
// cores.
template <class Loader>
cudaError_t launch_union_wgrad(const float* x, Loader ld, float* part, int NH, int H,
                               int CO, int W, int slabs, int rows_per_slab, int tiles,
                               cudaStream_t st) {
  union_wgrad_f32_kernel<Loader><<<dim3(slabs, tiles), kUThreads, 0, st>>>(
      x, ld, part, NH, H, CO, W, rows_per_slab);
  return cudaGetLastError();
}

// Units of the bf16 wgrad: (row, 64-column step) pairs.
inline int union_wgrad_units(int NH, int W) { return NH * ((W + kWgWB - 1) / kWgWB); }

// The bf16 wgrad over ``blocks`` blocks of ``per`` units each (covering
// union_wgrad_units), one partial [CO*64 + CO] per block; ``bases`` ORs
// the addresses of every tensor staged (stage_mode).
template <class Loader>
cudaError_t launch_union_wgrad(const __nv_bfloat16* x, Loader ld, float* part, int NH,
                               int H, int CO, int W, int blocks, int per, uintptr_t bases,
                               cudaStream_t st) {
  const int units = union_wgrad_units(NH, W);
  if (CO > kWgMaxCO || blocks <= 0 || per <= 0 || (long long)blocks * per < units)
    return cudaErrorInvalidValue;
  constexpr size_t bytes = WgTc<Loader>::kBytes;
  auto launch = [&](auto kernel) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
    kernel<<<blocks, kUThreads, bytes, st>>>(x, ld, part, H, CO, W, units, per);
    return cudaGetLastError();
  };
  if (stage_mode(bases, W) == kShift16) return launch(union_wgrad_tc_kernel<Loader, kShift16>);
  return launch(union_wgrad_tc_kernel<Loader, kElem>);
}

template <class Loader>
int union_wgrad_slots() {
  return device_slots(union_wgrad_tc_kernel<Loader, kShift16>, WgTc<Loader>::kBytes);
}

}  // namespace
