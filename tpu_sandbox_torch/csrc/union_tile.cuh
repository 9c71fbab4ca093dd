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
// A block stages the x halo strip it needs once in shared memory, 3 block
// rows x 16 channels x (its W tile + 2) columns, and builds the tile from
// it by index arithmetic: tile row t is strip row rr, channel ch, shifted
// by dc columns. x is read once per block row, not once per tap.
//
// The weight gradient dW1[c, t] = sum_{n,h,w} g[n,h,c,w] * T[t, w] and
// db[c] = sum g runs as one kernel template over a Loader that fills the
// block's 64 cotangent rows: GradRows (conv5_t.cu) reads g from device
// memory, TailDy (conv1_tail_t.cu) computes it from the BN tail's inputs.
// Blocks own a 64-row tile of channels and a slab of (n, h) rows and write
// one partial [CO*64 + CO] per slab; reduce_partials (reduce.cuh) adds the
// partials in a fixed order. No float atomics: two runs are bitwise equal.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

#include "dtypes.cuh"

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

// tile[t*ld + j] = T[t, w0 + j] for j < BW, from a strip staged with
// SW = BW + 2.
template <typename T>
__device__ __forceinline__ void build_tile(const T* strip, T* tile, int ld, int BW) {
  for (int i = threadIdx.x; i < kNT * BW; i += blockDim.x) {
    const int t = i / BW, j = i % BW;
    int rr, ch, dc;
    union_tap(t, rr, ch, dc);
    tile[t * ld + j] = strip[(rr * kC16 + ch) * (BW + 2) + j + dc];
  }
}

// ---- the weight gradient --------------------------------------------------
//
// A Loader has
//   int chan(int i): the channel of the block's tile row i (< 64), or -1;
//   void load(T* tile, int ld, int r, int w0, int WB): every thread of the
//     block fills tile[i*ld + wl] = g[r, chan(i), w0 + wl] for i < 64 and
//     wl < WB, zero where there is no channel or w0 + wl >= W.
// Its partial: part[slab * (CO*64 + CO) + chan*64 + t] = dW1, then db at
// CO*64 + chan.

constexpr int kWgWB = 64;             // bf16: columns per step
constexpr int kWgLd = kWgWB + 8;      // padded leading dim (multiple of 8)
constexpr int kWgCLd = kNT + 4;       // f32 epilogue tile

struct WgSmem {
  __nv_bfloat16 g[kNT][kWgLd];        // the cotangent rows x columns
  __nv_bfloat16 x[kNT][kWgLd];        // the union tile, taps x columns
  __nv_bfloat16 strip[3 * kC16 * (kWgWB + 2)];
};
constexpr size_t kWgBytes = sizeof(WgSmem) > sizeof(float) * kNT * kWgCLd
                                ? sizeof(WgSmem)
                                : sizeof(float) * kNT * kWgCLd;

// bf16 on the tensor cores (WMMA 16x16x16, f32 accumulation): the block's
// 64 x 64 (row, t) tile is 8 warps of 16 x 32; per (n, h) row and 64-column
// step the block loads g, stages the strip, builds the tile, and
// multiplies g by the tile transposed (the tile read as a column-major B).
template <class Loader>
__global__ void __launch_bounds__(kUThreads)
union_wgrad_tc_kernel(const __nv_bfloat16* __restrict__ x, Loader ld,
                      float* __restrict__ part, int NH, int H, int CO, int W,
                      int rows_per_slab) {
  using namespace nvcuda;
  __shared__ __align__(128) unsigned char smem[kWgBytes];
  WgSmem& s = *reinterpret_cast<WgSmem*>(smem);
  float* cs = reinterpret_cast<float*>(smem);    // reused after the loop

  const int tid = threadIdx.x, warp = tid / 32;
  const int wr = warp / 2, wt = warp % 2;        // warp's 16x32 sub-tile
  const int slab = blockIdx.x;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2];
  wmma::fill_fragment(acc[0], 0.f);
  wmma::fill_fragment(acc[1], 0.f);
  float dbacc = 0.f;

  const int r_begin = slab * rows_per_slab;
  const int r_end = min(NH, r_begin + rows_per_slab);
  for (int r = r_begin; r < r_end; ++r) {
    const int n = r / H, h = r % H;
    for (int w0 = 0; w0 < W; w0 += kWgWB) {
      ld.load(&s.g[0][0], kWgLd, r, w0, kWgWB);
      stage_strip(x, s.strip, n, h, H, W, w0, kWgWB + 2);
      __syncthreads();
      build_tile(s.strip, &s.x[0][0], kWgLd, kWgWB);
      if (tid < kNT) {
        for (int wl = 0; wl < kWgWB; ++wl) dbacc += __bfloat162float(s.g[tid][wl]);
      }
      __syncthreads();
#pragma unroll
      for (int ks = 0; ks < kWgWB / 16; ++ks) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
        wmma::load_matrix_sync(fa, &s.g[wr * 16][ks * 16], kWgLd);
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
          wmma::load_matrix_sync(fb, &s.x[wt * 32 + j * 16][ks * 16], kWgLd);
          wmma::mma_sync(acc[j], fa, fb, acc[j]);
        }
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int j = 0; j < 2; ++j)
    wmma::store_matrix_sync(cs + (wr * 16) * kWgCLd + wt * 32 + j * 16, acc[j], kWgCLd,
                            wmma::mem_row_major);
  __syncthreads();
  float* out = part + (size_t)slab * ((size_t)CO * kNT + CO);
  for (int i = tid; i < kNT * kNT; i += kUThreads) {
    const int row = i / kNT, t = i % kNT, c = ld.chan(row);
    if (c >= 0) out[(size_t)c * kNT + t] = cs[row * kWgCLd + t];
  }
  if (tid < kNT) {
    const int c = ld.chan(tid);
    if (c >= 0) out[(size_t)CO * kNT + c] = dbacc;
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

template <class Loader>
cudaError_t launch_union_wgrad(const __nv_bfloat16* x, Loader ld, float* part, int NH,
                               int H, int CO, int W, int slabs, int rows_per_slab,
                               int tiles, cudaStream_t st) {
  union_wgrad_tc_kernel<Loader><<<dim3(slabs, tiles), kUThreads, 0, st>>>(
      x, ld, part, NH, H, CO, W, rows_per_slab);
  return cudaGetLastError();
}

}  // namespace
