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
// bf16. All three are bytes-bound. The scattered-3x3 form of the same conv
// (conv_t.cu) contracts 144 taps where this one contracts 64.
//
// Design (forward). A block owns 128 output channels, 64 columns and a
// slab of kSlabRows rows. bf16: the weight tile [128, 64] is loaded once
// into WMMA fragments held in registers (8 per warp); per row the block
// stages the x halo strip once (3 block rows x 16 channels x 66 columns),
// builds the [64, 64] tap tile from it in shared memory, and its 8 warps
// each multiply a 32 x 32 output tile on the tensor cores (mma.sync, f32
// accumulation). The epilogue adds the bias in f32 and rounds once. fp32:
// the same tiling on the CUDA cores, 256 threads of 8 x 4 outputs reading
// the weight from shared memory and their taps straight from the strip;
// it is the tight check against the plain version.
//
// Design (stats). As conv_t.cu's: BN's per-channel sum and sum of squares
// of the ROUNDED y are an epilogue over the block's rows; one partial per
// (slab, W tile), added in a fixed order by reduce_partials (reduce.cuh).
// The stats variant is the same kernel as the forward, so its y is the
// forward's bit for bit.
//
// Design (wgrad). union_tile.cuh's kernel with g read from device memory
// (GradRows): blocks own 64 output channels and a slab of rows, and write
// per-slab partials that reduce_partials adds in a fixed order.
//
// wgmma, TMA and a pipelined ring are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "reduce.cuh"
#include "union_tile.cuh"

namespace {

constexpr int kThreads = kUThreads;
constexpr int kBCO = 128;        // output channels per block
constexpr int kBW = 64;          // output columns per block
constexpr int kSW = kBW + 2;     // strip columns
constexpr int kSlabRows = 8;     // rows of (n, h) per block
constexpr int kALd = kNT + 8;    // padded leading dims (multiples of 8)
constexpr int kBLd = kBW + 8;
constexpr int kCLd = kBW + 4;

struct FwdSmem {
  __nv_bfloat16 b[kNT][kBLd];                // the tap tile
  __nv_bfloat16 strip[3 * kC16 * kSW];
};
constexpr size_t kFwdBytes =
    sizeof(float) * kBCO * kCLd > sizeof(__nv_bfloat16) * kBCO * kALd
        ? sizeof(float) * kBCO * kCLd
        : sizeof(__nv_bfloat16) * kBCO * kALd;
static_assert(sizeof(FwdSmem) <= kFwdBytes, "forward tile fits the epilogue");

// bf16 forward, grid (slabs, W tiles, CO tiles). With STATS the epilogue
// leaves the rounded row tile in shared memory and 2 threads per channel
// each add 32 of its columns (and their squares) to registers that run
// over the slab, combined by one shuffle at the end.
template <bool STATS>
__global__ void __launch_bounds__(kThreads)
conv1_fwd_tc_kernel(const __nv_bfloat16* __restrict__ x,
                    const __nv_bfloat16* __restrict__ w1,
                    const __nv_bfloat16* __restrict__ bias,
                    __nv_bfloat16* __restrict__ y, float* __restrict__ part, int NH,
                    int H, int CO, int W) {
  using namespace nvcuda;
  constexpr int TPC = kThreads / kBCO, CPT = kBW / TPC;
  __shared__ __align__(128) unsigned char smem[kFwdBytes];
  FwdSmem& s = *reinterpret_cast<FwdSmem*>(smem);
  __nv_bfloat16 (*wa)[kALd] = reinterpret_cast<__nv_bfloat16 (*)[kALd]>(smem);
  float* cs = reinterpret_cast<float*>(smem);

  const int tid = threadIdx.x, warp = tid / 32;
  const int wco = warp / 2, wwc = warp % 2;      // warp's 32x32 sub-tile
  const int w0 = blockIdx.y * kBW;
  const int co0 = blockIdx.z * kBCO;
  const int r_begin = blockIdx.x * kSlabRows;
  const int r_end = min(NH, r_begin + kSlabRows);

  // the block's weight rows, 64 taps = eight 16-byte vectors each, into
  // shared memory once and from there into the warps' fragments
  for (int i = tid; i < kBCO * 8; i += kThreads) {
    const int co = i / 8, v = i % 8, gco = co0 + co;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (gco < CO) val = *reinterpret_cast<const uint4*>(w1 + (size_t)gco * kNT + v * 8);
    *reinterpret_cast<uint4*>(&wa[co][v * 8]) = val;
  }
  __syncthreads();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[2][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wmma::load_matrix_sync(fa[i][ks], &wa[wco * 32 + i * 16][ks * 16], kALd);
  __syncthreads();

  float st = 0.f, st2 = 0.f;
  for (int row = r_begin; row < r_end; ++row) {   // row = n * H + h
    const int h = row % H, n = row / H;
    stage_strip(x, s.strip, n, h, H, W, w0, kSW);
    __syncthreads();
    build_tile(s.strip, &s.b[0][0], kBLd, kBW);
    __syncthreads();
    wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.f);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) {
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[2];
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::load_matrix_sync(fb[j], &s.b[ks * 16][wwc * 32 + j * 16], kBLd);
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) wmma::mma_sync(acc[i][j], fa[i][ks], fb[j], acc[i][j]);
    }
    __syncthreads();                              // the tile is done with
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(cs + (wco * 32 + i * 16) * kCLd + wwc * 32 + j * 16,
                                acc[i][j], kCLd, wmma::mem_row_major);
    __syncthreads();
    for (int i = tid; i < kBCO * kBW; i += kThreads) {
      const int co = i / kBW, j = i % kBW;
      const int gco = co0 + co, w = w0 + j;
      float v = 0.f;
      if (gco < CO && w < W) {
        const __nv_bfloat16 r = __float2bfloat16_rn(cs[co * kCLd + j] +
                                                    __bfloat162float(bias[gco]));
        y[((size_t)row * CO + gco) * W + w] = r;
        v = __bfloat162float(r);
      }
      if (STATS) cs[co * kCLd + j] = v;
    }
    if (STATS) {
      __syncthreads();
      const float* crow = cs + (tid / TPC) * kCLd + (tid % TPC) * CPT;
      for (int j = 0; j < CPT; ++j) {
        st += crow[j];
        st2 += crow[j] * crow[j];
      }
    }
    // the next row's strip overwrites the epilogue tile
    __syncthreads();
  }

  if (STATS) {
#pragma unroll
    for (int off = TPC / 2; off > 0; off /= 2) {
      st += __shfl_xor_sync(0xffffffffu, st, off);
      st2 += __shfl_xor_sync(0xffffffffu, st2, off);
    }
    const int gco = co0 + tid / TPC;
    if (tid % TPC == 0 && gco < CO) {
      float* out = part + ((size_t)blockIdx.x * gridDim.y + blockIdx.y) * 2 * CO;
      out[gco] = st;
      out[CO + gco] = st2;
    }
  }
}

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

template <bool STATS>
cudaError_t launch_fwd(int dtype, const void* x, const void* w1, const void* bias,
                       void* y, float* part, int N, int H, int CO, int W,
                       cudaStream_t st) {
  const int NH = N * H;
  const dim3 grid((NH + kSlabRows - 1) / kSlabRows, (W + kBW - 1) / kBW,
                  (CO + kBCO - 1) / kBCO);
  if (dtype == 0)
    conv1_fwd_f32_kernel<STATS><<<grid, kThreads, 0, st>>>(
        (const float*)x, (const float*)w1, (const float*)bias, (float*)y, part, NH, H,
        CO, W);
  else if (dtype == 1)
    conv1_fwd_tc_kernel<STATS><<<grid, kThreads, 0, st>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)w1,
        (const __nv_bfloat16*)bias, (__nv_bfloat16*)y, part, NH, H, CO, W);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// The wgrad's cotangent rows read from g [N*H, CO, W]: tile row i is
// channel blockIdx.y*64 + i.
template <typename T>
struct GradRows {
  const T* g;
  int CO, W;
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
};

template <typename T>
cudaError_t wgrad(const void* x, const void* g, float* part, float* out, int N, int H,
                  int CO, int W, int slabs, int rows_per_slab, cudaStream_t st) {
  const GradRows<T> ld{(const T*)g, CO, W};
  cudaError_t err = launch_union_wgrad((const T*)x, ld, part, N * H, H, CO, W, slabs,
                                       rows_per_slab, (CO + kNT - 1) / kNT, st);
  if (err != cudaSuccess) return err;
  return reduce_partials(part, out, slabs, CO * kNT + CO, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x [N,H,16,W], w1 [CO, 64] (the
// scattered 5x5 kernel, tap t = (m'+2)*8 + (j+2)), bias [CO], y
// [N,H,CO,W]; all of dtype, contiguous.
extern "C" int conv1_s2d_t_fwd(int dtype, const void* x, const void* w1,
                               const void* bias, void* y, int N, int H, int CO, int W,
                               void* stream) {
  return (int)launch_fwd<false>(dtype, x, w1, bias, y, nullptr, N, H, CO, W,
                                (cudaStream_t)stream);
}

// Rows of (n, h) per slab of conv1_s2d_t_fwd_stats and its W tiles: the
// wrapper sizes ``part`` as slabs * wtiles * 2 * CO floats.
extern "C" int conv1_s2d_t_stats_rows(void) { return kSlabRows; }
extern "C" int conv1_s2d_t_stats_wtiles(int W) { return (W + kBW - 1) / kBW; }

// conv1_s2d_t_fwd plus the f32 per-channel sums of the rounded y: sums
// [2*CO] = sum over (n, h, w) of y, then of y*y. part f32 [slabs * wtiles,
// 2*CO] scratch.
extern "C" int conv1_s2d_t_fwd_stats(int dtype, const void* x, const void* w1,
                                     const void* bias, void* y, void* part, void* sums,
                                     int N, int H, int CO, int W, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t err = launch_fwd<true>(dtype, x, w1, bias, y, (float*)part, N, H,
                                           CO, W, st);
  if (err != cudaSuccess) return (int)err;
  const int slabs = (N * H + kSlabRows - 1) / kSlabRows;
  return (int)reduce_partials((const float*)part, (float*)sums,
                              slabs * ((W + kBW - 1) / kBW), 2 * CO, st);
}

// x [N,H,16,W], g [N,H,CO,W] of dtype; part f32 [slabs, CO*64 + CO]
// (scratch); out f32 [CO*64 + CO] = dW1 [CO, 64] followed by db [CO].
extern "C" int conv1_s2d_t_wgrad(int dtype, const void* x, const void* g, void* part,
                                 void* out, int N, int H, int CO, int W, int slabs,
                                 int rows_per_slab, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0)
    return (int)wgrad<float>(x, g, (float*)part, (float*)out, N, H, CO, W, slabs,
                             rows_per_slab, st);
  if (dtype == 1)
    return (int)wgrad<__nv_bfloat16>(x, g, (float*)part, (float*)out, N, H, CO, W,
                                     slabs, rows_per_slab, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
