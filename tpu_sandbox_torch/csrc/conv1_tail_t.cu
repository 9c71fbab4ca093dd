// The fused conv1 + BN/ReLU/pool tail weight gradient for Hopper (sm_90a):
// the BN tail's backward dy of conv1's output, computed on chip, fed
// straight into the sparse-tap conv1's weight+bias gradient. conv1's
// output cotangent [N, H4, 16*f1, W4] is never written to device memory.
//
// Replaces the Pallas TPU kernel of tpu_sandbox/ops/pallas_conv1_tail_t.py:
//   conv1_tail_t_wgrad  <- _wgrad_tail_kernel (:74), launched by
//                          _fused_wgrad (:142, pallas_call at :161)
//
// Per (n, h) row and 64-column step a block computes, for 16 pool windows
// (its 64 channels), dy = gi*((dz - c1) - t*c2) from y1, the pooled
// cotangent and the f32 columns with window_dy (tail_math.cuh: the same
// device function as bn_tail_t_bwd_apply, so dy is the apply pass's, each
// value rounded once to the activation dtype as the stored tensor would
// be), writes it into the shared-memory cotangent tile, and runs
// union_tile.cuh's wgrad on it: dW1 [CO, 64] and db [CO] through per-slab
// partials and reduce_partials (reduce.cuh), in a fixed order.
//
// What bounds it on the H100, at 3000x3000, batch 5 (bf16): it reads x
// (90 MB), y1 (1.44 GB) and the pooled cotangent (0.36 GB) once: 1.89 GB
// -> 0.564 ms at 3.35 TB/s; the 92.2 GFLOP of the product take 0.093 ms at
// 989 TFLOP/s. Bytes-bound. The unfused pair it replaces (bn_tail_t's
// apply, then conv1_s2d_t_wgrad) moves 3.24 + 1.53 GB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "reduce.cuh"
#include "tail_math.cuh"
#include "union_tile.cuh"

namespace {

constexpr int kWin = kNT / 4;    // pool windows per block: 4 channels each

// The wgrad's cotangent rows computed from the tail's inputs: tile row i
// is member i / 16 of window o = blockIdx.y*16 + i % 16.
template <typename T>
struct TailDy {
  const T* y;                    // y1 [N*H, C, W]
  const T* g;                    // pooled cotangent [N*H, C/4, W]
  const float *a, *b, *mu, *inv, *gi, *c1, *c2;
  int C, co, blk, W;
  __device__ int chan(int i) const {
    const int o = blockIdx.y * kWin + i % kWin;
    if (o >= C / 4) return -1;
    int ch[4];
    window(o, co, blk, ch);
    return ch[i / kWin];
  }
  __device__ void load(T* tile, int ld, int r, int w0, int WB) const {
    const int Cout = C / 4;
    const size_t row_off = (size_t)r * C * W;
    for (int i = threadIdx.x; i < kWin * WB; i += blockDim.x) {
      const int ol = i / WB, wl = i % WB;
      const int o = blockIdx.y * kWin + ol, w = w0 + wl;
      T d[4];
      if (o < Cout && w < W) {
        int ch[4];
        window(o, co, blk, ch);
        window_dy<T>(y, row_off, W, w, ch, to_f(g[((size_t)r * Cout + o) * W + w]), a,
                     b, mu, inv, gi, c1, c2, d);
      } else {
#pragma unroll
        for (int m = 0; m < 4; ++m) d[m] = from_f<T>(0.f);
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) tile[(m * kWin + ol) * ld + wl] = d[m];
    }
  }
};

template <typename T>
cudaError_t fused_wgrad(const void* x, const void* y1, const void* gp, const float* a,
                        const float* b, const float* mu, const float* inv,
                        const float* gi, const float* c1, const float* c2,
                        float* part, float* out, int N, int H, int C, int co, int blk,
                        int W, int slabs, int rows_per_slab, cudaStream_t st) {
  const TailDy<T> ld{(const T*)y1, (const T*)gp, a, b, mu, inv, gi, c1, c2,
                     C, co, blk, W};
  const int tiles = (C / 4 + kWin - 1) / kWin;
  cudaError_t err = launch_union_wgrad((const T*)x, ld, part, N * H, H, C, W, slabs,
                                       rows_per_slab, tiles, st);
  if (err != cudaSuccess) return err;
  return reduce_partials(part, out, slabs, C * kNT + C, st);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. x [N,H,16,W], y1 [N,H,C,W] (C =
// blk*blk*co = 16*f1), gp [N,H,C/4,W] of dtype; a, b, mu, inv, gi, c1, c2
// f32 [C] columns; part f32 [slabs, C*64 + C] (scratch); out f32
// [C*64 + C] = dW1 [C, 64] followed by db [C].
extern "C" int conv1_tail_t_wgrad(int dtype, const void* x, const void* y1,
                                  const void* gp, const float* a, const float* b,
                                  const float* mu, const float* inv, const float* gi,
                                  const float* c1, const float* c2, void* part,
                                  void* out, int N, int H, int C, int co, int blk,
                                  int W, int slabs, int rows_per_slab, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bad_tail_geometry(N * H, C, co, blk)) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)fused_wgrad<float>(x, y1, gp, a, b, mu, inv, gi, c1, c2, (float*)part,
                                   (float*)out, N, H, C, co, blk, W, slabs,
                                   rows_per_slab, st);
  if (dtype == 1)
    return (int)fused_wgrad<__nv_bfloat16>(x, y1, gp, a, b, mu, inv, gi, c1, c2,
                                           (float*)part, (float*)out, N, H, C, co,
                                           blk, W, slabs, rows_per_slab, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
