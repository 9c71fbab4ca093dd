// The fused conv1 + BN/ReLU/pool tail weight gradient for Hopper (sm_90a):
// the BN tail's backward dy of conv1's output, computed on chip, fed
// straight into the sparse-tap conv1's weight+bias gradient. conv1's
// output cotangent [N, H4, 16*f1, W4] is never written to device memory.
//
// Replaces the Pallas TPU kernel of tpu_sandbox/ops/pallas_conv1_tail_t.py:
//   conv1_tail_t_wgrad  <- _wgrad_tail_kernel (:74), launched by
//                          _fused_wgrad (:142, pallas_call at :161)
//
// dy = gi*((dz - c1) - t*c2) of conv1's output, for each pool window from
// y1, the pooled cotangent and the f32 columns, by window_dy_of
// (tail_math.cuh: the same arithmetic as bn_tail_t_bwd_apply, so dy is
// the apply pass's, each value rounded once to the activation dtype as the
// stored tensor would be), becomes the cotangent of union_tile.cuh's
// wgrad: dW1 [CO, 64] and db [CO] through partials and reduce_partials
// (reduce.cuh), in a fixed order.
//
// What bounds it on the H100, at 3000x3000, batch 5 (bf16): it reads x
// (90 MB), y1 (1.44 GB) and the pooled cotangent (0.36 GB) once: 1.89 GB
// -> 0.564 ms at 3.35 TB/s; the 92.2 GFLOP of the product take 0.093 ms at
// 989 TFLOP/s. Bytes-bound. The unfused pair it replaces (bn_tail_t's
// apply, then conv1_s2d_t_wgrad) moves 3.24 + 1.53 GB.
//
// What the bf16 body does about it: the y1 rows of all 256 channels and
// the 64 pooled rows of a (row, 64-column) unit come through the wgrad's
// cp.async ring beside the x rows, three units ahead; one unit ahead of
// the products, every thread turns its window's staged y1 values into dy
// in place (a thread keeps one window, so its 28 columns stay in
// registers for the whole kernel), and the products read dy from there as
// their A operand. Each of y1, g and x is read from device memory once.
// What holds it back now is the dy pass itself: about 90 f32 operations a
// window and column, kept those of the apply pass bit for bit, which is
// near the card's f32 issue rate for 2.9e9 values and does not overlap
// the products or the loads well (one barrier a unit, every warp doing
// every phase).
// The f32 body computes dy per 16-window tile straight from device memory
// (TailDy::load).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "reduce.cuh"
#include "tail_math.cuh"
#include "union_tile.cuh"

namespace {

constexpr int kWin = kNT / 4;    // pool windows per block: 4 channels each

// The wgrad's cotangent rows computed from the tail's inputs. f32: tile
// row i is member i / 16 of window o = blockIdx.y*16 + i % 16. bf16: row c
// is channel c.
template <typename T>
struct TailDy {
  const T* y;                    // y1 [N*H, C, W]
  const T* g;                    // pooled cotangent [N*H, C/4, W]
  const float *a, *b, *mu, *inv, *gi, *c1, *c2;
  int C, co, blk, W;
  static constexpr int kExtra = kNT;   // the pooled rows: C/4 <= 64
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

  // bf16: thread i keeps window i % 64 and takes the 16 columns from
  // (i / 64)*16 of each unit, starting at a lane-dependent one so that a
  // warp's 32 windows spread over the banks
  struct Cache {
    int ch[4];
    float col[7][4];
    bool ok;
    __device__ float operator()(int k, int i) const { return col[k][i]; }
  };
  __device__ void init(Cache& k) const {
    const int o = threadIdx.x % kNT;
    k.ok = o < C / 4;
    window(k.ok ? o : 0, co, blk, k.ch);
    const WindowCols cols{k.ch, a, b, mu, inv, gi, c1, c2};
#pragma unroll
    for (int c = 0; c < 7; ++c)
#pragma unroll
      for (int i = 0; i < 4; ++i) k.col[c][i] = cols(c, i);
  }
  template <int MODE>
  __device__ void stage(T* sa, T* se, int r, int w0, int ar) const {
    stage_rows<MODE, kWgWB>(sa, kWgAP, y + (size_t)r * C * W, ar, C, W, w0);
    stage_rows<MODE, kWgWB>(se, kWgAP, g + (size_t)r * (C / 4) * W, C / 4, C / 4, W, w0);
  }
  template <int MODE>
  __device__ void prepare(const Cache& k, T* sa, const T* se, int r, int w0) const {
    if (!k.ok) return;
    const int o = threadIdx.x % kNT, j0 = threadIdx.x / kNT * 16, lane = threadIdx.x % 32;
    T* rows[4];
#pragma unroll
    for (int m = 0; m < 4; ++m)
      rows[m] = sa + k.ch[m] * kWgAP + row_shift<MODE>(a_row(r, k.ch[m]));
    const T* gr = se + o * kWgAP + row_shift<MODE>(g + ((size_t)r * (C / 4) + o) * W);
#pragma unroll 4
    for (int s = 0; s < 16; ++s) {
      const int j = j0 + ((lane + s) & 15);
      T d[4];
      if (w0 + j < W) {
        float yf[4];
#pragma unroll
        for (int m = 0; m < 4; ++m) yf[m] = to_f(rows[m][j]);
        window_dy_of<T>(yf, to_f(gr[j]), k, d);
      } else {
#pragma unroll
        for (int m = 0; m < 4; ++m) d[m] = from_f<T>(0.f);
      }
#pragma unroll
      for (int m = 0; m < 4; ++m) rows[m][j] = d[m];
    }
  }
  __device__ const T* a_row(int r, int c) const { return y + ((size_t)r * C + c) * W; }
};

template <typename T>
cudaError_t fused_wgrad(const void* x, const void* y1, const void* gp, const float* a,
                        const float* b, const float* mu, const float* inv,
                        const float* gi, const float* c1, const float* c2,
                        float* part, float* out, int N, int H, int C, int co, int blk,
                        int W, int parts, int per, cudaStream_t st) {
  const TailDy<T> ld{(const T*)y1, (const T*)gp, a, b, mu, inv, gi, c1, c2,
                     C, co, blk, W};
  cudaError_t err;
  if constexpr (sizeof(T) == 4)
    err = launch_union_wgrad((const T*)x, ld, part, N * H, H, C, W, parts, per,
                             (C / 4 + kWin - 1) / kWin, st);
  else
    err = launch_union_wgrad((const T*)x, ld, part, N * H, H, C, W, parts, per,
                             (uintptr_t)x | (uintptr_t)y1 | (uintptr_t)gp, st);
  if (err != cudaSuccess) return err;
  return reduce_partials(part, out, parts, C * kNT + C, st);
}

}  // namespace

// The bf16 body's plan: which 0 -> the columns of a unit, 1 -> its blocks
// resident on the current device at once, 2 -> the most channels C it
// takes.
extern "C" int conv1_tail_t_wgrad_plan(int which) {
  if (which == 0) return kWgWB;
  if (which == 1) return union_wgrad_slots<TailDy<__nv_bfloat16>>();
  return which == 2 ? kWgMaxCO : 0;
}

// dtype: 0 = float32, 1 = bfloat16 (C <= 256). x [N,H,16,W], y1 [N,H,C,W]
// (C = blk*blk*co = 16*f1), gp [N,H,C/4,W] of dtype; a, b, mu, inv, gi,
// c1, c2 f32 [C] columns; part f32 [parts, C*64 + C] (scratch); out f32
// [C*64 + C] = dW1 [C, 64] followed by db [C]. fp32: ``parts`` slabs of
// ``per`` rows; bf16: ``parts`` blocks of ``per`` (row, 64-column) units
// (conv1_tail_t_wgrad_plan).
extern "C" int conv1_tail_t_wgrad(int dtype, const void* x, const void* y1,
                                  const void* gp, const float* a, const float* b,
                                  const float* mu, const float* inv, const float* gi,
                                  const float* c1, const float* c2, void* part,
                                  void* out, int N, int H, int C, int co, int blk,
                                  int W, int parts, int per, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bad_tail_geometry(N * H, C, co, blk)) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)fused_wgrad<float>(x, y1, gp, a, b, mu, inv, gi, c1, c2, (float*)part,
                                   (float*)out, N, H, C, co, blk, W, parts, per, st);
  if (dtype == 1)
    return (int)fused_wgrad<__nv_bfloat16>(x, y1, gp, a, b, mu, inv, gi, c1, c2,
                                           (float*)part, (float*)out, N, H, C, co,
                                           blk, W, parts, per, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
