// The per-window arithmetic of the fused train-mode BN + ReLU + 2x2 block
// max-pool tail in the transposed layout [N, H, C, W], shared by the
// tail's own kernels (bn_tail_t.cu) and the fused conv1+tail weight
// gradient (conv1_tail_t.cu): both compute the BN output cotangent dy with
// window_dy, so the two give the same dy, rounding for rounding.
//
// Channel c = (a*blk + b)*co + k, C = blk*blk*co. A pool window is the
// representative channel r = (2*a1*blk + 2*b1)*co + k and its partners
// r+co, r+blk*co, r+blk*co+co; its output channel is o = (a1*(blk/2) +
// b1)*co + k. The TPU rolls the [C, W] row along sublanes to line the
// partners up and compacts the representatives with a selection matmul;
// here one thread owns one window at one w and reads its four channel
// rows directly (a gather), so neither exists.
//
// Arithmetic, as the Pallas kernels and the plain PyTorch versions do it:
//   z   = max(round(y*a + b), 0), rounded to y's dtype BEFORE the ReLU,
//         the max and the routing; the mul and the add round separately
//         (no FMA), as two PyTorch ops do
//   fwd: out[o] = max of the window's four z
//   bwd: the pooled cotangent g goes to the pair max first (at offset
//        blk*co), then inside each pair (offset co), with weights
//        0.5*((x > xb) + (x >= xb)): an exact tie splits 0.5/0.5; masked
//        by z > 0. t = (y - mu)*inv.
//        reduce: s1[c] = sum dz, s2[c] = sum dz*t over (n, h, w)
//        apply:  dy = gi*((dz - c1) - t*c2), rounded once to y's dtype
// Per-channel vectors (a, b, mu, inv, gi, c1, c2) come in as f32 columns
// of C, as the Pallas kernels take them.
#pragma once

#include <cuda_runtime.h>

#include "dtypes.cuh"

namespace {

// The four channels of output channel o's window: r, r+co, r+blk*co,
// r+blk*co+co.
__device__ __forceinline__ void window(int o, int co, int blk, int ch[4]) {
  const int k = o % co, ab = o / co, half = blk / 2;
  const int r = (2 * (ab / half) * blk + 2 * (ab % half)) * co + k;
  ch[0] = r;
  ch[1] = r + co;
  ch[2] = r + blk * co;
  ch[3] = r + blk * co + co;
}

template <typename T>
__device__ __forceinline__ float rounded_relu(float y, float a, float b) {
  return fmaxf(to_f(from_f<T>(__fadd_rn(__fmul_rn(y, a), b))), 0.f);
}

__device__ __forceinline__ float tie_weight(float x, float xb) {
  return 0.5f * ((x > xb ? 1.f : 0.f) + (x >= xb ? 1.f : 0.f));
}

// The pool VJP of one window: g to the pair maxima, then inside each
// pair; masked by the ReLU. Every weight is 0, 0.5 or 1: exact.
__device__ __forceinline__ void route(const float z[4], float g, float dz[4]) {
  const float w2 = tie_weight(fmaxf(z[0], z[1]), fmaxf(z[2], z[3]));
  const float da = g * w2, db = g * (1.f - w2);
  const float w1a = tie_weight(z[0], z[1]), w1b = tie_weight(z[2], z[3]);
  dz[0] = da * w1a;
  dz[1] = da * (1.f - w1a);
  dz[2] = db * w1b;
  dz[3] = db * (1.f - w1b);
#pragma unroll
  for (int i = 0; i < 4; ++i) dz[i] = z[i] > 0.f ? dz[i] : 0.f;
}

// The window's four y at (row, w) in f32, and their z.
template <typename T>
__device__ __forceinline__ void load_window(const T* __restrict__ y, size_t row_off,
                                            int W, int w, const int ch[4],
                                            const float* __restrict__ a,
                                            const float* __restrict__ b,
                                            float yf[4], float z[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    yf[i] = to_f(y[row_off + (size_t)ch[i] * W + w]);
    z[i] = rounded_relu<T>(yf[i], a[ch[i]], b[ch[i]]);
  }
}

// The apply pass for one window from its four y values yf (in f32, as
// loaded from a tensor of dtype T): dy of its four channels, each rounded
// once to T. g is the pooled cotangent; col(k, i) is column k (0 a, 1 b,
// 2 mu, 3 inv, 4 gi, 5 c1, 6 c2) at member i's channel, read where it is
// used.
template <typename T, class Col>
__device__ __forceinline__ void window_dy_of(const float yf[4], float g, const Col& col,
                                             T dy[4]) {
  float z[4], dz[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) z[i] = rounded_relu<T>(yf[i], col(0, i), col(1, i));
  route(z, g, dz);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float t = __fmul_rn(__fsub_rn(yf[i], col(2, i)), col(3, i));
    const float v = __fsub_rn(__fsub_rn(dz[i], col(5, i)), __fmul_rn(t, col(6, i)));
    dy[i] = from_f<T>(__fmul_rn(col(4, i), v));
  }
}

// The columns of a window read from the f32 column vectors [C].
struct WindowCols {
  const int* ch;
  const float *a, *b, *mu, *inv, *gi, *c1, *c2;
  __device__ __forceinline__ float operator()(int k, int i) const {
    const float* v[7] = {a, b, mu, inv, gi, c1, c2};
    return v[k][ch[i]];
  }
};

// The apply pass for one window at (row, w): dy of its four channels,
// each rounded once to T. g is the pooled cotangent at (row, o, w).
template <typename T>
__device__ __forceinline__ void window_dy(const T* __restrict__ y, size_t row_off,
                                          int W, int w, const int ch[4], float g,
                                          const float* __restrict__ a,
                                          const float* __restrict__ b,
                                          const float* __restrict__ mu,
                                          const float* __restrict__ inv,
                                          const float* __restrict__ gi,
                                          const float* __restrict__ c1,
                                          const float* __restrict__ c2, T dy[4]) {
  float yf[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) yf[i] = to_f(y[row_off + (size_t)ch[i] * W + w]);
  window_dy_of<T>(yf, g, WindowCols{ch, a, b, mu, inv, gi, c1, c2}, dy);
}

inline bool bad_tail_geometry(int NH, int C, int co, int blk) {
  return blk < 2 || blk % 2 || co < 1 || C != blk * blk * co || NH > 65535;
}

}  // namespace
