// The BN tail's arithmetic on bf16 pairs in packed bf16x2, shared by the
// transposed tail (bn_tail_t.cu) and the NHWC tail (bn_tail.cu): z and g
// are bf16 values and every routing weight is 0, 0.5 or 1, so each packed
// max, comparison, sum and product is exact and equals tail_math.cuh's f32
// value, element for element. In the transposed layout a pair is one
// channel at two neighbouring w; in NHWC it is two neighbouring channels
// of one pixel (two windows).
#pragma once

#include <cuda_bf16.h>

namespace {

// z of a bf16 pair: y*a + b rounded to bf16 (the mul and the add rounded
// separately, no FMA), then the ReLU.
__device__ __forceinline__ __nv_bfloat162 relu_pair(float2 yf, float2 a, float2 b) {
  return __hmax2(__floats2bfloat162_rn(__fadd_rn(__fmul_rn(yf.x, a.x), b.x),
                                       __fadd_rn(__fmul_rn(yf.y, a.y), b.y)),
                 __float2bfloat162_rn(0.f));
}

// The pool routing of a pair of windows from their members' z: dz =
// route(z, g) masked by the ReLU, as tail_math.cuh's route computes them in
// f32, value for value (each a bf16 value, kept packed). The ReLU's mask is
// taken once for the window: a member whose z is 0 gets a nonzero weight
// only where the window's max is 0, and then every member is masked.
__device__ __forceinline__ void route_z_packed(const __nv_bfloat162 (&z)[4],
                                               __nv_bfloat162 gv, __nv_bfloat162 (&dz)[4]) {
  const __nv_bfloat162 zero = __float2bfloat162_rn(0.f), one = __float2bfloat162_rn(1.f);
  const __nv_bfloat162 half = __float2bfloat162_rn(0.5f);
  auto tie = [&](__nv_bfloat162 x, __nv_bfloat162 xb) {
    return __hmul2(__hadd2(__hgt2(x, xb), __hge2(x, xb)), half);
  };
  const __nv_bfloat162 m01 = __hmax2(z[0], z[1]), m23 = __hmax2(z[2], z[3]);
  const __nv_bfloat162 gm = __hmul2(gv, __hgt2(__hmax2(m01, m23), zero));
  const __nv_bfloat162 w2 = tie(m01, m23), w1a = tie(z[0], z[1]), w1b = tie(z[2], z[3]);
  const __nv_bfloat162 da = __hmul2(gm, w2), db = __hmul2(gm, __hsub2(one, w2));
  dz[0] = __hmul2(da, w1a);
  dz[1] = __hmul2(da, __hsub2(one, w1a));
  dz[2] = __hmul2(db, w1b);
  dz[3] = __hmul2(db, __hsub2(one, w1b));
}

// The same, dz in f32.
__device__ __forceinline__ void route_z_pair(const __nv_bfloat162 (&z)[4], __nv_bfloat162 gv,
                                             float2 (&dz)[4]) {
  __nv_bfloat162 d[4];
  route_z_packed(z, gv, d);
#pragma unroll
  for (int i = 0; i < 4; ++i) dz[i] = __bfloat1622float2(d[i]);
}

// dy of one element from its y, its routed dz and its channel's columns,
// in tail_math.cuh's window_dy_of order and roundings, before the one
// rounding to T: gi*((dz - c1) - t*c2) with t = (y - mu)*inv.
__device__ __forceinline__ float dy_of(float y, float dz, float mu, float inv, float gi,
                                       float c1, float c2) {
  const float t = __fmul_rn(__fsub_rn(y, mu), inv);
  return __fmul_rn(gi, __fsub_rn(__fsub_rn(dz, c1), __fmul_rn(t, c2)));
}

// A window's seven columns (a, b, mu, inv, gi, c1, c2 at its four
// channels) held in registers, read as window_dy_of reads them.
struct RegCols {
  const float (&col)[7][4];
  __device__ __forceinline__ float operator()(int k, int i) const { return col[k][i]; }
};

}  // namespace
