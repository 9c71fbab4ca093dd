// Fused train-mode BatchNorm-apply + ReLU + 2x2 block max-pool in the
// transposed layout [N, H, C, W], and its backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of tpu_sandbox/ops/pallas_bn_tail_t.py:
//   bn_tail_t_fwd         <- _fwd_kernel (:75), launched by _forward (:216)
//   bn_tail_t_bwd_reduce  <- _bwd_reduce_kernel (:97), launched by bwd_reduce (:258)
//   bn_tail_t_bwd_apply   <- _bwd_apply_kernel (:123), launched by _vjp_bwd (:317)
//
// The per-window arithmetic (window, z, the pool routing with exact
// 0.5/0.5 ties, dy) is in tail_math.cuh, shared with the fused conv1+tail
// weight gradient (conv1_tail_t.cu) and the NHWC tail (bn_tail.cu).
//
// What bounds them on the H100. At 3000x3000, batch 5 (bn1: C 256, co
// 16, blk 4; bn2: C 128, co 32, blk 2), each input read once and each
// output written once at 3.35 TB/s:
//   fwd    y + out       1.80 / 0.90 GB -> 0.537 / 0.269 ms
//   reduce y + g         1.80 / 0.90 GB -> 0.537 / 0.269 ms
//   apply  y + g + dy    3.24 / 1.62 GB -> 0.967 / 0.484 ms
// All three are bound by their memory traffic, but not at the bytes' rate
// alone. Rows are W*2 = 1500 bytes at these shapes, so a warp's 128-byte
// store of a row straddles 32-byte sectors, and a sector that two stores
// each write in part costs the memory system far more than a whole one (a
// plain copy through this walk ran much faster at widths whose rows fill
// whole sectors). The apply's routing (about 70 operations an element in
// f32) and its address arithmetic then have to hide under that traffic;
// the reduce is bound by its arithmetic.
//
// The walk, shared by the three passes: block (slab, o) owns window o
// over a slab of whole rows, sized on the host (ops/conv_t.py::
// wgrad_slabs, the C/4 windows as tiles) to about kWaves waves of the
// blocks the card holds (bn_tail_t_slots); the window's per-channel
// columns sit in registers, loaded once a block. Neighbouring threads take
// neighbouring slots of a row (coalesced), and a round's loads are in
// flight while the round before it is used (two register buffers). In the
// forward and the apply a row's slots are laid on the 64-byte runs of the
// row the pass stores (Slab), so a warp's stores fill whole sectors, and
// at even W a slot holds 16 bytes of each row it reads or writes (four
// bf16x2 or two float2 words: one access each, word by word only at a
// row's two ends), which also spends a quarter of the address arithmetic
// an element. The reduce keeps its walk of single words in row order (its
// sums' order). Odd W, or a tensor that starts at an odd element, takes
// one element a word.
//
// bf16 pairs take z, the max, the routing and dz in packed bf16x2
// arithmetic (route_pair, shared by the reduce and the apply; its parts are
// tail_pair.cuh's, shared with the NHWC tail): z and g
// are bf16 values and every routing weight is 0, 0.5 or 1, so each packed
// max, comparison, sum and product is exact and equals tail_math.cuh's
// f32 value. The apply's t and dy stay in f32 in window_dy_of's order
// (mul and add rounded separately, one rounding to bf16), so dy is the
// same bit for bit. fp32 and single elements take tail_math.cuh's f32
// functions.
//
// The reduce keeps its sums in registers, combines a warp by a shuffle
// butterfly and the warps in a fixed order, and writes one partial per
// slab; reduce_partials (reduce.cuh) adds the partials in a fixed order.
// No float atomics: two runs of any pass are bitwise equal. Left for
// later: fusing the reduce with the apply (y and g read once for both),
// and the apply's last third above its bound (its arithmetic and the
// rows' ends, which other blocks' stores complete).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include "mma.cuh"
#include "reduce.cuh"
#include "tail_math.cuh"
#include "tail_pair.cuh"

namespace {

constexpr int kThreads = 256;  // a block: one window over a slab of rows
constexpr int kWaves = 2;      // blocks: twice those resident at once
// each pass: slots a thread takes a round, and blocks an SM it is built
// for (65536 / (256 n) registers a thread); the apply's 16-byte slots
// take 128 registers
constexpr int kFwdUnroll = 1, kFwdMinBlocks = 4;
constexpr int kRedUnroll = 2, kRedMinBlocks = 4;
constexpr int kApplyUnroll = 1, kApplyMinBlocks = 2;
constexpr int kAlignBytes = 64;  // the forward's and the apply's slot runs
// words of V = 2 elements a slot of the forward and the apply: 16 bytes
template <typename T>
constexpr int kWords = 8 / sizeof(T);

// V elements of a channel row in one access (V 2: a bf16x2 or float2
// word, for rows 2V-byte aligned; V 1: one element).
template <typename T, int V>
struct Vec {
  using type = T;
};
template <>
struct Vec<__nv_bfloat16, 2> {
  using type = __nv_bfloat162;
};
template <>
struct Vec<float, 2> {
  using type = float2;
};

__device__ __forceinline__ float elem(float v, int) { return v; }
__device__ __forceinline__ float elem(__nv_bfloat16 v, int) { return __bfloat162float(v); }
__device__ __forceinline__ float elem(float2 v, int e) { return e ? v.y : v.x; }
__device__ __forceinline__ float elem(__nv_bfloat162 v, int e) {
  return e ? __high2float(v) : __low2float(v);
}

__device__ __forceinline__ void set_elem(float& d, int, float v) { d = v; }
__device__ __forceinline__ void set_elem(__nv_bfloat16& d, int, __nv_bfloat16 v) { d = v; }
__device__ __forceinline__ void set_elem(float2& d, int e, float v) { (e ? d.y : d.x) = v; }

// Q words of a row as one access of 2 to 16 bytes.
template <int B>
struct Raw;
template <>
struct Raw<2> {
  using type = unsigned short;
};
template <>
struct Raw<4> {
  using type = unsigned;
};
template <>
struct Raw<8> {
  using type = uint2;
};
template <>
struct Raw<16> {
  using type = uint4;
};

template <int Q, typename VT>
__device__ __forceinline__ void load_words(VT (&w)[Q], const VT* p) {
  using R = typename Raw<Q * sizeof(VT)>::type;
  *reinterpret_cast<R*>(w) = *reinterpret_cast<const R*>(p);
}
template <int Q, typename VT>
__device__ __forceinline__ void store_words(VT* p, const VT (&w)[Q]) {
  using R = typename Raw<Q * sizeof(VT)>::type;
  *reinterpret_cast<R*>(p) = *reinterpret_cast<const R*>(w);
}

// One item of a walk: Q words (of V elements each) from one (row, w) of
// the window's four channel rows and, for the backward passes, of the
// pooled cotangent; r is its row in the slab and w0 its first word in the
// row (words outside [0, W/V) are empty: a row's first and last items).
template <typename VT, int Q>
struct Item {
  VT y[4][Q], g[Q];
  int r, w0;
};

// n / d for 0 <= n < 2^31 and a divisor d >= 1 fixed for a block, by a
// multiply and a shift (Granlund and Montgomery's round-up method).
struct FastDiv {
  unsigned m;
  int l;
  __device__ __forceinline__ explicit FastDiv(unsigned d) {
    l = d > 1 ? 32 - __clz(d - 1) : 0;
    m = (unsigned)(((1ull << 32) * ((1ull << l) - d)) / d + 1);
  }
  __device__ __forceinline__ int operator()(int n) const {
    return (int)((__umulhi(m, (unsigned)n) + (unsigned)n) >> l);
  }
};

// Block (slab, o) of a pass: window o over rows [r0, r0 + rows_per_slab)
// of y [N*H, C, W] and of the pooled rows [N*H, C/4, W], walked as P
// slots (items of Q words) a row. Without AL (the reduce: Q 1) P = W/V
// and slot j holds word j. With AL (the forward and the apply) a row's
// slots lie on the kAlignBytes runs of the row the pass stores (the
// pooled row, or y's channel row ch[0] for dy): slot j holds words j*Q -
// lead on, lead the row's first word's place in its run, and P*Q is a
// whole number of runs. A warp's 32 slots then store whole 32-byte
// sectors of each row that shares that row's alignment (at the main
// path's shapes all the rows of a block): a sector that two warps' stores
// each write in part costs the memory system far more than a whole one.
// A slot whose Q words all lie in the row, in a block whose rows all share
// the stored row's alignment (vec), is read and written in one access of
// Q words; the others word by word.
template <typename T, int V, int Q, bool AL>
struct Slab {
  using VT = typename Vec<T, V>::type;
  static constexpr int kRun = kAlignBytes / sizeof(VT);  // words a run
  int ch[4], chW[4];          // the window's channels, and their rows' offsets
  int W, CW, PW, per_row, P, items;
  unsigned lead0, lead_step;  // row 0's lead, and its change a row (mod kRun)
  bool vec;
  FastDiv div;                // by P
  size_t y0, p0;              // the slab's first element of y, of the pooled rows

  // ``stored`` is the tensor the pass writes (AL), laid out as y
  // (``pooled`` false) or as the pooled rows; ``y_like`` and ``p_like``
  // the tensors it reads laid out as y and as the pooled rows (null where
  // none)
  __device__ __forceinline__ Slab(int NH, int C, int co, int blk, int W_, int rows_per_slab,
                                  const T* stored = nullptr, bool pooled = false,
                                  const T* y_like = nullptr, const T* p_like = nullptr)
      : W(W_), CW(C * W_), PW(gridDim.y * W_), per_row(W_ / V),
        P(AL ? (W_ / V + 2 * kRun - 2) / kRun * kRun / Q : W_ / V), div(P) {
    const int o = blockIdx.y, r0 = blockIdx.x * rows_per_slab;
    window(o, co, blk, ch);
#pragma unroll
    for (int i = 0; i < 4; ++i) chW[i] = ch[i] * W;
    items = (min(NH, r0 + rows_per_slab) - r0) * P;
    y0 = (size_t)r0 * CW;
    p0 = (size_t)r0 * PW + (size_t)o * W;
    lead0 = lead_step = 0;
    vec = Q == 1;
    if (AL) {
      const uintptr_t at = (uintptr_t)(stored + (pooled ? p0 : y0 + chW[0]));
      lead0 = (unsigned)(at / sizeof(VT));
      lead_step = (unsigned)((pooled ? PW : CW) / V);
      constexpr uintptr_t kQ = Q * sizeof(VT);
      bool same = (size_t)(CW - PW) * sizeof(T) % kQ == 0;
      auto rows_at = [&](const T* t, bool p) {
        if (t == nullptr) return;
        for (int i = 0; i < (p ? 1 : 4); ++i)
          same = same && ((uintptr_t)(t + (p ? p0 : y0 + chW[i])) - at) % kQ == 0;
      };
      rows_at(stored, pooled);
      rows_at(y_like, false);
      rows_at(p_like, true);
      vec = vec || same;
    }
  }
  // the item's element of channel row 0 of y (channel row ch[i] is
  // chW[i] further) from y0, and of its pooled row from p0: ints, as the
  // wrapper's plan keeps a slab of y under 2^31 elements
  __device__ __forceinline__ int y_off(const Item<VT, Q>& x) const { return x.r * CW + x.w0 * V; }
  __device__ __forceinline__ int p_off(const Item<VT, Q>& x) const { return x.r * PW + x.w0 * V; }
  __device__ __forceinline__ bool has(const Item<VT, Q>& x, int q) const {
    return !AL || (unsigned)(x.w0 + q) < (unsigned)per_row;
  }
  __device__ __forceinline__ bool empty(const Item<VT, Q>& x) const {
    return AL && (x.w0 + Q <= 0 || x.w0 >= per_row);
  }
  // all Q words in the row and one access for them
  __device__ __forceinline__ bool whole(const Item<VT, Q>& x) const {
    return !AL || (vec && x.w0 >= 0 && x.w0 + Q <= per_row);
  }
  // Q words of a row at p: one access, or word by word (empty words 0)
  __device__ __forceinline__ void read(const Item<VT, Q>& x, const T* p, VT (&w)[Q]) const {
    if (whole(x)) {
      load_words<Q>(w, reinterpret_cast<const VT*>(p));
    } else {
#pragma unroll
      for (int q = 0; q < Q; ++q)
        w[q] = has(x, q) ? reinterpret_cast<const VT*>(p)[q] : VT{};
    }
  }
  __device__ __forceinline__ void write(const Item<VT, Q>& x, T* p, const VT (&w)[Q]) const {
    if (whole(x)) {
      store_words<Q>(reinterpret_cast<VT*>(p), w);
    } else {
#pragma unroll
      for (int q = 0; q < Q; ++q)
        if (has(x, q)) reinterpret_cast<VT*>(p)[q] = w[q];
    }
  }
  // slot it's place, its four y word groups and, for the backward, its g
  // words (y and g the slab's first elements); nothing for an empty slot
  template <bool G>
  __device__ __forceinline__ void load(const T* __restrict__ y, const T* __restrict__ g, int it,
                                       Item<VT, Q>& x) const {
    x.r = div(it);
    x.w0 = (it - x.r * P) * Q - (int)((lead0 + (unsigned)x.r * lead_step) % kRun);
    if (empty(x)) return;
    const int yo = y_off(x);
#pragma unroll
    for (int i = 0; i < 4; ++i) read(x, y + (yo + chW[i]), x.y[i]);
    if (G) read(x, g + p_off(x), x.g);
  }
};

// A block's walk over items [0, items): a thread takes the U items it0,
// it0 + kThreads, ... a round, in order, and loads the next round while it
// uses the one before (two register buffers).
template <int U, class It, class Load, class Use>
__device__ __forceinline__ void walk(int items, const Load& load, const Use& use) {
  constexpr int R = U * kThreads;
  It buf[2][U];
  auto load_round = [&](int it0, It(&b)[U]) {
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (it0 + u * kThreads < items) load(it0 + u * kThreads, b[u]);
  };
  auto use_round = [&](int it0, const It(&b)[U]) {
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (it0 + u * kThreads < items) use(b[u]);
  };
  load_round(threadIdx.x, buf[0]);
  for (int it0 = threadIdx.x; it0 < items; it0 += 2 * R) {
    load_round(it0 + R, buf[1]);
    use_round(it0, buf[0]);
    load_round(it0 + 2 * R, buf[0]);
    use_round(it0 + R, buf[1]);
  }
}

// z of a bf16 pair of one channel (tail_pair.cuh's relu_pair, one a and b).
__device__ __forceinline__ __nv_bfloat162 relu_pair(float2 yf, float a, float b) {
  return relu_pair(yf, make_float2(a, a), make_float2(b, b));
}

// The pool routing of a bf16 pair of windows in packed bf16x2: the
// window's four y pairs yf in f32 and their dz (tail_pair.cuh's
// route_z_pair).
__device__ __forceinline__ void route_pair(const __nv_bfloat162 (&yv)[4], __nv_bfloat162 gv,
                                           const float (&ca)[4], const float (&cb)[4],
                                           float2 (&yf)[4], float2 (&dz)[4]) {
  __nv_bfloat162 z[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    yf[i] = __bfloat1622float2(yv[i]);
    z[i] = relu_pair(yf[i], ca[i], cb[i]);
  }
  route_z_pair(z, gv, dz);
}

// The forward of one item: out = the max of the window's four z, V
// elements, each exact in T.
template <typename T, int V, typename VT>
__device__ __forceinline__ VT pool_item(const VT (&yv)[4], const float (&ca)[4],
                                        const float (&cb)[4]) {
  VT out;
#pragma unroll
  for (int e = 0; e < V; ++e) {
    float z[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) z[i] = rounded_relu<T>(elem(yv[i], e), ca[i], cb[i]);
    set_elem(out, e, from_f<T>(fmaxf(fmaxf(z[0], z[1]), fmaxf(z[2], z[3]))));
  }
  return out;
}

// The same for a bf16 pair: the max of bf16 values is exact in packed form.
template <>
__device__ __forceinline__ __nv_bfloat162 pool_item<__nv_bfloat16, 2, __nv_bfloat162>(
    const __nv_bfloat162 (&yv)[4], const float (&ca)[4], const float (&cb)[4]) {
  __nv_bfloat162 z[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) z[i] = relu_pair(__bfloat1622float2(yv[i]), ca[i], cb[i]);
  return __hmax2(__hmax2(z[0], z[1]), __hmax2(z[2], z[3]));
}

// One item's V elements added to s1 and s2 (per channel of the window):
// z = relu(round(y*a + b)), dz routed (tail_math.cuh), t = (y - mu)*inv,
// s1 += dz and s2 += dz*t, element by element.
template <typename T, int V, typename VT>
__device__ __forceinline__ void add_item(const VT (&yv)[4], VT gv, const float (&ca)[4],
                                         const float (&cb)[4], const float (&cm)[4],
                                         const float (&ci)[4], float (&s1)[4],
                                         float (&s2)[4]) {
#pragma unroll
  for (int e = 0; e < V; ++e) {
    float yf[4], z[4], dz[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      yf[i] = elem(yv[i], e);
      z[i] = rounded_relu<T>(yf[i], ca[i], cb[i]);
    }
    route(z, elem(gv, e), dz);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float t = __fmul_rn(__fsub_rn(yf[i], cm[i]), ci[i]);
      s1[i] += dz[i];
      s2[i] += dz[i] * t;
    }
  }
}

// The same for a bf16 pair, routed by route_pair.
template <>
__device__ __forceinline__ void add_item<__nv_bfloat16, 2, __nv_bfloat162>(
    const __nv_bfloat162 (&yv)[4], __nv_bfloat162 gv, const float (&ca)[4],
    const float (&cb)[4], const float (&cm)[4], const float (&ci)[4], float (&s1)[4],
    float (&s2)[4]) {
  float2 yf[4], dz[4];
  route_pair(yv, gv, ca, cb, yf, dz);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float t = __fmul_rn(__fsub_rn(yf[i].x, cm[i]), ci[i]);
    s1[i] += dz[i].x;
    s2[i] += dz[i].x * t;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float t = __fmul_rn(__fsub_rn(yf[i].y, cm[i]), ci[i]);
    s1[i] += dz[i].y;
    s2[i] += dz[i].y * t;
  }
}

// The apply pass of one item: dy of the window's four channels, V
// elements each, by tail_math.cuh's window_dy_of.
template <typename T, int V, typename VT>
__device__ __forceinline__ void dy_item(const VT (&yv)[4], VT gv, const float (&col)[7][4],
                                        VT (&d)[4]) {
#pragma unroll
  for (int e = 0; e < V; ++e) {
    float yf[4];
    T de[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) yf[i] = elem(yv[i], e);
    window_dy_of<T>(yf, elem(gv, e), RegCols{col}, de);
#pragma unroll
    for (int i = 0; i < 4; ++i) set_elem(d[i], e, de[i]);
  }
}

// The same for a bf16 pair: dz by route_pair, then t and dy in f32 in
// window_dy_of's order and roundings.
template <>
__device__ __forceinline__ void dy_item<__nv_bfloat16, 2, __nv_bfloat162>(
    const __nv_bfloat162 (&yv)[4], __nv_bfloat162 gv, const float (&col)[7][4],
    __nv_bfloat162 (&d)[4]) {
  float2 yf[4], dz[4];
  route_pair(yv, gv, col[0], col[1], yf, dz);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    auto dy1 = [&](float y, float z) {
      return dy_of(y, z, col[2][i], col[3][i], col[4][i], col[5][i], col[6][i]);
    };
    d[i] = __floats2bfloat162_rn(dy1(yf[i].x, dz[i].x), dy1(yf[i].y, dz[i].y));
  }
}

// The four channels' word q of an item.
template <typename VT, int Q>
struct WordQ {
  VT v[4];
  __device__ __forceinline__ WordQ(const VT (&y)[4][Q], int q)
      : v{y[0][q], y[1][q], y[2][q], y[3][q]} {}
};

// grid (slabs, Cout); out [N*H, Cout, W].
template <typename T, int V, int Q>
__global__ void __launch_bounds__(kThreads, kFwdMinBlocks)
tail_fwd_kernel(const T* __restrict__ y, const float* __restrict__ a,
                const float* __restrict__ b, T* __restrict__ out, int NH, int C, int co,
                int blk, int W, int rows_per_slab) {
  using VT = typename Vec<T, V>::type;
  using It = Item<VT, Q>;
  const Slab<T, V, Q, true> s(NH, C, co, blk, W, rows_per_slab, out, true, y);
  float ca[4], cb[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    ca[i] = a[s.ch[i]];
    cb[i] = b[s.ch[i]];
  }
  const T* yb = y + s.y0;
  T* ob = out + s.p0;
  walk<kFwdUnroll, It>(
      s.items, [&](int it, It& x) { s.template load<false>(yb, nullptr, it, x); },
      [&](const It& x) {
        if (s.empty(x)) return;
        VT m[Q];
#pragma unroll
        for (int q = 0; q < Q; ++q) m[q] = pool_item<T, V>(WordQ<VT, Q>(x.y, q).v, ca, cb);
        s.write(x, ob + s.p_off(x), m);
      });
}

// grid (slabs, Cout); part f32 [slabs, 2*C] (s1 then s2 per channel).
// Each thread adds its items in order; the warp's lanes combine by a
// shuffle butterfly and the warps in order, and the block writes its four
// channels' s1 and s2.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, kRedMinBlocks)
tail_bwd_reduce_kernel(const T* __restrict__ y, const T* __restrict__ g,
                       const float* __restrict__ a, const float* __restrict__ b,
                       const float* __restrict__ mu, const float* __restrict__ inv,
                       float* __restrict__ part, int NH, int C, int co, int blk, int W,
                       int rows_per_slab) {
  using VT = typename Vec<T, V>::type;
  using It = Item<VT, 1>;
  __shared__ float red[kThreads / 32][8];
  const int tid = threadIdx.x;
  const Slab<T, V, 1, false> s(NH, C, co, blk, W, rows_per_slab);
  float ca[4], cb[4], cm[4], ci[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    ca[i] = a[s.ch[i]];
    cb[i] = b[s.ch[i]];
    cm[i] = mu[s.ch[i]];
    ci[i] = inv[s.ch[i]];
  }
  float s1[4] = {0.f, 0.f, 0.f, 0.f}, s2[4] = {0.f, 0.f, 0.f, 0.f};
  const T *yb = y + s.y0, *gb = g + s.p0;
  walk<kRedUnroll, It>(
      s.items, [&](int it, It& x) { s.template load<true>(yb, gb, it, x); },
      [&](const It& x) {
        add_item<T, V>(WordQ<VT, 1>(x.y, 0).v, x.g[0], ca, cb, cm, ci, s1, s2);
      });
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int off = 16; off > 0; off /= 2) {
      s1[i] += __shfl_xor_sync(0xffffffffu, s1[i], off);
      s2[i] += __shfl_xor_sync(0xffffffffu, s2[i], off);
    }
  if (tid % 32 == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      red[tid / 32][i] = s1[i];
      red[tid / 32][4 + i] = s2[i];
    }
  }
  __syncthreads();
  if (tid < 8) {
    float sum = 0.f;
    for (int w = 0; w < kThreads / 32; ++w) sum += red[w][tid];
    const int i = tid % 4;
    const int c = i == 0 ? s.ch[0] : i == 1 ? s.ch[1] : i == 2 ? s.ch[2] : s.ch[3];
    part[(size_t)blockIdx.x * 2 * C + (tid / 4) * C + c] = sum;
  }
}

// grid (slabs, Cout); dy [N*H, C, W].
template <typename T, int V, int Q>
__global__ void __launch_bounds__(kThreads, kApplyMinBlocks)
tail_bwd_apply_kernel(const T* __restrict__ y, const T* __restrict__ g,
                      const float* __restrict__ a, const float* __restrict__ b,
                      const float* __restrict__ mu, const float* __restrict__ inv,
                      const float* __restrict__ gi, const float* __restrict__ c1,
                      const float* __restrict__ c2, T* __restrict__ dy, int NH, int C,
                      int co, int blk, int W, int rows_per_slab) {
  using VT = typename Vec<T, V>::type;
  using It = Item<VT, Q>;
  const Slab<T, V, Q, true> s(NH, C, co, blk, W, rows_per_slab, dy, false, y, g);
  float col[7][4];
  const WindowCols cols{s.ch, a, b, mu, inv, gi, c1, c2};
#pragma unroll
  for (int k = 0; k < 7; ++k)
#pragma unroll
    for (int i = 0; i < 4; ++i) col[k][i] = cols(k, i);
  const T *yb = y + s.y0, *gb = g + s.p0;
  T* db = dy + s.y0;
  walk<kApplyUnroll, It>(
      s.items, [&](int it, It& x) { s.template load<true>(yb, gb, it, x); },
      [&](const It& x) {
        if (s.empty(x)) return;
        VT d[4][Q];
#pragma unroll
        for (int q = 0; q < Q; ++q) {
          VT dq[4];
          dy_item<T, V>(WordQ<VT, Q>(x.y, q).v, x.g[q], col, dq);
#pragma unroll
          for (int i = 0; i < 4; ++i) d[i][q] = dq[i];
        }
        const int yo = s.y_off(x);
#pragma unroll
        for (int i = 0; i < 4; ++i) s.write(x, db + (yo + s.chW[i]), d[i]);
      });
}

// Pairs (V 2) where W is even and every pointer holds whole pairs of T.
template <typename T, typename... P>
bool in_pairs(int W, const P*... p) {
  return W % 2 == 0 && (((uintptr_t)p % (2 * sizeof(T)) == 0) && ...);
}

template <typename T>
cudaError_t fwd(const void* y, const float* a, const float* b, void* out, int NH, int C,
                int co, int blk, int W, int slabs, int rows_per_slab, cudaStream_t st) {
  const dim3 grid(slabs, C / 4);
  if (in_pairs<T>(W, y, out))
    tail_fwd_kernel<T, 2, kWords<T>><<<grid, kThreads, 0, st>>>((const T*)y, a, b, (T*)out, NH,
                                                                C, co, blk, W, rows_per_slab);
  else
    tail_fwd_kernel<T, 1, 1><<<grid, kThreads, 0, st>>>((const T*)y, a, b, (T*)out, NH, C, co,
                                                        blk, W, rows_per_slab);
  return cudaGetLastError();
}

template <typename T>
cudaError_t bwd_reduce(const void* y, const void* g, const float* a, const float* b,
                       const float* mu, const float* inv, float* part, float* sums, int NH,
                       int C, int co, int blk, int W, int slabs, int rows_per_slab,
                       cudaStream_t st) {
  const dim3 grid(slabs, C / 4);
  if (in_pairs<T>(W, y, g))
    tail_bwd_reduce_kernel<T, 2><<<grid, kThreads, 0, st>>>(
        (const T*)y, (const T*)g, a, b, mu, inv, part, NH, C, co, blk, W, rows_per_slab);
  else
    tail_bwd_reduce_kernel<T, 1><<<grid, kThreads, 0, st>>>(
        (const T*)y, (const T*)g, a, b, mu, inv, part, NH, C, co, blk, W, rows_per_slab);
  return reduce_partials(part, sums, slabs, 2 * C, st);
}

template <typename T>
cudaError_t bwd_apply(const void* y, const void* g, const float* a, const float* b,
                      const float* mu, const float* inv, const float* gi, const float* c1,
                      const float* c2, void* dy, int NH, int C, int co, int blk, int W,
                      int slabs, int rows_per_slab, cudaStream_t st) {
  const dim3 grid(slabs, C / 4);
  if (in_pairs<T>(W, y, g, dy))
    tail_bwd_apply_kernel<T, 2, kWords<T>><<<grid, kThreads, 0, st>>>(
        (const T*)y, (const T*)g, a, b, mu, inv, gi, c1, c2, (T*)dy, NH, C, co, blk, W,
        rows_per_slab);
  else
    tail_bwd_apply_kernel<T, 1, 1><<<grid, kThreads, 0, st>>>(
        (const T*)y, (const T*)g, a, b, mu, inv, gi, c1, c2, (T*)dy, NH, C, co, blk, W,
        rows_per_slab);
  return cudaGetLastError();
}

// The slab plan must cover the N*H rows and keep a slab's elements of y
// (and so its slots) an int.
inline bool bad_plan(int NH, int C, int W, int slabs, int rows_per_slab) {
  return slabs < 1 || rows_per_slab < 1 || (long long)slabs * rows_per_slab < NH ||
         (long long)rows_per_slab * C * (W + 64) >= (1ll << 31);
}

}  // namespace

// Blocks a pass (0 fwd, 1 reduce, 2 apply) should run: kWaves times those
// of its bf16 pair kernel the card holds at once (0 if the device cannot
// be asked). The wrapper splits the N*H rows into slabs of whole rows,
// about this many blocks in all over the C/4 windows
// (ops/conv_t.py::wgrad_slabs); the reduce sizes ``part`` as slabs * 2 * C
// floats.
extern "C" int bn_tail_t_slots(int pass) {
  using B = __nv_bfloat16;
  if (pass == 0) return kWaves * device_slots(tail_fwd_kernel<B, 2, kWords<B>>, 0);
  if (pass == 1) return kWaves * device_slots(tail_bwd_reduce_kernel<B, 2>, 0);
  if (pass == 2) return kWaves * device_slots(tail_bwd_apply_kernel<B, 2, kWords<B>>, 0);
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16. y [N*H, C, W] of dtype, C =
// blk*blk*co; a, b f32 [C]; out [N*H, C/4, W] of dtype; the rows in slabs
// of rows_per_slab.
extern "C" int bn_tail_t_fwd(int dtype, const void* y, const float* a, const float* b,
                             void* out, int NH, int C, int co, int blk, int W, int slabs,
                             int rows_per_slab, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bad_tail_geometry(NH, C, co, blk) || bad_plan(NH, C, W, slabs, rows_per_slab))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)fwd<float>(y, a, b, out, NH, C, co, blk, W, slabs, rows_per_slab, st);
  if (dtype == 1)
    return (int)fwd<__nv_bfloat16>(y, a, b, out, NH, C, co, blk, W, slabs, rows_per_slab, st);
  return (int)cudaErrorInvalidValue;
}

// y [N*H, C, W], g [N*H, C/4, W] of dtype; a, b, mu, inv f32 [C]; part
// f32 [slabs, 2*C] scratch; sums f32 [2*C] = s1 then s2 per channel.
extern "C" int bn_tail_t_bwd_reduce(int dtype, const void* y, const void* g, const float* a,
                                    const float* b, const float* mu, const float* inv,
                                    float* part, float* sums, int NH, int C, int co, int blk,
                                    int W, int slabs, int rows_per_slab, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bad_tail_geometry(NH, C, co, blk) || bad_plan(NH, C, W, slabs, rows_per_slab))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)bwd_reduce<float>(y, g, a, b, mu, inv, part, sums, NH, C, co, blk, W, slabs,
                                  rows_per_slab, st);
  if (dtype == 1)
    return (int)bwd_reduce<__nv_bfloat16>(y, g, a, b, mu, inv, part, sums, NH, C, co, blk, W,
                                          slabs, rows_per_slab, st);
  return (int)cudaErrorInvalidValue;
}

// As the reduce, plus gi, c1, c2 f32 [C]; dy [N*H, C, W] of dtype.
extern "C" int bn_tail_t_bwd_apply(int dtype, const void* y, const void* g, const float* a,
                                   const float* b, const float* mu, const float* inv,
                                   const float* gi, const float* c1, const float* c2,
                                   void* dy, int NH, int C, int co, int blk, int W, int slabs,
                                   int rows_per_slab, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bad_tail_geometry(NH, C, co, blk) || bad_plan(NH, C, W, slabs, rows_per_slab))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)bwd_apply<float>(y, g, a, b, mu, inv, gi, c1, c2, dy, NH, C, co, blk, W, slabs,
                                 rows_per_slab, st);
  if (dtype == 1)
    return (int)bwd_apply<__nv_bfloat16>(y, g, a, b, mu, inv, gi, c1, c2, dy, NH, C, co, blk,
                                         W, slabs, rows_per_slab, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
