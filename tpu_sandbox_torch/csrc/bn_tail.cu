// Fused train-mode BatchNorm-apply + ReLU + 2x2 block max-pool in the NHWC
// layout [N, H, W, C], and its backward, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels of tpu_sandbox/ops/pallas_bn_tail.py:
//   bn_tail_fwd         <- _fwd_kernel (:114), launched by _forward (:255)
//   bn_tail_bwd_reduce  <- _bwd_reduce_kernel (:136), launched by _vjp_bwd (:294)
//   bn_tail_bwd_apply   <- _bwd_apply_kernel (:162), launched by _vjp_bwd (:327)
//
// The per-window arithmetic is tail_math.cuh's (window, rounded_relu,
// route, window_dy_of) and, on bf16 pairs, tail_pair.cuh's, both shared
// with the transposed tail (bn_tail_t.cu). In NHWC a pool window's four
// members are channels of ONE pixel, r, r+co, r+blk*co and r+blk*co+co,
// and its output is pooled channel o of that pixel, so the loaders address
// y at pixel*C + channel: the TPU's rolls along the lane dim and its
// selection matmul have no counterpart.
//
// What bounds them on the H100: all three are bytes-bound passes (a few
// flops per byte). At 3000x3000, batch 5 (bn1: C 256, co 16, blk 4;
// bn2: C 128, co 32, blk 2), each input read once and each output written
// once at 3.35 TB/s:
//   fwd    y + out       1.80 / 0.90 GB -> 0.537 / 0.269 ms
//   reduce y + g         1.80 / 0.90 GB -> 0.537 / 0.269 ms
//   apply  y + g + dy    3.24 / 1.62 GB -> 0.967 / 0.484 ms
// So all three have to keep enough loads in flight, spend few instructions
// a byte, and fill whole 32-byte sectors with each warp's accesses.
//
// The walk, shared by the three passes: a block takes a slab of whole
// pixels, sized on the host (ops/bn_tail.py::pixel_slabs) to about kWaves
// (the reduce: kRedWaves) waves of the blocks the card holds
// (bn_tail_slots). Thread t owns group
// g = t % G of the pixels t / G, t / G + PB, ... of its slab: a group is V
// consecutive pooled channels o = g*V .. g*V + V-1 of one (a1, b1) block,
// whose window members are four runs of V consecutive channels of y; G =
// C/(4V) groups a pixel, PB = 256/G pixels a round. A thread's channels
// and columns stay fixed for the whole walk; it loads a pixel and uses it,
// and the other warps' loads (two blocks an SM) hide the latency: loading
// the next pixel before using one measured no faster, and with two use
// sites a loop it spilled (the apply far slower). Where co
// is a multiple of 8, the tensors are bf16 and every pointer is 16-byte
// aligned (the main path), V is 8: each member's run is one 16-byte load,
// the pooled cotangent one more, and each output run one 16-byte store;
// the G threads of a pixel read its row of y in whole sectors and a warp's
// stores fill whole sectors. The pool and the routing run in packed bf16x2
// (tail_pair.cuh, exact), t and dy in f32 in window_dy_of's order, so out,
// dz and dy are those of tail_math.cuh's f32 functions bit for bit. The
// forward holds a and b of its 32 channels in registers; the apply's seven
// columns and the reduce's four do not fit beside their work (the reduce
// keeps s1 and s2 of its 32 channels, 64 f32 registers) and sit in shared
// memory, a group's in the order its thread reads them (float4; groups
// kColPitch or kRedPitch apart, so a quarter-warp's reads hit distinct
// banks). Everything else (fp32, co not a multiple of 8, a tensor that
// starts off 16 bytes) takes V 1: one window a thread, one element a word
// through tail_math.cuh's functions, columns in registers. Pixels that do
// not fill a slab's last round are masked. No division per element: a
// pixel's offset is a multiply.
//
// The reduce's sums: a thread adds its pixels in walk order; on the
// 16-byte path (G also a power of two, so a warp holds 32/G whole pixels)
// a group's threads in a warp, lanes l ^ G, l ^ 2G, ..., combine by a
// shuffle butterfly, then the warps in warp order in shared memory; with
// V 1 a window's PB threads combine in order in shared memory. Each block
// writes one partial row; reduce_partials (reduce.cuh) adds the rows in a
// fixed order. No float atomics: two runs of any pass are bitwise equal.
// Left for later: fusing the reduce with the apply (y and g read once for
// both).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "mma.cuh"
#include "reduce.cuh"
#include "tail_math.cuh"
#include "tail_pair.cuh"

namespace {

constexpr int kThreads = 256;
// the forward's and the apply's blocks: twice those resident; the
// reduce's: those resident (each block ends in a combine of its sums)
constexpr int kWaves = 2, kRedWaves = 1;
constexpr int kVec = 8;             // bf16 channels in one 16-byte access
// blocks an SM the passes are built for (65536 / (256 n) registers a
// thread)
constexpr int kFwdMinBlocks = 2, kApplyMinBlocks = 2, kReduceMinBlocks = 2;
// the apply's columns a group in shared memory: seven columns at its four
// runs of 8 channels as float4 (slot (h*4 + i)*7 + k: column k at channels
// ch[i] + 4h .. + 3), one pad so that the groups start in other banks
constexpr int kColSlots = 7 * 8, kColPitch = kColSlots + 1;
// the reduce's columns a group in shared memory: four columns at its four
// runs of 8 channels as float4 pairs (slot (w*4 + i)*2 + h: (a, b) at h 0,
// (mu, inv) at h 1, each of channels ch[i] + 2w, + 2w + 1), one pad
constexpr int kRedSlots = 4 * 8, kRedPitch = kRedSlots + 1;

// A block's share of a pass: pixels [p0, p0 + n) of y
// [NHW, C] and of the pooled [NHW, C/4]. Thread t takes group g = t % G
// (pooled channels g*V .. g*V + V-1; ch the first channel of each window
// member's run) of the pixels q = t / G, q + PB, ... (walk); threads from
// PB*G on take none.
template <int V>
struct Groups {
  int C, Cout, G, PB, g, q, n;
  long long p0;
  int ch[4];

  __device__ __forceinline__ Groups(long long NHW, int C_, int co, int blk, int per)
      : C(C_), Cout(C_ / 4), G(C_ / 4 / V), PB(kThreads / G), g(threadIdx.x % G),
        q(threadIdx.x / G) {
    p0 = (long long)blockIdx.x * per;
    n = q < PB ? (int)min((long long)per, NHW - p0) : 0;
    window(g * V, co, blk, ch);
  }
  // pixel j of the slab: its first element of y, and the group's first of
  // the pooled row
  __device__ __forceinline__ size_t y_at(int j) const { return (size_t)(p0 + j) * C; }
  __device__ __forceinline__ size_t p_at(int j) const {
    return (size_t)(p0 + j) * Cout + g * V;
  }
  // the thread's pixels in order, each loaded and then used
  template <class Use>
  __device__ __forceinline__ void walk(const Use& use) const {
    for (int j = q; j < n; j += PB) use(j);
  }
};

__device__ __forceinline__ uint4 load16(const void* p) {
  return __ldg(static_cast<const uint4*>(p));
}
__device__ __forceinline__ void store16(void* p, uint4 v) { *static_cast<uint4*>(p) = v; }
// word w (channels 2w, 2w + 1) of a 16-byte run of 8 bf16
__device__ __forceinline__ __nv_bfloat162 word(const uint4& u, int w) {
  const unsigned b = w == 0 ? u.x : w == 1 ? u.y : w == 2 ? u.z : u.w;
  __nv_bfloat162 v;
  memcpy(&v, &b, sizeof b);
  return v;
}
__device__ __forceinline__ unsigned bits(__nv_bfloat162 v) {
  unsigned b;
  memcpy(&b, &v, sizeof b);
  return b;
}
// the pair of a float4 that word w of a run uses (its channels 2w, 2w + 1
// are elements 2(w % 2), 2(w % 2) + 1 of the float4 of channels 4(w / 2) ..)
__device__ __forceinline__ float2 pair(const float4& c, int w) {
  return w % 2 ? make_float2(c.z, c.w) : make_float2(c.x, c.y);
}

// y [NHW, C] -> out [NHW, C/4]; grid (slabs), per pixels a slab.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, kFwdMinBlocks)
tail_fwd_kernel(const T* __restrict__ y, const float* __restrict__ a,
                const float* __restrict__ b, T* __restrict__ out, long long NHW, int C,
                int co, int blk, int per) {
  const Groups<V> s(NHW, C, co, blk, per);
  if constexpr (V == kVec) {
    // a and b at channels 2w, 2w + 1 of member i's run
    float2 ca[4][4], cb[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        const int c = s.ch[i] + 2 * w;
        ca[i][w] = make_float2(a[c], a[c + 1]);
        cb[i][w] = make_float2(b[c], b[c + 1]);
      }
    s.walk([&](int j) {
      const T* yp = y + s.y_at(j);
      uint4 yv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) yv[i] = load16(yp + s.ch[i]);
      unsigned o[4];
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        __nv_bfloat162 z[4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          z[i] = relu_pair(__bfloat1622float2(word(yv[i], w)), ca[i][w], cb[i][w]);
        o[w] = bits(__hmax2(__hmax2(z[0], z[1]), __hmax2(z[2], z[3])));
      }
      store16(out + s.p_at(j), make_uint4(o[0], o[1], o[2], o[3]));
    });
  } else {
    float ca[4], cb[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      ca[i] = a[s.ch[i]];
      cb[i] = b[s.ch[i]];
    }
    s.walk([&](int j) {
      const size_t yo = s.y_at(j);
      float z[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) z[i] = rounded_relu<T>(to_f(y[yo + s.ch[i]]), ca[i], cb[i]);
      out[s.p_at(j)] = from_f<T>(fmaxf(fmaxf(z[0], z[1]), fmaxf(z[2], z[3])));
    });
  }
}

// grid (slabs), per pixels a slab; a and b are columns of C, mu and inv of
// co (channel c reads element c % co); part f32 [slabs, 2*C] (s1 then s2
// per channel), one row a block. Dynamic shared memory: reduce_bytes(V, C).
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, kReduceMinBlocks)
tail_bwd_reduce_kernel(const T* __restrict__ y, const T* __restrict__ g,
                       const float* __restrict__ a, const float* __restrict__ b,
                       const float* __restrict__ mu, const float* __restrict__ inv,
                       float* __restrict__ part, long long NHW, int C, int co, int blk,
                       int per) {
  const Groups<V> s(NHW, C, co, blk, per);
  extern __shared__ float4 sm[];
  float* out = part + (size_t)blockIdx.x * 2 * C;
  if constexpr (V == kVec) {
    // the columns a group: at word w and member i, (a, a', b, b') then
    // (mu, mu', inv, inv') of channels ch[i] + 2w, + 2w + 1
    for (int e = threadIdx.x; e < s.G * kRedSlots; e += kThreads) {
      const int grp = e / kRedSlots, slot = e % kRedSlots;
      int ch[4];
      window(grp * V, co, blk, ch);
      // channel c's mu and inv at k = c % co (k + 1 < co: co a multiple of 8)
      const int c = ch[slot / 2 % 4] + 2 * (slot / 8), k = c % co;
      sm[grp * kRedPitch + slot] = slot % 2
                                       ? make_float4(mu[k], mu[k + 1], inv[k], inv[k + 1])
                                       : make_float4(a[c], a[c + 1], b[c], b[c + 1]);
    }
    __syncthreads();
    const float4* col = sm + s.g * kRedPitch;
    // the sums of member i's channel ch[i] + e
    float s1[4][V] = {}, s2[4][V] = {};
    s.walk([&](int j) {
      const T* yp = y + s.y_at(j);
      uint4 yv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) yv[i] = load16(yp + s.ch[i]);
      const uint4 gv = load16(g + s.p_at(j));
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        __nv_bfloat162 z[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 ab = col[(w * 4 + i) * 2];
          z[i] = relu_pair(__bfloat1622float2(word(yv[i], w)), make_float2(ab.x, ab.y),
                           make_float2(ab.z, ab.w));
        }
        float2 dz[4];
        route_z_pair(z, word(gv, w), dz);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4 m = col[(w * 4 + i) * 2 + 1];
          const float2 yf = __bfloat1622float2(word(yv[i], w));
          const float tx = __fmul_rn(__fsub_rn(yf.x, m.x), m.z);
          const float ty = __fmul_rn(__fsub_rn(yf.y, m.y), m.w);
          s1[i][2 * w] += dz[i].x;
          s2[i][2 * w] += dz[i].x * tx;
          s1[i][2 * w + 1] += dz[i].y;
          s2[i][2 * w + 1] += dz[i].y * ty;
        }
      }
    });
    // a group's partners in the warp are lanes l ^ G, l ^ 2G, ...: a
    // butterfly over those lane bits, then the warps in order
    for (int m = s.G; m < 32; m *= 2)
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int e = 0; e < V; ++e) {
          s1[i][e] += __shfl_xor_sync(0xffffffffu, s1[i][e], m);
          s2[i][e] += __shfl_xor_sync(0xffffffffu, s2[i][e], m);
        }
    float* red = reinterpret_cast<float*>(sm + s.G * kRedPitch);
    const int warp = threadIdx.x / 32;
    for (int w = 0; w < kThreads / 32; ++w) {
      if (warp == w && threadIdx.x % 32 < s.G) {
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int e = 0; e < V; ++e) {
            const int c = s.ch[i] + e;
            red[c] = w ? red[c] + s1[i][e] : s1[i][e];
            red[C + c] = w ? red[C + c] + s2[i][e] : s2[i][e];
          }
      }
      __syncthreads();
    }
    for (int c = threadIdx.x; c < 2 * C; c += kThreads) out[c] = red[c];
  } else {
    // one window a thread (PB threads a window), columns in registers,
    // then the PB threads of a window in order
    float* red = reinterpret_cast<float*>(sm);     // [8][kThreads]
    float s1[4] = {0.f, 0.f, 0.f, 0.f}, s2[4] = {0.f, 0.f, 0.f, 0.f};
    float cm[4], ci[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      cm[i] = mu[s.ch[i] % co];
      ci[i] = inv[s.ch[i] % co];
    }
    s.walk([&](int j) {
      float yf[4], z[4], dz[4];
      load_window<T>(y, s.y_at(j), 1, 0, s.ch, a, b, yf, z);
      route(z, to_f(g[s.p_at(j)]), dz);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float t = __fmul_rn(__fsub_rn(yf[i], cm[i]), ci[i]);
        s1[i] += dz[i];
        s2[i] += dz[i] * t;
      }
    });
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      red[i * kThreads + threadIdx.x] = s1[i];
      red[(4 + i) * kThreads + threadIdx.x] = s2[i];
    }
    __syncthreads();
    if (threadIdx.x < s.Cout) {
#pragma unroll
      for (int v = 0; v < 8; ++v) {
        float sum = 0.f;
        for (int r = 0; r < s.PB; ++r) sum += red[v * kThreads + r * s.Cout + threadIdx.x];
        out[(v / 4) * C + s.ch[v % 4]] = sum;
      }
    }
  }
}

// dy [NHW, C]; grid (slabs), per pixels a slab. With V 8 the columns sit
// in dynamic shared memory: G * kColPitch float4.
template <typename T, int V>
__global__ void __launch_bounds__(kThreads, kApplyMinBlocks)
tail_bwd_apply_kernel(const T* __restrict__ y, const T* __restrict__ g,
                      const float* __restrict__ a, const float* __restrict__ b,
                      const float* __restrict__ mu, const float* __restrict__ inv,
                      const float* __restrict__ gi, const float* __restrict__ c1,
                      const float* __restrict__ c2, T* __restrict__ dy, long long NHW, int C,
                      int co, int blk, int per) {
  const Groups<V> s(NHW, C, co, blk, per);
  // column k (0 a, 1 b, 2 mu, 3 inv, 4 gi, 5 c1, 6 c2), as window_dy_of numbers them
  auto column = [&](int k) {
    return k == 0 ? a : k == 1 ? b : k == 2 ? mu : k == 3 ? inv : k == 4 ? gi : k == 5 ? c1 : c2;
  };
  if constexpr (V == kVec) {
    extern __shared__ float4 sc[];
    for (int e = threadIdx.x; e < s.G * kColSlots; e += kThreads) {
      const int grp = e / kColSlots, slot = e % kColSlots;
      const int k = slot % 7, i = slot / 7 % 4, h = slot / 28;
      int ch[4];
      window(grp * V, co, blk, ch);
      const float* c = column(k) + ch[i] + 4 * h;
      sc[grp * kColPitch + slot] = make_float4(c[0], c[1], c[2], c[3]);
    }
    __syncthreads();
    const float4* col = sc + s.g * kColPitch;
    s.walk([&](int j) {
      const T* yp = y + s.y_at(j);
      uint4 yv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) yv[i] = load16(yp + s.ch[i]);
      const uint4 gv = load16(g + s.p_at(j));
      // each word's dz, routed in packed bf16x2
      __nv_bfloat162 dz[4][4];
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        __nv_bfloat162 z[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float4* ci = col + (w / 2 * 4 + i) * 7;
          z[i] = relu_pair(__bfloat1622float2(word(yv[i], w)), pair(ci[0], w), pair(ci[1], w));
        }
        route_z_packed(z, word(gv, w), dz[w]);
      }
      // then each member's dy, t and dy in f32
      T* dp = dy + s.y_at(j);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        unsigned d[4];
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const float4* ci = col + (w / 2 * 4 + i) * 7;
          const float2 yf = __bfloat1622float2(word(yv[i], w));
          const float2 df = __bfloat1622float2(dz[w][i]);
          const float2 m = pair(ci[2], w), iv = pair(ci[3], w), gs = pair(ci[4], w);
          const float2 k1 = pair(ci[5], w), k2 = pair(ci[6], w);
          d[w] = bits(__floats2bfloat162_rn(dy_of(yf.x, df.x, m.x, iv.x, gs.x, k1.x, k2.x),
                                            dy_of(yf.y, df.y, m.y, iv.y, gs.y, k1.y, k2.y)));
        }
        store16(dp + s.ch[i], make_uint4(d[0], d[1], d[2], d[3]));
      }
    });
  } else {
    float col[7][4];
#pragma unroll
    for (int k = 0; k < 7; ++k)
#pragma unroll
      for (int i = 0; i < 4; ++i) col[k][i] = column(k)[s.ch[i]];
    s.walk([&](int j) {
      const size_t yo = s.y_at(j);
      float yf[4];
      T d[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) yf[i] = to_f(y[yo + s.ch[i]]);
      window_dy_of<T>(yf, to_f(g[s.p_at(j)]), RegCols{col}, d);
#pragma unroll
      for (int i = 0; i < 4; ++i) dy[yo + s.ch[i]] = d[i];
    });
  }
}

bool bad_geometry(int C, int co, int blk) {
  return bad_tail_geometry(0, C, co, blk) || C / 4 > kThreads;
}

// A pass's slab plan must cover the pixels with no slab empty, and keep a
// slab's walk in ints.
bool bad_plan(long long NHW, int slabs, int per) {
  return slabs < 1 || per < 1 || per > (1 << 30) || (long long)slabs * per < NHW ||
         (long long)(slabs - 1) * per >= NHW;
}

// The 16-byte path (V 8) of bf16 tensors: co a multiple of 8 and every
// pointer 16-byte aligned (rows of C and C/4 bf16 then are too).
template <typename... P>
bool in_vectors(int co, const P*... p) {
  return co % kVec == 0 && (((uintptr_t)p % 16 == 0) && ...);
}

template <typename T>
constexpr bool kBf16 = std::is_same_v<T, __nv_bfloat16>;

// The apply's columns in shared memory at C channels (the 16-byte path).
int col_bytes(int C) { return C / 4 / kVec * kColPitch * (int)sizeof(float4); }

// The reduce's shared memory at C channels: with V 8 its columns and the
// warps' sums (2C floats), with V 1 its threads' eight sums.
int reduce_bytes(int V, int C) {
  return V == kVec ? C / 4 / kVec * kRedPitch * (int)sizeof(float4) + 2 * C * (int)sizeof(float)
                   : 8 * kThreads * (int)sizeof(float);
}

template <typename T>
cudaError_t fwd(const void* y, const float* a, const float* b, void* out, long long NHW,
                int C, int co, int blk, int slabs, int per, cudaStream_t st) {
  if constexpr (kBf16<T>) {
    if (in_vectors(co, y, out)) {
      tail_fwd_kernel<T, kVec><<<slabs, kThreads, 0, st>>>((const T*)y, a, b, (T*)out, NHW,
                                                           C, co, blk, per);
      return cudaGetLastError();
    }
  }
  tail_fwd_kernel<T, 1><<<slabs, kThreads, 0, st>>>((const T*)y, a, b, (T*)out, NHW, C, co,
                                                    blk, per);
  return cudaGetLastError();
}

// The reduce's 16-byte path also needs the G = C/32 groups of a pixel to
// split a warp evenly (G a power of two), for its lane butterfly; co a
// multiple of 8 makes G at least 1.
template <typename T>
cudaError_t bwd_reduce(const void* y, const void* g, const float* a, const float* b,
                       const float* mu, const float* inv, float* part, float* sums,
                       long long NHW, int C, int co, int blk, int slabs, int per,
                       cudaStream_t st) {
  const int G = C / 4 / kVec;
  if constexpr (kBf16<T>) {
    if (in_vectors(co, y, g) && 32 % G == 0) {
      tail_bwd_reduce_kernel<T, kVec><<<slabs, kThreads, reduce_bytes(kVec, C), st>>>(
          (const T*)y, (const T*)g, a, b, mu, inv, part, NHW, C, co, blk, per);
      return reduce_partials(part, sums, slabs, 2 * C, st);
    }
  }
  tail_bwd_reduce_kernel<T, 1><<<slabs, kThreads, reduce_bytes(1, C), st>>>(
      (const T*)y, (const T*)g, a, b, mu, inv, part, NHW, C, co, blk, per);
  return reduce_partials(part, sums, slabs, 2 * C, st);
}

template <typename T>
cudaError_t bwd_apply(const void* y, const void* g, const float* a, const float* b,
                      const float* mu, const float* inv, const float* gi, const float* c1,
                      const float* c2, void* dy, long long NHW, int C, int co, int blk,
                      int slabs, int per, cudaStream_t st) {
  if constexpr (kBf16<T>) {
    if (in_vectors(co, y, g, dy)) {
      tail_bwd_apply_kernel<T, kVec><<<slabs, kThreads, col_bytes(C), st>>>(
          (const T*)y, (const T*)g, a, b, mu, inv, gi, c1, c2, (T*)dy, NHW, C, co, blk, per);
      return cudaGetLastError();
    }
  }
  tail_bwd_apply_kernel<T, 1><<<slabs, kThreads, 0, st>>>(
      (const T*)y, (const T*)g, a, b, mu, inv, gi, c1, c2, (T*)dy, NHW, C, co, blk, per);
  return cudaGetLastError();
}

}  // namespace

// Blocks the forward (pass 0), the apply (pass 1) or the reduce (pass 2)
// should run at C channels: kWaves (kRedWaves) times those of its bf16
// 16-byte kernel the card holds at once (0 if the device cannot be asked).
// The wrapper splits the pixels into about this many slabs
// (ops/bn_tail.py::pixel_slabs).
extern "C" int bn_tail_slots(int pass, int C) {
  using B = __nv_bfloat16;
  if (C < 4 || C / 4 > kThreads) return 0;
  if (pass == 0) return kWaves * device_slots(tail_fwd_kernel<B, kVec>, 0);
  if (pass == 1) return kWaves * device_slots(tail_bwd_apply_kernel<B, kVec>, col_bytes(C));
  if (pass == 2)
    return kRedWaves * device_slots(tail_bwd_reduce_kernel<B, kVec>, reduce_bytes(kVec, C));
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16. y [N*H*W, C] of dtype, C =
// blk*blk*co <= 1024; a, b f32 [C]; out [N*H*W, C/4] of dtype; the pixels
// in slabs of pixels_per_slab.
extern "C" int bn_tail_fwd(int dtype, const void* y, const float* a, const float* b,
                           void* out, long long NHW, int C, int co, int blk, int slabs,
                           int pixels_per_slab, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bad_geometry(C, co, blk) || bad_plan(NHW, slabs, pixels_per_slab))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)fwd<float>(y, a, b, out, NHW, C, co, blk, slabs, pixels_per_slab, st);
  if (dtype == 1)
    return (int)fwd<__nv_bfloat16>(y, a, b, out, NHW, C, co, blk, slabs, pixels_per_slab,
                                   st);
  return (int)cudaErrorInvalidValue;
}

// y [N*H*W, C], g [N*H*W, C/4] of dtype; a, b f32 [C]; mu, inv f32 [co];
// part f32 [slabs, 2*C], one row a slab; sums f32 [2*C] = s1 then s2 per
// channel; the pixels in slabs as the forward's.
extern "C" int bn_tail_bwd_reduce(int dtype, const void* y, const void* g, const float* a,
                                  const float* b, const float* mu, const float* inv,
                                  float* part, float* sums, long long NHW, int C, int co,
                                  int blk, int slabs, int pixels_per_slab, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bad_geometry(C, co, blk) || bad_plan(NHW, slabs, pixels_per_slab))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)bwd_reduce<float>(y, g, a, b, mu, inv, part, sums, NHW, C, co, blk, slabs,
                                  pixels_per_slab, st);
  if (dtype == 1)
    return (int)bwd_reduce<__nv_bfloat16>(y, g, a, b, mu, inv, part, sums, NHW, C, co, blk,
                                          slabs, pixels_per_slab, st);
  return (int)cudaErrorInvalidValue;
}

// As the reduce, plus gi, c1, c2 f32 [C]; dy [N*H*W, C] of dtype; the
// pixels in slabs as the forward's.
extern "C" int bn_tail_bwd_apply(int dtype, const void* y, const void* g, const float* a,
                                 const float* b, const float* mu, const float* inv,
                                 const float* gi, const float* c1, const float* c2,
                                 void* dy, long long NHW, int C, int co, int blk, int slabs,
                                 int pixels_per_slab, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (bad_geometry(C, co, blk) || bad_plan(NHW, slabs, pixels_per_slab))
    return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return (int)bwd_apply<float>(y, g, a, b, mu, inv, gi, c1, c2, dy, NHW, C, co, blk, slabs,
                                 pixels_per_slab, st);
  if (dtype == 1)
    return (int)bwd_apply<__nv_bfloat16>(y, g, a, b, mu, inv, gi, c1, c2, dy, NHW, C, co,
                                         blk, slabs, pixels_per_slab, st);
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* cuda_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
