// Inline-PTX building blocks of the tensor-core kernels: cp.async copies
// into shared memory, bulk copies out of it, shared-memory barriers and
// tensor-map (TMA) loads, ldmatrix and the m16n8k16 bf16 mma.sync, and the
// staging of windows of rows of a bf16 tensor whose rows may be only 2- or
// 4-byte aligned; and the resident-block count that sizes the persistent
// kernels' grids.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte cp.async from global to shared memory (both 16-byte aligned):
// the first ``bytes`` (0 to 16) are read, the rest of the 16 zero-filled.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(bytes)
               : "memory");
}

// 4-byte cp.async (both 4-byte aligned): ``bytes`` 0 zero-fills
__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Bulk copies (the copy engine, no registers): ``bytes`` (a multiple of
// 16) from shared to global memory, both 16-byte aligned. Shared memory
// written by ordinary stores is made visible to them by
// fence_proxy_async in the writing threads; a thread's bulk copies are
// grouped by bulk_commit, and bulk_wait_read<N> returns once at most N of
// its groups may still read their shared memory (bulk_wait<N>: still
// write theirs).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_store(void* gdst, const void* ssrc, int bytes) {
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;\n" ::"l"(gdst),
               "r"(smem_u32(ssrc)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// Shared-memory barriers (mbarrier) and tensor-map (TMA) loads. A full
// barrier counts one arrival that announces the bytes to come, which the
// tensor copies then deliver; a thread waits for a phase by its parity.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the copy engine (then a block
// barrier makes them visible to the threads)
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("{\n.reg .b64 st;\nmbarrier.arrive.shared::cta.b64 st, [%0];\n}\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile(
      "{\n.reg .b64 st;\nmbarrier.arrive.expect_tx.shared::cta.b64 st, [%0], %1;\n}\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

// until the phase of parity ``parity`` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred p;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%0], %1;\n"
      "@!p bra WAIT_%=;\n}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// the box at coordinates (x, y, z) of a 3-D tensor map into shared memory
// (aligned as the map's swizzle needs), completing on ``bar``
__device__ __forceinline__ void tma_load_3d(void* dst, const void* tmap, int x, int y, int z,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(x), "r"(y), "r"(z), "r"(smem_u32(bar))
      : "memory");
}

// four 8x8 b16 matrices; lane l gives the address of row l % 8 of matrix
// l / 8 (16 bytes, 16-byte aligned)
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// the same four matrices transposed: lane (g, t) gets row 2t, 2t+1 of
// column g of each (the A fragment of a matrix stored column-major)
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p))
               : "memory");
}

// d += a b for a 16x16 row-major bf16 A, a 16x8 column-major bf16 B and an
// f32 16x8 D. Lane l (g = l / 4, t = l % 4) holds A rows g, g+8 at columns
// 2t, 2t+1 and 2t+8, 2t+9 (a0: row g cols 2t.., a1: row g+8, a2: row g
// cols 2t+8.., a3: row g+8 cols 2t+8..), B column g at rows 2t, 2t+1 (b0)
// and 2t+8, 2t+9 (b1), and D row g (d0, d1) and g+8 (d2, d3) at columns
// 2t, 2t+1. The lower half of each 32-bit register is the lower index.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// How the bf16 bodies stage windows of rows of a [..., W] tensor into
// shared memory. kShift16 (W even, every operand base 16-byte aligned):
// 16-byte cp.async of the aligned chunks around the window, so a row
// whose start is not 16-byte aligned (2W bytes is only 4-byte aligned at
// W % 8 == 2, the main path's W 750) lands shifted by row_shift elements.
// kElem (odd W, or a base off 16 bytes): 2-byte loads and stores, no
// shift.
enum StageMode { kElem = 0, kShift16 = 1 };

inline int stage_mode(uintptr_t bases, int W) {
  return W % 2 == 0 && bases % 16 == 0 ? kShift16 : kElem;
}

// The shift, in elements, of the row starting at ``row`` under MODE: its
// address mod 16 in elements (0, 2, 4 or 6 under kShift16), else 0.
template <int MODE>
__device__ __forceinline__ int row_shift(const __nv_bfloat16* row) {
  return MODE == kShift16 ? (int)((reinterpret_cast<uintptr_t>(row) & 15) >> 1) : 0;
}

// Stages elements e0 .. e0+N-1 (e0 and N multiples of 8) of ``rows`` rows
// src, src + W, ... into dst, dst + pitch (16-byte aligned, pitch >= N+8):
// element e of row ``row`` lands at dst[e - e0 + row_shift(row)]. Elements
// at e >= W and rows >= rows_ok are zero; elements at e < 0 are zero
// except, under kShift16, the up to 6 below 0 in the chunk that holds a
// row's start, which hold the previous row's tail (it lies in the same
// tensor: a row at its 16-byte aligned base has shift 0): a consumer that
// reads e < 0 masks them. kShift16 copies asynchronously (the caller
// commits and waits), kElem synchronously. All threads of the block take
// part.
template <int MODE, int N>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, int pitch,
                                           const __nv_bfloat16* src, int rows, int rows_ok,
                                           int W, int e0) {
  static_assert(N % 8 == 0, "whole chunks");
  if constexpr (MODE == kShift16) {
    constexpr int PER = N / 8 + 1;         // chunks a row at any shift
    for (int i = threadIdx.x; i < rows * PER; i += blockDim.x) {
      const int r = i / PER, k = i - r * PER;
      const __nv_bfloat16* row = src + (size_t)r * W;
      const int cs = e0 - row_shift<MODE>(row) + 8 * k;   // the chunk's first element
      const int n = r < rows_ok && cs > -8 && cs < W ? min(8, W - cs) : 0;
      cp_async16(dst + r * pitch + 8 * k, n ? row + cs : src, 2 * n);
    }
  } else {
    for (int i = threadIdx.x; i < rows * N; i += blockDim.x) {
      const int r = i / N, v = i - r * N;
      const int e = e0 + v;
      const bool ok = r < rows_ok && e >= 0 && e < W;
      dst[r * pitch + v] = ok ? src[(size_t)r * W + e] : __float2bfloat16_rn(0.f);
    }
  }
}

// Blocks of ``kernel`` (256 threads, ``bytes`` of dynamic shared memory)
// resident on the whole current device at once; 0 if it cannot be asked.
template <typename K>
int device_slots(K kernel, size_t bytes) {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  if (bytes > 48 * 1024 &&
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes) !=
          cudaSuccess)
    return 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, 256, bytes) != cudaSuccess)
    return 0;
  return sms * per_sm;
}

}  // namespace
