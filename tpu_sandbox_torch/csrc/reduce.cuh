// Fixed-order sum of per-block partials, shared by the kernels whose TPU
// versions carry a sum in VMEM across a sequential grid (the conv's fused
// BN statistics, the BN tail's backward reduction). Blocks on the GPU run
// in parallel and in no order, so each writes a partial row and this pass
// adds the rows: no float atomics, so two runs are bitwise equal.
#pragma once

#include <cuda_runtime.h>

namespace {

// out[i] = sum over k < S of part[k * M + i]. A block owns 32 columns
// (one coalesced 128-byte read per thread row); each of its 32 thread rows
// sums a contiguous run of k in order, then thread row 0 adds the 32 runs
// in order.
__global__ void reduce_partials_kernel(const float* __restrict__ part,
                                       float* __restrict__ out, int S, int M) {
  __shared__ float red[32][33];
  const int i = blockIdx.x * 32 + threadIdx.x;
  const int per = (S + 31) / 32;
  const int k0 = threadIdx.y * per, k1 = min(S, k0 + per);
  float s = 0.f;
  if (i < M)
    for (int k = k0; k < k1; ++k) s += part[(size_t)k * M + i];
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && i < M) {
    float t = 0.f;
    for (int r = 0; r < 32; ++r) t += red[r][threadIdx.x];
    out[i] = t;
  }
}

// Launch after the kernel that wrote ``part``; reports that kernel's
// launch error first.
inline cudaError_t reduce_partials(const float* part, float* out, int S, int M,
                                   cudaStream_t st) {
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  reduce_partials_kernel<<<(M + 31) / 32, dim3(32, 32), 0, st>>>(part, out, S, M);
  return cudaGetLastError();
}

}  // namespace
