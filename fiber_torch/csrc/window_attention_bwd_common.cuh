// Host and device helpers shared by the two window-attention backward
// kernels (K2: window_attention_bwd.cu on the CUDA cores for fp32,
// window_attention_bwd_tc.cu on the tensor cores for bf16): the split of
// the batch across blocks, the fixed-order sum of the per-split dbias
// partials, the occupancy query the wrapper sizes the split from, and the
// asynchronous copies that stage their operands.
//
// Both kernels run on a grid (nW * h, S).  Block (w * h + head, s) walks
// the batch elements of split s in ascending order and keeps its fp32
// dbias tile on chip across them.  With S = 1 it writes dbias itself; with
// S > 1 it writes its tile into partials[s] (S, nW, h, N, N) fp32, and
// window_attention_bwd_sum_splits adds the S tiles in the order
// s = 0 ... S - 1.  No atomics: two calls give the same bits.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fiber {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 (or 4) bytes from global to shared memory, asynchronously: the copies
// of a stage are all in flight at once, and cp_async_wait_all() followed by
// a __syncthreads() makes them visible to the block.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_u32(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Batch elements [*b0, *b1) of split s of S: contiguous, sizes differing
// by at most one.
__device__ __forceinline__ void split_range(int B, int S, int s, int* b0,
                                            int* b1) {
  *b0 = (int)((long long)s * B / S);
  *b1 = (int)((long long)(s + 1) * B / S);
}

// Where block (wh, s) writes its (N, N) dbias tile.
__device__ __forceinline__ float* dbias_tile(float* dbias, float* partials,
                                             int S, int s, int nWh, int wh,
                                             int N) {
  const size_t tile = (size_t)N * N;
  return S == 1 ? dbias + wh * tile : partials + ((size_t)s * nWh + wh) * tile;
}

// dbias[i] = part[0][i] + part[1][i] + ... + part[S - 1][i], in that order.
__global__ void window_attention_bwd_sum_splits(const float* __restrict__ part,
                                                float* __restrict__ dbias,
                                                int S, long long n) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += step) {
    float acc = part[i];
    for (int s = 1; s < S; ++s) acc += part[s * n + i];
    dbias[i] = acc;
  }
}

inline cudaError_t sum_splits(const float* part, float* dbias, int S,
                              long long n, cudaStream_t stream) {
  constexpr int kThreads = 256;
  long long blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 8192) blocks = 8192;
  window_attention_bwd_sum_splits<<<(int)blocks, kThreads, 0, stream>>>(
      part, dbias, S, n);
  return cudaGetLastError();
}

// Raises `kernel`'s dynamic shared-memory limit to `smem` (when above the
// default 48 KB).
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

// Resident blocks of `kernel` per SM at `threads` threads and `smem` bytes
// of dynamic shared memory; -1 on error.
template <typename K>
inline int blocks_per_sm(K kernel, int threads, size_t smem) {
  int n = 0;
  if (allow_smem(kernel, smem) != cudaSuccess) return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, threads, smem)
      != cudaSuccess)
    return -1;
  return n;
}

// Launches `kernel` on the (nW * h, S) grid, then, for S > 1, the sum of
// the partials into dbias.  Returns the first error.
template <typename K, typename... Args>
inline cudaError_t launch_split(K kernel, int nWh, int S, int threads,
                                size_t smem, cudaStream_t stream,
                                float* dbias, const float* partials,
                                long long dbias_numel, Args... args) {
  cudaError_t e = allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(nWh, S), threads, smem, stream>>>(args...);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if (S == 1) return cudaSuccess;
  return sum_splits(partials, dbias, S, dbias_numel, stream);
}

}  // namespace fiber
