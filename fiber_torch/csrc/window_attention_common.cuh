// Device helpers shared by the window-attention forward (K1) and backward
// (K2) kernels: dtype conversion, warp reductions and the staged-row
// layout.  Included by window_attention.cu and window_attention_bwd.cu.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stddef.h>

namespace fiber {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}
// x rounded to T and back: the rounding steps of the plain version
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// Row stride of a staged (N, hd) operand, in elements: an odd number of
// 32-bit words, so that 32 lanes reading 32 different rows hit 32
// different banks.
template <typename T> __host__ __device__ constexpr int k_stride(int hd) {
  return sizeof(T) == 4 ? hd + 1 : hd + 2;
}

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~size_t(15);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace fiber
