// Warp-level bf16 tensor-core helpers shared by the window-attention
// kernels that run on the tensor cores (K2's window_attention_bwd_tc.cu,
// the forward's window_attention_tc.cuh): the staged-operand layout,
// ldmatrix loads, the mma.sync m16n8k16 product with bf16 operands and fp32
// accumulators, bf16 packing, and the quad reductions over an accumulator
// row.
//
// Fragment layout of mma.sync m16n8k16 (g = lane / 4, c2 = 2 (lane % 4)):
// the fp32 accumulator d of a 16x8 tile holds rows g and g + 8, columns c2
// and c2 + 1 (d[0], d[1] on row g; d[2], d[3] on row g + 8), so the four
// lanes of a quad share a row and a row's reduction is two shuffles.  The
// accumulators of two neighbouring n8 tiles, packed to bf16 pairwise, are
// the A fragment of one k16 step.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "window_attention_bwd_common.cuh"

namespace fiber {

__host__ __device__ constexpr int pad16(int n) { return (n + 15) & ~15; }
// staged channels: hd, zero-padded to the mma's k16
__host__ __device__ constexpr int chans(int hd) { return hd < 16 ? 16 : hd; }
// row strides in elements, 16 bytes past a multiple of 16 bytes
__host__ __device__ constexpr int op_ld(int hd) { return chans(hd) + 8; }
__host__ __device__ constexpr int tile_ld(int np) { return np + 8; }

// four 8x8 bf16 matrices; lane l gives the address of row l % 8 of
// matrix l / 8
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)) : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const __nv_bfloat16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)) : "memory");
}

// d += a . b on a 16x8x16 tile: bf16 operands, fp32 accumulators
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats rounded to bf16, the first in the low half
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack(uint32_t u) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&u));
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ void zero(float (&d)[4]) {
  d[0] = d[1] = d[2] = d[3] = 0.f;
}

// d0, d1 += the warp's 16 rows (A fragments a) times rows 8t ... 8t + 15 of
// the staged operand X, transposed: two n8 tiles of S = q~ . K^T or
// dP = dO . V^T.
template <int KQ, int LDO>
__device__ __forceinline__ void key_pair_product(float (&d0)[4], float (&d1)[4],
                                                 const uint32_t (&a)[KQ][4],
                                                 const __nv_bfloat16* X, int t,
                                                 int lane) {
#pragma unroll
  for (int kk = 0; kk < KQ; ++kk) {
    uint32_t x[4];
    ldsm_x4(x, X + (8 * t + (lane & 7) + ((lane >> 4) << 3)) * LDO + kk * 16
               + ((lane >> 3) & 1) * 8);
    mma(d0, a[kk], x[0], x[1]);
    mma(d1, a[kk], x[2], x[3]);
  }
}

}  // namespace fiber
