// Warp-level TF32 tensor-core helpers for the fp32 window-attention kernels
// (K1's and K4's fp32 forward, window_attention_tf32.cuh; K2's fp32
// backward, window_attention_bwd_tf32.cu): the mma.sync m16n8k8 product
// with TF32 operands and fp32 accumulators, and its split-precision form
// ("3xTF32"), which keeps about fp32's accuracy on the tensor cores.
//
// An fp32 value x is split as big = tf32(x), small = tf32(x - big), each
// rounded to nearest (ties away: cvt.rna); x - big is exact in fp32 and
// big + small is x within 2^-22 |x|.  A product a.b is then
// a_small.b_big + a_big.b_small + a_big.b_big (mma_3xtf32); the dropped
// a_small.b_small is below 2^-22 |a||b|.
// The tensor cores take TF32 at 495 TFLOP/s on an H100 SXM, three of them
// an fp32 product: about 165 TFLOP/s, against 67 for fp32 FMAs on the CUDA
// cores.
//
// Fragment layout of mma.sync m16n8k8 .tf32 (g = lane / 4, c = lane % 4):
// A (16 x 8, row-major) a0 = A[g][c], a1 = A[g + 8][c], a2 = A[g][c + 4],
// a3 = A[g + 8][c + 4]; B (8 x 8, column-major) b0 = B[c][g], b1 =
// B[c + 4][g]; the accumulator d0, d1 = D[g][2c], D[g][2c + 1] and d2, d3
// the same columns of row g + 8.  An accumulator tile is not an A fragment
// as it stands (its thread holds columns 2c, 2c + 1, the A fragment columns
// c, c + 4), but a sum over k does not care how k is numbered: with k = c
// standing for column 2c and k = c + 4 for 2c + 1, the accumulator
// {d0, d2, d1, d3} is the A fragment, and B's rows follow the same
// numbering (b0 = B[2c][g], b1 = B[2c + 1][g]).  So P and dS never leave
// registers.
#pragma once

#include <stdint.h>

namespace fiber {

__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x = big + small within 2^-22 |x|
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
                                           uint32_t& small) {
  big = tf32_rna(x);
  small = tf32_rna(x - __uint_as_float(big));
}

// an A fragment of four fp32 values, split
struct SplitA {
  __device__ __forceinline__ SplitA() {}
  __device__ __forceinline__ SplitA(const float (&a)[4]) { set(a[0], a[1], a[2], a[3]); }
  uint32_t big[4], small[4];
  __device__ __forceinline__ void set(float a0, float a1, float a2, float a3) {
    split_tf32(a0, big[0], small[0]);
    split_tf32(a1, big[1], small[1]);
    split_tf32(a2, big[2], small[2]);
    split_tf32(a3, big[3], small[3]);
  }
  // from an accumulator tile, k renumbered as in the header
  __device__ __forceinline__ void from_acc(const float (&d)[4]) {
    set(d[0], d[2], d[1], d[3]);
  }
};

// a B fragment of two fp32 values, split
struct SplitB {
  uint32_t big[2], small[2];
};

// a B fragment read from a staged operand already split in shared memory:
// big values at X[o0], X[o1], small ones `plane` floats further
__device__ __forceinline__ SplitB planes_b(const float* X, int o0, int o1,
                                           int plane) {
  SplitB b;
  b.big[0] = __float_as_uint(X[o0]);
  b.big[1] = __float_as_uint(X[o1]);
  b.small[0] = __float_as_uint(X[o0 + plane]);
  b.small[1] = __float_as_uint(X[o1 + plane]);
  return b;
}

// d += a . b on a 16x8x8 tile: TF32 operands, fp32 accumulators
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d = a . b on a 16x8x8 tile, from a zero accumulator
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.f));
}

// d += a . b in three TF32 products.  The tensor cores round a sum toward
// zero, so a chain of products in one accumulator drifts (on an H100 up to
// 2e-6 in a logit, against the plain fp32 version's 3e-7 of fp64): the two
// small products go into an accumulator of their own, the big one into
// another, and both are added to d in fp32, to nearest.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const SplitA& a,
                                           const SplitB& b) {
  float s[4], u[4];
  mma_tf32_zero(s, a.small, b.big[0], b.big[1]);
  mma_tf32(s, a.big, b.small[0], b.small[1]);
  mma_tf32_zero(u, a.big, b.big[0], b.big[1]);
#pragma unroll
  for (int x = 0; x < 4; ++x) d[x] = (d[x] + u[x]) + s[x];
}

__device__ __forceinline__ float quad_max_f32(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum_f32(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

}  // namespace fiber
