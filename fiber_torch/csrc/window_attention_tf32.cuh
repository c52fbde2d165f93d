// Split-TF32 products on staged fp32 operands: the pieces of K2's fp32
// route ("tc_f32", window_attention_bwd_tf32.cu).  An fp32 operand is
// staged in shared memory as a big (TF32) plane and a small one
// (mma_tf32.cuh), and a product runs as three mma.sync m16n8k8 TF32
// products into fp32, about fp32's accuracy at the tensor cores' rate.
//
// * The ring (ring_loop): stages of 32 rows of two operands (fp32 rows of
//   hd + 4 floats, so that the fragment reads of 8 rows x 4 lanes hit 32
//   banks), copied by cp.async several stages ahead; each thread splits the
//   values it copied before the stage's barrier, so the warps read B
//   fragments already split.  Rows past N are zeroed.
// * A warp's 16 rows are A fragments, split in registers
//   (load_rows_a); a product of them with a staged operand, transposed
//   (rows_times_staged_t: S = q~ . K^T, dP = dO . V^T and their column
//   twins), starts from 0, and the bias is added after it in fp32 (read
//   from L2 before the products: load_bias_f32).
// * A product of accumulator tiles with a staged operand
//   (acc_times_staged: dq, dk, dv) takes the tiles, renumbered
//   (mma_tf32.cuh), as A fragments split in registers.
// * exp is exp2 of the difference from the max times log2(e) (f32_exp).
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "mma_tf32.cuh"
#include "window_attention_bwd_common.cuh"
#include "window_attention_f32.cuh"

namespace fiber {

constexpr int kF32KeyBlock = 32;                 // keys (or rows) a stage
constexpr int kF32KeyTiles = kF32KeyBlock / 8;   // n8 tiles a stage
constexpr int kF32MaxWarps = 8;                  // 16-row slabs a block
constexpr float kF32Log2e = 1.4426950408889634f;

// row stride, in floats, of a staged fp32 operand: hd + 4, so that 8 rows
// x 4 lanes of a fragment read hit 32 different banks
__host__ __device__ constexpr int f32_ld(int hd) { return hd + 4; }

// floats of one split operand plane: 32 rows, big (TF32) values; its small
// values follow in a plane of the same layout
__host__ __device__ constexpr int f32_plane(int hd) {
  return kF32KeyBlock * f32_ld(hd);
}

// floats of one ring stage: two operands (K and V, or q and dO), each as a
// big and a small plane
__host__ __device__ constexpr int f32_stage_floats(int hd) {
  return 4 * f32_plane(hd);
}

// exp(x) for x <= 0, x = s - max already formed: exp2 of x log2(e).  The
// product's rounding moves exp(x) by at most |x| 2^-24 of itself, so an
// exponential x e^x <= 0.37 of the row's max moves it by under 2.2e-8.
__device__ __forceinline__ float f32_exp(float x) {
  return exp2f(x * kF32Log2e);
}

__device__ __forceinline__ void f32_cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int pending>
__device__ __forceinline__ void f32_cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(pending) : "memory");
}

// A ring of STAGES stages over `steps` steps: stage(i) issues step i's
// copies into slot i % STAGES; when they have landed, split(i) turns the
// values each thread copied into big and small planes, and body(i) runs.
// Step i + STAGES - 1 is issued before step i is waited for, into the slot
// step i - 1 used, which every warp left at the __syncthreads that ends
// step i - 1.
template <int STAGES, class Stage, class Split, class Body>
__device__ __forceinline__ void ring_loop(int steps, Stage stage, Split split,
                                          Body body) {
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < steps) stage(i);
    f32_cp_commit();
  }
  for (int i = 0; i < steps; ++i) {
    if (i + STAGES - 1 < steps) stage(i + STAGES - 1);
    f32_cp_commit();
    f32_cp_wait<STAGES - 1>();
    split(i);                      // this thread's own copies of step i
    __syncthreads();               // step i is staged and split
    body(i);
    __syncthreads();               // every warp is done with its slot
  }
}

// Rows [r0, r0 + 32) of two (N, HD) operands (at a, row n at a + n * ars;
// b likewise) into a stage at S: a's big plane at S, b's at S + 2 plane;
// 16 bytes a copy; rows past N are zeroed in both planes.
template <int HD>
__device__ __forceinline__ void stage_pair_f32(float* S, const float* a,
                                               long long ars, const float* b,
                                               long long brs, int r0, int N) {
  constexpr int CH = HD / 4;                 // 16-byte chunks in a row
  constexpr int LD = f32_ld(HD);
  constexpr int PL = f32_plane(HD);
  for (int i = threadIdx.x; i < 2 * kF32KeyBlock * CH; i += blockDim.x) {
    const int op = i / (kF32KeyBlock * CH);
    const int rem = i - op * kF32KeyBlock * CH;
    const int r = rem / CH;
    const int ch = rem - r * CH;
    float* dst = S + 2 * op * PL + r * LD + 4 * ch;
    const int n = r0 + r;
    if (n < N) {
      cp_async16(dst, (op ? b + (size_t)n * brs : a + (size_t)n * ars) + 4 * ch);
    } else {
      *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(dst + PL) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
}

// The values this thread copied by stage_pair_f32 (same rows and chunks),
// a's times `amul`: each into its TF32 big value in place and its small
// value in the plane after.
template <int HD>
__device__ __forceinline__ void split_pair_f32(float* S, int r0, int N,
                                               float amul) {
  constexpr int CH = HD / 4;
  constexpr int LD = f32_ld(HD);
  constexpr int PL = f32_plane(HD);
  for (int i = threadIdx.x; i < 2 * kF32KeyBlock * CH; i += blockDim.x) {
    const int op = i / (kF32KeyBlock * CH);
    const int rem = i - op * kF32KeyBlock * CH;
    const int r = rem / CH;
    const int ch = rem - r * CH;
    if (r0 + r >= N) continue;
    float4* big = reinterpret_cast<float4*>(S + 2 * op * PL + r * LD + 4 * ch);
    float4 x = *big;
    if (op == 0) {
      x.x *= amul;
      x.y *= amul;
      x.z *= amul;
      x.w *= amul;
    }
    uint32_t b[4], sm[4];
    split_tf32(x.x, b[0], sm[0]);
    split_tf32(x.y, b[1], sm[1]);
    split_tf32(x.z, b[2], sm[2]);
    split_tf32(x.w, b[3], sm[3]);
    *big = make_float4(__uint_as_float(b[0]), __uint_as_float(b[1]),
                       __uint_as_float(b[2]), __uint_as_float(b[3]));
    *(big + PL / 4) = make_float4(__uint_as_float(sm[0]), __uint_as_float(sm[1]),
                                  __uint_as_float(sm[2]), __uint_as_float(sm[3]));
  }
}

// The bias of rows ra, rb and keys col, col + 1 from the (N, N) bias: -inf
// on keys past N, 0 on rows past N.
__device__ __forceinline__ void load_bias_f32(float (&d)[4],
                                              const float* __restrict__ bias,
                                              int N, int col, int ra, int rb) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = hr ? rb : ra;
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int j = col + e;
      d[2 * hr + e] = j >= N ? -INFINITY
                    : row < N ? __ldg(bias + (size_t)row * N + j) : 0.f;
    }
  }
}

// The A fragments of rows ra, rb of an (N, HD) operand (row n at x + n *
// rs), times `mul`, as fp32 values (0 on rows past N): split where used,
// to spare registers, or held split (SplitA) where they fit.
template <int HD>
__device__ __forceinline__ void load_rows_a(float (&a)[HD / 8][4],
                                            const float* __restrict__ x,
                                            long long rs, int ra, int rb,
                                            int N, float mul, int c) {
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) {
    const int d = 8 * kk + c;
    const float* xa = x + (size_t)ra * rs + d;
    const float* xb = x + (size_t)rb * rs + d;
    a[kk][0] = ra < N ? xa[0] * mul : 0.f;
    a[kk][1] = rb < N ? xb[0] * mul : 0.f;
    a[kk][2] = ra < N ? xa[4] * mul : 0.f;
    a[kk][3] = rb < N ? xb[4] * mul : 0.f;
  }
}

template <int HD>
__device__ __forceinline__ void load_rows_a(SplitA (&a)[HD / 8],
                                            const float* __restrict__ x,
                                            long long rs, int ra, int rb,
                                            int N, float mul, int c) {
  float raw[HD / 8][4];
  load_rows_a<HD>(raw, x, rs, ra, rb, N, mul, c);
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) a[kk] = SplitA(raw[kk]);
}

// d[t] = (the warp's 16 rows, A fragments a) . X[8t ... 8t + 7]^T for the
// tiles t < nt of a staged, split (32, HD) operand X (0 on the others):
// S = q~ . K^T, dP = dO . V^T, S^T = K . q~^T.  Each tile's hd / 8 x 3
// products start from 0.  A is SplitA[HD / 8] or raw float[HD / 8][4].
template <int HD, class A>
__device__ __forceinline__ void rows_times_staged_t(
    float (&d)[kF32KeyTiles][4], const A& a, const float* __restrict__ X,
    int nt, int g, int c) {
  constexpr int LD = f32_ld(HD);
  constexpr int PL = f32_plane(HD);
#pragma unroll
  for (int t = 0; t < kF32KeyTiles; ++t) d[t][0] = d[t][1] = d[t][2] = d[t][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 8; ++kk) {
    const SplitA ak(a[kk]);
#pragma unroll
    for (int t = 0; t < kF32KeyTiles; ++t) {
      if (t < nt) {
        const int o = (8 * t + g) * LD + 8 * kk + c;
        mma_3xtf32(d[t], ak, planes_b(X, o, o + 4, PL));
      }
    }
  }
}

// o[n] += (accumulator tiles p, renumbered as A fragments) . X for the
// tiles t < nt of a staged, split (32, HD) operand X: P . V, dS . K,
// P^T . dO, dS^T . q~.
template <int HD>
__device__ __forceinline__ void acc_times_staged(
    float (&o)[HD / 8][4], const float (&p)[kF32KeyTiles][4],
    const float* __restrict__ X, int nt, int g, int c) {
  constexpr int LD = f32_ld(HD);
  constexpr int PL = f32_plane(HD);
#pragma unroll
  for (int t = 0; t < kF32KeyTiles; ++t) {
    if (t < nt) {
      SplitA a;
      a.from_acc(p[t]);
      const int o0 = (8 * t + 2 * c) * LD + g;
#pragma unroll
      for (int n = 0; n < HD / 8; ++n)
        mma_3xtf32(o[n], a, planes_b(X, o0 + 8 * n, o0 + LD + 8 * n, PL));
    }
  }
}

}  // namespace fiber
