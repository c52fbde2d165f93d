// The fp32 window-attention forward on the CUDA cores, register-tiled: the
// routine of K1's and K4's fp32 route ("f32_tiled": window_attention_f32.cu,
// window_attention_heads_f32.cu).
//
// For every batch element b of [b_begin, b_end) it computes rows [r0, r0 +
// 8 warps) of one (window, head)'s
//
//     out = softmax(q * hd^-1/2 . k^T + bias) . v
//
// in fp32 with the operations, in the order, of attend_head
// (window_attention_common.cuh), the CUDA-core routine this one replaces
// for fp32 at hd <= 64: a logit is fmaf(q~[d], k[d], .) over d = 0 ... hd
// - 1 from 0, plus the bias; the row's max over the keys; its sum of
// expf(logit - max) taken by each lane over its keys j = lane + 32 t in
// order of t, then across the lanes by xor-shuffles 16, 8, 4, 2, 1; p =
// e / sum; an output fmaf(p_j, v[j][d], .) over j = 0 ... N - 1 from 0.
// So at hd >= 32 it gives attend_head's bits, which are the plain
// version's on the card (window_attention_reference through cuBLAS with
// TF32 off: `chip_smoke.py`'s fp32 rows measured 0 between them).  Those
// bits matter: fp32 is the detector's default dtype and what the
// card-vs-host gradient checks run, and the split-TF32 forward tried first
// (three TF32 products a product, within 1.5e-6 of the plain version) put
// the detector's deformable offset gradients 10x past their check, where
// this routine's bits hold it.
//
// What bounds it on the card: operations.  At FIBER's 576^2 stage 1 (B =
// 4, nW = 64, h = 4, N = 324, hd = 32) the two products are 13.8 GFLOP,
// 0.205 ms at the CUDA cores' 67 TFLOP/s, against 277 MB of qkv, output
// and bias, 0.083 ms at 3.35 TB/s.  attend_head (one warp a query row, one
// fmaf per shared-memory read) ran there at 10x that bound.  Here:
// * A warp owns 8 query rows: its lanes hold the logits of keys j = lane +
//   32 t for all 8 (the attend_head layout, eight rows deep), so each K
//   value read from shared memory (16 bytes: 4 channels of one key) feeds
//   32 fmaf, and each q~ value (a broadcast read) feeds KC.
// * The softmax runs in registers, as attend_head's.
// * P.V: a lane owns channel d (and d + 32 at hd = 64) of the 8 rows; the
//   rows' p pass through a 1 KB exchange buffer a warp, 32 keys at a time,
//   read as broadcasts (two 16-byte reads give one key's 8 p), so each V
//   read feeds 8 fmaf.
// * K (rows of hd + 4 floats: 8 lanes' 16-byte reads of 8 rows hit 32
//   banks), V (rows of hd, lanes on neighbouring channels) and the block's
//   q~ = q * hd^-1/2 rows are staged by cp.async once an element; rows
//   past N are not read.
// F32Rows (below, shared with K2's window_attention_tf32.cuh) places the
// operands of batch element b.
//
// K3's fp32 route (swin_stage_tf32.cu) runs the same routine with K3 = true,
// at K3's rounding, that of fiber_torch/ops/swin_stage.py::
// _attention_reference: the logits the fp32 q . k^T scaled by hd^-1/2 after
// the product, plus the bias row, plus the shift mask's row where there is
// one.  With K3 = false (K1, K4) nothing of it is compiled in.
#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "window_attention_bwd_common.cuh"
#include "window_attention_common.cuh"

namespace fiber {

constexpr int kF32RowsWarp = 8;        // query rows a warp
constexpr int kF32FwdMaxWarps = 8;

// key chunks a lane: N <= 32 KC
inline int f32_key_chunks(int N) {
  return N <= 64 ? 2 : N <= 160 ? 5 : N <= 256 ? 8 : 11;
}

inline bool f32_takes(int N, int hd) {
  return N >= 1 && N <= 352 && (hd == 8 || hd == 16 || hd == 32 || hd == 64);
}

// Bytes of shared memory: K (32 KC rows of hd + 4 fp32), V (32 KC rows of
// hd), the block's q~ rows and each warp's p exchange (32 keys x 8 rows).
__host__ __device__ inline size_t attend_f32_smem_bytes(int KC, int hd,
                                                        int warps) {
  return sizeof(float) * ((size_t)32 * KC * (hd + 4) + (size_t)32 * KC * hd
                          + (size_t)kF32RowsWarp * warps * hd
                          + (size_t)warps * 32 * kF32RowsWarp);
}

// The operand rows of one (window, head), from batch element 0 on: q, k and
// v rows at q0 / k0 / v0 + n * in_rs, the output's at out + n * out_rs, the
// next element in_elem (out_elem) further.  K1 and K2 pass the packed qkv
// rows (in_rs = 3C, out_rs = C), K4 the per-head rows (both hd).
struct F32Rows {
  const float *q0, *k0, *v0;
  float* out;
  long long in_elem, out_elem, in_rs, out_rs;
  __device__ const float* q(int b) const { return q0 + b * in_elem; }
  __device__ const float* k(int b) const { return k0 + b * in_elem; }
  __device__ const float* v(int b) const { return v0 + b * in_elem; }
  __device__ float* o(int b) const { return out + b * out_elem; }
};

__device__ __forceinline__ F32Rows packed_rows(const float* qkv, float* out,
                                                int nW, int N, int h, int hd,
                                                int w, int head) {
  const long long C = (long long)h * hd;
  F32Rows r;
  r.q0 = qkv + (long long)w * N * 3 * C + (long long)head * hd;
  r.k0 = r.q0 + C;
  r.v0 = r.q0 + 2 * C;
  r.out = out + (long long)w * N * C + (long long)head * hd;
  r.in_elem = (long long)nW * N * 3 * C;
  r.out_elem = (long long)nW * N * C;
  r.in_rs = 3 * C;
  r.out_rs = C;
  return r;
}

// K3: the logits scaled after the product and `mask` (N x N, or nullptr)
// added after the bias.
template <int HD, int KC, bool K3 = false>
__device__ __forceinline__ void attend_f32(const F32Rows& rows,
                                           const float* __restrict__ bias,
                                           int N, int r0, int b_begin,
                                           int b_end, float scale,
                                           float* smem,
                                           const float* __restrict__ mask = nullptr) {
  constexpr int KLD = HD + 4;
  constexpr int R = kF32RowsWarp;
  constexpr int NCH = HD >= 32 ? HD / 32 : 1;   // channels a lane in P.V
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* Ks = smem;
  float* Vs = Ks + 32 * KC * KLD;
  float* Qs = Vs + 32 * KC * HD;                // the block's q~ rows
  float* Px = Qs + R * warps * HD + warp * 32 * R;  // this warp's p
  const int w0 = r0 + R * warp;                 // the warp's first row
  const int nrows = R * warps;

  for (int b = b_begin; b < b_end; ++b) {
    // stage K, V (rows < N) and q (the block's rows < N), 16 bytes a copy
    {
      constexpr int CH = HD / 4;
      const float* k = rows.k(b);
      const float* v = rows.v(b);
      for (int i = threadIdx.x; i < N * CH; i += blockDim.x) {
        const int n = i / CH;
        const int c4 = 4 * (i - n * CH);
        cp_async16(Ks + n * KLD + c4, k + (size_t)n * rows.in_rs + c4);
        cp_async16(Vs + n * HD + c4, v + (size_t)n * rows.in_rs + c4);
      }
      const float* q = rows.q(b);
      const int qn = min(nrows, N - r0);
      for (int i = threadIdx.x; i < qn * CH; i += blockDim.x) {
        const int n = i / CH;
        const int c4 = 4 * (i - n * CH);
        cp_async16(Qs + n * HD + c4, q + (size_t)(r0 + n) * rows.in_rs + c4);
      }
      cp_async_wait_all();
      __syncthreads();
      if (!K3) {
        // q~ = q * scale in fp32, as attend_head rounds it
        for (int i = threadIdx.x; i < qn * HD; i += blockDim.x) Qs[i] *= scale;
        __syncthreads();
      }
    }

    if (w0 < N) {
      const float* Qw = Qs + R * warp * HD;
      // logits: row i, key j = lane + 32 t
      float acc[R][KC];
#pragma unroll
      for (int i = 0; i < R; ++i) {
#pragma unroll
        for (int t = 0; t < KC; ++t) acc[i][t] = 0.f;
      }
#pragma unroll 2
      for (int d = 0; d < HD; d += 4) {
        float4 q4[R];
#pragma unroll
        for (int i = 0; i < R; ++i)
          q4[i] = *reinterpret_cast<const float4*>(Qw + i * HD + d);
#pragma unroll
        for (int t = 0; t < KC; ++t) {
          if (32 * t < N) {
            const float4 k4 =
                *reinterpret_cast<const float4*>(Ks + (lane + 32 * t) * KLD + d);
#pragma unroll
            for (int i = 0; i < R; ++i) {
              float a = acc[i][t];
              a = fmaf(q4[i].x, k4.x, a);
              a = fmaf(q4[i].y, k4.y, a);
              a = fmaf(q4[i].z, k4.z, a);
              a = fmaf(q4[i].w, k4.w, a);
              acc[i][t] = a;
            }
          }
        }
      }
      // the softmax of each row, attend_head's steps: bias, max, exp, sum
      float sums[R];
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const int row = w0 + i;
        const float* brow = bias + (size_t)min(row, N - 1) * N;
        const float* mrow =
            K3 && mask ? mask + (size_t)min(row, N - 1) * N : nullptr;
        float mx = -INFINITY;
#pragma unroll
        for (int t = 0; t < KC; ++t) {
          const int j = lane + 32 * t;
          if (j < N) {
            if (K3) {   // (q . k) * scale + bias (+ mask), each rounded
              acc[i][t] = __fadd_rn(__fmul_rn(acc[i][t], scale), brow[j]);
              if (mrow) acc[i][t] = acc[i][t] + mrow[j];
            } else {
              acc[i][t] = acc[i][t] + brow[j];
            }
            mx = fmaxf(mx, acc[i][t]);
          }
        }
        mx = warp_max(mx);
        float sum = 0.f;
#pragma unroll
        for (int t = 0; t < KC; ++t) {
          const int j = lane + 32 * t;
          if (j < N) {
            acc[i][t] = expf(acc[i][t] - mx);
            sum += acc[i][t];
          }
        }
        sums[i] = warp_sum(sum);
      }
      // P.V: 32 keys at a time through the exchange, j ascending
      float o[R][NCH];
#pragma unroll
      for (int i = 0; i < R; ++i) {
#pragma unroll
        for (int c = 0; c < NCH; ++c) o[i][c] = 0.f;
      }
      const int d0 = HD >= 32 ? lane : lane % HD;
#pragma unroll
      for (int t = 0; t < KC; ++t) {
        if (32 * t >= N) break;
        float4* px = reinterpret_cast<float4*>(Px + lane * R);
        px[0] = make_float4(acc[0][t] / sums[0], acc[1][t] / sums[1],
                            acc[2][t] / sums[2], acc[3][t] / sums[3]);
        px[1] = make_float4(acc[4][t] / sums[4], acc[5][t] / sums[5],
                            acc[6][t] / sums[6], acc[7][t] / sums[7]);
        __syncwarp();
        // each key's 8 fmaf a channel, keys in order; unrolled over full
        // chunks so that the reads of the next keys are in flight
        auto key = [&](int l) {
          const float4 pa = *reinterpret_cast<const float4*>(Px + l * R);
          const float4 pb = *reinterpret_cast<const float4*>(Px + l * R + 4);
          const float p[R] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
          const float* vr = Vs + (32 * t + l) * HD + d0;
#pragma unroll
          for (int c = 0; c < NCH; ++c) {
            const float vv = vr[32 * c];
#pragma unroll
            for (int i = 0; i < R; ++i) o[i][c] = fmaf(p[i], vv, o[i][c]);
          }
        };
        if (32 * t + 32 <= N) {
#pragma unroll 8
          for (int l = 0; l < 32; ++l) key(l);
        } else {
          for (int l = 0; l < N - 32 * t; ++l) key(l);
        }
        __syncwarp();
      }
      if (HD >= 32 || lane < HD) {
        float* dst = rows.o(b);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          if (w0 + i < N) {
#pragma unroll
            for (int c = 0; c < NCH; ++c)
              dst[(size_t)(w0 + i) * rows.out_rs + d0 + 32 * c] = o[i][c];
          }
        }
      }
    }
    __syncthreads();               // every warp is done with K, V and q~
  }
}

}  // namespace fiber
