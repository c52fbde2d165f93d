// The window-attention forward of one (window, head) over a run of batch
// elements, bf16 on the tensor cores: the routine of K1's tensor-core
// kernel (window_attention_tc.cu) and K4's (window_attention_heads_tc.cu).
//
// For every batch element b of [b_begin, b_end) it computes
//
//     out = softmax(round(q * hd^-1/2) . k^T + bias) . v
//
// with the rounding steps of the plain version window_attention_reference
// (fiber_torch/ops/window_attention.py): q is scaled in fp32 and rounded to
// bf16 before the product, the logits accumulate in fp32 on top of the fp32
// bias, the softmax is fp32, the probabilities are rounded to bf16 before
// P.V, and P.V accumulates in fp32 and is rounded on store.
//
// Design (the forward half of K2's window_attention_bwd_tc.cu):
// * One warp per 16-row query slab: NP = N padded to 16, NP / 16 warps (9
//   at N = 144).
// * Shared memory holds the (window, head)'s fp32 bias tile, copied once by
//   cp.async for the whole run of batch elements (the TPU kernel kept it
//   resident across its batch sweep the same way), and two buffers of q, K
//   and V in 16-byte-padded bf16 rows: the next element's are copied by
//   cp.async while the current one is computed.  Padded rows, and channels
//   8 ... 15 at hd = 8, are zeroed once and never written again.
// * S = bias + q~ . K^T on mma.sync m16n8k16: the accumulators start as
//   the staged bias (-inf on padded keys, 0 on padded rows); q's A
//   fragments come from ldmatrix and are scaled and rounded in registers;
//   K's B fragments from ldmatrix.  A slab's S row is NP / 2 fp32 a thread.
// * The softmax: quad shuffles for the row max and sum, exp2 of prescaled
//   logits, one reciprocal a row.
// * P.V: the accumulators of two key tiles, packed to bf16, are the A
//   fragment of one k16 step, so P never goes through shared memory; V's B
//   fragments come from ldmatrix.trans.
// * The store writes rows < N and channels < hd only, 4 bytes a lane.
//
// `Rows` places the operands of batch element b: q(b), k(b) and v(b) point
// at row 0 of q, k and v (row n at + n * in_rs), o(b) at row 0 of the
// output (row n at + n * out_rs).  K1 and K3 pass the packed qkv rows
// (PackedRows, in_rs = 3C), K4 the per-head rows (in_rs = hd).  Every row
// start must be 16-byte aligned: the wrappers check the base pointers, and
// hd is a multiple of 8.  The caller gives attend_tc_smem_bytes(N, HD)
// bytes of dynamic shared memory at `smem`.
//
// Two compile-time options, off for K1 and K4:
// * SCALE_AFTER (K3's rounding, fiber_torch/ops/swin_stage.py::
//   fused_swin_blocks_reference): the logits are fp32(q . k^T) * hd^-1/2
//   plus the bias tile; q is neither scaled nor rounded first, and the
//   accumulators start at 0.  With it, a non-null `mask` (N, N) fp32 is
//   added into the staged tile once, so the logits add (bias + mask) where
//   the plain version adds bias and then mask: at most one fp32 ulp apart,
//   far inside bf16's tolerance.
// * SLAB_LOOP: the block's warps loop over the NP / 16 slabs
//   (slab = warp, warp + nwarps, ...), so a block of any warp count runs
//   the routine; warps without a slab still reach every __syncthreads.
//   Without it the block has attend_tc_threads(N) threads, one warp a slab.
#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "window_attention_bwd_common.cuh"
#include "window_attention_common.cuh"

namespace fiber {

constexpr int kTcMaxNP = 144;               // a slab row of S: NP / 2 fp32 a thread
constexpr int kTcMaxWarps = kTcMaxNP / 16;  // one 16-row slab per warp
constexpr int kTcMaxTiles = kTcMaxNP / 8;   // n8 tiles over the keys
constexpr float kTcLog2e = 1.4426950408889634f;

// Bytes of shared memory: the fp32 bias tile and two buffers of q, K, V.
__host__ __device__ inline size_t attend_tc_smem_bytes(int N, int hd) {
  const size_t np = pad16(N);
  return align16(sizeof(float) * np * tile_ld(np))
       + 6 * align16(sizeof(__nv_bfloat16) * np * op_ld(hd));
}

__host__ __device__ inline int attend_tc_threads(int N) {
  return pad16(N) / 16 * 32;
}

// The shapes the routine takes: a slab's S row in registers, the head dims
// instantiated.
inline bool attend_tc_takes(int N, int hd) {
  return N >= 1 && N <= kTcMaxNP && (hd == 8 || hd == 16 || hd == 32 || hd == 64);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits until at most `pending` committed groups of this thread are in
// flight
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(pending) : "memory");
}

// K1's and K3's operands of one (window, head): the packed qkv rows and the
// output rows of one window, from batch element 0 on, at the head's
// channels.
struct PackedRows {
  const __nv_bfloat16* qkv;
  __nv_bfloat16* out;
  long long in_elem, out_elem;  // from one batch element to the next
  long long in_rs, out_rs;      // 3C, C
  int C;
  __device__ const __nv_bfloat16* q(int b) const { return qkv + b * in_elem; }
  __device__ const __nv_bfloat16* k(int b) const { return q(b) + C; }
  __device__ const __nv_bfloat16* v(int b) const { return q(b) + 2 * C; }
  __device__ __nv_bfloat16* o(int b) const { return out + b * out_elem; }
};

// K4's operands of one (window, head): per-head rows of hd values, from
// batch element 0 on.
struct HeadRows {
  const __nv_bfloat16 *q0, *k0, *v0;
  __nv_bfloat16* out;
  long long elem;               // from one batch element to the next
  long long in_rs, out_rs;      // hd
  __device__ const __nv_bfloat16* q(int b) const { return q0 + b * elem; }
  __device__ const __nv_bfloat16* k(int b) const { return k0 + b * elem; }
  __device__ const __nv_bfloat16* v(int b) const { return v0 + b * elem; }
  __device__ __nv_bfloat16* o(int b) const { return out + b * elem; }
};

// q, k and v of batch element b into the three (NP, op_ld(HD)) bf16 tiles
// at `dst`, op_bytes apart: rows < N, channels < HD, 16 bytes a copy.
template <int HD, class Rows>
__device__ __forceinline__ void stage_qkv(unsigned char* dst, size_t op_bytes,
                                          const Rows& rows, int b, int N) {
  constexpr int CH = HD / 8;                 // 16-byte chunks in a row
  constexpr int LDO = op_ld(HD);
  for (int i = threadIdx.x; i < 3 * N * CH; i += blockDim.x) {
    const int op = i / (N * CH);             // q, k, v
    const int rem = i - op * N * CH;
    const int n = rem / CH;
    const int ch = rem - n * CH;
    const __nv_bfloat16* src = op == 0 ? rows.q(b) : op == 1 ? rows.k(b) : rows.v(b);
    cp_async16(reinterpret_cast<__nv_bfloat16*>(dst + op * op_bytes) + n * LDO + 8 * ch,
               src + (size_t)n * rows.in_rs + 8 * ch);
  }
}

// Logits (rows ra, rb; columns 8t + c2, + 1) of the staged fp32 bias tile:
// -inf on padded keys, 0 on padded rows.
__device__ __forceinline__ void load_bias(float (&d)[4], const float* Bs, int LDP,
                                          int N, int t, int ra, int rb, int c2) {
  const int col = 8 * t + c2;
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = hr ? rb : ra;
    const float2 v = row < N ? *reinterpret_cast<const float2*>(Bs + row * LDP + col)
                             : make_float2(0.f, 0.f);
    d[2 * hr] = col < N ? v.x : -INFINITY;
    d[2 * hr + 1] = col + 1 < N ? v.y : -INFINITY;
  }
}

// One warp's 16-row query slab (rows r0 ... r0 + 15) of one staged batch
// element: S, the softmax and P.V, stored at rows < N of dst.
template <int HD, bool SCALE_AFTER>
__device__ __forceinline__ void attend_slab(
    const __nv_bfloat16* Qs, const __nv_bfloat16* Ks, const __nv_bfloat16* Vs,
    const float* Bs, int LDP, int N, int NT, int r0, float scale,
    __nv_bfloat16* dst, long long out_rs) {
  constexpr int HP = chans(HD);
  constexpr int LDO = op_ld(HD);
  constexpr int KQ = HP / 16;      // k16 steps over the channels
  constexpr int NC = HP / 8;       // n8 tiles over the channels
  const int lane = threadIdx.x & 31;
  const int c2 = 2 * (lane & 3);
  const int ra = r0 + (lane >> 2);
  const int rb = ra + 8;

  // the logits start as the fp32 bias, or at 0 when scaled after the
  // product
  float s[kTcMaxTiles][4];
#pragma unroll
  for (int t = 0; t < kTcMaxTiles; ++t) {
    if (t < NT) {
      if (SCALE_AFTER)
        zero(s[t]);
      else
        load_bias(s[t], Bs, LDP, N, t, ra, rb, c2);
    }
  }

  // S = bias + round(q * scale) . K^T, or S = (q . K^T) * scale + bias
  {
    uint32_t qa[KQ][4];
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
      ldsm_x4(qa[kk], Qs + (r0 + (lane & 15)) * LDO + kk * 16 + (lane >> 4) * 8);
      if (!SCALE_AFTER) {
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float2 f = unpack(qa[kk][r]);
          qa[kk][r] = pack(f.x * scale, f.y * scale);
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kTcMaxTiles; t += 2)
      if (t < NT) key_pair_product<KQ, LDO>(s[t], s[t + 1], qa, Ks, t, lane);
  }
  if (SCALE_AFTER) {
#pragma unroll
    for (int t = 0; t < kTcMaxTiles; ++t) {
      if (t < NT) {
        float b[4];
        load_bias(b, Bs, LDP, N, t, ra, rb, c2);
#pragma unroll
        for (int i = 0; i < 4; ++i) s[t][i] = s[t][i] * scale + b[i];
      }
    }
  }

  // softmax of rows ra and rb
  float mxa = -INFINITY, mxb = -INFINITY;
#pragma unroll
  for (int t = 0; t < kTcMaxTiles; ++t) {
    if (t < NT) {
      mxa = fmaxf(mxa, fmaxf(s[t][0], s[t][1]));
      mxb = fmaxf(mxb, fmaxf(s[t][2], s[t][3]));
    }
  }
  mxa = quad_max(mxa) * kTcLog2e;
  mxb = quad_max(mxb) * kTcLog2e;
  float suma = 0.f, sumb = 0.f;
#pragma unroll
  for (int t = 0; t < kTcMaxTiles; ++t) {
    if (t < NT) {
      s[t][0] = exp2f(fmaf(s[t][0], kTcLog2e, -mxa));
      s[t][1] = exp2f(fmaf(s[t][1], kTcLog2e, -mxa));
      s[t][2] = exp2f(fmaf(s[t][2], kTcLog2e, -mxb));
      s[t][3] = exp2f(fmaf(s[t][3], kTcLog2e, -mxb));
      suma += s[t][0] + s[t][1];
      sumb += s[t][2] + s[t][3];
    }
  }
  suma = 1.f / quad_sum(suma);
  sumb = 1.f / quad_sum(sumb);

  // out = round(P) . V, P packed from the accumulators
  float o[NC][4];
#pragma unroll
  for (int j = 0; j < NC; ++j) zero(o[j]);
#pragma unroll
  for (int kk = 0; kk < kTcMaxTiles / 2; ++kk) {
    if (2 * kk < NT) {
      const float* p0 = s[2 * kk];
      const float* p1 = s[2 * kk + 1];
      const uint32_t pa[4] = {pack(p0[0] * suma, p0[1] * suma),
                              pack(p0[2] * sumb, p0[3] * sumb),
                              pack(p1[0] * suma, p1[1] * suma),
                              pack(p1[2] * sumb, p1[3] * sumb)};
#pragma unroll
      for (int j = 0; j < NC; j += 2) {
        uint32_t vb[4];
        ldsm_x4_t(vb, Vs + (kk * 16 + (lane & 15)) * LDO + 8 * (j + (lane >> 4)));
        mma(o[j], pa, vb[0], vb[1]);
        mma(o[j + 1], pa, vb[2], vb[3]);
      }
    }
  }

#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    if (ra < N)
      *reinterpret_cast<uint32_t*>(dst + ra * out_rs + 8 * j + c2) =
          pack(o[j][0], o[j][1]);
    if (rb < N)
      *reinterpret_cast<uint32_t*>(dst + rb * out_rs + 8 * j + c2) =
          pack(o[j][2], o[j][3]);
  }
}

template <int HD, bool SCALE_AFTER = false, bool SLAB_LOOP = false, class Rows>
__device__ __forceinline__ void attend_heads_tc(
    const Rows& rows, const float* __restrict__ bias, int N, int b_begin,
    int b_end, float scale, unsigned char* smem,
    const float* __restrict__ mask = nullptr) {
  using bf16 = __nv_bfloat16;
  constexpr int LDO = op_ld(HD);
  const int NP = pad16(N);
  const int NT = NP / 8;           // n8 tiles over the keys
  const int LDP = tile_ld(NP);
  const int warp = threadIdx.x >> 5;

  float* Bs = reinterpret_cast<float*>(smem);
  unsigned char* ops = smem + align16(sizeof(float) * NP * LDP);
  const size_t op_bytes = align16(sizeof(bf16) * NP * LDO);

  {
    uint4* z = reinterpret_cast<uint4*>(ops);
    const int n16 = (int)(6 * op_bytes / 16);
    for (int i = threadIdx.x; i < n16; i += blockDim.x) z[i] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();
  if (SCALE_AFTER && mask != nullptr) {
    // the tile holds bias + mask, summed once as it is staged
    if ((N & 3) == 0) {
      const int n4 = N / 4;
#pragma unroll 4
      for (int i = threadIdx.x; i < N * n4; i += blockDim.x) {
        const int r = i / n4;
        const int c = 4 * (i - r * n4);
        const float4 b = *reinterpret_cast<const float4*>(bias + (size_t)r * N + c);
        const float4 m = *reinterpret_cast<const float4*>(mask + (size_t)r * N + c);
        *reinterpret_cast<float4*>(Bs + r * LDP + c) =
            make_float4(b.x + m.x, b.y + m.y, b.z + m.z, b.w + m.w);
      }
    } else {
      for (int i = threadIdx.x; i < N * N; i += blockDim.x) {
        const int r = i / N;
        Bs[r * LDP + (i - r * N)] = bias[i] + mask[i];
      }
    }
  } else if ((N & 3) == 0) {
    const int n4 = N / 4;
    for (int i = threadIdx.x; i < N * n4; i += blockDim.x) {
      const int r = i / n4;
      const int c = 4 * (i - r * n4);
      cp_async16(Bs + r * LDP + c, bias + (size_t)r * N + c);
    }
  } else {
    for (int i = threadIdx.x; i < N * N; i += blockDim.x) {
      const int r = i / N;
      cp_async4(Bs + r * LDP + (i - r * N), bias + i);
    }
  }
  if (b_begin < b_end) stage_qkv<HD>(ops, op_bytes, rows, b_begin, N);
  cp_async_commit();

  for (int b = b_begin; b < b_end; ++b) {
    const int cur = (b - b_begin) & 1;
    if (b + 1 < b_end) {           // prefetch the next element
      stage_qkv<HD>(ops + (cur ^ 1) * 3 * op_bytes, op_bytes, rows, b + 1, N);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();               // element b (and the bias) are staged
    const bf16* Qs = reinterpret_cast<const bf16*>(ops + cur * 3 * op_bytes);
    const bf16* Ks = Qs + op_bytes / sizeof(bf16);
    const bf16* Vs = Ks + op_bytes / sizeof(bf16);
    if (SLAB_LOOP) {
      for (int slab = warp; slab < NP / 16; slab += blockDim.x >> 5)
        attend_slab<HD, SCALE_AFTER>(Qs, Ks, Vs, Bs, LDP, N, NT, 16 * slab,
                                     scale, rows.o(b), rows.out_rs);
    } else {
      attend_slab<HD, SCALE_AFTER>(Qs, Ks, Vs, Bs, LDP, N, NT, 16 * warp,
                                   scale, rows.o(b), rows.out_rs);
    }
    __syncthreads();               // every warp is done with this buffer
  }
}

}  // namespace fiber
