// The long-window routine of the window-attention kernels on the tensor
// cores, bf16, for windows of 144 < N <= 352 tokens (FIBER's 18 x 18
// windows at 576^2, N = 324): K1's forward (window_attention_tc_long.cu)
// and K2's backward row kernel (window_attention_bwd_tc_long.cu) run it.
//
// One warp owns a 16-row query slab of one (window, head) and walks the
// keys in blocks of kKeyBlock = 64 (8 n8 tiles, their products independent
// of one another) on mma.sync m16n8k16, in two passes:
//   pass 1: S = bias + round(q * scale) . K^T, block by block, keeping each
//           lane's running row max m and sum l of exp(s - m) (rescaled when
//           a block raises the max); a quad reduction gives the row's max M
//           and 1 / L;
//   pass 2: S again, with the same instructions (so the same bits), and
//           p = round(exp(s - M) / L): P is normalised before it is
//           rounded, as the plain version window_attention_reference does.
// A one-pass online softmax would round P before its normalisation.
//
// A (N, N) row of logits never exists whole: no thread holds more than one
// key block of it.  K1 and K2's row kernel stage each batch element's K and
// V whole (double-buffered, the next element's copied while the current
// one is computed) beside their R bias rows, and split each slab's keys
// over P warps (`parts`, `tile_steps`), which trade their rows' statistics
// after pass 1 and add their accumulators after pass 2.  K2's column
// kernel walks the query rows instead, in blocks through a ring of
// kLongStages shared-memory stages.  The wrappers' pure plans
// (fiber_torch/ops/window_attention.py: _long_plan, _bwd_long_plan) pick
// R, P and the batch splits.
//
// Fragment layout: see mma_bf16.cuh.  Row la = 16 warp + lane / 4 and
// lb = la + 8 of the block's rows; columns 8 u + c2, + 1 (c2 = 2 (lane % 4))
// of tile u of a key block.
#pragma once

#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

#include "window_attention_tc.cuh"

namespace fiber {

constexpr int kLongMaxNP = 352;              // N <= 352
constexpr int kLongMaxWarps = 8;             // R <= 128 rows a block
constexpr int kLongMaxThreads = 512;         // R / 16 x parts warps <= 16
constexpr int kKeyBlock = 64;                // keys (or query rows) a step
constexpr int kBlockTiles = kKeyBlock / 8;   // n8 tiles a step
constexpr int kLongStages = 2;               // the ring's stages

__host__ __device__ inline int key_blocks(int N) {
  return (N + kKeyBlock - 1) / kKeyBlock;
}

// n8 tiles of key block kb: 8, or the even remainder of NP / 8 in the last
__device__ __forceinline__ int block_tiles(int N, int kb) {
  const int nt = pad16(N) / 8 - kBlockTiles * kb;
  return nt < kBlockTiles ? nt : kBlockTiles;
}

// f(integral_constant<int, TILES>) for the tiles of a key block (2, 4, 6
// or 8), so that each size runs fully unrolled
template <class F>
__device__ __forceinline__ void by_tiles(int tiles, F&& f) {
  switch (tiles) {
    case 2: f(std::integral_constant<int, 2>()); break;
    case 4: f(std::integral_constant<int, 4>()); break;
    case 6: f(std::integral_constant<int, 6>()); break;
    default: f(std::integral_constant<int, 8>()); break;
  }
}

// f(TILES, t0) for each step of key tiles [t_begin, t_end): up to 8 tiles
// (64 keys) a step, an even count
template <class F>
__device__ __forceinline__ void tile_steps(int t_begin, int t_end, F&& f) {
  for (int t0 = t_begin; t0 < t_end; t0 += kBlockTiles) {
    const int n = t_end - t0 < kBlockTiles ? t_end - t0 : kBlockTiles;
    by_tiles(n, [&](auto T) { f(T, t0); });
  }
}

// rows [0, n) of an (n, HD) bf16 operand at src (row stride rs elements)
// into dst (row stride op_ld(HD)), 16 bytes a copy, by the whole block
template <int HD>
__device__ __forceinline__ void copy_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long rs, int n) {
  constexpr int CH = HD / 8;
  constexpr int LDO = op_ld(HD);
  for (int i = threadIdx.x; i < n * CH; i += blockDim.x) {
    const int r = i / CH;
    const int ch = i - r * CH;
    cp_async16(dst + r * LDO + 8 * ch, src + (size_t)r * rs + 8 * ch);
  }
}

// rows [0, n) x columns [0, m) of the fp32 matrix at src (row stride
// ld_src) into dst (row stride ld), by the whole block: 16 bytes a copy
// where `vec` (N % 4 == 0: every offset a multiple of 4 floats), else 4
__device__ __forceinline__ void copy_f32(float* dst, int ld, const float* src,
                                         long long ld_src, int n, int m,
                                         bool vec) {
  if (vec) {
    const int m4 = m / 4;
    for (int i = threadIdx.x; i < n * m4; i += blockDim.x) {
      const int r = i / m4;
      const int c = 4 * (i - r * m4);
      cp_async16(dst + r * ld + c, src + (size_t)r * ld_src + c);
    }
  } else {
    for (int i = threadIdx.x; i < n * m; i += blockDim.x) {
      const int r = i / m;
      const int c = i - r * m;
      cp_async4(dst + r * ld + c, src + (size_t)r * ld_src + c);
    }
  }
}

// A 16-row slab's A fragments (rows r0 ... r0 + 15 of the staged operand
// X), scaled and rounded when `scale` is not 1: round(q * scale) for the
// logits, dO as it is
template <int KQ, int LDO>
__device__ __forceinline__ void slab_fragments(uint32_t (&a)[KQ][4],
                                               const __nv_bfloat16* X, int r0,
                                               float scale, int lane) {
#pragma unroll
  for (int kk = 0; kk < KQ; ++kk) {
    ldsm_x4(a[kk], X + (r0 + (lane & 15)) * LDO + kk * 16 + (lane >> 4) * 8);
    if (scale != 1.f) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float2 f = unpack(a[kk][r]);
        a[kk][r] = pack(f.x * scale, f.y * scale);
      }
    }
  }
}

// Logits of rows la, lb and columns c, c + 1 as the fp32 block Bb (row
// stride ld): 0 on rows at or past nq, -inf on columns at or past ncol
__device__ __forceinline__ void bias_frag(float (&d)[4], const float* Bb, int ld,
                                          int nq, int ncol, int la, int lb,
                                          int c) {
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = hr ? lb : la;
    const float2 v = row < nq ? *reinterpret_cast<const float2*>(Bb + row * ld + c)
                              : make_float2(0.f, 0.f);
    d[2 * hr] = c < ncol ? v.x : -INFINITY;
    d[2 * hr + 1] = c + 1 < ncol ? v.y : -INFINITY;
  }
}

// S tiles 0 ... TILES - 1 of one key block: its bias (Bb, ld; ncol real
// keys) plus q~ . K^T, K the block's staged rows Kb
template <int TILES, int KQ, int LDO>
__device__ __forceinline__ void logits_step(float (&s)[TILES][4],
                                            const uint32_t (&qa)[KQ][4],
                                            const __nv_bfloat16* Kb,
                                            const float* Bb, int ld, int nq,
                                            int ncol, int la, int lb, int c2,
                                            int lane) {
#pragma unroll
  for (int u = 0; u < TILES; u += 2) {
    bias_frag(s[u], Bb, ld, nq, ncol, la, lb, 8 * u + c2);
    bias_frag(s[u + 1], Bb, ld, nq, ncol, la, lb, 8 * (u + 1) + c2);
    key_pair_product<KQ, LDO>(s[u], s[u + 1], qa, Kb, u, lane);
  }
}

// d (TILES n8 tiles) = A . X^T for the slab's A fragments a and the block's
// staged rows Xb: dP = dO . V^T
template <int TILES, int KQ, int LDO>
__device__ __forceinline__ void product_step(float (&d)[TILES][4],
                                             const uint32_t (&a)[KQ][4],
                                             const __nv_bfloat16* Xb, int lane) {
#pragma unroll
  for (int u = 0; u < TILES; u += 2) {
    zero(d[u]);
    zero(d[u + 1]);
    key_pair_product<KQ, LDO>(d[u], d[u + 1], a, Xb, u, lane);
  }
}

// A lane's running max m and sum l of exp(s - m) over its logits of one
// row (accumulator elements e and e + 1 of each tile), taking a block of
// tiles: the max over the block, one rescale of the sum when the max
// grows, then the block's exponentials added tile by tile.  With `dp`, the
// running sum g of exp(s - m) dP rides along, rescaled with l.
template <int TILES, bool DOT>
__device__ __forceinline__ void online(float& m, float& l, float& g,
                                       const float (&s)[TILES][4],
                                       const float (&dp)[TILES][4], int e) {
  float t = fmaxf(s[0][e], s[0][e + 1]);
#pragma unroll
  for (int u = 1; u < TILES; ++u) t = fmaxf(t, fmaxf(s[u][e], s[u][e + 1]));
  if (t > m) {
    const float r = exp2f((m - t) * kTcLog2e);
    l *= r;
    if (DOT) g *= r;
    m = t;
  }
  if (m > -INFINITY) {             // else all of this lane's keys so far are padded
    const float ml = m * kTcLog2e;
    float add = 0.f, dot = 0.f;
#pragma unroll
    for (int u = 0; u < TILES; ++u) {
      const float p0 = exp2f(fmaf(s[u][e], kTcLog2e, -ml));
      const float p1 = exp2f(fmaf(s[u][e + 1], kTcLog2e, -ml));
      add += p0 + p1;
      if (DOT) dot = fmaf(p0, dp[u][e], fmaf(p1, dp[u][e + 1], dot));
    }
    l += add;
    if (DOT) g += dot;
  }
}

// s <- exp(s - M) / L on rows a (elements 0, 1) and b (2, 3)
template <int TILES>
__device__ __forceinline__ void probs(float (&s)[TILES][4], float mla,
                                      float inva, float mlb, float invb) {
#pragma unroll
  for (int u = 0; u < TILES; ++u) {
    s[u][0] = exp2f(fmaf(s[u][0], kTcLog2e, -mla)) * inva;
    s[u][1] = exp2f(fmaf(s[u][1], kTcLog2e, -mla)) * inva;
    s[u][2] = exp2f(fmaf(s[u][2], kTcLog2e, -mlb)) * invb;
    s[u][3] = exp2f(fmaf(s[u][3], kTcLog2e, -mlb)) * invb;
  }
}

// o += round(p) . Xb: the accumulators of tiles u, u + 1, packed to bf16,
// are the A fragment of one k16 step over the block's rows of the staged
// operand Xb (V for P.V; dO, q or K in the backward)
template <int TILES, int NC, int LDO>
__device__ __forceinline__ void pv_acc(float (&o)[NC][4],
                                       const float (&p)[TILES][4],
                                       const __nv_bfloat16* Xb, int lane) {
#pragma unroll
  for (int u = 0; u < TILES; u += 2) {
    const uint32_t pa[4] = {pack(p[u][0], p[u][1]), pack(p[u][2], p[u][3]),
                            pack(p[u + 1][0], p[u + 1][1]),
                            pack(p[u + 1][2], p[u + 1][3])};
#pragma unroll
    for (int j = 0; j < NC; j += 2) {
      uint32_t xb[4];
      ldsm_x4_t(xb, Xb + (8 * u + (lane & 15)) * LDO + 8 * (j + (lane >> 4)));
      mma(o[j], pa, xb[0], xb[1]);
      mma(o[j + 1], pa, xb[2], xb[3]);
    }
  }
}

// rows la, lb (< n) of a slab's accumulators, times `scale`, rounded and
// stored at dst (row stride ld), channels < HD, 4 bytes a lane
template <int HD, int NC>
__device__ __forceinline__ void store_rows(__nv_bfloat16* dst, long long ld,
                                           const float (&acc)[NC][4],
                                           float scale, int la, int lb, int n,
                                           int c2) {
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    if (la < n)
      *reinterpret_cast<uint32_t*>(dst + la * ld + 8 * j + c2) =
          pack(acc[j][0] * scale, acc[j][1] * scale);
    if (lb < n)
      *reinterpret_cast<uint32_t*>(dst + lb * ld + 8 * j + c2) =
          pack(acc[j][2] * scale, acc[j][3] * scale);
  }
}

}  // namespace fiber
