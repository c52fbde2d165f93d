// The long-window routine of the window-attention kernels on the tensor
// cores, bf16, for windows of 144 < N <= 352 tokens (FIBER's 18 x 18
// windows at 576^2, N = 324): K1's forward (window_attention_tc_long.cu),
// K4's (window_attention_heads_tc_long.cu, the same attend_long on per-head
// rows), K3's attention phase (swin_stage_tc_long.cu: attend_long_rows
// with K3's rounding and the shift mask, over the items of a persistent
// grid) and K2's backward row kernel (window_attention_bwd_tc_long.cu) run
// it.
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
// key block of it.  K1, K4 and K3 (attend_long_rows below) stage each batch
// element's K and V whole (double-buffered, the next element's copied while
// the current one is computed) beside their R bias rows, and split each
// slab's keys over P warps (`parts`, `tile_steps`), which trade their rows'
// statistics after pass 1 and add their accumulators after pass 2.  K2's
// row kernel runs the same two passes on wgmma, its K and V streamed in key
// blocks (window_attention_bwd_tc_long.cu).  The wrappers' pure plans
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

// rows [0, n) x columns [0, m) of a + b (fp32 matrices of row stride
// ld_src) into dst (row stride ld), by the whole block with plain loads
// (cp.async cannot add): 16 bytes a load where `vec`, else 4
__device__ __forceinline__ void sum_f32(float* dst, int ld, const float* a,
                                        const float* b, long long ld_src,
                                        int n, int m, bool vec) {
  if (vec) {
    const int m4 = m / 4;
    for (int i = threadIdx.x; i < n * m4; i += blockDim.x) {
      const int r = i / m4;
      const int c = 4 * (i - r * m4);
      const float4 x = *reinterpret_cast<const float4*>(a + (size_t)r * ld_src + c);
      const float4 y = *reinterpret_cast<const float4*>(b + (size_t)r * ld_src + c);
      *reinterpret_cast<float4*>(dst + r * ld + c) =
          make_float4(x.x + y.x, x.y + y.y, x.z + y.z, x.w + y.w);
    }
  } else {
    for (int i = threadIdx.x; i < n * m; i += blockDim.x) {
      const int r = i / m;
      const int c = i - r * m;
      dst[r * ld + c] = a[(size_t)r * ld_src + c] + b[(size_t)r * ld_src + c];
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
// keys) plus q~ . K^T, K the block's staged rows Kb.  With SCALE_AFTER
// (K3's rounding) the accumulators start at 0 and the tile is
// round(fp32(q . K^T) * scale) + bias: the product is scaled, rounded,
// then the bias added, as the plain version computes it.
template <int TILES, int KQ, int LDO, bool SCALE_AFTER = false>
__device__ __forceinline__ void logits_step(float (&s)[TILES][4],
                                            const uint32_t (&qa)[KQ][4],
                                            const __nv_bfloat16* Kb,
                                            const float* Bb, int ld, int nq,
                                            int ncol, int la, int lb, int c2,
                                            int lane, float scale = 1.f) {
#pragma unroll
  for (int u = 0; u < TILES; u += 2) {
    if (SCALE_AFTER) {
      zero(s[u]);
      zero(s[u + 1]);
    } else {
      bias_frag(s[u], Bb, ld, nq, ncol, la, lb, 8 * u + c2);
      bias_frag(s[u + 1], Bb, ld, nq, ncol, la, lb, 8 * (u + 1) + c2);
    }
    key_pair_product<KQ, LDO>(s[u], s[u + 1], qa, Kb, u, lane);
    if (SCALE_AFTER) {
      float b[2][4];
      bias_frag(b[0], Bb, ld, nq, ncol, la, lb, 8 * u + c2);
      bias_frag(b[1], Bb, ld, nq, ncol, la, lb, 8 * (u + 1) + c2);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        s[u][i] = __fmul_rn(s[u][i], scale) + b[0][i];
        s[u + 1][i] = __fmul_rn(s[u + 1][i], scale) + b[1][i];
      }
    }
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

// ---------------------------------------------------------------------------
// The long-window forward of one (window, head) over the batch elements of
// one split, on query rows [r0, r0 + R) (K1's window_attention_tc_long.cu,
// K4's window_attention_heads_tc_long.cu): the block's R / 16 slabs each on
// `parts` warps.  `Rows` places the operands of batch element b as
// attend_heads_tc's does (PackedRows for K1, HeadRows for K4), so both
// kernels run the same instructions and give the same bits.
// ---------------------------------------------------------------------------

// Bytes of a block's shared memory: the staged bias rows, two buffers of K
// and V (NP rows each) and q (R rows), then the parts' exchange: P.V
// accumulators of parts 1 ... P - 1 (16 x HP fp32 a slab and part) and
// every part's (max, sum) of each row.
struct FwdLongLayout {
  size_t bias, kv, q, acc, stats;
  __host__ __device__ FwdLongLayout(int N, int hd, int R, int parts) {
    const int np = pad16(N);
    bias = align16(sizeof(float) * (size_t)R * tile_ld(np));
    kv = align16(sizeof(__nv_bfloat16) * (size_t)np * op_ld(hd));
    q = align16(sizeof(__nv_bfloat16) * (size_t)R * op_ld(hd));
    acc = align16(sizeof(float) * (size_t)R * (parts - 1) * chans(hd));
    stats = align16(sizeof(float2) * (size_t)R * parts);
  }
  __host__ __device__ size_t buffer() const { return 2 * kv + q; }
  __host__ __device__ size_t total() const {
    return bias + 2 * buffer() + acc + stats;
  }
};

// The shapes the forward takes: N <= 352, the instantiated head dims, R a
// multiple of 16, at most 16 warps, every part with a real key.
inline bool long_takes(int N, int hd, int R, int parts) {
  return N >= 1 && N <= kLongMaxNP
      && (hd == 8 || hd == 16 || hd == 32 || hd == 64)
      && R >= 16 && R % 16 == 0 && parts >= 1 && parts <= pad16(N) / 16
      && R / 16 * parts * 32 <= kLongMaxThreads;
}

// K and V (rows < N) and q (the block's nq rows from r0) of batch element
// b into one buffer, 16 bytes a copy.
template <int HD, class Rows>
__device__ __forceinline__ void stage_element(unsigned char* buf,
                                              const FwdLongLayout& L,
                                              const Rows& rows, int b, int N,
                                              int r0, int nq) {
  using bf16 = __nv_bfloat16;
  copy_rows<HD>(reinterpret_cast<bf16*>(buf), rows.k(b), rows.in_rs, N);
  copy_rows<HD>(reinterpret_cast<bf16*>(buf + L.kv), rows.v(b), rows.in_rs, N);
  copy_rows<HD>(reinterpret_cast<bf16*>(buf + 2 * L.kv),
                rows.q(b) + (size_t)r0 * rows.in_rs, rows.in_rs, nq);
}

// Query rows [r0, r0 + R) of one (window, head), batch elements [b_begin,
// b_end), on the block's first R / 16 x parts warps (a 16-row slab on
// `parts` warps; warps past them idle but reach every __syncthreads);
// `bias` at the (window, head)'s (N, N) fp32 tile; FwdLongLayout(N, HD, R,
// parts).total() bytes of dynamic shared memory at `smem`.  With
// SCALE_AFTER (K3's rounding, as attend_heads_tc's) the logits are
// round(fp32(q . k^T) * scale) + bias, q neither scaled nor rounded first,
// and a non-null `mask` (rows of N fp32 at the tile's stride) is added
// into the staged bias rows once; without it `mask` is not read.
template <int HD, bool SCALE_AFTER, class Rows>
__device__ __forceinline__ void attend_long_rows(
    const Rows& rows, const float* __restrict__ bias,
    const float* __restrict__ mask, int N, int b_begin, int b_end,
    float scale, int R, int parts, int r0, unsigned char* smem) {
  using bf16 = __nv_bfloat16;
  constexpr int HP = chans(HD);
  constexpr int LDO = op_ld(HD);
  constexpr int KQ = HP / 16;      // k16 steps over the channels
  constexpr int NC = HP / 8;       // n8 tiles over the channels
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int slab = warp / parts;
  const int part = warp - slab * parts;
  const int c2 = 2 * (lane & 3);
  const int la = 16 * slab + (lane >> 2);
  const int lb = la + 8;
  const int nq = min(R, N - r0);
  const int NP = pad16(N);
  const int LDP = tile_ld(NP);
  // the part's key tiles: a run of the NP / 16 tile pairs
  const int pairs = NP / 16;
  const int t_begin = 2 * (part * pairs / parts);
  const int t_end = 2 * ((part + 1) * pairs / parts);
  const bool active = 16 * slab < nq;  // slabs past the last row block's rows idle

  const FwdLongLayout L(N, HD, R, parts);
  float* Bs = reinterpret_cast<float*>(smem);
  unsigned char* bufs = smem + L.bias;
  float* acc_x = reinterpret_cast<float*>(bufs + 2 * L.buffer());
  float2* stat_x = reinterpret_cast<float2*>(bufs + 2 * L.buffer() + L.acc);

  // padded rows and channels stay zero: only real ones are staged
  {
    uint4* z = reinterpret_cast<uint4*>(bufs);
    const int n16 = (int)(2 * L.buffer() / 16);
    for (int i = threadIdx.x; i < n16; i += blockDim.x) z[i] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();
  if (SCALE_AFTER && mask != nullptr)   // the rows hold bias + mask
    sum_f32(Bs, LDP, bias + (size_t)r0 * N, mask + (size_t)r0 * N, N, nq, N,
            (N & 3) == 0);
  else
    copy_f32(Bs, LDP, bias + (size_t)r0 * N, N, nq, N, (N & 3) == 0);
  if (b_begin < b_end) stage_element<HD>(bufs, L, rows, b_begin, N, r0, nq);
  cp_async_commit();

  for (int b = b_begin; b < b_end; ++b) {
    const int cur = (b - b_begin) & 1;
    if (b + 1 < b_end) {           // prefetch the next element
      stage_element<HD>(bufs + (cur ^ 1) * L.buffer(), L, rows, b + 1, N, r0, nq);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();               // element b (and the bias) are staged
    const unsigned char* buf = bufs + cur * L.buffer();
    const bf16* Ks = reinterpret_cast<const bf16*>(buf);
    const bf16* Vs = reinterpret_cast<const bf16*>(buf + L.kv);
    const bf16* Qs = reinterpret_cast<const bf16*>(buf + 2 * L.kv);

    // pass 1: the part's (max, sum) of each row, traded with the others
    uint32_t qa[KQ][4];            // round(q * scale), or q, the A fragments
    float Ma = 0.f, Mb = 0.f, La = 0.f, Lb = 0.f;
    if (active) {
      slab_fragments<KQ, LDO>(qa, Qs, 16 * slab, SCALE_AFTER ? 1.f : scale,
                              lane);
      float ma = -INFINITY, mb = -INFINITY, sa = 0.f, sb = 0.f, unused = 0.f;
      tile_steps(t_begin, t_end, [&](auto T, int t0) {
        constexpr int TL = decltype(T)::value;
        float s[TL][4];
        logits_step<TL, KQ, LDO, SCALE_AFTER>(s, qa, Ks + 8 * t0 * LDO,
                                              Bs + 8 * t0, LDP, nq, N - 8 * t0,
                                              la, lb, c2, lane, scale);
        online<TL, false>(ma, sa, unused, s, s, 0);
        online<TL, false>(mb, sb, unused, s, s, 2);
      });
      Ma = quad_max(ma);
      Mb = quad_max(mb);
      La = quad_sum(sa * exp2f((ma - Ma) * kTcLog2e));
      Lb = quad_sum(sb * exp2f((mb - Mb) * kTcLog2e));
      if (parts > 1 && (lane & 3) == 0) {
        stat_x[(slab * parts + part) * 16 + (lane >> 2)] = make_float2(Ma, La);
        stat_x[(slab * parts + part) * 16 + (lane >> 2) + 8] = make_float2(Mb, Lb);
      }
    }
    if (parts > 1) __syncthreads();

    // pass 2: out = round(exp(s - M) / L) . V over the part's keys
    float o[NC][4];
#pragma unroll
    for (int j = 0; j < NC; ++j) zero(o[j]);
    if (active) {
      if (parts > 1) {
        const float2* st = stat_x + slab * parts * 16 + (lane >> 2);
        Ma = Mb = -INFINITY;
        for (int p = 0; p < parts; ++p) {
          Ma = fmaxf(Ma, st[16 * p].x);
          Mb = fmaxf(Mb, st[16 * p + 8].x);
        }
        La = Lb = 0.f;
        for (int p = 0; p < parts; ++p) {
          La += st[16 * p].y * exp2f((st[16 * p].x - Ma) * kTcLog2e);
          Lb += st[16 * p + 8].y * exp2f((st[16 * p + 8].x - Mb) * kTcLog2e);
        }
      }
      const float mla = Ma * kTcLog2e, inva = 1.f / La;
      const float mlb = Mb * kTcLog2e, invb = 1.f / Lb;
      tile_steps(t_begin, t_end, [&](auto T, int t0) {
        constexpr int TL = decltype(T)::value;
        float s[TL][4];
        logits_step<TL, KQ, LDO, SCALE_AFTER>(s, qa, Ks + 8 * t0 * LDO,
                                              Bs + 8 * t0, LDP, nq, N - 8 * t0,
                                              la, lb, c2, lane, scale);
        probs<TL>(s, mla, inva, mlb, invb);
        pv_acc<TL, NC, LDO>(o, s, Vs + 8 * t0 * LDO, lane);
      });
      // the parts' accumulators meet in part 0, in the order of the parts,
      // each lane's elements at the same place in every part
      if (part > 0) {
        float* mine = acc_x + ((size_t)slab * (parts - 1) + part - 1) * 16 * HP;
#pragma unroll
        for (int j = 0; j < NC; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) mine[(j * 4 + i) * 32 + lane] = o[j][i];
      }
    }
    if (parts > 1) __syncthreads();
    if (active && part == 0) {
      for (int p = 1; p < parts; ++p) {
        const float* theirs = acc_x + ((size_t)slab * (parts - 1) + p - 1) * 16 * HP;
#pragma unroll
        for (int j = 0; j < NC; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) o[j][i] += theirs[(j * 4 + i) * 32 + lane];
      }
      store_rows<HD, NC>(rows.o(b) + (size_t)r0 * rows.out_rs, rows.out_rs, o,
                         1.f, la, lb, nq, c2);
    }
    __syncthreads();               // every warp is done with this buffer
  }
}

// K1's and K4's block (blockIdx.x = r0 / R) of R = blockDim.x / 32 / parts
// x 16 query rows, with the logits' scale before the product and no mask.
template <int HD, class Rows>
__device__ __forceinline__ void attend_long(const Rows& rows,
                                            const float* __restrict__ bias,
                                            int N, int b_begin, int b_end,
                                            float scale, int parts,
                                            unsigned char* smem) {
  const int R = (blockDim.x >> 5) / parts * 16;
  attend_long_rows<HD, false>(rows, bias, nullptr, N, b_begin, b_end, scale,
                              R, parts, blockIdx.x * R, smem);
}

}  // namespace fiber
