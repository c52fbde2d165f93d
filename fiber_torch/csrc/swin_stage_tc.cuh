// The pieces of the tensor-core K3 that do not depend on the window size:
// the GEMM and LayerNorm phases, the seven-phase run of Swin blocks on a
// persistent cooperative grid, and its launch.  swin_stage_tc.cu (N <= 144,
// attention by attend_heads_tc) and swin_stage_tc_long.cu (144 < N <= 352,
// attention by attend_long_rows) include it and pass their attention phase
// to swin_blocks.  See swin_stage_tc.cu for the design.
#pragma once

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "swin_stage_common.cuh"
#include "window_attention_bwd_common.cuh"
#include "window_attention_tc.cuh"

namespace fiber {

namespace swin_tc {

using bf16 = __nv_bfloat16;

constexpr int kGemmWarps = 8;               // the warps that run the products
constexpr int kBK = 32;                     // reduction depth of a stage
constexpr int kLds = kBK + 8;               // staged row stride: 80 bytes
constexpr int kStages = 4;
constexpr int kMaxBM = 128, kMaxBN = 128;
constexpr size_t kGemmSmem =
    (size_t)kStages * (kMaxBM + kMaxBN) * kLds * sizeof(__nv_bfloat16)
    + 2 * sizeof(long long) * kMaxBM;

// What the host chose for this launch: the batch splits of the attention
// items and each product's tile shape, an index into kTiles.
struct Plan {
  int splits;
  int tile[4];  // qkv, proj, fc1, fc2
};

// The tile shapes (BM x BN), by the index the wrapper passes; the wrapper's
// table is fiber_torch/ops/swin_stage.py::_K3_TILES.
constexpr int kTiles[3][2] = {{128, 128}, {128, 64}, {64, 64}};

// O[orows(r), c] = epilogue(sum_k A[arows(r), k] * Wt[c, k] + bias[c]) for
// r < M, c < Nout; A's row r at A + arows.token(r) * lda, O's at
// O + orows.token(r) * ldo.
struct Gemm {
  long long M;
  int K, Nout;
  const bf16* A;
  int lda;
  Rows arows;
  const bf16* Wt;
  const bf16* bias;
  bf16* O;
  int ldo;
  Rows orows;
};

// Every BM x BN output tile of one product, spread over the grid.  Warp w
// of the first kGemmWarps owns rows (w % WM) * BM / WM and columns
// (w / WM) * BN / WN of the tile; the block's other warps only copy.
template <int BM, int BN, int WM, int WN, int EPI>
__device__ __noinline__ void gemm_phase(const Gemm g, unsigned char* smem) {
  constexpr int WTM = BM / WM, WTN = BN / WN;
  constexpr int MI = WTM / 16, NI = WTN / 8;
  static_assert(WM * WN == kGemmWarps && WTM % 16 == 0 && NI % 2 == 0,
                "warp tiling");
  static_assert(BM <= kMaxBM && BN <= kMaxBN, "tile within the shared memory");
  constexpr int CH = kBK / 8;                    // 16-byte chunks in a row
  bf16* As = reinterpret_cast<bf16*>(smem);      // [kStages][BM][kLds]
  bf16* Bs = As + kStages * BM * kLds;           // [kStages][BN][kLds]
  long long* aoff = reinterpret_cast<long long*>(Bs + kStages * BN * kLds);
  long long* ooff = aoff + BM;
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int wm0 = (warp % WM) * WTM, wn0 = (warp / WM) * WTN;
  const bool computes = warp < kGemmWarps;
  const int tiles_m = (int)((g.M + BM - 1) / BM);
  const int tiles = tiles_m * ((g.Nout + BN - 1) / BN);
  const int KT = g.K / kBK;

  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    const int tm = t % tiles_m, tn = t / tiles_m;
    const long long r0 = (long long)tm * BM;
    const int c0 = tn * BN;
    __syncthreads();  // the last users of this shared memory are done
    for (int i = tid; i < BM; i += blockDim.x) {
      const long long r = r0 + i;
      // rows past M read row M - 1 and are not stored
      aoff[i] = g.arows.token(r < g.M ? r : g.M - 1) * g.lda;
      ooff[i] = r < g.M ? g.orows.token(r) * g.ldo : -1;
    }
    __syncthreads();
    auto load = [&](int slot, int kt) {
      const int k0 = kt * kBK;
      bf16* as = As + slot * BM * kLds;
      bf16* bs = Bs + slot * BN * kLds;
      for (int i = tid; i < BM * CH; i += blockDim.x) {
        const int r = i / CH, ch = i - r * CH;
        cp_async16(as + r * kLds + 8 * ch, g.A + aoff[r] + k0 + 8 * ch);
      }
      for (int i = tid; i < BN * CH; i += blockDim.x) {
        const int n = i / CH, ch = i - n * CH;
        const int c = c0 + n < g.Nout ? c0 + n : g.Nout - 1;
        cp_async16(bs + n * kLds + 8 * ch, g.Wt + (size_t)c * g.K + k0 + 8 * ch);
      }
    };
#pragma unroll
    for (int s = 0; s < kStages - 1; ++s) {
      if (s < KT) load(s, s);
      cp_async_commit();
    }

    float acc[MI][NI][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) zero(acc[mi][ni]);

    for (int kt = 0; kt < KT; ++kt) {
      cp_async_wait<kStages - 2>();  // slab kt has landed
      __syncthreads();               // ... for every thread; slot kt - 1 is free
      const int nk = kt + kStages - 1;
      if (nk < KT) load(nk % kStages, nk);
      cp_async_commit();
      if (computes) {
        const bf16* as = As + (kt % kStages) * BM * kLds;
        const bf16* bs = Bs + (kt % kStages) * BN * kLds;
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          uint32_t af[MI][4];
#pragma unroll
          for (int mi = 0; mi < MI; ++mi)
            ldsm_x4(af[mi], as + (wm0 + 16 * mi + (lane & 15)) * kLds
                                + 16 * kk + (lane >> 4) * 8);
#pragma unroll
          for (int nj = 0; nj < NI / 2; ++nj) {
            uint32_t bf[4];
            ldsm_x4(bf, bs + (wn0 + 16 * nj + (lane & 7) + ((lane >> 4) << 3)) * kLds
                           + 16 * kk + ((lane >> 3) & 1) * 8);
#pragma unroll
            for (int mi = 0; mi < MI; ++mi) {
              mma(acc[mi][2 * nj], af[mi], bf[0], bf[1]);
              mma(acc[mi][2 * nj + 1], af[mi], bf[2], bf[3]);
            }
          }
        }
      }
    }
    cp_async_wait<0>();

    if (computes) {
      const int g4 = lane >> 2, c2 = 2 * (lane & 3);
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const long long off = ooff[wm0 + 16 * mi + g4 + 8 * hr];
          if (off < 0) continue;
#pragma unroll
          for (int ni = 0; ni < NI; ++ni) {
            const int c = c0 + wn0 + 8 * ni + c2;
            if (c >= g.Nout) continue;
            const float2 b = unpack(*reinterpret_cast<const uint32_t*>(g.bias + c));
            float v0 = acc[mi][ni][2 * hr] + b.x;
            float v1 = acc[mi][ni][2 * hr + 1] + b.y;
            uint32_t* o = reinterpret_cast<uint32_t*>(g.O + off + c);
            if (EPI == kBiasGelu) {
              v0 = gelu_as(v0);
              v1 = gelu_as(v1);
            }
            if (EPI == kBiasResidRound || EPI == kBiasResid) {
              const float2 r = unpack(*o);
              if (EPI == kBiasResidRound) {
                v0 = r.x + round_to<bf16>(v0);
                v1 = r.y + round_to<bf16>(v1);
              } else {
                v0 = r.x + v0;
                v1 = r.y + v1;
              }
            }
            *o = pack(v0, v1);
          }
        }
      }
    }
  }
}

template <int EPI>
__device__ __forceinline__ void gemm(int tile, const Gemm& g, unsigned char* smem) {
  switch (tile) {
    case 0: gemm_phase<kTiles[0][0], kTiles[0][1], 2, 4, EPI>(g, smem); break;
    case 1: gemm_phase<kTiles[1][0], kTiles[1][1], 4, 2, EPI>(g, smem); break;
    default: gemm_phase<kTiles[2][0], kTiles[2][1], 2, 4, EPI>(g, smem); break;
  }
}

// dst row r = round(LayerNorm(act row rows.token(r)) * s + b) for r < M,
// one warp a row: fp32 mean, then the mean of squared deviations (eps
// 1e-5), as the plain version computes them.
__device__ __noinline__ void ln_phase(const bf16* act, bf16* dst, Rows rows,
                                      long long M, int C,
                                      const float* __restrict__ s,
                                      const float* __restrict__ b) {
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int CH = C / 8;
  for (long long r = (long long)blockIdx.x * warps + (threadIdx.x >> 5); r < M;
       r += (long long)gridDim.x * warps) {
    const uint4* a = reinterpret_cast<const uint4*>(act + rows.token(r) * C);
    float sum = 0.f;
    for (int ch = lane; ch < CH; ch += 32) {
      const uint4 u = a[ch];
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = unpack(w[i]);
        sum += f.x + f.y;
      }
    }
    const float mean = warp_sum(sum) / C;
    float sq = 0.f;
    for (int ch = lane; ch < CH; ch += 32) {
      const uint4 u = a[ch];
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = unpack(w[i]);
        sq += (f.x - mean) * (f.x - mean) + (f.y - mean) * (f.y - mean);
      }
    }
    const float rstd = rsqrtf(warp_sum(sq) / C + 1e-5f);
    uint4* o = reinterpret_cast<uint4*>(dst + r * C);
    for (int ch = lane; ch < CH; ch += 32) {
      const uint4 u = a[ch];
      const uint32_t w[4] = {u.x, u.y, u.z, u.w};
      uint32_t y[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = 8 * ch + 2 * i;
        const float2 f = unpack(w[i]);
        y[i] = pack((f.x - mean) * rstd * s[k] + b[k],
                    (f.y - mean) * rstd * s[k + 1] + b[k + 1]);
      }
      o[ch] = make_uint4(y[0], y[1], y[2], y[3]);
    }
  }
}

// The kernel's body: x copied into the activations, then n Swin blocks of
// seven phases each (LN1 -> qkv -> attention -> proj -> LN2 -> fc1 -> fc2)
// with a grid sync after each; attention(j, shifted) runs block j's
// attention from the packed qkv rows (window order) into the context rows.
template <class Attention>
__device__ __forceinline__ void swin_blocks(const Params& p, const Plan& plan,
                                            unsigned char* smem,
                                            Attention&& attention) {
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int C = p.C, hid = p.hidden;
  const long long M = (long long)p.B * p.H * p.W;
  bf16* act = static_cast<bf16*>(p.act);
  bf16* qkv = static_cast<bf16*>(p.qkv);
  bf16* ctx = static_cast<bf16*>(p.ctx);  // also the LayerNorm outputs
  bf16* hbuf = static_cast<bf16*>(p.hid);
  const bf16* qkv_w = static_cast<const bf16*>(p.qkv_w);
  const bf16* qkv_b = static_cast<const bf16*>(p.qkv_b);
  const bf16* proj_w = static_cast<const bf16*>(p.proj_w);
  const bf16* proj_b = static_cast<const bf16*>(p.proj_b);
  const bf16* fc1_w = static_cast<const bf16*>(p.fc1_w);
  const bf16* fc1_b = static_cast<const bf16*>(p.fc1_b);
  const bf16* fc2_w = static_cast<const bf16*>(p.fc2_w);
  const bf16* fc2_b = static_cast<const bf16*>(p.fc2_b);

  {
    const uint4* src = static_cast<const uint4*>(p.x);
    uint4* dst = reinterpret_cast<uint4*>(act);
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < M * C / 8; i += (long long)gridDim.x * blockDim.x)
      dst[i] = src[i];
  }
  grid.sync();

  const Rows lin{p.H, p.W, 0, 0};
  for (int j = 0; j < p.n_blocks; ++j) {
    const bool shifted = p.use_shift && (j & 1);
    const Rows win{p.H, p.W, p.window, shifted ? p.window / 2 : 0};
    // LN1, written in window order
    ln_phase(act, ctx, win, M, C, p.ln1_s + (size_t)j * C, p.ln1_b + (size_t)j * C);
    grid.sync();
    gemm<kBias>(plan.tile[0],
                Gemm{M, C, 3 * C, ctx, C, lin, qkv_w + (size_t)j * 3 * C * C,
                     qkv_b + (size_t)j * 3 * C, qkv, 3 * C, lin}, smem);
    grid.sync();
    attention(j, shifted);
    grid.sync();
    // proj + residual, written back at the un-rolled tokens
    gemm<kBiasResidRound>(plan.tile[1],
                          Gemm{M, C, C, ctx, C, lin, proj_w + (size_t)j * C * C,
                               proj_b + (size_t)j * C, act, C, win}, smem);
    grid.sync();
    // LN2, in token order
    ln_phase(act, ctx, lin, M, C, p.ln2_s + (size_t)j * C, p.ln2_b + (size_t)j * C);
    grid.sync();
    gemm<kBiasGelu>(plan.tile[2],
                    Gemm{M, C, hid, ctx, C, lin, fc1_w + (size_t)j * hid * C,
                         fc1_b + (size_t)j * hid, hbuf, hid, lin}, smem);
    grid.sync();
    gemm<kBiasResid>(plan.tile[3],
                     Gemm{M, hid, C, hbuf, hid, lin, fc2_w + (size_t)j * C * hid,
                          fc2_b + (size_t)j * C, act, C, lin}, smem);
    grid.sync();
  }
}

// The shapes every K3 on the tensor cores takes besides its attention's:
// H and W multiples of the window, C and the MLP width multiples of 32, a
// tile index in kTiles for each product, 1 <= splits <= B.
inline bool stack_takes(const Params& p, const Plan& plan) {
  for (int t : plan.tile)
    if (t < 0 || t > 2) return false;
  return p.window >= 1 && p.H % p.window == 0 && p.W % p.window == 0 &&
         p.C % 32 == 0 && p.hidden % 32 == 0 && p.heads >= 1 &&
         p.C % p.heads == 0 && p.n_blocks >= 1 && p.B >= 1 &&
         plan.splits >= 1 && plan.splits <= p.B;
}

// A cooperative launch of `kernel` on `grid` blocks of `threads` threads
// and `smem` bytes; every block must be resident for the grid syncs, so a
// grid that does not fit is refused (cudaErrorCooperativeLaunchTooLarge),
// never shrunk.
template <class K>
inline cudaError_t launch_cooperative(K kernel, int grid, int threads,
                                      size_t smem, void** args,
                                      cudaStream_t stream) {
  const int per_sm = blocks_per_sm(kernel, threads, smem);  // raises the limit
  if (per_sm < 0) return cudaErrorInvalidValue;
  int dev = 0, coop = 0, sms = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess) return e;
  if (!coop) return cudaErrorNotSupported;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return e;
  if (grid < 1 || grid > per_sm * sms) return cudaErrorCooperativeLaunchTooLarge;
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                  dim3(grid), dim3(threads), args, smem, stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace swin_tc

}  // namespace fiber
