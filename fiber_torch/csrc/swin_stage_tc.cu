// A run of n unfused Swin blocks in one launch (inference), bf16, on the
// H100's tensor cores (sm_90a: warp-level mma.sync m16n8k16, bf16
// operands, fp32 accumulators, fed by ldmatrix and cp.async).  (fp32, and
// bf16 beyond N = 144 or at hd = 128, run swin_stage.cu on the CUDA cores.)
//
// Replaces the JAX package's Pallas TPU kernel
// fiber_tpu/ops/swin_stage.py::fused_swin_blocks (body _kernel).  It
// computes swin_stage.cu's function (see there) with the rounding points of
// the plain version fiber_torch/ops/swin_stage.py::
// fused_swin_blocks_reference: LayerNorm in fp32 rounded to bf16 before its
// product; every product accumulating in fp32 with its bias, GELU and
// residual epilogues in fp32; qkv, the probabilities, the context and the
// projection rounded to bf16; the logits the fp32 q . k^T scaled by
// hd^-1/2 after the product, plus (rpb + mask) summed once in fp32 as the
// tile is staged (the plain version adds rpb, then the mask: at most one
// fp32 ulp apart).
//
// What bounds it on the card: operations.  At FIBER-Base 384^2 stage 3
// (C = 512, N = 144, the 14 trunk blocks at B = 4) the products are about
// 212 GFLOP, 203 of them the four GEMMs (24 C^2 FLOP a token), on 88 MB of
// bf16 weights: 0.21 ms at 989 TFLOP/s.  The first K3 (swin_stage.cu) ran
// every product in fp32 on the CUDA cores and took 24 ms there.  Here:
// * the same persistent cooperative launch: grid = resident blocks per SM
//   x SMs (the wrapper computes it, a grid that does not fit is refused),
//   grid syncs between the phases, and the rolled windows read and written
//   through one row-to-token map (Rows, swin_stage_common.cuh), with no
//   roll kernel;
// * seven phases per Swin block: LN1 -> qkv -> attention -> proj -> LN2 ->
//   fc1 -> fc2.  LayerNorm is a phase of its own, one warp a row: its fp32
//   statistics are computed once per row (the first K3 recomputed them for
//   every column tile of qkv and fc1, 24 and 32 times at stage 3) and the
//   rounded rows are written in the order the next product reads them
//   (LN1 in window order, LN2 in token order), into the context buffer,
//   which is free at both points;
// * one GEMM routine, BM x BN output tiles over a kStages-deep cp.async
//   pipeline of 32-deep slabs in 16-byte-padded rows (conflict-free
//   ldmatrix), 8 warps each on a (BM / WM) x (BN / WN) warp tile of
//   mma.sync; A's rows through per-row offsets (gathered, rolled rows
//   work), W in nn.Linear's (out, in) layout as the "col" operand, with no
//   transpose; the epilogues on the accumulator fragments in fp32, each
//   output pair written by one thread as bf16x2;
// * the tile shape of each product (128x128, 128x64 or 64x64) chosen on
//   the host by a cost model over the launched grid, waves x shared-memory
//   traffic per tile (fiber_torch/ops/swin_stage.py::_k3_plan), and passed
//   in the parameters;
// * attention items (window, head, split): the split walks batch elements
//   as K1 does, staging the bias tile once per item (attend_heads_tc of
//   window_attention_tc.cuh, scale after the product, its slabs looped
//   over the block's warps); the wrapper picks the split with K1's
//   _bwd_splits on K3's grid.
// Every output element is written by one thread, without atomics: two
// calls give the same bits.
//
// Shared memory: the larger of the GEMM pipeline's (83,968 bytes) and
// attend_tc_smem_bytes(N, hd) (156,672 at N = 144, hd = 32): one block of
// 9 warps per SM there.  Left for later: wgmma + TMA (the only way to the
// card's full tensor-core rate) and keeping fc1's hidden tile on chip for
// fc2.
//
// Limits: bf16, N <= 144 and hd in {8, 16, 32, 64} (attend_heads_tc's),
// C and the MLP width multiples of 32, H and W multiples of the window;
// every tensor 16-byte aligned (the wrapper checks and raises).

#include <cooperative_groups.h>
#include <stdint.h>

#include "mma_bf16.cuh"
#include "swin_stage_common.cuh"
#include "window_attention_tc.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace fiber;
using bf16 = __nv_bfloat16;

constexpr int kThreads = kTcMaxWarps * 32;  // 9 warps: a slab each at N = 144
constexpr int kGemmWarps = 8;               // the warps that run the products
constexpr int kBK = 32;                     // reduction depth of a stage
constexpr int kLds = kBK + 8;               // staged row stride: 80 bytes
constexpr int kStages = 4;
constexpr int kMaxBM = 128, kMaxBN = 128;
constexpr size_t kGemmSmem =
    (size_t)kStages * (kMaxBM + kMaxBN) * kLds * sizeof(bf16)
    + 2 * sizeof(long long) * kMaxBM;

__host__ __device__ inline size_t smem_bytes(int N, int hd) {
  const size_t a = attend_tc_smem_bytes(N, hd);
  return a > kGemmSmem ? a : kGemmSmem;
}

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
// (w / WM) * BN / WN of the tile; the ninth warp only copies.
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

// The attention of Swin block j: items (window, head, split) over the
// grid, each running attend_heads_tc over its split's batch elements.
template <int HD>
__device__ __noinline__ void attention_phase(const Params p, int splits, int j,
                                             bool shifted, unsigned char* smem) {
  const int C = p.C, h = p.heads, N = p.window * p.window;
  const int nW = (p.H / p.window) * (p.W / p.window);
  const int units = nW * h;
  const bf16* qkv = static_cast<const bf16*>(p.qkv);
  bf16* ctx = static_cast<bf16*>(p.ctx);
  for (int it = blockIdx.x; it < units * splits; it += gridDim.x) {
    const int s = it / units, wh = it - s * units;
    const int w = wh / h, head = wh - w * h;
    int b0, b1;
    split_range(p.B, splits, s, &b0, &b1);
    const size_t row0 = (size_t)w * N;  // window w's first token, element 0
    const PackedRows rows{qkv + row0 * 3 * C + head * HD, ctx + row0 * C + head * HD,
                          (long long)nW * N * 3 * C, (long long)nW * N * C,
                          3LL * C, (long long)C, C};
    attend_heads_tc<HD, true, true>(
        rows, p.rpb + ((size_t)j * h + head) * N * N, N, b0, b1, p.scale, smem,
        shifted ? p.mask + (size_t)w * N * N : nullptr);
  }
}

__global__ void __launch_bounds__(kThreads, 1)
fused_swin_blocks_tc_kernel(const Params p, const Plan plan) {
  cg::grid_group grid = cg::this_grid();
  extern __shared__ __align__(16) unsigned char smem[];
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
    switch (C / p.heads) {
      case 8: attention_phase<8>(p, plan.splits, j, shifted, smem); break;
      case 16: attention_phase<16>(p, plan.splits, j, shifted, smem); break;
      case 32: attention_phase<32>(p, plan.splits, j, shifted, smem); break;
      default: attention_phase<64>(p, plan.splits, j, shifted, smem); break;
    }
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

cudaError_t launch(const Params& p, const Plan& plan, int grid,
                   cudaStream_t stream) {
  auto kernel = fused_swin_blocks_tc_kernel;
  const size_t smem = smem_bytes(p.window * p.window, p.C / p.heads);
  const int per_sm = blocks_per_sm(kernel, kThreads, smem);  // raises the limit
  if (per_sm < 0) return cudaErrorInvalidValue;
  int dev = 0, coop = 0, sms = 0;
  cudaError_t e;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return e;
  if ((e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev)) != cudaSuccess) return e;
  if (!coop) return cudaErrorNotSupported;
  if ((e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return e;
  // every block must be resident for the grid syncs: a grid that does not
  // fit is refused, never shrunk
  if (grid < 1 || grid > per_sm * sms) return cudaErrorCooperativeLaunchTooLarge;
  Params args = p;
  Plan plan_args = plan;
  void* kargs[] = {&args, &plan_args};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                  dim3(grid), dim3(kThreads), kargs, smem,
                                  stream);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory one block needs; -1 where the shape is not taken.
long long fiber_fused_swin_blocks_tc_smem_bytes(int N, int hd) {
  return attend_tc_takes(N, hd) ? (long long)smem_bytes(N, hd) : -1;
}

// Resident blocks per SM; -1 on error or where the shape is not taken.
int fiber_fused_swin_blocks_tc_blocks_per_sm(int N, int hd) {
  if (!attend_tc_takes(N, hd)) return -1;
  return blocks_per_sm(fused_swin_blocks_tc_kernel, kThreads, smem_bytes(N, hd));
}

// Runs n_blocks Swin blocks over x (B, H, W, C) into out, in one
// cooperative launch of `grid` blocks on `stream`; returns a CUDA error
// code (0 on success).  Activations, scratch and weights are contiguous
// bf16 (weights stacked over the blocks in nn.Linear's (out, in) layout);
// LayerNorm parameters, rpb (n, h, N, N) and mask (nW, N, N) fp32; every
// pointer 16-byte aligned.  `splits` (1 <= splits <= B) splits the batch of
// the attention items; tile_* index kTiles for the four products.  A grid
// larger than the card holds at once is refused with
// cudaErrorCooperativeLaunchTooLarge.
int fiber_fused_swin_blocks_tc(
    const void* x, void* out, void* qkv, void* ctx, void* hid,
    const void* ln1_s, const void* ln1_b, const void* qkv_w, const void* qkv_b,
    const void* proj_w, const void* proj_b, const void* ln2_s,
    const void* ln2_b, const void* fc1_w, const void* fc1_b, const void* fc2_w,
    const void* fc2_b, const void* rpb, const void* mask, int n_blocks, int B,
    int H, int W, int C, int hidden, int window, int heads, int use_shift,
    float scale, int grid, int splits, int tile_qkv, int tile_proj,
    int tile_fc1, int tile_fc2, void* stream) {
  const Plan plan{splits, {tile_qkv, tile_proj, tile_fc1, tile_fc2}};
  for (int t : plan.tile)
    if (t < 0 || t > 2) return (int)cudaErrorInvalidValue;
  if (window < 1 || H % window || W % window || C % 32 || hidden % 32 ||
      heads < 1 || C % heads || n_blocks < 1 || B < 1 || splits < 1 ||
      splits > B || !attend_tc_takes(window * window, C / heads))
    return (int)cudaErrorInvalidValue;
  Params p{x, out, qkv, ctx, hid,
           static_cast<const float*>(ln1_s), static_cast<const float*>(ln1_b),
           qkv_w, qkv_b, proj_w, proj_b,
           static_cast<const float*>(ln2_s), static_cast<const float*>(ln2_b),
           fc1_w, fc1_b, fc2_w, fc2_b,
           static_cast<const float*>(rpb), static_cast<const float*>(mask),
           n_blocks, B, H, W, C, hidden, window, heads, use_shift, scale};
  return (int)launch(p, plan, grid, static_cast<cudaStream_t>(stream));
}

}  // extern "C"
