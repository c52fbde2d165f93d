// A run of n unfused Swin blocks in one launch (inference), fp32 at hd in
// {8, 16, 32, 64} and N <= 352, with every product on the H100's tensor
// cores as split-TF32 products (route "tc_f32").  (bf16 runs
// swin_stage_tc.cu and swin_stage_tc_long.cu; hd = 128 swin_stage.cu.)
//
// Replaces the JAX package's Pallas TPU kernel
// fiber_tpu/ops/swin_stage.py::fused_swin_blocks (body _kernel) in fp32.  It
// computes swin_stage.cu's function (see there) at the rounding points of
// the plain version fiber_torch/ops/swin_stage.py::
// fused_swin_blocks_reference, which in fp32 round nothing: LayerNorm in
// fp32 (eps 1e-5); each product plus its bias in fp32, then its epilogue
// (the erf-GELU of swin_stage_common.cuh, or the residual sum); the logits
// the fp32 q . k^T scaled by hd^-1/2 after the product, plus the bias, plus
// the shift mask on shifted blocks; fp32 softmax.
//
// What bounds it on the card: operations.  A block does 24 C^2 + 4 N C FLOP
// a token, the four products 24 C^2 of them (95.5% at N = 144, C = 512;
// 90.5% at N = 324).  fp32 FMAs on the CUDA cores give at most 67 TFLOP/s;
// the first fp32 K3 (swin_stage.cu) ran at 9 TFLOP/s there.  Here:
// * the products (qkv, proj, fc1, fc2) on mma.sync m16n8k8 TF32: each fp32
//   operand is its big and small TF32 halves, a . b = a_small . b_big +
//   a_big . b_small + a_big . b_big (mma_tf32.cuh), 495 / 3 = 165 TFLOP/s
//   at most;
// * the tensor cores round the sum they write toward zero, so a chain over
//   the whole reduction drifts (a CPU model gives 5e-5 of the output's
//   max-abs at fc2's K = 4096, tests/test_torch_swin_stage_tf32.py): each
//   32-deep stage sums its 12 products from a zero accumulator, and the
//   stage is added into the tile's fp32 accumulator to nearest (the model:
//   within the plain fp32 product's own error of fp64);
// * the operands stay fp32 in device memory, as the plain version has
//   them (4 bytes a value): A's and W's rows come by cp.async into a
//   kF32Stages ring of 32-deep slabs, rows of 36 floats (a warp's fragment
//   reads, rows g = lane / 4 and columns c = lane % 4, hit 32 banks), and
//   each thread splits the values of its fragments as it reads them (3
//   instructions a value).  Two other forms were slower on an H100:
//   operands split in device memory (8 bytes a value to stage: the
//   products' staging bound them) and one block-wide pass a slab from the
//   fp32 ring into a split slab (one more block sync a slab, and less of
//   the ring);
// * each of the three products over the whole warp tile before the next,
//   so that MI x NI independent mma stand between two into one tile;
// * the tiles (128x128, 128x64, 64x64, 96x128 on 8 warps, kF32Tiles)
//   chosen per product by the host (fiber_torch/ops/swin_stage.py::
//   _k3_f32_plan: waves x shared-memory traffic, as the bf16 plan); 96 x
//   128 fills one wave where 128 x 128 leaves 45% of the card idle (proj
//   and fc2 at 384^2 stage 3, B = 4: 96 tiles against 72 on 132 SMs), and
//   each block streams the slabs of all its tiles through one ring;
// * the attention on the CUDA cores (under 10% of the FLOP): attend_f32 of
//   window_attention_f32.cuh, K1's and K4's fp32 routine, with K3's
//   rounding (its K3 option), over items (row block of 64, window, head,
//   split), the row blocks of one (window, head) neighbours in the grid;
// * the persistent cooperative grid of swin_stage_tc.cu: one block of 8
//   warps per resident slot (the occupancy API's count, a grid that does
//   not fit is refused), grid syncs between the seven phases of a block,
//   and the rolled windows through Rows.  One kernel instance for each of
//   attend_f32's key chunks (N <= 64, 160, 256, 352); all four take about
//   255 registers a thread (the products' two accumulator tiles, 128 at
//   128 x 128), so one block an SM;
// * built with FIBER_K3_PHASE_TIMES, the kernel also records each phase's
//   device time (PhaseClock below).
// Every output element is written by one thread, without atomics: two
// calls give the same bits.
//
// Shared memory: the larger of the products' ring (kF32Stages slabs of 128
// + 128 rows of 144 bytes: 147,456 bytes) and attend_f32's (59,904 bytes at
// N = 144, hd = 32, 112,128 at N = 324).  The LayerNorm phases hold a row
// in a warp's registers (kLnVec).
//
// Limits: fp32, N <= 352, hd in {8, 16, 32, 64}; C <= 1536 (a LayerNorm
// row in a warp's registers); C and the MLP width multiples of 32, H and W
// multiples of the window; every tensor 16-byte aligned (the wrapper checks
// and raises).  Scratch (the wrapper's, fp32): qkv (M, 3C), the context and
// LayerNorm rows (M, C), fc1's rows (M, hidden).

#include <cooperative_groups.h>
#include <stdint.h>

#include "mma_tf32.cuh"
#include "swin_stage_tc.cuh"
#include "window_attention_f32.cuh"

namespace {

using namespace fiber;
using namespace fiber::swin_tc;

constexpr int kThreads = kF32FwdMaxWarps * 32;  // 8 warps: kGemmWarps
static_assert(kF32FwdMaxWarps == kGemmWarps, "one block shape for both");
constexpr int kAttnRows = kF32RowsWarp * kF32FwdMaxWarps;  // 64 query rows
constexpr int kF32BK = 32;              // reduction depth of a stage
constexpr int kRawF = kF32BK + 4;       // a staged row: 144 bytes
constexpr int kF32Stages = 4;
constexpr size_t kF32GemmSmem =
    (size_t)(kMaxBM + kMaxBN) * kF32Stages * kRawF * sizeof(float);

// The instance for a window of N tokens: attend_f32's key chunks a lane.
__host__ __device__ inline size_t smem_bytes(int KC, int hd) {
  const size_t a = attend_f32_smem_bytes(KC, hd, kF32FwdMaxWarps);
  return a > kF32GemmSmem ? a : kF32GemmSmem;
}

// O[orows(r), c] = epilogue(sum_k A[r, k] * Wt[c, k] + bias[c]) for r < M,
// c < Nout; A's row r at A + r * K (token order), O's at O +
// orows.token(r) * ldo.
struct GemmF32 {
  long long M;
  int K, Nout;
  const float* A;
  const float* Wt;
  const float* bias;
  float* O;
  int ldo;
  Rows orows;
};

// The tile shapes (BM x BN) of the products, by the index the wrapper
// passes: swin_stage_tc.cuh's kTiles and 96 x 128 (fiber_torch/ops/
// swin_stage.py::_K3_F32_TILES), each on 8 warps of (BM / WM) x (BN / WN).
constexpr int kF32Tiles[4][2] = {{kTiles[0][0], kTiles[0][1]},
                                 {kTiles[1][0], kTiles[1][1]},
                                 {kTiles[2][0], kTiles[2][1]},
                                 {96, 128}};

// Every BM x BN output tile of one product, spread over the grid: block b
// runs tiles b, b + grid, ..., its slabs one stream through the ring, so
// that the next tile's first slabs load while this one's last are used
// and its epilogue runs.
template <int BM, int BN, int WM, int WN, int EPI>
__device__ __noinline__ void gemm_f32_phase(const GemmF32 g, unsigned char* smem) {
  constexpr int WTM = BM / WM, WTN = BN / WN;
  constexpr int MI = WTM / 16, NI = WTN / 8;
  static_assert(WM * WN == kGemmWarps && WTM % 16 == 0 && WTN % 8 == 0,
                "warp tiling");
  static_assert(BM <= kMaxBM && BN <= kMaxBN, "tile within the shared memory");
  constexpr int ROWS = BM + BN;                    // A's rows, then W's
  constexpr int CH = kF32BK / 4;                   // 16-byte chunks a row
  float* raw = reinterpret_cast<float*>(smem);     // [kF32Stages][ROWS][kRawF]
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g4 = lane >> 2, c4 = lane & 3;
  const int wm0 = (warp % WM) * WTM, wn0 = (warp / WM) * WTN;
  const int tiles_m = (int)((g.M + BM - 1) / BM);
  const int tiles = tiles_m * ((g.Nout + BN - 1) / BN);
  const int KT = g.K / kF32BK;
  const int mine = blockIdx.x < tiles
      ? (tiles - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  const int steps = mine * KT;                     // (tile, slab) pairs
  if (steps == 0) return;

  // slab `step` of this block's stream, fp32 as it is, into its ring slot
  auto load = [&](int step) {
    const int i = step / KT, kt = step - i * KT;
    const int t = blockIdx.x + i * gridDim.x;
    const long long r0 = (long long)(t % tiles_m) * BM;
    const int c0 = (t / tiles_m) * BN;
    const int k0 = kt * kF32BK;
    float* dst = raw + (step % kF32Stages) * ROWS * kRawF;
    for (int j = tid; j < ROWS * CH; j += blockDim.x) {
      const int r = j / CH, ch = j - r * CH;
      const float* src;
      if (r < BM) {      // rows past M read row M - 1 and are not stored
        const long long row = r0 + r < g.M ? r0 + r : g.M - 1;
        src = g.A + row * g.K;
      } else {
        const int c = c0 + r - BM < g.Nout ? c0 + r - BM : g.Nout - 1;
        src = g.Wt + (size_t)c * g.K;
      }
      cp_async16(dst + r * kRawF + 4 * ch, src + k0 + 4 * ch);
    }
  };
  __syncthreads();  // the last users of this shared memory are done
#pragma unroll
  for (int s = 0; s < kF32Stages - 1; ++s) {
    if (s < steps) load(s);
    cp_async_commit();
  }

  float acc[MI][NI][4];
#pragma unroll
  for (int mi = 0; mi < MI; ++mi)
#pragma unroll
    for (int ni = 0; ni < NI; ++ni) zero(acc[mi][ni]);

  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kF32Stages - 2>();  // slab `step` has landed
    __syncthreads();  // ... for every thread; the slot of step - 1 is free
    if (step + kF32Stages - 1 < steps) load(step + kF32Stages - 1);
    cp_async_commit();
    const float* As = raw + (step % kF32Stages) * ROWS * kRawF;
    const float* Bs = As + BM * kRawF;
    // the slab's 12 products a tile from zero (the tensor cores round
    // toward zero), then added into acc in fp32, to nearest
    float st[MI][NI][4];
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) zero(st[mi][ni]);
#pragma unroll
    for (int kk = 0; kk < kF32BK / 8; ++kk) {
      const int k = 8 * kk + c4;
      SplitA a[MI];
#pragma unroll
      for (int mi = 0; mi < MI; ++mi) {
        const float* r = As + (wm0 + 16 * mi + g4) * kRawF + k;
        a[mi].set(r[0], r[8 * kRawF], r[4], r[8 * kRawF + 4]);
      }
      SplitB b[NI];
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) {
        const float* r = Bs + (wn0 + 8 * ni + g4) * kRawF + k;
        split_tf32(r[0], b[ni].big[0], b[ni].small[0]);
        split_tf32(r[4], b[ni].big[1], b[ni].small[1]);
      }
      // each of the three products over the whole warp tile before the
      // next, so that MI x NI independent mma stand between two that
      // accumulate into one tile
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
          mma_tf32(st[mi][ni], a[mi].small, b[ni].big[0], b[ni].big[1]);
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
          mma_tf32(st[mi][ni], a[mi].big, b[ni].small[0], b[ni].small[1]);
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int mi = 0; mi < MI; ++mi)
          mma_tf32(st[mi][ni], a[mi].big, b[ni].big[0], b[ni].big[1]);
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni)
#pragma unroll
        for (int x = 0; x < 4; ++x) acc[mi][ni][x] += st[mi][ni][x];

    const int i = step / KT;
    if (step - i * KT != KT - 1) continue;
    // the tile's last slab: its epilogue, then acc from zero
    const int t = blockIdx.x + i * gridDim.x;
    const long long r0 = (long long)(t % tiles_m) * BM;
    const int c0 = (t / tiles_m) * BN;
    const int c2 = 2 * c4;
#pragma unroll
    for (int mi = 0; mi < MI; ++mi) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const long long r = r0 + wm0 + 16 * mi + g4 + 8 * hr;
        if (r >= g.M) continue;
        const long long off = g.orows.token(r) * g.ldo;
#pragma unroll
        for (int ni = 0; ni < NI; ++ni) {
          const int c = c0 + wn0 + 8 * ni + c2;
          if (c >= g.Nout) continue;
          const float2 b = *reinterpret_cast<const float2*>(g.bias + c);
          float v0 = acc[mi][ni][2 * hr] + b.x;
          float v1 = acc[mi][ni][2 * hr + 1] + b.y;
          float2* o = reinterpret_cast<float2*>(g.O + off + c);
          if (EPI == kBiasGelu) {
            v0 = gelu_as(v0);
            v1 = gelu_as(v1);
          }
          if (EPI == kBiasResidRound || EPI == kBiasResid) {
            const float2 q = *o;
            v0 = q.x + v0;
            v1 = q.y + v1;
          }
          *o = make_float2(v0, v1);
        }
      }
    }
#pragma unroll
    for (int mi = 0; mi < MI; ++mi)
#pragma unroll
      for (int ni = 0; ni < NI; ++ni) zero(acc[mi][ni]);
  }
  cp_async_wait<0>();
}

template <int EPI>
__device__ __forceinline__ void gemm_f32(int tile, const GemmF32& g,
                                         unsigned char* smem) {
  switch (tile) {
    case 0: gemm_f32_phase<kF32Tiles[0][0], kF32Tiles[0][1], 2, 4, EPI>(g, smem); break;
    case 1: gemm_f32_phase<kF32Tiles[1][0], kF32Tiles[1][1], 4, 2, EPI>(g, smem); break;
    case 2: gemm_f32_phase<kF32Tiles[2][0], kF32Tiles[2][1], 2, 4, EPI>(g, smem); break;
    default: gemm_f32_phase<kF32Tiles[3][0], kF32Tiles[3][1], 2, 4, EPI>(g, smem); break;
  }
}

// dst row r = LayerNorm(act row rows.token(r)) * s + b for r < M, one warp
// a row held in registers (C <= 4 * 32 * kLnVec): fp32 mean, then the mean
// of squared deviations (eps 1e-5), as the plain version computes them.
constexpr int kLnVec = 12;
__device__ __noinline__ void ln_f32_phase(const float* act, float* dst, Rows rows,
                                      long long M, int C,
                                      const float* __restrict__ s,
                                      const float* __restrict__ b) {
  const int lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int Q = C / 4;
  for (long long r = (long long)blockIdx.x * warps + (threadIdx.x >> 5); r < M;
       r += (long long)gridDim.x * warps) {
    const float4* a = reinterpret_cast<const float4*>(act + rows.token(r) * C);
    float4 v[kLnVec];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < kLnVec; ++i) {
      const int q = lane + 32 * i;
      v[i] = q < Q ? a[q] : make_float4(0.f, 0.f, 0.f, 0.f);
      sum += (v[i].x + v[i].y) + (v[i].z + v[i].w);
    }
    const float mean = warp_sum(sum) / C;
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < kLnVec; ++i) {
      if (lane + 32 * i < Q) {
        const float dx = v[i].x - mean, dy = v[i].y - mean;
        const float dz = v[i].z - mean, dw = v[i].w - mean;
        sq += (dx * dx + dy * dy) + (dz * dz + dw * dw);
      }
    }
    const float rstd = rsqrtf(warp_sum(sq) / C + 1e-5f);
    float4* o = reinterpret_cast<float4*>(dst + r * C);
#pragma unroll
    for (int i = 0; i < kLnVec; ++i) {
      const int q = lane + 32 * i;
      if (q < Q) {
        const float4 sc = reinterpret_cast<const float4*>(s)[q];
        const float4 bi = reinterpret_cast<const float4*>(b)[q];
        o[q] = make_float4((v[i].x - mean) * rstd * sc.x + bi.x,
                           (v[i].y - mean) * rstd * sc.y + bi.y,
                           (v[i].z - mean) * rstd * sc.z + bi.z,
                           (v[i].w - mean) * rstd * sc.w + bi.w);
      }
    }
  }
}

// The attention of Swin block j: items (row block, window, head, split)
// over the grid, each attend_f32 on 64 query rows of one (window, head)
// for its split's batch elements.
template <int HD, int KC>
__device__ __noinline__ void attention_phase(const Params p, int splits, int j,
                                             bool shifted, float* smem) {
  const int C = p.C, h = p.heads, N = p.window * p.window;
  const int nW = (p.H / p.window) * (p.W / p.window);
  const int row_blocks = (N + kAttnRows - 1) / kAttnRows;
  const int units = row_blocks * nW * h;
  const float* qkv = static_cast<const float*>(p.qkv);
  float* ctx = static_cast<float*>(p.ctx);
  for (int it = blockIdx.x; it < units * splits; it += gridDim.x) {
    const int s = it / units, u = it - s * units;
    const int wh = u / row_blocks, rb = u - wh * row_blocks;
    const int w = wh / h, head = wh - w * h;
    int b0, b1;
    split_range(p.B, splits, s, &b0, &b1);
    attend_f32<HD, KC, true>(
        packed_rows(qkv, ctx, nW, N, h, HD, w, head),
        p.rpb + ((size_t)j * h + head) * N * N, N, rb * kAttnRows, b0, b1,
        p.scale, smem, shifted ? p.mask + (size_t)w * N * N : nullptr);
  }
}

// The device time of each of a Swin block's seven phases, summed over the
// run, where the library is built with FIBER_K3_PHASE_TIMES
// (`swin_stage_tf32+FIBER_K3_PHASE_TIMES`, fiber_torch/ops/swin_stage.py::
// tf32_phase_ms): block 0's thread 0 reads the global timer after each grid
// sync, where a phase has ended for the whole grid.  Otherwise nothing.
#ifdef FIBER_K3_PHASE_TIMES
__device__ unsigned long long g_phase_ns[7];
struct PhaseClock {
  bool on;
  unsigned long long last;
  __device__ PhaseClock() : on(blockIdx.x == 0 && threadIdx.x == 0), last(0) {}
  __device__ static unsigned long long now() {
    unsigned long long t;
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
    return t;
  }
  __device__ void start() {
    if (!on) return;
    for (int i = 0; i < 7; ++i) g_phase_ns[i] = 0;
    last = now();
  }
  __device__ void mark(int phase) {
    if (!on) return;
    const unsigned long long t = now();
    g_phase_ns[phase] += t - last;
    last = t;
  }
};
#else
struct PhaseClock {
  __device__ void start() {}
  __device__ void mark(int) {}
};
#endif

template <int KC>
__global__ void __launch_bounds__(kThreads, 1)
fused_swin_blocks_tf32_kernel(const Params p, const Plan plan) {
  extern __shared__ __align__(16) unsigned char smem[];
  cooperative_groups::grid_group grid = cooperative_groups::this_grid();
  const int C = p.C, hid = p.hidden;
  const long long M = (long long)p.B * p.H * p.W;
  float* act = static_cast<float*>(p.act);
  float* qkv = static_cast<float*>(p.qkv);
  float* ctx = static_cast<float*>(p.ctx);  // also the LayerNorm outputs
  float* hbuf = static_cast<float*>(p.hid);
  const float* qkv_w = static_cast<const float*>(p.qkv_w);
  const float* proj_w = static_cast<const float*>(p.proj_w);
  const float* fc1_w = static_cast<const float*>(p.fc1_w);
  const float* fc2_w = static_cast<const float*>(p.fc2_w);
  const float* qkv_b = static_cast<const float*>(p.qkv_b);
  const float* proj_b = static_cast<const float*>(p.proj_b);
  const float* fc1_b = static_cast<const float*>(p.fc1_b);
  const float* fc2_b = static_cast<const float*>(p.fc2_b);

  {
    const float4* src = static_cast<const float4*>(p.x);
    float4* dst = reinterpret_cast<float4*>(act);
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < M * C / 4; i += (long long)gridDim.x * blockDim.x)
      dst[i] = src[i];
  }
  grid.sync();
  PhaseClock clock;
  clock.start();

  const Rows lin{p.H, p.W, 0, 0};
  for (int j = 0; j < p.n_blocks; ++j) {
    const bool shifted = p.use_shift && (j & 1);
    const Rows win{p.H, p.W, p.window, shifted ? p.window / 2 : 0};
    // LN1, written in window order
    ln_f32_phase(act, ctx, win, M, C, p.ln1_s + (size_t)j * C, p.ln1_b + (size_t)j * C);
    grid.sync();
    clock.mark(0);
    gemm_f32<kBias>(plan.tile[0],
                GemmF32{M, C, 3 * C, ctx, qkv_w + (size_t)j * 3 * C * C, qkv_b + (size_t)j * 3 * C, qkv,
                        3 * C, lin}, smem);
    grid.sync();
    clock.mark(1);
    {
      float* s = reinterpret_cast<float*>(smem);
      switch (C / p.heads) {
        case 8: attention_phase<8, KC>(p, plan.splits, j, shifted, s); break;
        case 16: attention_phase<16, KC>(p, plan.splits, j, shifted, s); break;
        case 32: attention_phase<32, KC>(p, plan.splits, j, shifted, s); break;
        default: attention_phase<64, KC>(p, plan.splits, j, shifted, s); break;
      }
    }
    grid.sync();
    clock.mark(2);
    // proj + residual, written back at the un-rolled tokens
    gemm_f32<kBiasResidRound>(plan.tile[1],
                          GemmF32{M, C, C, ctx, proj_w + (size_t)j * C * C, proj_b + (size_t)j * C,
                                  act, C, win}, smem);
    grid.sync();
    clock.mark(3);
    // LN2, in token order
    ln_f32_phase(act, ctx, lin, M, C, p.ln2_s + (size_t)j * C, p.ln2_b + (size_t)j * C);
    grid.sync();
    clock.mark(4);
    gemm_f32<kBiasGelu>(plan.tile[2],
                    GemmF32{M, C, hid, ctx, fc1_w + (size_t)j * hid * C,
                            fc1_b + (size_t)j * hid, hbuf, hid, lin}, smem);
    grid.sync();
    clock.mark(5);
    gemm_f32<kBiasResid>(plan.tile[3],
                     GemmF32{M, hid, C, hbuf, fc2_w + (size_t)j * C * hid, fc2_b + (size_t)j * C, act,
                             C, lin}, smem);
    grid.sync();
    clock.mark(6);
  }
}

// The instance of a window of N tokens (attend_f32's key chunks), with its
// shared memory at head dim hd.
struct Instance {
  void (*kernel)(const Params, const Plan);
  size_t smem;
};

inline Instance instance(int N, int hd) {
  const int kc = f32_key_chunks(N);
  Instance in{nullptr, smem_bytes(kc, hd)};
  switch (kc) {
    case 2: in.kernel = fused_swin_blocks_tf32_kernel<2>; break;
    case 5: in.kernel = fused_swin_blocks_tf32_kernel<5>; break;
    case 8: in.kernel = fused_swin_blocks_tf32_kernel<8>; break;
    default: in.kernel = fused_swin_blocks_tf32_kernel<11>; break;
  }
  return in;
}

}  // namespace

extern "C" {

// Shared memory one block needs; -1 where the shape is not taken.
long long fiber_fused_swin_blocks_tf32_smem_bytes(int N, int hd) {
  return f32_takes(N, hd) ? (long long)instance(N, hd).smem : -1;
}

// out[0..2] = registers a thread, local (spilled) bytes a thread and
// resident blocks an SM of the instance a window of N tokens at head dim hd
// runs, at its shared memory; a CUDA error code.
int fiber_fused_swin_blocks_tf32_attrs(int N, int hd, int* out) {
  if (!f32_takes(N, hd)) return (int)cudaErrorInvalidValue;
  const Instance in = instance(N, hd);
  cudaError_t e = allow_smem(in.kernel, in.smem);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes a;
  if ((e = cudaFuncGetAttributes(&a, in.kernel)) != cudaSuccess) return (int)e;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = blocks_per_sm(in.kernel, kThreads, in.smem);
  return out[2] < 0 ? (int)cudaErrorInvalidValue : 0;
}

// Runs n_blocks Swin blocks over x (B, H, W, C) into out, in one
// cooperative launch of `grid` blocks on `stream`; returns a CUDA error
// code (0 on success).  Activations, weights (stacked over the blocks in
// nn.Linear's (out, in) layout), Linear biases, LayerNorm parameters, rpb
// (n, h, N, N) and mask (nW, N, N) fp32; scratch: qkv (M, 3C), ctx
// (M, C), hid (M, hidden); every pointer 16-byte aligned.  `splits` (1 <= splits <= B) splits the batch of
// the attention items; tile_* index kTiles for the four products.  A grid
// larger than the card holds at once is refused with
// cudaErrorCooperativeLaunchTooLarge.
int fiber_fused_swin_blocks_tf32(
    const void* x, void* out, void* qkv, void* ctx, void* hid,
    const void* ln1_s, const void* ln1_b, const void* qkv_w, const void* qkv_b,
    const void* proj_w, const void* proj_b, const void* ln2_s,
    const void* ln2_b, const void* fc1_w, const void* fc1_b, const void* fc2_w,
    const void* fc2_b, const void* rpb, const void* mask, int n_blocks, int B, int H, int W, int C, int hidden, int window,
    int heads, int use_shift, float scale, int grid, int splits, int tile_qkv,
    int tile_proj, int tile_fc1, int tile_fc2, void* stream) {
  Plan plan{splits, {tile_qkv, tile_proj, tile_fc1, tile_fc2}};
  Params p{x, out, qkv, ctx, hid,
           static_cast<const float*>(ln1_s), static_cast<const float*>(ln1_b),
           qkv_w, qkv_b, proj_w, proj_b,
           static_cast<const float*>(ln2_s), static_cast<const float*>(ln2_b),
           fc1_w, fc1_b, fc2_w, fc2_b,
           static_cast<const float*>(rpb), static_cast<const float*>(mask),
           n_blocks, B, H, W, C, hidden, window, heads, use_shift, scale};
  // stack_takes checks the shapes (and kTiles' indices: kF32Tiles' here)
  const Plan shapes{splits, {0, 0, 0, 0}};
  for (int t : plan.tile)
    if (t < 0 || t > 3) return (int)cudaErrorInvalidValue;
  if (!stack_takes(p, shapes) || !f32_takes(window * window, C / heads) ||
      C > 4 * 32 * kLnVec)
    return (int)cudaErrorInvalidValue;
  const Instance in = instance(window * window, C / heads);
  void* args[] = {&p, &plan};
  return (int)launch_cooperative(in.kernel, grid, kThreads, in.smem, args,
                                 static_cast<cudaStream_t>(stream));
}

#ifdef FIBER_K3_PHASE_TIMES
// out[0..6] = ns of LN1, qkv, attention, proj, LN2, fc1, fc2 in the last
// run; a CUDA error code.
int fiber_fused_swin_blocks_tf32_phase_ns(unsigned long long* out) {
  return (int)cudaMemcpyFromSymbol(out, g_phase_ns, sizeof(g_phase_ns));
}
#endif

}  // extern "C"
