// Windowed multi-head attention backward for Hopper (sm_90a), bf16, on the
// tensor cores, for windows of 144 < N <= 352 tokens: FIBER's 18 x 18
// windows (N = 324) at 576^2, where every Swin block of a 576^2 training
// step (VQA, ITC, caption finetuning) runs at N = 324, hd = 32; and for the
// shapes of N <= 144 whose whole tiles do not fit window_attention_bwd_tc.cu
// (hd = 64 at N = 144).  (fp32 runs window_attention_bwd.cu.)
//
// Replaces the JAX package's Pallas TPU kernel
// fiber_tpu/ops/window_attention.py::window_attention_packed_pallas_bwd
// (body _packed_bwd_kernel) at those shapes.  For every (batch b, window
// w, head), with the steps of the plain version
// window_attention_bwd_reference (fiber_torch/ops/window_attention.py):
//
//     P   = softmax(round(q * scale) . k^T + bias)          fp32, as K1
//     dv  = round(P)^T . dO
//     dP  = dO . v^T                                        fp32
//     dS  = P * (dP - rowsum(dP * P))                       fp32
//     dq  = scale * round(dS) . k,   dk = scale * round(dS)^T . q
//     dbias[w, head] = sum over b of dS                     fp32
//
// Three sums cross the tiles: dq over the keys, dk and dv over the query
// rows, dbias over the batch.  No block can hold a (window, head)'s whole
// (N, N) fp32 dbias (462,336 bytes at N = 324, against a block's 232,448),
// so the work is split between two kernels, each the only writer of what
// it sums, with no atomics (two calls give the same bits):
//
// * the row kernel, grid (ceil(N / 64), nW * h, S): block (r, w * h +
//   head, s) owns query rows [64 r, 64 r + 64) of one (window, head) and
//   walks the batch elements of split s, keeping its 64 bias rows and 64
//   dbias rows (fp32, in shared memory) for the whole run.  A producer warp
//   copies each element's K and V, 64 keys a block, by cp.async with
//   completion on mbarriers: where they fit (hd <= 32 at N = 324), the
//   element's whole K and V stay for both passes (`stages` 0, one barrier
//   a key block, each block released after its pass-B use, so the next
//   element's blocks land while this one finishes), else through a ring
//   of `stages` stages, pass A's blocks and then pass B's.  P consumer
//   warpgroups (`parts`) take the key blocks in turn (block kb to part kb
//   % P), each warp a 16-row slab of the 64 rows:
//     pass A: S = bias + q~ . K^T and dP = dO . V^T by wgmma (q~ = round(q
//             * scale) and dO as register A fragments, the next element's
//             loaded during this one's pass B; K and V from shared
//             memory), each lane's running max m, sum l of exp(s - m) and
//             sum g of exp(s - m) dP, rescaled together; the quad, then the
//             parts in the order p = 0 ... P - 1, give M, 1 / L and D =
//             rowsum(dP * P) = g / L (over fp32 P and dP, before any
//             rounding), written to a (B, nW h, N) x 4 fp32 scratch;
//     pass B: S and dP again by the same instructions (the same bits), P =
//             exp(s - M) / L as K1 forms it, dS = P (dP - D) added into the
//             dbias rows (each element owned by one thread for the whole
//             run), and dq += round(dS) . K by wgmma from the accumulators
//             packed as A fragments; part 0 adds the other parts' dq in
//             their order and stores.  The dbias rows go to dbias (S = 1)
//             or to their split's partial, summed in the order s = 0 ...
//             S - 1 by window_attention_bwd_sum_splits;
// * the column kernel, grid (ceil(N / Rc), nW * h, S'), Rc = 64 G keys:
//   G consumer warpgroups of 64 keys, a warp's 16 keys of K and V as its
//   register A fragments (from device memory, the next element's loaded
//   while this one runs), the block's bias columns for every query row in
//   shared memory for the whole run, and a producer warp that streams, for
//   each element, its query rows in blocks of 64 through a ring of
//   `stages` stages: q and dO (cp.async) and the rows' (M, 1 / L, D) (a
//   bulk copy of the tensor memory accelerator).  Per block: q~ = round(q
//   * scale) into the group's own buffer; by wgmma S^T = bias^T + K .
//   q~^T, dP^T = V . dO^T; P^T from the rows' statistics and dS^T in
//   registers; dv += round(P^T) . dO and dk += round(dS^T) . q.  dk and dv
//   are written whole for its keys.
//
// Operands that wgmma reads from shared memory are in the core layout of
// wgmma_bf16.cuh (8-row, 16-byte core matrices, no swizzle); its A operands
// come from registers with mma.sync's fragment layout, so P and dS never
// leave registers.  The blocks of one (window, head) are neighbours in the
// launch order, so its K, V and the rest come from device memory once,
// then from L2.
//
// Products of N^2 hd: the row kernel runs QK^T and dP twice (the
// statistics need a whole row before dS can be formed, and keeping the
// row's fp32 S and dP for a second look would take 172 KB of shared memory
// beside the 176 KB of bias and dbias rows), the column kernel once more
// each: 9 against the algorithm's 5.
//
// What bounds it on the card: bytes.  At stage 1 of 576^2 at B = 8 (nW =
// 64, h = 4) qkv, dout and dqkv in bf16 (254.8 MB) and the bias and dbias
// (107.5 MB each) are 469.8 MB: 0.140 ms at 3.35 TB/s; the five products
// are 68.8 GFLOP, 0.070 ms at 989 TFLOP/s.  The scratch is 8 MB there.
// What held the previous version (mma.sync, each element's K and V staged
// whole by the whole block, 2 cp.async stages in the column kernel: 1.99
// ms there on an H100) was latency: dependent mma.sync, ldmatrix and exp
// chains on 12 warps an SM, a __syncthreads per stage, and in the column
// kernel the bias block read again for every element (about 0.9 GB from L2
// a call).  Here the products run asynchronously on the warpgroups, the
// copies on a warp of their own, the column kernel's bias once a block and
// the row kernel's K and V once an element: 1.48 ms there (fiber_torch/
// tools/k2_long_times.py).  Still one block an SM in the row kernel (its
// bias and dbias rows) and two in the column kernel (its bias columns),
// each warpgroup waiting out its products.
// Limits: N <= 352 with 3 or more blocks of 64 query rows (N > 128), hd in
// {8, 16, 32, 64}, within a block's shared memory (the wrapper's plan,
// _bwd_long_plan, picks parts, G and the stages that fit).

#include <stdint.h>

#include "window_attention_bwd_common.cuh"
#include "window_attention_tc_long.cuh"
#include "wgmma_bf16.cuh"

namespace {

using namespace fiber;
using bf16 = __nv_bfloat16;

constexpr int kRowMaxParts = 2;      // consumer warpgroups of the row kernel
constexpr int kMaxStages = 4;        // the rings' stages
constexpr int kMaxBarriers = 8;      // full (and empty) barriers: a ring's
                                     // stages, or an element's key blocks
constexpr int kRows = kKeyBlock;     // query rows of a row block

__host__ __device__ inline size_t align128(size_t x) {
  return (x + 127) & ~size_t(127);
}

bool bwd_long_takes(int N, int hd) {
  return N > 2 * kKeyBlock && N <= kLongMaxNP
      && (hd == 8 || hd == 16 || hd == 32 || hd == 64);
}

// The row kernel's shared memory: its barriers, the 64 staged bias rows and
// the 64 dbias rows (NP + 8 fp32 each), its K and V (the core layout):
// `stages` ring stages of one key block each (64 rows), or, with stages =
// 0, one element's whole K and V (NP rows), each key block copied once for
// both passes; then the parts' exchange: every part's (max, sum, dot) of
// each row and, with P > 1, one part's dq accumulators (64 x HP fp32),
// through which parts 1 ... P - 1 pass theirs to part 0 in turn.
struct RowLayout {
  size_t bars, bias, kv, stats, acc;
  int stages, rows;                  // K / V tile rows: 64, or NP (stages 0)
  __host__ __device__ RowLayout(int N, int hd, int parts, int nstages)
      : stages(nstages), rows(nstages ? kKeyBlock : pad16(N)) {
    bars = 128;
    bias = align128(sizeof(float) * (size_t)kRows * tile_ld(pad16(N)));
    kv = align128(sizeof(bf16) * (size_t)rows * chans(hd));
    stats = sizeof(float4) * (size_t)kRows * parts;
    acc = parts > 1 ? sizeof(float) * (size_t)kRows * chans(hd) : 0;
  }
  __host__ __device__ size_t stage() const { return 2 * kv; }
  __host__ __device__ size_t total() const {
    return bars + 2 * bias + (stages ? stages : 1) * stage() + stats + acc;
  }
};

// The operands of one (window, head) of batch element 0; element b is
// b * in_elem (qkv, dqkv) or b * out_elem (dout) further on
struct BwdRows {
  const bf16* q;     // + C: k, + 2C: v
  const bf16* o;     // dout
  bf16* g;           // dqkv: dq, + C: dk, + 2C: dv
  long long in_elem, out_elem;
  int C;
};

__device__ __forceinline__ BwdRows bwd_rows(const bf16* qkv, const bf16* dout,
                                            bf16* dqkv, int nW, int N, int h,
                                            int HD, int w, int head) {
  const int C = h * HD;
  const size_t row0 = (size_t)w * N;
  return BwdRows{qkv + row0 * 3 * C + head * HD, dout + row0 * C + head * HD,
                 dqkv + row0 * 3 * C + head * HD, (long long)nW * N * 3 * C,
                 (long long)nW * N * C, C};
}


// A key block's logits start as its bias rows (Bb, row stride ld; ncol real
// keys, nq real rows; bias_frag's -inf and 0 on the padding), its dP at 0:
// where every row and key of the block is real, straight loads
template <int TL>
__device__ __forceinline__ void block_bias(float (&s)[TL][4],
                                           float (&dp)[TL][4], const float* Bb,
                                           int ld, int nq, int ncol, int la,
                                           int lb, int c2) {
  if (nq == kRows && ncol >= 8 * TL) {
#pragma unroll
    for (int u = 0; u < TL; ++u) {
      const float2 a = *reinterpret_cast<const float2*>(Bb + la * ld + 8 * u + c2);
      const float2 b = *reinterpret_cast<const float2*>(Bb + lb * ld + 8 * u + c2);
      s[u][0] = a.x;
      s[u][1] = a.y;
      s[u][2] = b.x;
      s[u][3] = b.y;
      zero(dp[u]);
    }
  } else {
#pragma unroll
    for (int u = 0; u < TL; ++u) {
      bias_frag(s[u], Bb, ld, nq, ncol, la, lb, 8 * u + c2);
      zero(dp[u]);
    }
  }
}

// named barrier 1 over the consumer warps (the producer warp does not take
// part)
__device__ __forceinline__ void consumers_sync(int threads) {
  asm volatile("bar.sync 1, %0;\n" :: "r"(threads) : "memory");
}

// A warp's A fragments of two (rows, hd) bf16 operands x and y (row
// strides xs, ys): rows ra and rb = ra + 8, 4 bytes a register, straight
// from device memory, zero at or past row n (q and dO in the row kernel,
// K and V in the column kernel)
template <int KQ>
__device__ __forceinline__ void row_fragments(uint32_t (&xa)[KQ][4],
                                              uint32_t (&ya)[KQ][4],
                                              const bf16* x, long long xs,
                                              const bf16* y, long long ys,
                                              int hd, int ra, int rb, int n,
                                              int c2) {
#pragma unroll
  for (int kk = 0; kk < KQ; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = r & 1 ? rb : ra;
      const int col = 16 * kk + c2 + (r & 2 ? 8 : 0);
      const bool in = row < n && col < hd;
      xa[kk][r] = in ? *reinterpret_cast<const uint32_t*>(x + row * xs + col) : 0u;
      ya[kk][r] = in ? *reinterpret_cast<const uint32_t*>(y + row * ys + col) : 0u;
    }
}

template <int KQ>
__device__ __forceinline__ void scale_fragments(uint32_t (&a)[KQ][4],
                                                float scale) {
#pragma unroll
  for (int kk = 0; kk < KQ; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float2 f = unpack(a[kk][r]);
      a[kk][r] = pack(f.x * scale, f.y * scale);
    }
}

template <int HD, int P>
__global__ void __launch_bounds__(P * 128 + 32, 1)
window_attention_bwd_rows_kernel(const bf16* __restrict__ qkv,
                                 const float* __restrict__ bias,
                                 const bf16* __restrict__ dout,
                                 bf16* __restrict__ dqkv,
                                 float* __restrict__ dbias,
                                 float* __restrict__ partials,
                                 float4* __restrict__ stats, int B, int nW,
                                 int N, int h, long long bias_w_stride,
                                 float scale, int stages) {
  constexpr int HP = chans(HD);
  constexpr int KQ = HP / 16;
  constexpr int NC = HP / 8;
  constexpr int CH = HD / 8;
  const int wh = blockIdx.y;
  const int w = wh / h;
  const int head = wh - w * h;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  constexpr int parts = P;
  const int r0 = blockIdx.x * kRows;
  const int nq = min(kRows, N - r0);
  const int NP = pad16(N);
  const int LDP = tile_ld(NP);
  const int nkb = key_blocks(N);
  int b_begin, b_end;
  split_range(B, gridDim.z, blockIdx.z, &b_begin, &b_end);
  // the ring's steps: an element's key blocks for pass A, then again for
  // pass B; or, K and V resident (stages 0), each block once
  const bool resident = stages == 0;
  const int per_elem = resident ? nkb : 2 * nkb;
  const int steps = (b_end - b_begin) * per_elem;

  extern __shared__ __align__(128) unsigned char smem[];
  const RowLayout L(N, HD, parts, stages);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxBarriers;
  float* Bs = reinterpret_cast<float*>(smem + L.bars);
  float* dB = reinterpret_cast<float*>(smem + L.bars + L.bias);
  unsigned char* ring = smem + L.bars + 2 * L.bias;
  const int slots = resident ? 1 : stages;
  const int T = L.rows;
  float4* stat_x = reinterpret_cast<float4*>(ring + slots * L.stage());
  float* acc_x = reinterpret_cast<float*>(ring + slots * L.stage() + L.stats);
  // step g (of a key block kb) is in barrier slot `bar`, its fill number f
  // (the fills of a barrier before it), its K tile at Kt, its first row
  // n0 of that tile
  struct Step { int bar, f, n0; unsigned char* Kt; };
  auto step_at = [&](int g, int kb) {
    if (resident)
      return Step{kb, g / nkb, kb * kKeyBlock, ring};
    return Step{g % stages, g / stages, 0, ring + (g % stages) * L.stage()};
  };

  const BwdRows rows = bwd_rows(qkv, dout, dqkv, nW, N, h, HD, w, head);
  const int C = rows.C;

  {  // the dbias rows and the ring start at zero (padded keys stay zero)
    uint4* z = reinterpret_cast<uint4*>(dB);
    const int n16 = (int)((L.bias + slots * L.stage()) / 16);
    for (int i = threadIdx.x; i < n16; i += blockDim.x) z[i] = make_uint4(0, 0, 0, 0);
  }
  copy_f32(Bs, LDP, bias + (size_t)w * bias_w_stride + ((size_t)head * N + r0) * N,
           N, nq, N, (N & 3) == 0);
  cp_async_commit();
  cp_async_wait<0>();
  if (threadIdx.x == 0) {
    for (int s = 0; s < (resident ? nkb : stages); ++s) {
      mbar_init(&full[s], 32);       // the producer's lanes' copies
      mbar_init(&empty[s], 4);       // the consuming part's four warps
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4 * parts) {
    // ---- the producer warp: key block kb of step st into its stage ------
    for (int g = 0; g < steps; ++g) {
      const int e = g / per_elem;
      const int kb = g % nkb;
      const Step p = step_at(g, kb);
      if (p.f > 0) mbar_wait(&empty[p.bar], (p.f - 1) & 1);
      const int k0 = kb * kKeyBlock;
      const int nk = min(kKeyBlock, N - k0);
      const bf16* kr = rows.q + (b_begin + e) * rows.in_elem + C
                     + (size_t)k0 * 3 * C;
      for (int i = lane; i < nk * CH; i += 32) {
        const int r = i / CH, c = i - (i / CH) * CH;
        cp_async16(p.Kt + core_at(p.n0 + r, c, T), kr + (size_t)r * 3 * C + 8 * c);
        cp_async16(p.Kt + L.kv + core_at(p.n0 + r, c, T),
                   kr + C + (size_t)r * 3 * C + 8 * c);
      }
      mbar_arrive_cp_async(&full[p.bar]);
    }
    cp_async_wait_all();
    return;
  }

  // ---- the consumer warpgroups: part p takes key blocks p, p + P, ... -----
  const int part = warp >> 2;
  const int tig = threadIdx.x & 127;           // thread in the group
  const int slab = warp & 3;
  const int c2 = 2 * (lane & 3);
  const int la = 16 * slab + (lane >> 2);
  const int lb = la + 8;
  const int cthreads = 128 * parts;

  // round(q * scale) and dO of element b; the next element's loaded while
  // this one's pass B runs
  uint32_t qa[KQ][4], oa[KQ][4], qn[KQ][4], on[KQ][4];
  auto prefetch = [&](int b) {
    row_fragments<KQ>(qn, on, rows.q + b * rows.in_elem + (size_t)r0 * 3 * C,
                      3LL * C, rows.o + b * rows.out_elem + (size_t)r0 * C, C,
                      HD, la, lb, nq, c2);
  };
  if (b_begin < b_end) prefetch(b_begin);
  int st = 0;                                  // the ring's step
  for (int b = b_begin; b < b_end; ++b, st += per_elem) {
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        qa[kk][r] = qn[kk][r];
        oa[kk][r] = on[kk][r];
      }
    scale_fragments<KQ>(qa, scale);

    // pass A: the part's (max, sum, dot) of each row
    float ma = -INFINITY, mb = -INFINITY, sa = 0.f, sb = 0.f, ga = 0.f, gb = 0.f;
    for (int kb = part; kb < nkb; kb += parts) {
      const Step p = step_at(st + kb, kb);
      mbar_wait(&full[p.bar], p.f & 1);
      fence_proxy_async();
      by_tiles(block_tiles(N, kb), [&](auto TT) {
        constexpr int TL = decltype(TT)::value;
        float s[TL][4], dp[TL][4];
        const int t0 = kb * kBlockTiles;
        block_bias<TL>(s, dp, Bs + 8 * t0, LDP, nq, N - 8 * t0, la, lb, c2);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KQ; ++kk)
          wgmma_rs<0>(s, qa[kk], kmajor_desc(p.Kt, T, p.n0, kk));
#pragma unroll
        for (int kk = 0; kk < KQ; ++kk)
          wgmma_rs<0>(dp, oa[kk], kmajor_desc(p.Kt + L.kv, T, p.n0, kk));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        if (!resident) {             // resident blocks serve pass B too
          __syncwarp();
          if (lane == 0) mbar_arrive(&empty[p.bar]);
        }
        online<TL, true>(ma, sa, ga, s, dp, 0);
        online<TL, true>(mb, sb, gb, s, dp, 2);
      });
    }
    float Ma = quad_max(ma), Mb = quad_max(mb);
    {
      const float ra = exp2f((ma - Ma) * kTcLog2e), rb = exp2f((mb - Mb) * kTcLog2e);
      const float La = quad_sum(sa * ra), Lb = quad_sum(sb * rb);
      const float Ga = quad_sum(ga * ra), Gb = quad_sum(gb * rb);
      if ((lane & 3) == 0) {
        stat_x[part * kRows + la] = make_float4(Ma, La, Ga, 0.f);
        stat_x[part * kRows + lb] = make_float4(Mb, Lb, Gb, 0.f);
      }
    }
    consumers_sync(cthreads);
    // the parts' statistics of each row, met in the order of the parts
    float La = 0.f, Lb = 0.f, Ga = 0.f, Gb = 0.f;
    Ma = Mb = -INFINITY;
    for (int p = 0; p < parts; ++p) {
      Ma = fmaxf(Ma, stat_x[p * kRows + la].x);
      Mb = fmaxf(Mb, stat_x[p * kRows + lb].x);
    }
    for (int p = 0; p < parts; ++p) {
      const float4 x = stat_x[p * kRows + la], y = stat_x[p * kRows + lb];
      const float ea = exp2f((x.x - Ma) * kTcLog2e), eb = exp2f((y.x - Mb) * kTcLog2e);
      La += x.y * ea;
      Ga += x.z * ea;
      Lb += y.y * eb;
      Gb += y.z * eb;
    }
    const float mla = Ma * kTcLog2e, inva = 1.f / La, da = Ga * inva;
    const float mlb = Mb * kTcLog2e, invb = 1.f / Lb, db = Gb * invb;
    if (part == 0 && (lane & 3) == 0) {
      float4* srow = stats + ((size_t)b * gridDim.y + wh) * N + r0;
      if (la < nq) srow[la] = make_float4(mla, inva, da, 0.f);
      if (lb < nq) srow[lb] = make_float4(mlb, invb, db, 0.f);
    }

    if (b + 1 < b_end) prefetch(b + 1);

    // pass B: dS = P (dP - D) into the dbias rows, dq += round(dS) . K
    float dq[NC][4];
#pragma unroll
    for (int j = 0; j < NC; ++j) zero(dq[j]);
    for (int kb = part; kb < nkb; kb += parts) {
      const Step p = step_at(resident ? st + kb : st + nkb + kb, kb);
      mbar_wait(&full[p.bar], p.f & 1);
      fence_proxy_async();
      by_tiles(block_tiles(N, kb), [&](auto TT) {
        constexpr int TL = decltype(TT)::value;
        float s[TL][4], dp[TL][4];
        const int t0 = kb * kBlockTiles;
        block_bias<TL>(s, dp, Bs + 8 * t0, LDP, nq, N - 8 * t0, la, lb, c2);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < KQ; ++kk)
          wgmma_rs<0>(s, qa[kk], kmajor_desc(p.Kt, T, p.n0, kk));
#pragma unroll
        for (int kk = 0; kk < KQ; ++kk)
          wgmma_rs<0>(dp, oa[kk], kmajor_desc(p.Kt + L.kv, T, p.n0, kk));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(s);
        fence_regs(dp);
        probs<TL>(s, mla, inva, mlb, invb);
        uint32_t a[TL / 2][4];
#pragma unroll
        for (int u = 0; u < TL; ++u) {
          s[u][0] *= dp[u][0] - da;   // dS, in place of P
          s[u][1] *= dp[u][1] - da;
          s[u][2] *= dp[u][2] - db;
          s[u][3] *= dp[u][3] - db;
          const int col = 8 * (t0 + u) + c2;
          float2* xa = reinterpret_cast<float2*>(dB + la * LDP + col);
          float2* xb = reinterpret_cast<float2*>(dB + lb * LDP + col);
          float2 x = *xa, y = *xb;
          x.x += s[u][0];
          x.y += s[u][1];
          y.x += s[u][2];
          y.y += s[u][3];
          *xa = x;
          *xb = y;
        }
#pragma unroll
        for (int k2 = 0; k2 < TL / 2; ++k2) {
          a[k2][0] = pack(s[2 * k2][0], s[2 * k2][1]);
          a[k2][1] = pack(s[2 * k2][2], s[2 * k2][3]);
          a[k2][2] = pack(s[2 * k2 + 1][0], s[2 * k2 + 1][1]);
          a[k2][3] = pack(s[2 * k2 + 1][2], s[2 * k2 + 1][3]);
        }
        wgmma_fence();
#pragma unroll
        for (int k2 = 0; k2 < TL / 2; ++k2)
          wgmma_rs<1>(dq, a[k2], mnmajor_desc(p.Kt + 16 * p.n0, T, k2));
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs(dq);
        fence_regs(a);
        __syncwarp();
        if (lane == 0) mbar_arrive(&empty[p.bar]);
      });
    }
    // the parts' dq accumulators meet in part 0, in the order of the
    // parts, one at a time through the exchange buffer
#pragma unroll
    for (int p = 1; p < parts; ++p) {
      if (p > 1) consumers_sync(cthreads);   // part 0 has read part p - 1's
      if (part == p) {
#pragma unroll
        for (int j = 0; j < NC; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc_x[(j * 4 + i) * 128 + tig] = dq[j][i];
      }
      consumers_sync(cthreads);
      if (part == 0) {
#pragma unroll
        for (int j = 0; j < NC; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) dq[j][i] += acc_x[(j * 4 + i) * 128 + tig];
      }
    }
    if (part == 0)
      store_rows<HD, NC>(rows.g + b * rows.in_elem + (size_t)r0 * 3 * C, 3LL * C,
                         dq, scale, la, lb, nq, c2);
    consumers_sync(cthreads);      // stat_x and acc_x are free again
  }

  float* dst = dbias_tile(dbias, partials, gridDim.z, blockIdx.z, gridDim.y, wh, N)
             + (size_t)r0 * N;
  if ((N & 3) == 0) {                // 16 bytes a store
    const int n4 = N / 4;
    for (int i = threadIdx.x; i < nq * n4; i += cthreads) {
      const int r = i / n4, c = 4 * (i - (i / n4) * n4);
      *reinterpret_cast<float4*>(dst + (size_t)r * N + c) =
          *reinterpret_cast<const float4*>(dB + r * LDP + c);
    }
  } else {
    for (int i = threadIdx.x; i < nq * N; i += cthreads) {
      const int r = i / N;
      dst[i] = dB[r * LDP + (i - r * N)];
    }
  }
}

// The column kernel's shared memory: its barriers, its keys' bias columns
// for every query row (NP x (Rc + 4) fp32: rows are queries, columns the
// block's keys), kept for the whole run of batch elements, each consumer
// group's round(q * scale) of the current query block (64 rows, the core
// layout), then the ring's stages, each a block of 64 query rows: q and dO
// (the core layout) and the rows' statistics (64 x 4 fp32).
struct ColLayout {
  size_t bars, bias, op, st;
  int groups, stages;
  __host__ __device__ ColLayout(int N, int hd, int Rc, int nstages)
      : groups(Rc / 64), stages(nstages) {
    bars = 128;
    bias = align128(sizeof(float) * (size_t)pad16(N) * (Rc + 4));
    op = align128(sizeof(bf16) * (size_t)kKeyBlock * chans(hd));
    st = sizeof(float) * 4 * kKeyBlock;
  }
  __host__ __device__ size_t stage() const { return 2 * op + st; }
  __host__ __device__ size_t total() const {
    return bars + bias + groups * op + stages * stage();
  }
};

// named barrier 2 + g over consumer warpgroup g
__device__ __forceinline__ void group_sync(int g) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(2 + g) : "memory");
}

// The column kernel, grid (ceil(N / Rc), nW * h, S'), Rc = 64 x G keys a
// block: G consumer warpgroups of 64 keys and one producer warp.  See the
// file's header.
template <int HD, int G>
__global__ void __launch_bounds__(G * 128 + 32, G == 1 ? 2 : 1)
window_attention_bwd_cols_kernel(const bf16* __restrict__ qkv,
                                 const float* __restrict__ bias,
                                 const bf16* __restrict__ dout,
                                 bf16* __restrict__ dqkv,
                                 const float4* __restrict__ stats, int B,
                                 int nW, int N, int h, long long bias_w_stride,
                                 float scale, int stages) {
  constexpr int HP = chans(HD);
  constexpr int KQ = HP / 16;      // k16 steps over the channels
  constexpr int NC = HP / 8;       // n8 tiles (and chunk planes) of channels
  constexpr int CH = HD / 8;       // 16-byte chunks of a real row
  const int wh = blockIdx.y;
  const int w = wh / h;
  const int head = wh - w * h;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  constexpr int groups = G;
  const int Rc = 64 * groups;
  const int c0 = blockIdx.x * Rc;
  const int nk = min(Rc, N - c0);
  const int nqb = key_blocks(N);
  const int ldt = Rc + 4;
  int b_begin, b_end;
  split_range(B, gridDim.z, blockIdx.z, &b_begin, &b_end);
  const int steps = (b_end - b_begin) * nqb;

  extern __shared__ __align__(128) unsigned char smem[];
  const ColLayout L(N, HD, Rc, stages);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxBarriers;
  float* Bt = reinterpret_cast<float*>(smem + L.bars);
  unsigned char* qsbuf = smem + L.bars + L.bias;  // each group's q~
  unsigned char* ring = qsbuf + groups * L.op;

  const BwdRows rows = bwd_rows(qkv, dout, dqkv, nW, N, h, HD, w, head);
  const int C = rows.C;

  // padded channels, and the padded query rows of a stage's first use,
  // stay zero; later, a stage's rows past the last query row hold an
  // earlier block's (finite) values, which the -inf logits there multiply
  // by zero
  {
    uint4* z = reinterpret_cast<uint4*>(qsbuf);
    const int n16 = (int)((groups * L.op + stages * L.stage()) / 16);
    for (int i = threadIdx.x; i < n16; i += blockDim.x) z[i] = make_uint4(0, 0, 0, 0);
  }
  // the block's bias columns, every query row
  copy_f32(Bt, ldt, bias + (size_t)w * bias_w_stride + (size_t)head * N * N + c0,
           N, N, nk, (N & 3) == 0);
  cp_async_commit();
  cp_async_wait<0>();
  if (threadIdx.x == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(&full[s], 32);                 // the producer's lanes' copies
      mbar_init(&empty[s], 4 * groups);        // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (warp == 4 * groups) {
    // ---- the producer warp: fills stage st % stages for step st --------
    for (int st = 0; st < steps; ++st) {
      const int slot = st % stages;
      if (st >= stages) mbar_wait(&empty[slot], ((st / stages) - 1) & 1);
      const int e = st / nqb;
      const int q0 = (st - e * nqb) * kKeyBlock;
      const int nr = min(kKeyBlock, N - q0);
      const int b = b_begin + e;
      unsigned char* stg = ring + slot * L.stage();
      unsigned char* Qt = stg;                 // q
      unsigned char* Ot = stg + L.op;          // dO
      float4* St = reinterpret_cast<float4*>(stg + 2 * L.op);
      const bf16* qr = rows.q + b * rows.in_elem + (size_t)q0 * 3 * C;
      const bf16* ob = rows.o + b * rows.out_elem + (size_t)q0 * C;
      const float4* srow = stats + ((size_t)b * gridDim.y + wh) * N + q0;
      if (lane == 0) {                         // the rows' statistics
        mbar_expect_tx(&full[slot], 16 * nr);
        bulk_copy(St, srow, 16 * nr, &full[slot]);
      }
      for (int i = lane; i < nr * CH; i += 32) {
        const int r = i / CH, c = i - (i / CH) * CH;
        cp_async16(Qt + core_at(r, c, kKeyBlock), qr + (size_t)r * 3 * C + 8 * c);
        cp_async16(Ot + core_at(r, c, kKeyBlock), ob + (size_t)r * C + 8 * c);
      }
      mbar_arrive_cp_async(&full[slot]);
    }
    cp_async_wait_all();
    return;
  }

  // ---- the consumer warpgroups: 64 keys each, a 16-key slab a warp ------
  const int grp = warp >> 2;
  const int c2 = 2 * (lane & 3);
  const int la = 16 * (warp & 3) + (lane >> 2);  // the group's keys
  const int lb = la + 8;
  const int ka_key = 64 * grp + la, kb_key = 64 * grp + lb;  // the block's
  unsigned char* Qs = qsbuf + grp * L.op;      // the group's q~
  // the warp's 16 keys of K and V of element e (ka, va); the next
  // element's loaded while this one runs (kn, vn)
  uint32_t ka[KQ][4], va[KQ][4], kn[KQ][4], vn[KQ][4];
  auto prefetch = [&](int e) {
    const bf16* k = rows.q + (b_begin + e) * rows.in_elem + C + (size_t)c0 * 3 * C;
    row_fragments<KQ>(kn, vn, k, 3LL * C, k + C, 3LL * C, HD, ka_key, kb_key,
                      nk, c2);
  };
  if (steps > 0) prefetch(0);
  float dk[NC][4], dv[NC][4];
  for (int st = 0; st < steps; ++st) {
    const int slot = st % stages;
    const int e = st / nqb;
    const int qblk = st - e * nqb;
    const int q0 = qblk * kKeyBlock;
    const int nr = min(kKeyBlock, N - q0);
    if (qblk == 0) {
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          ka[kk][r] = kn[kk][r];
          va[kk][r] = vn[kk][r];
        }
      if (st + nqb < steps) prefetch(e + 1);
#pragma unroll
      for (int j = 0; j < NC; ++j) {
        zero(dk[j]);
        zero(dv[j]);
      }
    }
    // S^T starts as the bias transposed: -inf on padded keys and query rows
    float s[kBlockTiles][4], dp[kBlockTiles][4];
#pragma unroll
    for (int u = 0; u < kBlockTiles; ++u) {
      const int c = 8 * u + c2;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int key = i < 2 ? ka_key : kb_key;
        const int qr = c + (i & 1);
        s[u][i] = key < nk && qr < nr ? Bt[(q0 + qr) * ldt + key] : -INFINITY;
      }
      zero(dp[u]);
    }
    mbar_wait(&full[slot], (st / stages) & 1);
    fence_proxy_async();
    const unsigned char* stg = ring + slot * L.stage();
    const unsigned char* Qt = stg;
    const unsigned char* Ot = stg + L.op;
    const float4* St = reinterpret_cast<const float4*>(stg + 2 * L.op);
    // round(q * scale) into the group's buffer (its last reader, the
    // previous step's S^T product, has completed), then the group meets
    for (int i = threadIdx.x & 127; i < kKeyBlock * NC; i += 128) {
      uint4 v = *reinterpret_cast<const uint4*>(Qt + 16 * i);
      uint32_t* x = reinterpret_cast<uint32_t*>(&v);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 f = unpack(x[j]);
        x[j] = pack(f.x * scale, f.y * scale);
      }
      *reinterpret_cast<uint4*>(Qs + 16 * i) = v;
    }
    fence_proxy_async();
    group_sync(grp);
    // S^T += K . round(q * scale)^T, dP^T = V . dO^T
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk)
      wgmma_rs<0>(s, ka[kk], kmajor_desc(Qs, kKeyBlock, 0, kk));
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk)
      wgmma_rs<0>(dp, va[kk], kmajor_desc(Ot, kKeyBlock, 0, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
    // P^T from the rows' statistics, dS^T = P^T (dP^T - D), both rounded
    // to bf16 as the A fragments of the next products
    uint32_t pa[kBlockTiles / 2][4], da[kBlockTiles / 2][4];
#pragma unroll
    for (int u = 0; u < kBlockTiles; ++u) {
      const float4 x = St[8 * u + c2];         // query column c
      const float4 y = St[8 * u + c2 + 1];     // and c + 1
      s[u][0] = exp2f(fmaf(s[u][0], kTcLog2e, -x.x)) * x.y;
      s[u][1] = exp2f(fmaf(s[u][1], kTcLog2e, -y.x)) * y.y;
      s[u][2] = exp2f(fmaf(s[u][2], kTcLog2e, -x.x)) * x.y;
      s[u][3] = exp2f(fmaf(s[u][3], kTcLog2e, -y.x)) * y.y;
      dp[u][0] = s[u][0] * (dp[u][0] - x.z);
      dp[u][1] = s[u][1] * (dp[u][1] - y.z);
      dp[u][2] = s[u][2] * (dp[u][2] - x.z);
      dp[u][3] = s[u][3] * (dp[u][3] - y.z);
    }
#pragma unroll
    for (int k4 = 0; k4 < kBlockTiles / 2; ++k4) {
      const float* p0 = s[2 * k4];
      const float* p1 = s[2 * k4 + 1];
      const float* d0 = dp[2 * k4];
      const float* d1 = dp[2 * k4 + 1];
      pa[k4][0] = pack(p0[0], p0[1]);
      pa[k4][1] = pack(p0[2], p0[3]);
      pa[k4][2] = pack(p1[0], p1[1]);
      pa[k4][3] = pack(p1[2], p1[3]);
      da[k4][0] = pack(d0[0], d0[1]);
      da[k4][1] = pack(d0[2], d0[3]);
      da[k4][2] = pack(d1[0], d1[1]);
      da[k4][3] = pack(d1[2], d1[3]);
    }
    // dv += round(P^T) . dO, dk += round(dS^T) . q
    wgmma_fence();
#pragma unroll
    for (int k4 = 0; k4 < kBlockTiles / 2; ++k4)
      wgmma_rs<1>(dv, pa[k4], mnmajor_desc(Ot, kKeyBlock, k4));
#pragma unroll
    for (int k4 = 0; k4 < kBlockTiles / 2; ++k4)
      wgmma_rs<1>(dk, da[k4], mnmajor_desc(Qt, kKeyBlock, k4));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv);
    fence_regs(dk);
    fence_regs(pa);
    fence_regs(da);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[slot]);
    if (qblk == nqb - 1) {
      const int b = b_begin + e;
      bf16* g = rows.g + b * rows.in_elem + (size_t)(c0 + 64 * grp) * 3 * C;
      const int n = nk - 64 * grp;
      store_rows<HD, NC>(g + C, 3LL * C, dk, scale, la, lb, n, c2);
      store_rows<HD, NC>(g + 2 * C, 3LL * C, dv, 1.f, la, lb, n, c2);
    }
  }
}

template <int HD, int G>
cudaError_t launch_cols(const bf16* qkv, const float* bias, const bf16* dout,
                        bf16* dqkv, const float4* stats, int B, int nW, int N,
                        int h, long long bias_w_stride, float scale, int stages,
                        int splits, cudaStream_t stream) {
  auto ck = window_attention_bwd_cols_kernel<HD, G>;
  const size_t cs = ColLayout(N, HD, 64 * G, stages).total();
  cudaError_t e = allow_smem(ck, cs);
  if (e != cudaSuccess) return e;
  ck<<<dim3((N + 64 * G - 1) / (64 * G), nW * h, splits), 128 * G + 32, cs,
       stream>>>(qkv, bias, dout, dqkv, stats, B, nW, N, h, bias_w_stride,
                 scale, stages);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch(const bf16* qkv, const float* bias, const bf16* dout,
                   bf16* dqkv, float* dbias, float* partials, float4* stats,
                   int B, int nW, int N, int h, long long bias_w_stride,
                   float scale, int parts, int stages, int splits, int Rc,
                   int col_splits, int col_stages, int kernels,
                   cudaStream_t stream) {
  cudaError_t e;
  if (kernels & 1) {
    auto rk = parts == 1 ? window_attention_bwd_rows_kernel<HD, 1>
                         : window_attention_bwd_rows_kernel<HD, 2>;
    const size_t rs = RowLayout(N, HD, parts, stages).total();
    if ((e = allow_smem(rk, rs)) != cudaSuccess) return e;
    rk<<<dim3((N + kRows - 1) / kRows, nW * h, splits), 128 * parts + 32, rs,
         stream>>>(qkv, bias, dout, dqkv, dbias, partials, stats, B, nW, N, h,
                   bias_w_stride, scale, stages);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    if (splits > 1 &&
        (e = sum_splits(partials, dbias, splits, (long long)nW * h * N * N,
                        stream)) != cudaSuccess)
      return e;
  }
  if (!(kernels & 2)) return cudaSuccess;
  return Rc == 64
      ? launch_cols<HD, 1>(qkv, bias, dout, dqkv, stats, B, nW, N, h,
                           bias_w_stride, scale, col_stages, col_splits, stream)
      : launch_cols<HD, 2>(qkv, bias, dout, dqkv, stats, B, nW, N, h,
                           bias_w_stride, scale, col_stages, col_splits, stream);
}

// kernel 0 (rows): `width` parts, `stages` 0 (K and V resident) or a ring
// of 2 to 4; kernel 1 (columns): Rc = `width` keys, a ring of 2 to 4
bool plan_takes(int N, int hd, int width, int stages, int kernel) {
  if (!bwd_long_takes(N, hd) || stages > kMaxStages) return false;
  return kernel ? (width == 64 || width == 128) && stages >= 2
                      && stages <= 2 * key_blocks(N)
                : width >= 1 && width <= kRowMaxParts
                      && (stages == 0 || stages >= 2);
}

size_t plan_smem(int N, int hd, int width, int stages, int kernel) {
  return kernel ? ColLayout(N, hd, width, stages).total()
                : RowLayout(N, hd, width, stages).total();
}

template <int HD>
int occupancy(int N, int width, int stages, int kernel) {
  const size_t smem = plan_smem(N, HD, width, stages, kernel);
  if (!kernel) {
    const int threads = 128 * width + 32;
    return width == 1 ? blocks_per_sm(window_attention_bwd_rows_kernel<HD, 1>, threads, smem)
                      : blocks_per_sm(window_attention_bwd_rows_kernel<HD, 2>, threads, smem);
  }
  return width == 64
      ? blocks_per_sm(window_attention_bwd_cols_kernel<HD, 1>, 160, smem)
      : blocks_per_sm(window_attention_bwd_cols_kernel<HD, 2>, 288, smem);
}

}  // namespace

extern "C" {

// Shared memory of one block of the row kernel (`kernel` 0: `width`
// consumer warpgroups, `stages` in its ring) or of the column kernel (1:
// `width` keys, 64 or 128); -1 where the shape is not taken.
long long fiber_window_attention_bwd_tc_long_smem_bytes(int N, int hd,
                                                        int width, int stages,
                                                        int kernel) {
  return plan_takes(N, hd, width, stages, kernel)
      ? (long long)plan_smem(N, hd, width, stages, kernel) : -1;
}

// Resident blocks per SM of the row (0) or column (1) kernel; -1 on error
// or where the shape is not taken.
int fiber_window_attention_bwd_tc_long_blocks_per_sm(int N, int hd, int width,
                                                     int stages, int kernel) {
  if (!plan_takes(N, hd, width, stages, kernel)) return -1;
  switch (hd) {
    case 8: return occupancy<8>(N, width, stages, kernel);
    case 16: return occupancy<16>(N, width, stages, kernel);
    case 32: return occupancy<32>(N, width, stages, kernel);
    default: return occupancy<64>(N, width, stages, kernel);
  }
}

// Launches on `stream` the row kernel (64 query rows a block on `parts`
// consumer warpgroups, a ring of `stages`, `splits` of the batch), the
// fixed-order sum of its dbias partials when splits > 1, then the column
// kernel (Rc keys a block, `col_splits`, a ring of `col_stages`); `kernels`
// picks the row kernel (1, with the sum), the column kernel (2, on the
// statistics a row kernel left in `stats`) or both (3); returns the first
// CUDA error (0 on success).  `rows` must be 64.  qkv, dqkv (B, nW, N, 3 h
// hd) and dout (B, nW, N, h hd) contiguous bf16, 16-byte aligned; bias
// fp32, element (w, head, i, j) at w * bias_w_stride + (head * N + i) * N
// + j, 16-byte aligned; dbias (nW, h, N, N) fp32 contiguous, written
// whole; partials (splits, nW, h, N, N) fp32 scratch, used only when
// splits > 1; stats (B, nW h, N, 4) fp32 scratch, 16-byte aligned.
int fiber_window_attention_bwd_tc_long(const void* qkv, const void* bias,
                                       const void* dout, void* dqkv,
                                       void* dbias, void* partials, void* stats,
                                       int B, int nW, int N, int h, int hd,
                                       long long bias_w_stride, float scale,
                                       int rows, int parts, int stages,
                                       int splits, int Rc, int col_splits,
                                       int col_stages, int kernels,
                                       void* stream) {
  if (rows != kRows || !plan_takes(N, hd, parts, stages, 0)
      || !plan_takes(N, hd, Rc, col_stages, 1) || splits < 1 || splits > B
      || col_splits < 1 || col_splits > B)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto q = static_cast<const bf16*>(qkv);
  auto bi = static_cast<const float*>(bias);
  auto o = static_cast<const bf16*>(dout);
  auto dq = static_cast<bf16*>(dqkv);
  auto db = static_cast<float*>(dbias);
  auto pa = static_cast<float*>(partials);
  auto st = static_cast<float4*>(stats);
  switch (hd) {
    case 8: return (int)launch<8>(q, bi, o, dq, db, pa, st, B, nW, N, h, bias_w_stride, scale, parts, stages, splits, Rc, col_splits, col_stages, kernels, s);
    case 16: return (int)launch<16>(q, bi, o, dq, db, pa, st, B, nW, N, h, bias_w_stride, scale, parts, stages, splits, Rc, col_splits, col_stages, kernels, s);
    case 32: return (int)launch<32>(q, bi, o, dq, db, pa, st, B, nW, N, h, bias_w_stride, scale, parts, stages, splits, Rc, col_splits, col_stages, kernels, s);
    default: return (int)launch<64>(q, bi, o, dq, db, pa, st, B, nW, N, h, bias_w_stride, scale, parts, stages, splits, Rc, col_splits, col_stages, kernels, s);
  }
}

}  // extern "C"
