// Windowed multi-head attention backward for Hopper (sm_90a), fp32, on the
// tensor cores as split-TF32 products: K2's fp32 route ("tc_f32") for hd in
// {8, 16, 32, 64} and every N <= 352 (FIBER-B at 384^2 and 576^2, Swin-T
// and the detection stages: hd = 32 at N = 49, 144 and 324).  (bf16 runs
// window_attention_bwd_tc.cu and window_attention_bwd_tc_long.cu; fp32 at
// hd = 128 window_attention_bwd.cu.)
//
// Replaces the JAX package's Pallas TPU kernel
// fiber_tpu/ops/window_attention.py::window_attention_packed_pallas_bwd
// (body _packed_bwd_kernel) in fp32.  For every (batch b, window w, head),
// with the steps of the plain version window_attention_bwd_reference
// (fiber_torch/ops/window_attention.py) in fp32:
//
//     P   = softmax((q * scale) . k^T + bias)
//     dv  = P^T . dO
//     dP  = dO . v^T
//     dS  = P * (dP - rowsum(dP * P))
//     dq  = (dS . k) * scale,   dk = (dS^T . q) * scale
//     dbias[w, head] = sum over b of dS
//
// Every product runs as three TF32 products on the tensor cores (mma.sync
// m16n8k8, big.big + big.small + small.big: mma_tf32.cuh), which keeps
// about fp32's accuracy.  dq, dk, dv go into dqkv (B, nW, N, 3C) at the
// channels the forward reads q, k, v from; dbias is (nW, h, N, N) fp32.
//
// Three sums cross the tiles: dq over the keys, dk and dv over the query
// rows, dbias over the batch.  As in the bf16 window_attention_bwd_tc_long.cu
// two kernels split them, each the only writer of what it sums, with no
// atomics (two calls give the same bits):
//
// * the row kernel, grid (ceil(N / 16 W), nW h, S): block (r, w h + head,
//   s) owns 16 W query rows, one 16-row slab a warp, and walks the batch
//   elements of split s, keeping its rows' fp32 dbias in shared memory
//   for the whole run (each element owned by one thread).  K and V pass
//   through a ring of three stages of 32 keys (window_attention_tf32.cuh's
//   ring_loop, copied by cp.async, two blocks in flight while one is
//   used), twice an element:
//     pass A: S = bias + q~ . K^T and dP = dO . V^T (q~ = q * scale and dO
//             as split A fragments in registers, read once an element), the
//             row's running max m, sum l of exp(s - m) and g of exp(s - m)
//             dP, rescaled together; then M, 1 / L and D = g / L = rowsum(dP
//             * P) go to a (B, nW h, N) x 4 fp32 scratch;
//     pass B: S and dP again, P = exp(s - M) / L, dS = P (dP - D) added
//             into the dbias rows, and dq += dS . K from the accumulators
//             renumbered as A fragments; dq * scale is stored.
//   The dbias rows go to dbias (S = 1) or to their split's partial, summed
//   in the order s = 0 ... S - 1 (window_attention_bwd_sum_splits);
// * the column kernel, grid (ceil(N / 16 W'), nW h, S'): one warp a slab
//   of 16 keys, whose K and V are its split A fragments for the element;
//   q, dO and the rows' (M, 1 / L, D) pass through a ring of four stages
//   of 32 query rows.  Per stage: S^T = bias^T + K . q~^T and dP^T = V . dO^T,
//   P^T and dS^T from the rows' statistics in registers, dv += P^T . dO and
//   dk += dS^T . q from the accumulators renumbered as A fragments.  dk *
//   scale and dv are written whole for its keys.
// The bias is read from L2 (the row kernel's rows, the column kernel's
// columns; a block's stay in L2 over its run of elements) before a stage's
// products and added to them in fp32, -inf on keys (rows) past N.  Each
// product's three terms are summed apart and added in fp32 to nearest
// (mma_3xtf32): the tensor cores round a sum toward zero, and chained they
// put K1's logits up to 2e-6 from the plain version.
//
// Products of N^2 hd: the row kernel runs S and dP twice (D needs a whole
// row before dS), the column kernel once more each: 9 against the
// algorithm's 5, each three TF32 products.
//
// What bounds it on the card: operations.  At FIBER's 576^2 stage 1 (B =
// 8, nW = 64, h = 4, N = 324, hd = 32) the five products are 68.8 GFLOP:
// 0.417 ms at 3xTF32's 165 TFLOP/s (1.03 at the CUDA cores' 67), against
// 725 MB of qkv, dout, dqkv, bias and dbias, 0.216 ms at 3.35 TB/s.  The
// previous design (window_attention_bwd.cu: a warp a query row or key, the
// lanes over the other axis, seven fp32 FMA products from shared memory,
// one 215 KB block an SM) ran at 16x its bound there; this one runs all
// nine products on the tensor cores, a warp a 16-row slab.  What holds it
// now is latency: 174-215 registers a thread leave 2 warps a scheduler,
// the row kernel's dbias rows (16 W (N + 8) fp32) one block an SM at N =
// 324, and each warp's MMAs wait on shared-memory fragment reads; the
// wrapper's plan (`_bwd_f32_plan`) picks each kernel's W for the most
// slabs an SM runs at once.
#include <stdint.h>

#include "window_attention_tf32.cuh"

namespace {

using namespace fiber;

constexpr int kRowStages = 3;    // the row kernel's ring (its dbias rows
                                 // take most of the block's shared memory)
constexpr int kColStages = 4;    // the column kernel's
constexpr int kRowKernel = 1, kColKernel = 2;   // `kernels` bits

// row stride of the row kernel's dbias rows: 8 or 24 mod 32 floats, so that
// a warp's float2 updates of 8 rows x 4 lanes hit 32 banks a half
__host__ __device__ inline int dbias_ld(int N) { return ((N + 15) & ~15) + 8; }

__host__ __device__ inline size_t rows_smem_bytes(int N, int hd, int warps) {
  return sizeof(float) * (kRowStages * (size_t)f32_stage_floats(hd)
                          + (size_t)16 * warps * dbias_ld(N));
}

// a column stage: 32 rows of q and of dO, then their (M, 1 / L, D, 0)
__host__ __device__ constexpr int col_stage_floats(int hd) {
  return f32_stage_floats(hd) + 4 * kF32KeyBlock;
}

__host__ __device__ inline size_t cols_smem_bytes(int hd) {
  return sizeof(float) * kColStages * (size_t)col_stage_floats(hd);
}

template <int HD>
__global__ void __launch_bounds__(kF32MaxWarps * 32)
bwd_tf32_rows_kernel(const float* __restrict__ qkv,
                     const float* __restrict__ bias,
                     const float* __restrict__ dout, float* __restrict__ dqkv,
                     float* __restrict__ dbias, float* __restrict__ partials,
                     float4* __restrict__ stats, int B, int nW, int N, int h,
                     long long bias_w_stride, float scale) {
  constexpr int NC = HD / 8;
  constexpr int KT = kF32KeyTiles;
  constexpr int SF = f32_stage_floats(HD);
  constexpr int PL = f32_plane(HD);
  const int nWh = nW * h;
  const int wh = blockIdx.y;
  const int w = wh / h;
  const int head = wh - w * h;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int R = 16 * (blockDim.x >> 5);
  const int r0 = blockIdx.x * R;
  const int ra = r0 + 16 * warp + g;
  const int rb = ra + 8;
  const bool active = r0 + 16 * warp < N;
  const int LDB = dbias_ld(N);
  int b_begin, b_end;
  split_range(B, gridDim.z, blockIdx.z, &b_begin, &b_end);

  extern __shared__ __align__(16) float smem_f32[];
  float* db = smem_f32 + kRowStages * SF;         // R x LDB dbias rows
  for (int i = threadIdx.x; i < R * LDB; i += blockDim.x) db[i] = 0.f;

  // q, k, v of element 0, dO's rows (dout's layout: out_elem, out_rs)
  const F32Rows rows = packed_rows(qkv, nullptr, nW, N, h, HD, w, head);
  const long long C = (long long)h * HD;
  const float* do0 = dout + (long long)w * N * C + (long long)head * HD;
  const float* bias_wh = bias + (size_t)w * bias_w_stride + (size_t)head * N * N;
  const int nkb = (N + kF32KeyBlock - 1) / kF32KeyBlock;
  const int per = 2 * nkb;                        // stages an element
  const int steps = (b_end - b_begin) * per;

  // step i: key block kb of element b_begin + i / per, K then V
  auto key_block = [&](int i) {
    const int j = i % per;
    return j < nkb ? j : j - nkb;
  };
  auto stage = [&](int i) {
    const int e = i / per;
    stage_pair_f32<HD>(smem_f32 + (i % kRowStages) * SF, rows.k(b_begin + e),
                       rows.in_rs, rows.v(b_begin + e), rows.in_rs,
                       key_block(i) * kF32KeyBlock, N);
  };
  auto split = [&](int i) {
    split_pair_f32<HD>(smem_f32 + (i % kRowStages) * SF,
                       key_block(i) * kF32KeyBlock, N, 1.f);
  };

  // q~ and dO as split A fragments, held for the element
  SplitA qa[NC], da[NC];
  float dq[NC][4];
  float m[2], l[2], gs[2], D[2], iL[2];
  ring_loop<kRowStages>(steps, stage, split, [&](int i) {
    const int e = i / per;
    const int j = i - e * per;
    const bool pass_b = j >= nkb;
    const int kb = pass_b ? j - nkb : j;
    const int b = b_begin + e;
    if (!active) return;
    if (j == 0) {
      load_rows_a<HD>(qa, rows.q(b), rows.in_rs, ra, rb, N, scale, c);
      load_rows_a<HD>(da, do0 + b * rows.out_elem, rows.out_rs, ra, rb, N,
                      1.f, c);
      m[0] = m[1] = -INFINITY;
      l[0] = l[1] = gs[0] = gs[1] = 0.f;
#pragma unroll
      for (int n = 0; n < NC; ++n) dq[n][0] = dq[n][1] = dq[n][2] = dq[n][3] = 0.f;
    }
    const float* Ks = smem_f32 + (i % kRowStages) * SF;
    const float* Vs = Ks + 2 * PL;
    const int k0 = kb * kF32KeyBlock;
    const int nt = min(KT, (N - k0 + 7) / 8);
    // S = q~ . K^T + bias (the bias read before the products) and dP
    float s[KT][4], dp[KT][4], bs[KT][4];
#pragma unroll
    for (int t = 0; t < KT; ++t) load_bias_f32(bs[t], bias_wh, N, k0 + 8 * t + 2 * c, ra, rb);
    rows_times_staged_t<HD>(s, qa, Ks, nt, g, c);
    rows_times_staged_t<HD>(dp, da, Vs, nt, g, c);
#pragma unroll
    for (int t = 0; t < KT; ++t) {
#pragma unroll
      for (int x = 0; x < 4; ++x) s[t][x] += bs[t][x];
    }
    if (!pass_b) {
      // the running max, sum of exp and sum of exp . dP of rows ra, rb
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int t = 0; t < KT; ++t) {
        mx[0] = fmaxf(mx[0], fmaxf(s[t][0], s[t][1]));
        mx[1] = fmaxf(mx[1], fmaxf(s[t][2], s[t][3]));
      }
      mx[0] = quad_max_f32(mx[0]);
      mx[1] = quad_max_f32(mx[1]);
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const float al = f32_exp(m[x] - mx[x]);
        m[x] = mx[x];
        l[x] *= al;
        gs[x] *= al;
      }
#pragma unroll
      for (int t = 0; t < KT; ++t) {
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const float p = f32_exp(s[t][x] - mx[x >> 1]);
          l[x >> 1] += p;
          gs[x >> 1] = fmaf(p, dp[t][x], gs[x >> 1]);
        }
      }
      if (kb == nkb - 1) {
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          iL[x] = 1.f / quad_sum_f32(l[x]);
          D[x] = quad_sum_f32(gs[x]) * iL[x];
        }
        if (c == 0) {
          float4* st = stats + ((size_t)b * nWh + wh) * N;
          if (ra < N) st[ra] = make_float4(m[0], iL[0], D[0], 0.f);
          if (rb < N) st[rb] = make_float4(m[1], iL[1], D[1], 0.f);
        }
      }
      return;
    }
    // dS = P (dP - D), into the dbias rows and, renumbered, dq's A
#pragma unroll
    for (int t = 0; t < KT; ++t) {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int hr = x >> 1;
        const float p = f32_exp(s[t][x] - m[hr]) * iL[hr];
        s[t][x] = p * (dp[t][x] - D[hr]);
      }
      if (t < nt) {
        const int col = k0 + 8 * t + 2 * c;
        float2* pa = reinterpret_cast<float2*>(db + (ra - r0) * LDB + col);
        float2* pb = reinterpret_cast<float2*>(db + (rb - r0) * LDB + col);
        float2 va = *pa, vb = *pb;
        va.x += s[t][0];
        va.y += s[t][1];
        vb.x += s[t][2];
        vb.y += s[t][3];
        *pa = va;
        *pb = vb;
      }
    }
    acc_times_staged<HD>(dq, s, Ks, nt, g, c);
    if (kb == nkb - 1) {
      // dq's rows: dqkv at q's channels
      float* dst = dqkv + b * rows.in_elem + (rows.q0 - qkv);
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        if (ra < N)
          *reinterpret_cast<float2*>(dst + (size_t)ra * rows.in_rs + 8 * n + 2 * c) =
              make_float2(dq[n][0] * scale, dq[n][1] * scale);
        if (rb < N)
          *reinterpret_cast<float2*>(dst + (size_t)rb * rows.in_rs + 8 * n + 2 * c) =
              make_float2(dq[n][2] * scale, dq[n][3] * scale);
      }
    }
  });

  // the run's dbias rows: to dbias (S = 1) or to split s's partial
  float* dst = dbias_tile(dbias, partials, gridDim.z, blockIdx.z, nWh, wh, N);
  const int nr = min(R, N - r0);
  for (int i = threadIdx.x; i < nr * N; i += blockDim.x) {
    const int r = i / N;
    const int col = i - r * N;
    dst[(size_t)(r0 + r) * N + col] = db[r * LDB + col];
  }
}

template <int HD>
__global__ void __launch_bounds__(kF32MaxWarps * 32)
bwd_tf32_cols_kernel(const float* __restrict__ qkv,
                     const float* __restrict__ bias,
                     const float* __restrict__ dout, float* __restrict__ dqkv,
                     const float4* __restrict__ stats, int B, int nW, int N,
                     int h, long long bias_w_stride, float scale) {
  constexpr int NC = HD / 8;
  constexpr int KT = kF32KeyTiles;
  constexpr int CF = col_stage_floats(HD);
  constexpr int PL = f32_plane(HD);
  const int nWh = nW * h;
  const int wh = blockIdx.y;
  const int w = wh / h;
  const int head = wh - w * h;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int c = lane & 3;
  const int k0 = blockIdx.x * 16 * (blockDim.x >> 5) + 16 * warp;
  const int ka = k0 + g;
  const int kb_ = ka + 8;
  const bool active = k0 < N;
  int b_begin, b_end;
  split_range(B, gridDim.z, blockIdx.z, &b_begin, &b_end);

  extern __shared__ __align__(16) float smem_f32[];
  // q, k, v of element 0 (dk and dv go to dqkv at k's and v's channels),
  // dO's rows (dout's layout: out_elem, out_rs)
  const F32Rows rows = packed_rows(qkv, nullptr, nW, N, h, HD, w, head);
  const long long C = (long long)h * HD;
  const float* do0 = dout + (long long)w * N * C + (long long)head * HD;
  const float* bias_wh = bias + (size_t)w * bias_w_stride + (size_t)head * N * N;
  const int nqb = (N + kF32KeyBlock - 1) / kF32KeyBlock;
  const int steps = (b_end - b_begin) * nqb;

  // step i: query rows [32 qb, + 32) of element b_begin + i / nqb: q
  // (stride 3C) and dO (stride C), split (q as q~ = q * scale), and their
  // statistics
  auto stage = [&](int i) {
    const int e = i / nqb;
    const int b = b_begin + e;
    const int q0 = (i - e * nqb) * kF32KeyBlock;
    float* Qs = smem_f32 + (i % kColStages) * CF;
    stage_pair_f32<HD>(Qs, rows.q(b), rows.in_rs, do0 + b * rows.out_elem,
                       rows.out_rs, q0, N);
    const float4* st = stats + ((size_t)b * nWh + wh) * N;
    for (int r = threadIdx.x; r < kF32KeyBlock; r += blockDim.x) {
      float* dst = Qs + 4 * PL + 4 * r;
      if (q0 + r < N)
        cp_async16(dst, st + q0 + r);
      else
        *reinterpret_cast<float4*>(dst) = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto split = [&](int i) {
    split_pair_f32<HD>(smem_f32 + (i % kColStages) * CF,
                       (i % nqb) * kF32KeyBlock, N, scale);
  };

  // K and V of the warp's 16 keys as split A fragments, held for the
  // element
  SplitA ka_[NC], va_[NC];
  float dk[NC][4], dv[NC][4];
  ring_loop<kColStages>(steps, stage, split, [&](int i) {
    const int e = i / nqb;
    const int qb = i - e * nqb;
    const int b = b_begin + e;
    if (!active) return;
    if (qb == 0) {
      load_rows_a<HD>(ka_, rows.k(b), rows.in_rs, ka, kb_, N, 1.f, c);
      load_rows_a<HD>(va_, rows.v(b), rows.in_rs, ka, kb_, N, 1.f, c);
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        dk[n][0] = dk[n][1] = dk[n][2] = dk[n][3] = 0.f;
        dv[n][0] = dv[n][1] = dv[n][2] = dv[n][3] = 0.f;
      }
    }
    const float* Qs = smem_f32 + (i % kColStages) * CF;
    const float* Os = Qs + 2 * PL;
    const float4* St = reinterpret_cast<const float4*>(Qs + 4 * PL);
    const int q0 = qb * kF32KeyBlock;
    const int nt = min(KT, (N - q0 + 7) / 8);
    // bias^T of keys ka, kb_ by rows q0 + 8t + 2c (+ 1): -inf on rows past
    // N; read before the products
    float st[KT][4], dpt[KT][4], bs[KT][4];
#pragma unroll
    for (int t = 0; t < KT; ++t) {
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const int row = q0 + 8 * t + 2 * c + (x & 1);
        const int key = x < 2 ? ka : kb_;
        bs[t][x] = row >= N ? -INFINITY
                 : key < N ? __ldg(bias_wh + (size_t)row * N + key) : 0.f;
      }
    }
    // S^T = K . q~^T (+ bias^T below), dP^T = V . dO^T
    rows_times_staged_t<HD>(st, ka_, Qs, nt, g, c);
    rows_times_staged_t<HD>(dpt, va_, Os, nt, g, c);
    // P^T and dS^T from the rows' (M, 1 / L, D)
#pragma unroll
    for (int t = 0; t < KT; ++t) {
      const float4 s0 = St[8 * t + 2 * c];
      const float4 s1 = St[8 * t + 2 * c + 1];
#pragma unroll
      for (int x = 0; x < 4; ++x) {
        const float4 sr = (x & 1) ? s1 : s0;
        const float p = f32_exp(st[t][x] + bs[t][x] - sr.x) * sr.y;
        st[t][x] = p;
        dpt[t][x] = p * (dpt[t][x] - sr.z);
      }
    }
    acc_times_staged<HD>(dv, st, Os, nt, g, c);
    acc_times_staged<HD>(dk, dpt, Qs, nt, g, c);
    if (qb == nqb - 1) {
      float* kdst = dqkv + b * rows.in_elem + (rows.k0 - qkv);
      float* vdst = dqkv + b * rows.in_elem + (rows.v0 - qkv);
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        if (ka < N) {
          *reinterpret_cast<float2*>(kdst + (size_t)ka * rows.in_rs + 8 * n + 2 * c) =
              make_float2(dk[n][0], dk[n][1]);
          *reinterpret_cast<float2*>(vdst + (size_t)ka * rows.in_rs + 8 * n + 2 * c) =
              make_float2(dv[n][0], dv[n][1]);
        }
        if (kb_ < N) {
          *reinterpret_cast<float2*>(kdst + (size_t)kb_ * rows.in_rs + 8 * n + 2 * c) =
              make_float2(dk[n][2], dk[n][3]);
          *reinterpret_cast<float2*>(vdst + (size_t)kb_ * rows.in_rs + 8 * n + 2 * c) =
              make_float2(dv[n][2], dv[n][3]);
        }
      }
    }
  });
}

template <int HD>
cudaError_t launch(const float* qkv, const float* bias, const float* dout,
                   float* dqkv, float* dbias, float* partials, float4* stats,
                   int B, int nW, int N, int h, long long sw, float scale,
                   int row_warps, int splits, int col_warps, int col_splits,
                   int kernels, cudaStream_t stream) {
  const size_t rsm = rows_smem_bytes(N, HD, row_warps);
  const size_t csm = cols_smem_bytes(HD);
  cudaError_t e = allow_smem(bwd_tf32_rows_kernel<HD>, rsm);
  if (e != cudaSuccess) return e;
  if ((e = allow_smem(bwd_tf32_cols_kernel<HD>, csm)) != cudaSuccess) return e;
  if (kernels & kRowKernel) {
    const int R = 16 * row_warps;
    bwd_tf32_rows_kernel<HD><<<dim3((N + R - 1) / R, nW * h, splits),
                               32 * row_warps, rsm, stream>>>(
        qkv, bias, dout, dqkv, dbias, partials, stats, B, nW, N, h, sw, scale);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
    if (splits > 1 &&
        (e = sum_splits(partials, dbias, splits, (long long)nW * h * N * N,
                        stream)) != cudaSuccess)
      return e;
  }
  if (kernels & kColKernel) {
    const int Rc = 16 * col_warps;
    bwd_tf32_cols_kernel<HD><<<dim3((N + Rc - 1) / Rc, nW * h, col_splits),
                               32 * col_warps, csm, stream>>>(
        qkv, bias, dout, dqkv, stats, B, nW, N, h, sw, scale);
    if ((e = cudaGetLastError()) != cudaSuccess) return e;
  }
  return cudaSuccess;
}

template <int HD>
int blocks(int N, int warps, int kernel) {
  return kernel == 0
      ? blocks_per_sm(bwd_tf32_rows_kernel<HD>, 32 * warps, rows_smem_bytes(N, HD, warps))
      : blocks_per_sm(bwd_tf32_cols_kernel<HD>, 32 * warps, cols_smem_bytes(HD));
}

}  // namespace

extern "C" {

// Shared memory of a block of the row kernel (kernel 0, `warps` slabs) or
// the column kernel (1); -1 where hd is not built.
long long fiber_window_attention_bwd_tf32_smem_bytes(int N, int hd, int warps,
                                                     int kernel) {
  if (!f32_takes(1, hd)) return -1;
  return (long long)(kernel == 0 ? rows_smem_bytes(N, hd, warps)
                                 : cols_smem_bytes(hd));
}

// Resident blocks an SM of either kernel; -1 on error.
int fiber_window_attention_bwd_tf32_blocks_per_sm(int N, int hd, int warps,
                                                  int kernel) {
  switch (hd) {
    case 8: return blocks<8>(N, warps, kernel);
    case 16: return blocks<16>(N, warps, kernel);
    case 32: return blocks<32>(N, warps, kernel);
    case 64: return blocks<64>(N, warps, kernel);
    default: return -1;
  }
}

// Launches the row kernel (`row_warps` slabs a block, `splits` of the
// batch) and the fixed-order sum of its dbias partials when splits > 1,
// then the column kernel (`col_warps`, `col_splits`), each where its bit of
// `kernels` is set (1 rows, 2 columns: the column kernel reads the
// statistics the last row launch left), on `stream`; returns the first
// CUDA error.  qkv, dqkv (B, nW, N, 3 h hd) and dout (B, nW, N, h hd)
// contiguous fp32, 16-byte aligned; bias fp32, element (w, head, i, j) at
// w * bias_w_stride + (head * N + i) * N + j; dbias (nW, h, N, N) fp32,
// written whole; partials (splits, nW, h, N, N) fp32 scratch, read only
// when splits > 1; stats (B, nW h, N, 4) fp32 scratch.
int fiber_window_attention_bwd_tf32(const void* qkv, const void* bias,
                                    const void* dout, void* dqkv, void* dbias,
                                    void* partials, void* stats, int B, int nW,
                                    int N, int h, int hd,
                                    long long bias_w_stride, float scale,
                                    int row_warps, int splits, int col_warps,
                                    int col_splits, int kernels, void* stream) {
  if (!f32_takes(N, hd) || row_warps < 1 || row_warps > kF32MaxWarps
      || col_warps < 1 || col_warps > kF32MaxWarps || splits < 1
      || splits > B || col_splits < 1 || col_splits > B)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto q = static_cast<const float*>(qkv);
  auto bi = static_cast<const float*>(bias);
  auto o = static_cast<const float*>(dout);
  auto dq = static_cast<float*>(dqkv);
  auto db = static_cast<float*>(dbias);
  auto pa = static_cast<float*>(partials);
  auto st = static_cast<float4*>(stats);
  switch (hd) {
    case 8: return (int)launch<8>(q, bi, o, dq, db, pa, st, B, nW, N, h, bias_w_stride, scale, row_warps, splits, col_warps, col_splits, kernels, s);
    case 16: return (int)launch<16>(q, bi, o, dq, db, pa, st, B, nW, N, h, bias_w_stride, scale, row_warps, splits, col_warps, col_splits, kernels, s);
    case 32: return (int)launch<32>(q, bi, o, dq, db, pa, st, B, nW, N, h, bias_w_stride, scale, row_warps, splits, col_warps, col_splits, kernels, s);
    case 64: return (int)launch<64>(q, bi, o, dq, db, pa, st, B, nW, N, h, bias_w_stride, scale, row_warps, splits, col_warps, col_splits, kernels, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
