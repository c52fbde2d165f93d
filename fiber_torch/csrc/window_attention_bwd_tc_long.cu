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
// Why not window_attention_bwd_tc.cu's design: it holds a 16-row slab's
// whole S and dP rows in registers (N / 2 fp32 each a thread) and stages
// the whole (N, N) fp32 bias and dbias tiles of a (window, head): 462,336
// bytes each at N = 324, against a block's 232,448.  Here the work is
// split between two kernels, so that no thread holds a whole row or column
// of the logits and no scratch grows with the activations:
//
// * the row kernel, grid (ceil(N / R), nW * h, S): block (r, w * h + head,
//   s) owns query rows [r R, r R + R) of one (window, head) and walks the
//   batch elements of split s.  It stages its R bias rows once and, as K1
//   (window_attention_tc_long.cu) does, each element's K and V whole and
//   its q and dO rows, double-buffered (single where two buffers do not
//   fit: hd = 64 beyond N = 304); each 16-row slab runs on P warps, each a
//   share of the key tiles, through the long-window routine of
//   window_attention_tc_long.cuh:
//     pass A: S and dP = dO . V^T a key block at a time; each lane keeps
//             its running max m, sum l of exp(s - m) and sum g of
//             exp(s - m) dP, rescaled together; the quad, then the parts
//             in the order p = 0 ... P - 1, give M, 1 / L and
//             D = rowsum(dP * P) = g / L (over fp32 P and dP, before any
//             rounding), written to a (B, nW h, N) x 4 fp32 scratch;
//     pass B: S and dP again, P = exp(s - M) / L as K1 forms it, dS =
//             P (dP - D), added into the block's dbias rows in shared
//             memory (R x (NP + 8) fp32, each element owned by one thread
//             for the whole run of elements), and dq += round(dS) . K from
//             the accumulators packed as A fragments; part 0 adds the other
//             parts' dq in their order.  dq is written whole for its rows;
//             the dbias rows go to dbias (S = 1) or to their split's
//             partial, summed in the order s = 0 ... S - 1 by
//             window_attention_bwd_sum_splits;
// * the column kernel, grid (ceil(N / Rc), nW * h, S'): block (c, w * h +
//   head, s) owns keys [c Rc, c Rc + Rc), one 16-key slab a warp, with
//   K and V of its keys as the A fragments, and walks the query rows of
//   each element in blocks of 64 (q, dO, the bias block transposed, and
//   the rows' (M, 1 / L, D)) through a ring of kLongStages shared-memory
//   stages, the next block's copied by cp.async while the block computes
//   this one: S^T = bias^T +
//   K . q~^T, P^T from the rows' statistics, dP^T = V . dO^T, dS^T;
//   dv += round(P^T) . dO and dk += round(dS^T) . q.  dk and dv are
//   written whole for its keys.
//
// The blocks of one (window, head) are neighbours in the launch order, so
// they run at about the same time and its K, V and the rest come from
// device memory once, then from L2.  No atomics: every output element is
// written by one thread, and two
// calls give the same bits.  The row kernel's QK^T and dP run twice (+4
// products of N^2 hd over the five the algorithm needs), the column
// kernel's once more each.
//
// What bounds it on the card: bytes.  At stage 1 of 576^2 at B = 8 (nW =
// 64, h = 4) qkv, dout and dqkv in bf16 (254.8 MB) and the bias and dbias
// (107.5 MB each) are 469.8 MB: 0.140 ms at 3.35 TB/s; the five products
// are 68.8 GFLOP, 0.070 ms at 989 TFLOP/s.  The scratch is 8 MB there.
// Limits: N <= 352, hd in {8, 16, 32, 64}, R and Rc multiples of 16 up to
// 128, within a block's shared memory.  wgmma and TMA are left for a later
// version.

#include <stdint.h>

#include "window_attention_bwd_common.cuh"
#include "window_attention_tc_long.cuh"

namespace {

using namespace fiber;
using bf16 = __nv_bfloat16;

bool bwd_long_takes(int N, int hd, int R, int parts = 1, int buffers = 1) {
  return N >= 1 && N <= kLongMaxNP
      && (hd == 8 || hd == 16 || hd == 32 || hd == 64)
      && R >= 16 && R <= 16 * kLongMaxWarps && R % 16 == 0 && parts >= 1
      && parts <= pad16(N) / 16 && R / 16 * parts * 32 <= kLongMaxThreads
      && (buffers == 1 || buffers == 2);
}

// The row kernel's shared memory: its staged bias rows and its dbias rows
// (R x (NP + 8) fp32 each), one or two buffers of K and V (NP rows each)
// and q and dO (R rows each), then the parts' exchange: the dq
// accumulators of parts 1 ... P - 1 (16 x HP fp32 a slab and part) and
// every part's (max, sum, dot) of each row.
struct RowLayout {
  size_t bias, kv, op, acc, stats;
  int buffers;
  __host__ __device__ RowLayout(int N, int hd, int R, int parts, int nbuf)
      : buffers(nbuf) {
    const int np = pad16(N);
    bias = align16(sizeof(float) * (size_t)R * tile_ld(np));
    kv = align16(sizeof(bf16) * (size_t)np * op_ld(hd));
    op = align16(sizeof(bf16) * (size_t)R * op_ld(hd));
    acc = align16(sizeof(float) * (size_t)R * (parts - 1) * chans(hd));
    stats = align16(sizeof(float4) * (size_t)R * parts);
  }
  __host__ __device__ size_t buffer() const { return 2 * kv + 2 * op; }
  __host__ __device__ size_t total() const {
    return 2 * bias + buffers * buffer() + acc + stats;
  }
};

// The column kernel's: two buffers each of its keys' K and V rows, then
// the ring's stages, each a block of 64 query rows of q and dO, the bias
// block transposed (64 x (Rc + 4) fp32) and the rows' statistics (64 x 4
// fp32).
struct ColLayout {
  size_t op, qo, bt, st;
  __host__ __device__ ColLayout(int N, int hd, int Rc) {
    op = align16(sizeof(bf16) * (size_t)Rc * op_ld(hd));
    qo = align16(sizeof(bf16) * (size_t)kKeyBlock * op_ld(hd));
    bt = align16(sizeof(float) * (size_t)kKeyBlock * (Rc + 4));
    st = sizeof(float) * 4 * kKeyBlock;
  }
  __host__ __device__ size_t stage() const { return 2 * qo + bt + st; }
  __host__ __device__ size_t total() const {
    return 4 * op + kLongStages * stage();
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

template <int HD>
__global__ void __launch_bounds__(kLongMaxThreads, 1)
window_attention_bwd_rows_kernel(const bf16* __restrict__ qkv,
                                 const float* __restrict__ bias,
                                 const bf16* __restrict__ dout,
                                 bf16* __restrict__ dqkv,
                                 float* __restrict__ dbias,
                                 float* __restrict__ partials,
                                 float4* __restrict__ stats, int B, int nW,
                                 int N, int h, long long bias_w_stride,
                                 float scale, int parts, int buffers) {
  constexpr int HP = chans(HD);
  constexpr int LDO = op_ld(HD);
  constexpr int KQ = HP / 16;
  constexpr int NC = HP / 8;
  const int wh = blockIdx.y;
  const int w = wh / h;
  const int head = wh - w * h;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int slab = warp / parts;
  const int part = warp - slab * parts;
  const int c2 = 2 * (lane & 3);
  const int la = 16 * slab + (lane >> 2);
  const int lb = la + 8;
  const int R = (blockDim.x >> 5) / parts * 16;
  const int r0 = blockIdx.x * R;
  const int nq = min(R, N - r0);
  const int NP = pad16(N);
  const int LDP = tile_ld(NP);
  const int pairs = NP / 16;       // the part's key tiles: a run of pairs
  const int t_begin = 2 * (part * pairs / parts);
  const int t_end = 2 * ((part + 1) * pairs / parts);
  const bool active = 16 * slab < nq;
  int b_begin, b_end;
  split_range(B, gridDim.z, blockIdx.z, &b_begin, &b_end);

  extern __shared__ __align__(16) unsigned char smem[];
  const RowLayout L(N, HD, R, parts, buffers);
  float* Bs = reinterpret_cast<float*>(smem);
  float* dB = reinterpret_cast<float*>(smem + L.bias);
  unsigned char* bufs = smem + 2 * L.bias;
  float* acc_x = reinterpret_cast<float*>(bufs + buffers * L.buffer());
  float4* stat_x = reinterpret_cast<float4*>(bufs + buffers * L.buffer() + L.acc);

  const BwdRows rows = bwd_rows(qkv, dout, dqkv, nW, N, h, HD, w, head);
  const int C = rows.C;

  {  // the dbias rows start at zero; padded rows and channels stay zero
    uint4* z = reinterpret_cast<uint4*>(dB);
    const int n16 = (int)((L.bias + buffers * L.buffer()) / 16);
    for (int i = threadIdx.x; i < n16; i += blockDim.x) z[i] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();
  copy_f32(Bs, LDP, bias + (size_t)w * bias_w_stride + ((size_t)head * N + r0) * N,
           N, nq, N, (N & 3) == 0);
  // K and V (all N rows) and the block's q and dO rows of element b
  auto stage = [&](unsigned char* buf, int b) {
    const bf16* qb = rows.q + b * rows.in_elem;
    copy_rows<HD>(reinterpret_cast<bf16*>(buf), qb + C, 3LL * C, N);
    copy_rows<HD>(reinterpret_cast<bf16*>(buf + L.kv), qb + 2 * C, 3LL * C, N);
    copy_rows<HD>(reinterpret_cast<bf16*>(buf + 2 * L.kv),
                  qb + (size_t)r0 * 3 * C, 3LL * C, nq);
    copy_rows<HD>(reinterpret_cast<bf16*>(buf + 2 * L.kv + L.op),
                  rows.o + b * rows.out_elem + (size_t)r0 * C, C, nq);
  };
  if (b_begin < b_end) stage(bufs, b_begin);
  cp_async_commit();

  for (int b = b_begin; b < b_end; ++b) {
    const int cur = buffers == 2 ? (b - b_begin) & 1 : 0;
    if (buffers == 1 && b > b_begin) {  // the one buffer is free again
      stage(bufs, b);
      cp_async_commit();
    }
    if (buffers == 2 && b + 1 < b_end) {  // prefetch the next element
      stage(bufs + (cur ^ 1) * L.buffer(), b + 1);
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
    const bf16* Os = reinterpret_cast<const bf16*>(buf + 2 * L.kv + L.op);

    // pass A: the part's (max, sum, dot) of each row, traded with the others
    uint32_t qa[KQ][4], oa[KQ][4];   // round(q * scale), dO: A fragments
    float Ma = 0.f, Mb = 0.f, La = 0.f, Lb = 0.f, Ga = 0.f, Gb = 0.f;
    if (active) {
      slab_fragments<KQ, LDO>(qa, Qs, 16 * slab, scale, lane);
      slab_fragments<KQ, LDO>(oa, Os, 16 * slab, 1.f, lane);
      float ma = -INFINITY, mb = -INFINITY, sa = 0.f, sb = 0.f, ga = 0.f, gb = 0.f;
      tile_steps(t_begin, t_end, [&](auto T, int t0) {
        constexpr int TL = decltype(T)::value;
        float s[TL][4], dp[TL][4];
        logits_step<TL, KQ, LDO>(s, qa, Ks + 8 * t0 * LDO, Bs + 8 * t0, LDP, nq,
                                 N - 8 * t0, la, lb, c2, lane);
        product_step<TL, KQ, LDO>(dp, oa, Vs + 8 * t0 * LDO, lane);
        online<TL, true>(ma, sa, ga, s, dp, 0);
        online<TL, true>(mb, sb, gb, s, dp, 2);
      });
      Ma = quad_max(ma);
      Mb = quad_max(mb);
      const float ra = exp2f((ma - Ma) * kTcLog2e), rb = exp2f((mb - Mb) * kTcLog2e);
      La = quad_sum(sa * ra);
      Lb = quad_sum(sb * rb);
      Ga = quad_sum(ga * ra);
      Gb = quad_sum(gb * rb);
      if (parts > 1 && (lane & 3) == 0) {
        stat_x[(slab * parts + part) * 16 + (lane >> 2)] = make_float4(Ma, La, Ga, 0.f);
        stat_x[(slab * parts + part) * 16 + (lane >> 2) + 8] = make_float4(Mb, Lb, Gb, 0.f);
      }
    }
    if (parts > 1) __syncthreads();

    // pass B: dS = P (dP - D) into the dbias rows, dq += round(dS) . K
    float dq[NC][4];
#pragma unroll
    for (int j = 0; j < NC; ++j) zero(dq[j]);
    if (active) {
      if (parts > 1) {
        const float4* st = stat_x + slab * parts * 16 + (lane >> 2);
        Ma = Mb = -INFINITY;
        for (int p = 0; p < parts; ++p) {
          Ma = fmaxf(Ma, st[16 * p].x);
          Mb = fmaxf(Mb, st[16 * p + 8].x);
        }
        La = Lb = Ga = Gb = 0.f;
        for (int p = 0; p < parts; ++p) {
          const float4 x = st[16 * p], y = st[16 * p + 8];
          const float ea = exp2f((x.x - Ma) * kTcLog2e), eb = exp2f((y.x - Mb) * kTcLog2e);
          La += x.y * ea;
          Ga += x.z * ea;
          Lb += y.y * eb;
          Gb += y.z * eb;
        }
      }
      const float mla = Ma * kTcLog2e, inva = 1.f / La, da = Ga * inva;
      const float mlb = Mb * kTcLog2e, invb = 1.f / Lb, db = Gb * invb;
      if (part == 0 && (lane & 3) == 0) {
        float4* srow = stats + ((size_t)b * gridDim.y + wh) * N + r0;
        if (la < nq) srow[la] = make_float4(mla, inva, da, 0.f);
        if (lb < nq) srow[lb] = make_float4(mlb, invb, db, 0.f);
      }
      tile_steps(t_begin, t_end, [&](auto T, int t0) {
        constexpr int TL = decltype(T)::value;
        float s[TL][4], dp[TL][4];
        logits_step<TL, KQ, LDO>(s, qa, Ks + 8 * t0 * LDO, Bs + 8 * t0, LDP, nq,
                                 N - 8 * t0, la, lb, c2, lane);
        product_step<TL, KQ, LDO>(dp, oa, Vs + 8 * t0 * LDO, lane);
        probs<TL>(s, mla, inva, mlb, invb);
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
        pv_acc<TL, NC, LDO>(dq, s, Ks + 8 * t0 * LDO, lane);   // round(dS) . K
      });
      // the parts' dq accumulators meet in part 0, in the order of the
      // parts, each lane's elements at the same place in every part
      if (part > 0) {
        float* mine = acc_x + ((size_t)slab * (parts - 1) + part - 1) * 16 * HP;
#pragma unroll
        for (int j = 0; j < NC; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) mine[(j * 4 + i) * 32 + lane] = dq[j][i];
      }
    }
    if (parts > 1) __syncthreads();
    if (active && part == 0) {
      for (int p = 1; p < parts; ++p) {
        const float* theirs = acc_x + ((size_t)slab * (parts - 1) + p - 1) * 16 * HP;
#pragma unroll
        for (int j = 0; j < NC; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) dq[j][i] += theirs[(j * 4 + i) * 32 + lane];
      }
      store_rows<HD, NC>(rows.g + b * rows.in_elem + (size_t)r0 * 3 * C, 3LL * C,
                         dq, scale, la, lb, nq, c2);
    }
    __syncthreads();               // every warp is done with this buffer
  }

  float* dst = dbias_tile(dbias, partials, gridDim.z, blockIdx.z, gridDim.y, wh, N)
             + (size_t)r0 * N;
  for (int i = threadIdx.x; i < nq * N; i += blockDim.x) {
    const int r = i / N;
    dst[i] = dB[r * LDP + (i - r * N)];
  }
}

// d0, d1 += the slab's A fragments a times rows 8t ... 8t + 15 of the
// staged q block X, each element scaled and rounded first: two n8 tiles
// of S^T = K . round(q * scale)^T
template <int KQ, int LDO>
__device__ __forceinline__ void scaled_pair_product(float (&d0)[4], float (&d1)[4],
                                                    const uint32_t (&a)[KQ][4],
                                                    const bf16* X, int t,
                                                    float scale, int lane) {
#pragma unroll
  for (int kk = 0; kk < KQ; ++kk) {
    uint32_t x[4];
    ldsm_x4(x, X + (8 * t + (lane & 7) + ((lane >> 4) << 3)) * LDO + kk * 16
               + ((lane >> 3) & 1) * 8);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const float2 f = unpack(x[r]);
      x[r] = pack(f.x * scale, f.y * scale);
    }
    mma(d0, a[kk], x[0], x[1]);
    mma(d1, a[kk], x[2], x[3]);
  }
}

template <int HD>
__global__ void __launch_bounds__(kLongMaxWarps * 32, 2)
window_attention_bwd_cols_kernel(const bf16* __restrict__ qkv, const float* __restrict__ bias,
                const bf16* __restrict__ dout, bf16* __restrict__ dqkv,
                const float4* __restrict__ stats, int B, int nW, int N, int h,
                long long bias_w_stride, float scale) {
  constexpr int HP = chans(HD);
  constexpr int LDO = op_ld(HD);
  constexpr int KQ = HP / 16;
  constexpr int NC = HP / 8;
  const int wh = blockIdx.y;
  const int w = wh / h;
  const int head = wh - w * h;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c2 = 2 * (lane & 3);
  const int la = 16 * warp + (lane >> 2);  // the block's keys
  const int lb = la + 8;
  const int Rc = (blockDim.x >> 5) * 16;
  const int ldt = Rc + 4;
  const int c0 = blockIdx.x * Rc;
  const int nk = min(Rc, N - c0);
  const int nqb = key_blocks(N);
  int b_begin, b_end;
  split_range(B, gridDim.z, blockIdx.z, &b_begin, &b_end);
  const int steps = (b_end - b_begin) * nqb;

  extern __shared__ __align__(16) unsigned char smem[];
  const ColLayout L(N, HD, Rc);
  bf16* Ks = reinterpret_cast<bf16*>(smem);                 // two buffers
  bf16* Vs = reinterpret_cast<bf16*>(smem + 2 * L.op);
  unsigned char* ring = smem + 4 * L.op;
  const size_t opn = L.op / sizeof(bf16);

  const BwdRows rows = bwd_rows(qkv, dout, dqkv, nW, N, h, HD, w, head);
  const int C = rows.C;
  const float* bsrc = bias + (size_t)w * bias_w_stride + (size_t)head * N * N + c0;
  const bool vec = (N & 3) == 0;

  {
    uint4* z = reinterpret_cast<uint4*>(smem);
    const int n16 = (int)(L.total() / 16);
    for (int i = threadIdx.x; i < n16; i += blockDim.x) z[i] = make_uint4(0, 0, 0, 0);
  }
  __syncthreads();

  // step st: element st / nqb, query block st % nqb
  auto issue = [&](int st) {
    if (st < steps) {
      const int e = st / nqb;
      const int q0 = (st - e * nqb) * kKeyBlock;
      const int nr = min(kKeyBlock, N - q0);
      const int b = b_begin + e;
      const bf16* qb = rows.q + b * rows.in_elem;
      unsigned char* stg = ring + (st % kLongStages) * L.stage();
      copy_rows<HD>(reinterpret_cast<bf16*>(stg), qb + (size_t)q0 * 3 * C,
                    3LL * C, nr);
      copy_rows<HD>(reinterpret_cast<bf16*>(stg + L.qo),
                    rows.o + b * rows.out_elem + (size_t)q0 * C, C, nr);
      copy_f32(reinterpret_cast<float*>(stg + 2 * L.qo), ldt,
               bsrc + (size_t)q0 * N, N, nr, nk, vec);
      copy_f32(reinterpret_cast<float*>(stg + 2 * L.qo + L.bt), 4,
               reinterpret_cast<const float*>(stats + ((size_t)b * gridDim.y + wh) * N + q0),
               4, nr, 4, true);
      if (q0 == 0) {
        copy_rows<HD>(Ks + (e & 1) * opn, qb + C + (size_t)c0 * 3 * C, 3LL * C, nk);
        copy_rows<HD>(Vs + (e & 1) * opn, qb + 2 * C + (size_t)c0 * 3 * C, 3LL * C, nk);
      }
    }
    cp_async_commit();
  };
  for (int st = 0; st < kLongStages - 1; ++st) issue(st);

  uint32_t ka[KQ][4], va[KQ][4];   // the warp's 16 keys of K and V
  float dk[NC][4], dv[NC][4];
  for (int st = 0; st < steps; ++st) {
    issue(st + kLongStages - 1);
    cp_async_wait<kLongStages - 1>();
    __syncthreads();
    const int e = st / nqb;
    const int qblk = st - e * nqb;
    const int q0 = qblk * kKeyBlock;
    const int nr = min(kKeyBlock, N - q0);
    const int b = b_begin + e;
    const unsigned char* stg = ring + (st % kLongStages) * L.stage();
    const bf16* Qb = reinterpret_cast<const bf16*>(stg);
    const bf16* Ob = reinterpret_cast<const bf16*>(stg + L.qo);
    const float* Bt = reinterpret_cast<const float*>(stg + 2 * L.qo);
    const float4* St = reinterpret_cast<const float4*>(stg + 2 * L.qo + L.bt);
    if (16 * warp < nk) {
      if (q0 == 0) {
        slab_fragments<KQ, LDO>(ka, Ks + (e & 1) * opn, 16 * warp, 1.f, lane);
        slab_fragments<KQ, LDO>(va, Vs + (e & 1) * opn, 16 * warp, 1.f, lane);
#pragma unroll
        for (int j = 0; j < NC; ++j) {
          zero(dk[j]);
          zero(dv[j]);
        }
      }
      by_tiles(block_tiles(N, qblk), [&](auto T) {
        constexpr int TL = decltype(T)::value;
        float s[TL][4], dp[TL][4];
        // S^T starts as the bias transposed: -inf on padded keys and
        // query rows
#pragma unroll
        for (int u = 0; u < TL; ++u) {
          const int c = 8 * u + c2;
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int key = i < 2 ? la : lb;
            const int qr = c + (i & 1);
            s[u][i] = key < nk && qr < nr ? Bt[qr * ldt + key] : -INFINITY;
          }
        }
#pragma unroll
        for (int u = 0; u < TL; u += 2)
          scaled_pair_product<KQ, LDO>(s[u], s[u + 1], ka, Qb, u, scale, lane);
        product_step<TL, KQ, LDO>(dp, va, Ob, lane);  // dP^T = V . dO^T
#pragma unroll
        for (int u = 0; u < TL; ++u) {
          const float4 x = St[8 * u + c2];              // query column c
          const float4 y = St[8 * u + c2 + 1];          // and c + 1
          s[u][0] = exp2f(fmaf(s[u][0], kTcLog2e, -x.x)) * x.y;
          s[u][1] = exp2f(fmaf(s[u][1], kTcLog2e, -y.x)) * y.y;
          s[u][2] = exp2f(fmaf(s[u][2], kTcLog2e, -x.x)) * x.y;
          s[u][3] = exp2f(fmaf(s[u][3], kTcLog2e, -y.x)) * y.y;
          dp[u][0] = s[u][0] * (dp[u][0] - x.z);        // dS^T
          dp[u][1] = s[u][1] * (dp[u][1] - y.z);
          dp[u][2] = s[u][2] * (dp[u][2] - x.z);
          dp[u][3] = s[u][3] * (dp[u][3] - y.z);
        }
        pv_acc<TL, NC, LDO>(dv, s, Ob, lane);   // round(P^T) . dO
        pv_acc<TL, NC, LDO>(dk, dp, Qb, lane);  // round(dS^T) . q
      });
      if (qblk == nqb - 1) {
        bf16* g = rows.g + b * rows.in_elem + (size_t)c0 * 3 * C;
        store_rows<HD, NC>(g + C, 3LL * C, dk, scale, la, lb, nk, c2);
        store_rows<HD, NC>(g + 2 * C, 3LL * C, dv, 1.f, la, lb, nk, c2);
      }
    }
    __syncthreads();
  }
}

template <int HD>
cudaError_t launch(const bf16* qkv, const float* bias, const bf16* dout,
                   bf16* dqkv, float* dbias, float* partials, float4* stats,
                   int B, int nW, int N, int h, long long bias_w_stride,
                   float scale, int R, int parts, int buffers, int splits,
                   int Rc, int col_splits, cudaStream_t stream) {
  auto rk = window_attention_bwd_rows_kernel<HD>;
  auto ck = window_attention_bwd_cols_kernel<HD>;
  const size_t rs = RowLayout(N, HD, R, parts, buffers).total();
  const size_t cs = ColLayout(N, HD, Rc).total();
  cudaError_t e = allow_smem(rk, rs);
  if (e == cudaSuccess) e = allow_smem(ck, cs);
  if (e != cudaSuccess) return e;
  rk<<<dim3((N + R - 1) / R, nW * h, splits), R / 16 * parts * 32, rs, stream>>>(
      qkv, bias, dout, dqkv, dbias, partials, stats, B, nW, N, h,
      bias_w_stride, scale, parts, buffers);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if (splits > 1 &&
      (e = sum_splits(partials, dbias, splits, (long long)nW * h * N * N,
                      stream)) != cudaSuccess)
    return e;
  ck<<<dim3((N + Rc - 1) / Rc, nW * h, col_splits), Rc / 16 * 32, cs, stream>>>(
      qkv, bias, dout, dqkv, stats, B, nW, N, h, bias_w_stride, scale);
  return cudaGetLastError();
}

template <class K>
int occupancy(K kernel, int threads, size_t smem) {
  return blocks_per_sm(kernel, threads, smem);
}

}  // namespace

extern "C" {

// Shared memory of one block of the row kernel (`kernel` 0: R query rows
// on `parts` warps a slab, `buffers` of the element's operands) or of the
// column kernel (1: R keys; parts and buffers 1); -1 where the shape is
// not taken.
long long fiber_window_attention_bwd_tc_long_smem_bytes(int N, int hd, int R,
                                                        int parts, int buffers,
                                                        int kernel) {
  if (!bwd_long_takes(N, hd, R, parts, buffers)
      || (kernel && (parts != 1 || buffers != 1)))
    return -1;
  return (long long)(kernel ? ColLayout(N, hd, R).total()
                            : RowLayout(N, hd, R, parts, buffers).total());
}

// Resident blocks per SM of the row (0) or column (1) kernel; -1 on error
// or where the shape is not taken.
int fiber_window_attention_bwd_tc_long_blocks_per_sm(int N, int hd, int R,
                                                     int parts, int buffers,
                                                     int kernel) {
  if (!bwd_long_takes(N, hd, R, parts, buffers)
      || (kernel && (parts != 1 || buffers != 1)))
    return -1;
  const size_t smem = kernel ? ColLayout(N, hd, R).total()
                             : RowLayout(N, hd, R, parts, buffers).total();
  const int threads = R / 16 * parts * 32;
  switch (hd) {
    case 8: return kernel ? occupancy(window_attention_bwd_cols_kernel<8>, threads, smem) : occupancy(window_attention_bwd_rows_kernel<8>, threads, smem);
    case 16: return kernel ? occupancy(window_attention_bwd_cols_kernel<16>, threads, smem) : occupancy(window_attention_bwd_rows_kernel<16>, threads, smem);
    case 32: return kernel ? occupancy(window_attention_bwd_cols_kernel<32>, threads, smem) : occupancy(window_attention_bwd_rows_kernel<32>, threads, smem);
    default: return kernel ? occupancy(window_attention_bwd_cols_kernel<64>, threads, smem) : occupancy(window_attention_bwd_rows_kernel<64>, threads, smem);
  }
}

// Launches on `stream` the row kernel (R query rows a block on `parts`
// warps a slab, its element's operands in `buffers` (2: the next element
// prefetched), `splits` of the batch), the fixed-order sum of its dbias
// partials when splits > 1, then the column kernel (Rc keys a block,
// `col_splits`); returns the first CUDA error (0 on success).  qkv, dqkv
// (B, nW, N, 3 h hd) and dout (B, nW, N, h hd) contiguous bf16, 16-byte
// aligned; bias fp32, element (w, head, i, j) at w * bias_w_stride +
// (head * N + i) * N + j, 16-byte aligned; dbias (nW, h, N, N) fp32
// contiguous, written whole; partials (splits, nW, h, N, N) fp32 scratch,
// used only when splits > 1; stats (B, nW h, N, 4) fp32 scratch, 16-byte
// aligned.
int fiber_window_attention_bwd_tc_long(const void* qkv, const void* bias,
                                       const void* dout, void* dqkv,
                                       void* dbias, void* partials, void* stats,
                                       int B, int nW, int N, int h, int hd,
                                       long long bias_w_stride, float scale,
                                       int R, int parts, int buffers,
                                       int splits, int Rc, int col_splits,
                                       void* stream) {
  if (!bwd_long_takes(N, hd, R, parts, buffers) || !bwd_long_takes(N, hd, Rc)
      || splits < 1 || splits > B || col_splits < 1 || col_splits > B)
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
    case 8: return (int)launch<8>(q, bi, o, dq, db, pa, st, B, nW, N, h, bias_w_stride, scale, R, parts, buffers, splits, Rc, col_splits, s);
    case 16: return (int)launch<16>(q, bi, o, dq, db, pa, st, B, nW, N, h, bias_w_stride, scale, R, parts, buffers, splits, Rc, col_splits, s);
    case 32: return (int)launch<32>(q, bi, o, dq, db, pa, st, B, nW, N, h, bias_w_stride, scale, R, parts, buffers, splits, Rc, col_splits, s);
    default: return (int)launch<64>(q, bi, o, dq, db, pa, st, B, nW, N, h, bias_w_stride, scale, R, parts, buffers, splits, Rc, col_splits, s);
  }
}

}  // extern "C"
