// Windowed multi-head attention backward for Hopper (sm_90a), bf16, on the
// tensor cores (warp-level mma.sync m16n8k16, bf16 operands, fp32
// accumulators, fed by ldmatrix).  (fp32 runs window_attention_bwd.cu, on
// the CUDA cores.)
//
// Replaces the JAX package's Pallas TPU kernel
// fiber_tpu/ops/window_attention.py::window_attention_packed_pallas_bwd
// (body _packed_bwd_kernel).  For every (batch b, window w, head) it
// recomputes the forward's probabilities and returns the gradients of
// out = softmax(q * hd^-1/2 . k^T + bias[w, head]) . v:
//
//     P   = softmax(round(q * scale) . k^T + bias)          fp32, as K1
//     dv  = round(P)^T . dO
//     dP  = dO . v^T                                        fp32
//     dS  = P * (dP - rowsum(dP * P))                       fp32
//     dq  = scale * round(dS) . k,   dk = scale * round(dS)^T . q
//     dbias[w, head] = sum over b of dS                     fp32
//
// where round() is a rounding to bf16 and every product accumulates in
// fp32, the steps of the plain version window_attention_bwd_reference
// (fiber_torch/ops/window_attention.py): q is scaled and rounded before
// q.k^T, dk takes the raw q, P and dS are rounded only as operands of their
// products, dbias sums the unrounded dS, dq and dk are scaled after the
// fp32 product and rounded on store.  dq, dk, dv are written into dqkv
// (B, nW, N, 3C) at the channel offsets the forward reads q, k, v from;
// dbias is (nW, h, N, N) fp32.
//
// What bounds it on the card: bytes.  At the report shape (FIBER-Base 384^2
// stage 3, N = 144, hd = 32, nW = 4, h = 16, B = 24) qkv, dout and dqkv in
// bf16 and the bias and dbias in fp32, each once, are 110 MB: 0.0327 ms at
// 3.35 TB/s.  The five products are 10 N^2 hd FLOP per (b, w, head), 10.2
// GFLOP there: 0.0103 ms at 989 TFLOP/s.  The first K2 (fp32 FMAs on the
// CUDA cores, one block per (window, head) walking the whole batch) took
// 4.5 ms there, held by two limits; what this design does about each:
//
// * Parallelism: nW * h blocks (64 at stage 3) left most of the 132 SMs
//   idle.  The grid is (nW * h, S): block (w * h + head, s) walks the batch
//   elements of split s in ascending order and keeps its fp32 dbias tile in
//   shared memory across them; the S tiles are summed in the order s = 0
//   ... S - 1 by a second kernel (window_attention_bwd_common.cuh), or
//   written directly when S = 1.  No atomics.  The wrapper picks S from the
//   batch, the grid and the resident blocks per SM: the fewest splits
//   whose waves times batch elements per block is near the least.
// * Arithmetic: seven fp32 products fed from shared memory become six on
//   the tensor cores (dP is computed twice, below).  One warp owns a 16-row
//   slab of queries (N padded to a multiple of 16: 9 warps at N = 144):
//     0. q, k, v and dO of the batch element, and the fp32 bias tile (the
//        same for every b, so it comes from L2), are copied into shared
//        memory by cp.async;
//     1. S = bias + q~ . K^T into registers (N/2 fp32 a thread: the
//        accumulators start as the bias, padded keys at -inf); the softmax
//        with quad shuffles for the row max and sum, exp2 of prescaled
//        logits, one reciprocal a row;
//     2. rowsum(dP * P) from dP = dO . V^T, two key tiles at a time;
//     3. dP again, dS = P * (dP - rowsum), added into the block's dbias tile
//        in shared memory (each thread owns its elements, so the sum over b
//        has a fixed order); round(P) stored over the bias tile; round(dS)
//        packed into A fragments in registers (an accumulator pair is an A
//        fragment), and dq = scale * round(dS) . K from those registers.
//        S and dP rows together would not fit in a thread's registers beside
//        the fragments: 9 warps on an SM's 4 schedulers cap a thread at 168
//        registers, hence the second dP;
//     4. after a barrier each warp owns a 16-key slab: dv = round(P)^T . dO
//        (ldmatrix.trans for both operands); after another barrier round(dS)
//        replaces round(P) in the same buffer, and dk = scale * round(dS)^T . q.
//   Padded rows of q, K, V and dO are zero, so they add nothing to any sum;
//   hd = 8 is zero-padded to the k16 of the mma.
//
// Shared memory (bytes, NP = N padded to 16, HP = max(hd, 16)):
//   Q, K, V, dO staged in bf16       4 * NP * (HP + 8) * 2     46,080
//   bias (fp32), then round(P) and
//   round(dS) (bf16) in its place    NP * (NP + 8) * 4        87,552
//   dbias tile, fp32                 NP * (NP + 8) * 4        87,552
//   total at N = 144, hd = 32                                221,184
// The 8-element row padding puts the 8 rows that one ldmatrix reads in 8
// different bank groups.  One block per SM at N = 144.  The wrapper's
// route rule sends the shapes that do not fit (hd >= 64 at N = 144), and
// N > 144, where a slab's S row no longer fits in registers, to
// window_attention_bwd_tc_long.cu (hd = 128 there raises).
// Launch checks: the C function returns the first CUDA error of the
// launches and sets the dynamic shared-memory limit first.  wgmma, TMA and
// warp specialisation are left for a later version.

#include <stdint.h>

#include "window_attention_bwd_common.cuh"
#include "window_attention_common.cuh"
#include "mma_bf16.cuh"

namespace {

using namespace fiber;
using bf16 = __nv_bfloat16;

constexpr int kMaxNP = 144;             // a slab row of S: NP / 2 fp32 a thread
constexpr int kMaxWarps = kMaxNP / 16;  // one 16-row slab per warp
constexpr int kMaxTiles = kMaxNP / 8;   // n8 tiles over the keys
constexpr float kLog2e = 1.4426950408889634f;

// Bytes of shared memory: Q, K, V and dO; the staged fp32 bias, whose tile
// then holds round(P) and round(dS); the dbias tile.
__host__ __device__ inline size_t tc_smem_bytes(int N, int hd) {
  const size_t np = pad16(N);
  return 4 * align16(sizeof(bf16) * np * op_ld(hd))
       + 2 * align16(sizeof(float) * np * tile_ld(np));
}

// acc (16 keys of slab m0, HP channels) = A^T . X, where A (NP, NP) is the
// bf16 tile at `tile` (rows: queries; round(P) or round(dS)) and X the
// staged (NP, HP) operand: the dv and dk products of one warp.
template <int HP>
__device__ __forceinline__ void slab_t_product(
    float (&acc)[HP / 8][4], const bf16* tile, int ldp, const bf16* X,
    int ldo, int m0, int NT, int lane) {
#pragma unroll
  for (int j = 0; j < HP / 8; ++j) zero(acc[j]);
#pragma unroll
  for (int kk = 0; kk < kMaxTiles / 2; ++kk) {
    if (2 * kk < NT) {
      uint32_t a[4];
      ldsm_x4_t(a, tile + (kk * 16 + (lane & 7) + ((lane >> 4) << 3)) * ldp
                          + m0 + ((lane >> 3) & 1) * 8);
#pragma unroll
      for (int j = 0; j < HP / 8; j += 2) {
        uint32_t x[4];
        ldsm_x4_t(x, X + (kk * 16 + (lane & 15)) * ldo + 8 * (j + (lane >> 4)));
        mma(acc[j], a, x[0], x[1]);
        mma(acc[j + 1], a, x[2], x[3]);
      }
    }
  }
}

// rows ra and ra + 8 of a 16-row accumulator slab, times `scale`, rounded
// and stored at dst (row stride ld) for the real channels (< HD) and rows
// (< N)
template <int HD, int HP>
__device__ __forceinline__ void store_slab(bf16* dst, long long ld,
                                           const float (&acc)[HP / 8][4],
                                           float scale, int ra, int N,
                                           int lane) {
  const int c2 = 2 * (lane & 3);
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    if (ra < N)
      *reinterpret_cast<uint32_t*>(dst + ra * ld + 8 * j + c2) =
          pack(acc[j][0] * scale, acc[j][1] * scale);
    if (ra + 8 < N)
      *reinterpret_cast<uint32_t*>(dst + (ra + 8) * ld + 8 * j + c2) =
          pack(acc[j][2] * scale, acc[j][3] * scale);
  }
}

template <int HD>
__global__ void __launch_bounds__(kMaxWarps * 32, 1)
window_attention_bwd_tc_kernel(const bf16* __restrict__ qkv,
                               const float* __restrict__ bias,
                               const bf16* __restrict__ dout,
                               bf16* __restrict__ dqkv,
                               float* __restrict__ dbias,
                               float* __restrict__ partials,
                               int B, int nW, int N, int h,
                               long long bias_w_stride, float scale) {
  constexpr int HP = chans(HD);
  constexpr int LDO = op_ld(HD);
  constexpr int KQ = HP / 16;      // k16 steps over the channels
  constexpr int NC = HP / 8;       // n8 tiles over the channels
  constexpr int CH = HD / 8;       // 16-byte chunks in a head's row
  const int NP = pad16(N);
  const int NT = NP / 8;           // n8 tiles over the keys
  const int LDP = tile_ld(NP);
  const int w = blockIdx.x / h;
  const int head = blockIdx.x - w * h;
  const int C = h * HD;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c2 = 2 * (lane & 3);
  const int r0 = warp * 16;        // the warp's query slab, then its key slab
  const int ra = r0 + (lane >> 2);
  const int rb = ra + 8;
  int b_begin, b_end;
  split_range(B, gridDim.y, blockIdx.y, &b_begin, &b_end);

  extern __shared__ __align__(16) unsigned char smem[];
  const size_t op_bytes = align16(sizeof(bf16) * NP * LDO);
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = reinterpret_cast<bf16*>(smem + op_bytes);
  bf16* Vs = reinterpret_cast<bf16*>(smem + 2 * op_bytes);
  bf16* Os = reinterpret_cast<bf16*>(smem + 3 * op_bytes);
  bf16* Ps = reinterpret_cast<bf16*>(smem + 4 * op_bytes);
  float* Bs = reinterpret_cast<float*>(Ps);  // the staged bias, before round(P)
  float* dB = reinterpret_cast<float*>(
      smem + 4 * op_bytes + align16(sizeof(float) * NP * LDP));
  const float* bias_wh = bias + (size_t)w * bias_w_stride + (size_t)head * N * N;

  // Zero everything once: padded rows and channels stay zero, and the
  // dbias tile starts at zero.
  {
    uint4* z = reinterpret_cast<uint4*>(smem);
    const int n16 = (int)(tc_smem_bytes(N, HD) / 16);
    for (int i = threadIdx.x; i < n16; i += blockDim.x) z[i] = make_uint4(0, 0, 0, 0);
  }

  for (int b = b_begin; b < b_end; ++b) {
    const size_t row0 = ((size_t)b * nW + w) * N;  // first token of the window
    const bf16* win = qkv + row0 * 3 * C + head * HD;
    const bf16* dwin = dout + row0 * C + head * HD;
    bf16* gwin = dqkv + row0 * 3 * C + head * HD;

    __syncthreads();                // the previous element is done with smem
    for (int i = threadIdx.x; i < 4 * N * CH; i += blockDim.x) {
      const int op = i / (N * CH);  // q, k, v, dO
      const int rem = i - op * N * CH;
      const int n = rem / CH;
      const int ch = rem - n * CH;
      const bf16* src = op < 3 ? win + (size_t)n * 3 * C + op * C
                               : dwin + (size_t)n * C;
      bf16* dst = reinterpret_cast<bf16*>(smem + op * op_bytes) + n * LDO;
      cp_async16(dst + 8 * ch, src + 8 * ch);
    }
    if ((N & 3) == 0) {             // the same bias tile for every b, from L2
      const int n4 = N / 4;
      for (int i = threadIdx.x; i < N * n4; i += blockDim.x) {
        const int r = i / n4;
        const int c = 4 * (i - r * n4);
        cp_async16(Bs + r * LDP + c, bias_wh + (size_t)r * N + c);
      }
    } else {
      for (int i = threadIdx.x; i < N * N; i += blockDim.x) {
        const int r = i / N;
        cp_async4(Bs + r * LDP + (i - r * N), bias_wh + i);
      }
    }
    cp_async_wait_all();
    __syncthreads();

    // the logits start as the fp32 bias: -inf on padded keys, 0 on padded
    // rows
    float s[kMaxTiles][4];
#pragma unroll
    for (int t = 0; t < kMaxTiles; ++t) {
      if (t < NT) {
        const int col = 8 * t + c2;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int row = hr ? rb : ra;
          const float2 v = row < N ? *reinterpret_cast<const float2*>(Bs + row * LDP + col)
                                   : make_float2(0.f, 0.f);
          s[t][2 * hr] = col < N ? v.x : -INFINITY;
          s[t][2 * hr + 1] = col + 1 < N ? v.y : -INFINITY;
        }
      }
    }

    // ---- 1. logits and softmax of the warp's 16 query rows --------------
    {
      uint32_t qa[KQ][4];           // round(q * scale) as A fragments
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk) {
        ldsm_x4(qa[kk], Qs + (r0 + (lane & 15)) * LDO + kk * 16 + (lane >> 4) * 8);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float2 f = unpack(qa[kk][r]);
          qa[kk][r] = pack(f.x * scale, f.y * scale);
        }
      }
#pragma unroll
      for (int t = 0; t < kMaxTiles; t += 2)
        if (t < NT) key_pair_product<KQ, LDO>(s[t], s[t + 1], qa, Ks, t, lane);
    }
    float mxa = -INFINITY, mxb = -INFINITY;
#pragma unroll
    for (int t = 0; t < kMaxTiles; ++t) {
      if (t < NT) {
        mxa = fmaxf(mxa, fmaxf(s[t][0], s[t][1]));
        mxb = fmaxf(mxb, fmaxf(s[t][2], s[t][3]));
      }
    }
    mxa = quad_max(mxa) * kLog2e;
    mxb = quad_max(mxb) * kLog2e;
    float suma = 0.f, sumb = 0.f;
#pragma unroll
    for (int t = 0; t < kMaxTiles; ++t) {
      if (t < NT) {
        s[t][0] = exp2f(fmaf(s[t][0], kLog2e, -mxa));
        s[t][1] = exp2f(fmaf(s[t][1], kLog2e, -mxa));
        s[t][2] = exp2f(fmaf(s[t][2], kLog2e, -mxb));
        s[t][3] = exp2f(fmaf(s[t][3], kLog2e, -mxb));
        suma += s[t][0] + s[t][1];
        sumb += s[t][2] + s[t][3];
      }
    }
    suma = 1.f / quad_sum(suma);
    sumb = 1.f / quad_sum(sumb);
#pragma unroll
    for (int t = 0; t < kMaxTiles; ++t) {
      if (t < NT) {
        s[t][0] *= suma;
        s[t][1] *= suma;
        s[t][2] *= sumb;
        s[t][3] *= sumb;
      }
    }

    // ---- 2. rowsum(dP * P), dP = dO . V^T two key tiles at a time -------
    // (dP is recomputed in step 3 rather than held: S and dP rows together
    // would not fit in a thread's registers beside the fragments)
    uint32_t oa[KQ][4];
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk)
      ldsm_x4(oa[kk], Os + (r0 + (lane & 15)) * LDO + kk * 16 + (lane >> 4) * 8);
    float dota = 0.f, dotb = 0.f;
#pragma unroll
    for (int t = 0; t < kMaxTiles; t += 2) {
      if (t < NT) {
        float d[2][4] = {};
        key_pair_product<KQ, LDO>(d[0], d[1], oa, Vs, t, lane);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          dota = fmaf(d[u][0], s[t + u][0], fmaf(d[u][1], s[t + u][1], dota));
          dotb = fmaf(d[u][2], s[t + u][2], fmaf(d[u][3], s[t + u][3], dotb));
        }
      }
    }
    dota = quad_sum(dota);
    dotb = quad_sum(dotb);

    // ---- 3. dS into dbias; round(P) to smem; round(dS) fragments; dq -----
    __syncthreads();                // every warp has read its bias rows
    uint32_t dsa[kMaxTiles / 2][4];
#pragma unroll
    for (int t = 0; t < kMaxTiles; t += 2) {
      if (t < NT) {
        float d[2][4] = {};
        key_pair_product<KQ, LDO>(d[0], d[1], oa, Vs, t, lane);
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const float* p = s[t + u];
          d[u][0] = p[0] * (d[u][0] - dota);
          d[u][1] = p[1] * (d[u][1] - dota);
          d[u][2] = p[2] * (d[u][2] - dotb);
          d[u][3] = p[3] * (d[u][3] - dotb);
          const int col = 8 * (t + u) + c2;
          // dS is 0 on padded rows (dO is 0) and keys (P is 0): the whole
          // padded tile takes the sum, only its (N, N) corner is written out
          float2* da = reinterpret_cast<float2*>(dB + ra * LDP + col);
          float2* db = reinterpret_cast<float2*>(dB + rb * LDP + col);
          float2 x = *da, y = *db;
          x.x += d[u][0];
          x.y += d[u][1];
          y.x += d[u][2];
          y.y += d[u][3];
          *da = x;
          *db = y;
          // round(P), zero on padded rows
          *reinterpret_cast<uint32_t*>(Ps + ra * LDP + col) =
              ra < N ? pack(p[0], p[1]) : 0u;
          *reinterpret_cast<uint32_t*>(Ps + rb * LDP + col) =
              rb < N ? pack(p[2], p[3]) : 0u;
          // the accumulator pair of tiles t, t + 1 is the A fragment of
          // k-step t / 2
          dsa[t / 2][2 * u] = pack(d[u][0], d[u][1]);
          dsa[t / 2][2 * u + 1] = pack(d[u][2], d[u][3]);
        }
      }
    }
    {
      float dq[NC][4];
#pragma unroll
      for (int j = 0; j < NC; ++j) zero(dq[j]);
#pragma unroll
      for (int kk = 0; kk < kMaxTiles / 2; ++kk) {
        if (2 * kk < NT) {
#pragma unroll
          for (int j = 0; j < NC; j += 2) {
            uint32_t kb[4];
            ldsm_x4_t(kb, Ks + (kk * 16 + (lane & 15)) * LDO + 8 * (j + (lane >> 4)));
            mma(dq[j], dsa[kk], kb[0], kb[1]);
            mma(dq[j + 1], dsa[kk], kb[2], kb[3]);
          }
        }
      }
      store_slab<HD, HP>(gwin, 3LL * C, dq, scale, ra, N, lane);
    }

    // ---- 4. dv and dk of the warp's 16 keys -------------------------------
    __syncthreads();                // round(P) of every row is in Ps
    {
      float acc[NC][4];
      slab_t_product<HP>(acc, Ps, LDP, Os, LDO, r0, NT, lane);
      store_slab<HD, HP>(gwin + 2 * C, 3LL * C, acc, 1.f, ra, N, lane);
    }
    __syncthreads();                // every warp is done with round(P)
#pragma unroll
    for (int kk = 0; kk < kMaxTiles / 2; ++kk) {
      if (2 * kk < NT) {
        const int col = 16 * kk + c2;
        *reinterpret_cast<uint32_t*>(Ps + ra * LDP + col) = dsa[kk][0];
        *reinterpret_cast<uint32_t*>(Ps + rb * LDP + col) = dsa[kk][1];
        *reinterpret_cast<uint32_t*>(Ps + ra * LDP + col + 8) = dsa[kk][2];
        *reinterpret_cast<uint32_t*>(Ps + rb * LDP + col + 8) = dsa[kk][3];
      }
    }
    __syncthreads();
    {
      float acc[NC][4];
      slab_t_product<HP>(acc, Ps, LDP, Qs, LDO, r0, NT, lane);
      store_slab<HD, HP>(gwin + C, 3LL * C, acc, scale, ra, N, lane);
    }
  }

  __syncthreads();
  float* dbias_wh = dbias_tile(dbias, partials, gridDim.y, blockIdx.y,
                               gridDim.x, blockIdx.x, N);
  for (int i = threadIdx.x; i < N * N; i += blockDim.x) {
    const int r = i / N;
    dbias_wh[i] = dB[r * LDP + (i - r * N)];
  }
}

inline int threads_for(int N) { return pad16(N) / 16 * 32; }

template <int HD>
cudaError_t launch(const bf16* qkv, const float* bias, const bf16* dout,
                   bf16* dqkv, float* dbias, float* partials, int B, int nW,
                   int N, int h, long long bias_w_stride, float scale,
                   int splits, cudaStream_t stream) {
  return launch_split(window_attention_bwd_tc_kernel<HD>, nW * h, splits,
                      threads_for(N), tc_smem_bytes(N, HD), stream, dbias,
                      partials, (long long)nW * h * N * N, qkv, bias, dout,
                      dqkv, dbias, partials, B, nW, N, h, bias_w_stride, scale);
}

}  // namespace

extern "C" {

// Shared memory one block needs; -1 where N > 144 (registers).
long long fiber_window_attention_bwd_tc_smem_bytes(int N, int hd) {
  if (N < 1 || N > kMaxNP) return -1;
  return (long long)tc_smem_bytes(N, hd);
}

// Resident blocks per SM at that shared memory; -1 on error.
int fiber_window_attention_bwd_tc_blocks_per_sm(int N, int hd) {
  if (N < 1 || N > kMaxNP) return -1;
  const size_t smem = tc_smem_bytes(N, hd);
  const int threads = threads_for(N);
  switch (hd) {
    case 8: return blocks_per_sm(window_attention_bwd_tc_kernel<8>, threads, smem);
    case 16: return blocks_per_sm(window_attention_bwd_tc_kernel<16>, threads, smem);
    case 32: return blocks_per_sm(window_attention_bwd_tc_kernel<32>, threads, smem);
    case 64: return blocks_per_sm(window_attention_bwd_tc_kernel<64>, threads, smem);
    case 128: return blocks_per_sm(window_attention_bwd_tc_kernel<128>, threads, smem);
    default: return -1;
  }
}

// Launches on `stream` and returns the first CUDA error (0 on success).
// qkv, dqkv (B, nW, N, 3 h hd) and dout (B, nW, N, h hd) contiguous bf16,
// 16-byte aligned; bias fp32, element (w, head, i, j) at w * bias_w_stride
// + (head * N + i) * N + j; dbias (nW, h, N, N) fp32 contiguous, written
// whole; partials (splits, nW, h, N, N) fp32 scratch, used only when
// splits > 1.
int fiber_window_attention_bwd_tc(const void* qkv, const void* bias,
                                  const void* dout, void* dqkv, void* dbias,
                                  void* partials, int B, int nW, int N, int h,
                                  int hd, long long bias_w_stride, float scale,
                                  int splits, void* stream) {
  if (N < 1 || N > kMaxNP || splits < 1 || splits > B)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto q = static_cast<const bf16*>(qkv);
  auto bi = static_cast<const float*>(bias);
  auto o = static_cast<const bf16*>(dout);
  auto dq = static_cast<bf16*>(dqkv);
  auto db = static_cast<float*>(dbias);
  auto pa = static_cast<float*>(partials);
  switch (hd) {
    case 8: return (int)launch<8>(q, bi, o, dq, db, pa, B, nW, N, h, bias_w_stride, scale, splits, s);
    case 16: return (int)launch<16>(q, bi, o, dq, db, pa, B, nW, N, h, bias_w_stride, scale, splits, s);
    case 32: return (int)launch<32>(q, bi, o, dq, db, pa, B, nW, N, h, bias_w_stride, scale, splits, s);
    case 64: return (int)launch<64>(q, bi, o, dq, db, pa, B, nW, N, h, bias_w_stride, scale, splits, s);
    case 128: return (int)launch<128>(q, bi, o, dq, db, pa, B, nW, N, h, bias_w_stride, scale, splits, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
