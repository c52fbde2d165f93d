// Windowed multi-head attention backward for Hopper (sm_90a), fp32, on the
// CUDA cores.  (bf16 runs window_attention_bwd_tc.cu, on the tensor cores.)
//
// Replaces the JAX package's Pallas TPU kernel
// fiber_tpu/ops/window_attention.py::window_attention_packed_pallas_bwd
// (body _packed_bwd_kernel).  For every (batch b, window w, head) it
// recomputes the forward's probabilities and returns the gradients of
// out = softmax(q * hd^-1/2 . k^T + bias[w, head]) . v:
//
//     P   = softmax((q * scale) . k^T + bias)
//     dv  = P^T . dO
//     dP  = dO . v^T
//     dS  = P * (dP - rowsum(dP * P))
//     dq  = scale * dS . k,   dk = scale * dS^T . q
//     dbias[w, head] = sum over b of dS
//
// in fp32 throughout, the steps of the plain version
// window_attention_bwd_reference (fiber_torch/ops/window_attention.py).
// dq, dk, dv are written into dqkv (B, nW, N, 3C) at the channel offsets
// the forward reads q, k, v from; dbias is (nW, h, N, N) fp32.
//
// What bounds it on the card: at the FIBER-Base 384^2 shapes (N = 144,
// hd = 32) the five products are 10 N^2 hd FLOP per (b, w, head), 10.2
// GFLOP at stage 3 and B = 24, against 67 TFLOP/s of fp32 CUDA-core rate:
// 0.152 ms, above the 0.0623 ms the bytes take (qkv, dout and dqkv in fp32,
// bias and dbias once, 209 MB at 3.35 TB/s).  This design runs its products
// as fp32 FMAs fed from shared memory, seven where five would do (below),
// and is bound by them.
//
// The choices, point by point:
// * The dbias sum over the batch (the TPU kernel keeps one dbias block
//   resident across a sequential batch axis): the grid is (nW * h, S).
//   Block (w * h + head, s) walks the batch elements of split s in
//   ascending order and keeps its fp32 dbias tile in shared memory across
//   them; each element is owned by one thread per batch element.  The S
//   tiles are summed in the order s = 0 ... S - 1 by a second kernel
//   (window_attention_bwd_common.cuh), or written directly when S = 1: no
//   atomics, the same bits from call to call.  The wrapper picks S from the
//   batch, the grid and the card's resident blocks: the fewest splits
//   whose waves times batch elements per block is near the least (at
//   B = 24 on 132 SMs: S = 1 / 1 / 2 / 4 at stages 1-4, 256 / 128 / 128 /
//   128 blocks instead of 256 / 128 / 64 / 32).
// * dk and dv sum over query rows, dq over keys: two passes per batch
//   element.  Pass A gives a warp one query row (lanes own keys): logits,
//   softmax, dP, dS, the dbias update, dq, and the row's max, sum and
//   rowsum(dP * P).  Pass B gives a warp one key (lanes own query rows):
//   it recomputes P and dS for that key's column with the same operations
//   in the same order (so bit for bit the values of pass A) from the
//   stored row statistics, then dv and dk.  Recomputing costs two of the
//   seven products but keeps no (N, N) probabilities in shared memory.
// * Shared memory: the bias tile (staged once per block, since it is the
//   same for every b) and the dbias tile, (N, N|1) fp32 each, plus two
//   staged (N, hd) operands: K and V in pass A, Q and dO in pass B.  At
//   N = 144, hd = 32 that is 215 KB, one block per SM; the wrapper's route
//   rule sends the shapes that do not fit (N = 256, or hd = 64 at N = 144)
//   to the long-window kernels below.
// * The broadcast bias: a window stride of 0 reads one (h, N, N) bias
//   for every window; dbias is always written per window, and autograd's
//   expand backward sums it.
// * N = 144 is not a power of two: lanes own the keys (or rows)
//   j = lane + 32 t, t < 8, with a masked tail, as in K1.
// * Staging: the bias tile once per block and the two operands of each
//   pass are copied by cp.async, all in flight at once (a block's fixed cost
//   grows with the split, so it is kept small).
// * Launch checks: the C function returns the first CUDA error of the
//   launches and sets the dynamic shared-memory limit first.
//
// Long windows (FIBER's 18 x 18 windows at 576^2, N = 324; any N <= 352
// whose whole tiles do not fit, N = 256 at hd = 32 already): the (N, N)
// bias and dbias tiles no longer fit a block, so the work splits as in the
// bf16 window_attention_bwd_tc_long.cu, by a row kernel and a column
// kernel, on the CUDA cores:
// * window_attention_bwd_long_rows_kernel, grid (ceil(N / 16), nW * h,
//   S): a block owns 16 query rows of one (window, head) and walks the
//   elements of split s; per element it stages K and V (all N rows), and
//   each warp runs pass A above for one of its rows at a time (the bias
//   row read from L2), adds dS into the block's 16 dbias rows in shared
//   memory, writes dq and the row's (max, sum, rowsum(dP * P)) to a (B,
//   nW h, N) x 4 fp32 scratch; the split's dbias rows are summed over S as
//   above;
// * window_attention_bwd_long_cols_kernel, grid (ceil(N / 16), nW * h,
//   S'): a block owns 16 keys, stages their bias columns once
//   (transposed), and per element Q, dO and the rows' statistics; each
//   warp runs pass B for one of its keys at a time (lanes own query rows
//   i = lane + 32 t, t < 11), then dv and dk.
// Both recompute P with the same operations in the same order, so bit for
// bit the same values.  This is a simple kernel: only the fp32 card-vs-host
// gradient checks run it.  It takes N <= 352 where K and V (or q and dO)
// fit a block: not hd = 128 beyond N = 195.

#include <stdint.h>

#include "window_attention_bwd_common.cuh"
#include "window_attention_common.cuh"

namespace {

using namespace fiber;

constexpr int kWarps = 16;
constexpr int kMaxChunks = 8;  // N <= 32 * 8 = 256

// Leading dimension of the (N, N) fp32 tiles: odd, so that a column read
// by 32 lanes hits 32 banks.
__host__ __device__ inline int tile_ld(int N) { return N | 1; }

__host__ __device__ inline size_t bwd_smem_bytes(int N, int hd) {
  return 2 * align16(sizeof(float) * (size_t)N * tile_ld(N))  // bias, dbias
       + 2 * align16(sizeof(float) * (size_t)N * k_stride<float>(hd))  // two operands
       + align16(sizeof(float) * 3 * (size_t)N)                // row stats
       + align16(sizeof(float) * kWarps * (size_t)(2 * hd + N));  // per warp
}

// acc[c] = sum_j w[j] * M[j, d] for the lane's channels d (lane + 32 c for
// HD >= 32; for HD < 32 the lanes split the rows into 32 / HD groups and
// reduce, and lane d < HD holds the result).
template <int HD>
__device__ __forceinline__ void weighted_rows(
    const float* __restrict__ w, const float* __restrict__ M, int ld, int N,
    int lane, float (&acc)[HD >= 32 ? HD / 32 : 1]) {
  if constexpr (HD >= 32) {
#pragma unroll
    for (int c = 0; c < HD / 32; ++c) acc[c] = 0.f;
    for (int j = 0; j < N; ++j) {
      const float wj = w[j];
      const float* row = M + (size_t)j * ld + lane;
#pragma unroll
      for (int c = 0; c < HD / 32; ++c) acc[c] = fmaf(wj, row[32 * c], acc[c]);
    }
  } else {
    constexpr int G = 32 / HD;
    const int d = lane % HD;
    float a = 0.f;
    for (int j = lane / HD; j < N; j += G) a = fmaf(w[j], M[(size_t)j * ld + d], a);
#pragma unroll
    for (int off = HD; off < 32; off <<= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
    acc[0] = a;
  }
}

// dst[d] = scale * acc for the lane's channels
template <int HD>
__device__ __forceinline__ void store_row(float* __restrict__ dst, int lane,
                                          const float (&acc)[HD >= 32 ? HD / 32 : 1],
                                          float scale) {
  if constexpr (HD >= 32) {
#pragma unroll
    for (int c = 0; c < HD / 32; ++c) dst[lane + 32 * c] = acc[c] * scale;
  } else {
    if (lane < HD) dst[lane] = acc[0] * scale;
  }
}

template <int HD>
__global__ void __launch_bounds__(kWarps * 32)
window_attention_bwd_kernel(const float* __restrict__ qkv,
                            const float* __restrict__ bias,
                            const float* __restrict__ dout,
                            float* __restrict__ dqkv,
                            float* __restrict__ dbias,
                            float* __restrict__ partials,
                            int B, int nW, int N, int h,
                            long long bias_w_stride, float scale) {
  constexpr int KS = k_stride<float>(HD);
  constexpr int NACC = HD >= 32 ? HD / 32 : 1;
  const int w = blockIdx.x / h;
  const int head = blockIdx.x - w * h;
  const int C = h * HD;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ld = tile_ld(N);
  int b_begin, b_end;
  split_range(B, gridDim.y, blockIdx.y, &b_begin, &b_end);

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* p = smem;
  float* bias_s = reinterpret_cast<float*>(p);
  p += align16(sizeof(float) * (size_t)N * ld);
  float* dbias_s = reinterpret_cast<float*>(p);
  p += align16(sizeof(float) * (size_t)N * ld);
  float* opA = reinterpret_cast<float*>(p);         // K (pass A), Q (pass B)
  p += align16(sizeof(float) * (size_t)N * KS);
  float* opB = reinterpret_cast<float*>(p);         // V (pass A), dO (pass B)
  p += align16(sizeof(float) * (size_t)N * KS);
  float* row_max = reinterpret_cast<float*>(p);
  float* row_sum = row_max + N;
  float* row_dot = row_sum + N;                     // rowsum(dP * P)
  p += align16(sizeof(float) * 3 * (size_t)N);
  float* wbuf = reinterpret_cast<float*>(p) + warp * (2 * HD + N);
  float* vec1 = wbuf;                               // q~ row (A), k row (B)
  float* vec2 = wbuf + HD;                          // dO row (A), v row (B)
  float* vecN = wbuf + 2 * HD;                      // dS row (A), column (B)

  const float* bias_wh = bias + (size_t)w * bias_w_stride + (size_t)head * N * N;
  for (int i = threadIdx.x; i < N * N; i += blockDim.x) {
    const int r = i / N;
    const int c = i - r * N;
    cp_async4(bias_s + r * ld + c, bias_wh + i);  // waited for with pass A's
    dbias_s[r * ld + c] = 0.f;
  }

  for (int b = b_begin; b < b_end; ++b) {
    const size_t row0 = ((size_t)b * nW + w) * N;  // first token of the window
    const float* win = qkv + row0 * 3 * C + head * HD;
    const float* dwin = dout + row0 * C + head * HD;
    float* gwin = dqkv + row0 * 3 * C + head * HD;

    // ---- pass A: one query row per warp --------------------------------
    __syncthreads();                                // previous pass B is done
    for (int i = threadIdx.x; i < N * HD; i += blockDim.x) {
      const int n = i / HD;
      const int d = i - n * HD;
      cp_async4(opA + n * KS + d, win + (size_t)n * 3 * C + C + d);
      cp_async4(opB + n * KS + d, win + (size_t)n * 3 * C + 2 * C + d);
    }
    cp_async_wait_all();
    __syncthreads();
    for (int i = warp; i < N; i += kWarps) {
      for (int d = lane; d < HD; d += 32) {
        vec1[d] = win[(size_t)i * 3 * C + d] * scale;
        vec2[d] = dwin[(size_t)i * C + d];
      }
      __syncwarp();
      float pr[kMaxChunks], dp[kMaxChunks];
      float mx = -INFINITY;
#pragma unroll
      for (int t = 0; t < kMaxChunks; ++t) {
        const int j = lane + 32 * t;
        pr[t] = -INFINITY;
        if (j < N) {
          const float* kr = opA + j * KS;
          float acc = 0.f;
#pragma unroll
          for (int d = 0; d < HD; ++d) acc = fmaf(vec1[d], kr[d], acc);
          pr[t] = acc + bias_s[i * ld + j];
          mx = fmaxf(mx, pr[t]);
        }
      }
      mx = warp_max(mx);
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < kMaxChunks; ++t) {
        if (lane + 32 * t < N) {
          pr[t] = expf(pr[t] - mx);
          sum += pr[t];
        }
      }
      sum = warp_sum(sum);
      float dot = 0.f;
#pragma unroll
      for (int t = 0; t < kMaxChunks; ++t) {
        const int j = lane + 32 * t;
        dp[t] = 0.f;
        if (j < N) {
          pr[t] = pr[t] / sum;
          const float* vr = opB + j * KS;
          float acc = 0.f;
#pragma unroll
          for (int d = 0; d < HD; ++d) acc = fmaf(vec2[d], vr[d], acc);
          dp[t] = acc;
          dot = fmaf(acc, pr[t], dot);
        }
      }
      dot = warp_sum(dot);
#pragma unroll
      for (int t = 0; t < kMaxChunks; ++t) {
        const int j = lane + 32 * t;
        if (j < N) {
          const float ds = pr[t] * (dp[t] - dot);
          dbias_s[i * ld + j] += ds;
          vecN[j] = ds;
        }
      }
      if (lane == 0) {
        row_max[i] = mx;
        row_sum[i] = sum;
        row_dot[i] = dot;
      }
      __syncwarp();
      float acc[NACC];
      weighted_rows<HD>(vecN, opA, KS, N, lane, acc);   // dS . k
      store_row<HD>(gwin + (size_t)i * 3 * C, lane, acc, scale);
      __syncwarp();
    }

    // ---- pass B: one key per warp --------------------------------------
    __syncthreads();
    for (int i = threadIdx.x; i < N * HD; i += blockDim.x) {
      const int n = i / HD;
      const int d = i - n * HD;
      cp_async4(opA + n * KS + d, win + (size_t)n * 3 * C + d);
      cp_async4(opB + n * KS + d, dwin + (size_t)n * C + d);
    }
    cp_async_wait_all();
    __syncthreads();
    for (int j = warp; j < N; j += kWarps) {
      for (int d = lane; d < HD; d += 32) {
        vec1[d] = win[(size_t)j * 3 * C + C + d];
        vec2[d] = win[(size_t)j * 3 * C + 2 * C + d];
      }
      __syncwarp();
      float ds[kMaxChunks];
#pragma unroll
      for (int t = 0; t < kMaxChunks; ++t) {
        const int i = lane + 32 * t;
        ds[t] = 0.f;
        if (i < N) {
          const float* qr = opA + i * KS;
          const float* orow = opB + i * KS;
          float acc = 0.f;
#pragma unroll
          for (int d = 0; d < HD; ++d) acc = fmaf(qr[d] * scale, vec1[d], acc);
          const float pij = expf(acc + bias_s[i * ld + j] - row_max[i]) / row_sum[i];
          float dpij = 0.f;
#pragma unroll
          for (int d = 0; d < HD; ++d) dpij = fmaf(orow[d], vec2[d], dpij);
          ds[t] = pij * (dpij - row_dot[i]);
          vecN[i] = pij;
        }
      }
      __syncwarp();
      float acc[NACC];
      weighted_rows<HD>(vecN, opB, KS, N, lane, acc);   // P^T . dO
      store_row<HD>(gwin + (size_t)j * 3 * C + 2 * C, lane, acc, 1.f);
      __syncwarp();
#pragma unroll
      for (int t = 0; t < kMaxChunks; ++t) {
        const int i = lane + 32 * t;
        if (i < N) vecN[i] = ds[t];
      }
      __syncwarp();
      weighted_rows<HD>(vecN, opA, KS, N, lane, acc);   // dS^T . q
      store_row<HD>(gwin + (size_t)j * 3 * C + C, lane, acc, scale);
      __syncwarp();
    }
  }

  __syncthreads();
  float* dbias_wh = dbias_tile(dbias, partials, gridDim.y, blockIdx.y,
                               gridDim.x, blockIdx.x, N);
  for (int i = threadIdx.x; i < N * N; i += blockDim.x) {
    const int r = i / N;
    dbias_wh[i] = dbias_s[r * ld + (i - r * N)];
  }
}

template <int HD>
cudaError_t launch(const float* qkv, const float* bias, const float* dout,
                   float* dqkv, float* dbias, float* partials, int B, int nW,
                   int N, int h, long long bias_w_stride, float scale,
                   int splits, cudaStream_t stream) {
  return launch_split(window_attention_bwd_kernel<HD>, nW * h, splits,
                      kWarps * 32, bwd_smem_bytes(N, HD), stream, dbias,
                      partials, (long long)nW * h * N * N, qkv, bias, dout,
                      dqkv, dbias, partials, B, nW, N, h, bias_w_stride, scale);
}

// ---- long windows ------------------------------------------------------
constexpr int kLongWarps = 8;
constexpr int kLongRows = 16;    // query rows (row kernel), keys (column kernel)
constexpr int kLongChunks = 11;  // N <= 32 * 11 = 352

// Shared memory of either long-window kernel: two staged (N, hd) operands
// (K, V or q, dO), 16 rows of an (N, N|1) fp32 tile (dbias rows or the
// bias columns), the rows' statistics (N x 4 fp32) and per warp two hd
// rows and one N row.
__host__ __device__ inline size_t bwd_long_smem_bytes(int N, int hd) {
  return 2 * align16(sizeof(float) * (size_t)N * k_stride<float>(hd))
       + align16(sizeof(float) * kLongRows * (size_t)tile_ld(N))
       + align16(sizeof(float) * 4 * (size_t)N)
       + align16(sizeof(float) * kLongWarps * (size_t)(2 * hd + N));
}

struct LongSmem {
  float *opA, *opB, *tile;
  float4* stats;
  float *vec1, *vec2, *vecN;
  __device__ LongSmem(unsigned char* p, int N, int hd, int KS) {
    const int warp = threadIdx.x >> 5;
    opA = reinterpret_cast<float*>(p);
    p += align16(sizeof(float) * (size_t)N * KS);
    opB = reinterpret_cast<float*>(p);
    p += align16(sizeof(float) * (size_t)N * KS);
    tile = reinterpret_cast<float*>(p);
    p += align16(sizeof(float) * kLongRows * (size_t)tile_ld(N));
    stats = reinterpret_cast<float4*>(p);
    p += align16(sizeof(float) * 4 * (size_t)N);
    vec1 = reinterpret_cast<float*>(p) + warp * (2 * hd + N);
    vec2 = vec1 + hd;
    vecN = vec1 + 2 * hd;
  }
};

template <int HD>
__global__ void __launch_bounds__(kLongWarps * 32)
window_attention_bwd_long_rows_kernel(const float* __restrict__ qkv,
                     const float* __restrict__ bias,
                     const float* __restrict__ dout, float* __restrict__ dqkv,
                     float* __restrict__ dbias, float* __restrict__ partials,
                     float4* __restrict__ stats, int B, int nW, int N, int h,
                     long long bias_w_stride, float scale) {
  constexpr int KS = k_stride<float>(HD);
  constexpr int NACC = HD >= 32 ? HD / 32 : 1;
  const int wh = blockIdx.y;
  const int w = wh / h;
  const int head = wh - w * h;
  const int C = h * HD;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ld = tile_ld(N);
  const int r0 = blockIdx.x * kLongRows;
  const int nq = min(kLongRows, N - r0);
  int b_begin, b_end;
  split_range(B, gridDim.z, blockIdx.z, &b_begin, &b_end);

  extern __shared__ __align__(16) unsigned char smem[];
  const LongSmem S(smem, N, HD, KS);
  float* dB = S.tile;
  for (int i = threadIdx.x; i < kLongRows * ld; i += blockDim.x) dB[i] = 0.f;
  const float* bias_wh = bias + (size_t)w * bias_w_stride + (size_t)head * N * N;

  for (int b = b_begin; b < b_end; ++b) {
    const size_t row0 = ((size_t)b * nW + w) * N;
    const float* win = qkv + row0 * 3 * C + head * HD;
    const float* dwin = dout + row0 * C + head * HD;
    float* gwin = dqkv + row0 * 3 * C + head * HD;
    __syncthreads();               // the previous element is done with K, V
    for (int i = threadIdx.x; i < N * HD; i += blockDim.x) {
      const int n = i / HD;
      const int d = i - n * HD;
      cp_async4(S.opA + n * KS + d, win + (size_t)n * 3 * C + C + d);
      cp_async4(S.opB + n * KS + d, win + (size_t)n * 3 * C + 2 * C + d);
    }
    cp_async_wait_all();
    __syncthreads();
    for (int il = warp; il < nq; il += kLongWarps) {
      const int i = r0 + il;
      for (int d = lane; d < HD; d += 32) {
        S.vec1[d] = win[(size_t)i * 3 * C + d] * scale;
        S.vec2[d] = dwin[(size_t)i * C + d];
      }
      __syncwarp();
      float pr[kLongChunks], dp[kLongChunks];
      float mx = -INFINITY;
#pragma unroll
      for (int t = 0; t < kLongChunks; ++t) {
        const int j = lane + 32 * t;
        pr[t] = -INFINITY;
        if (j < N) {
          const float* kr = S.opA + j * KS;
          float acc = 0.f;
#pragma unroll
          for (int d = 0; d < HD; ++d) acc = fmaf(S.vec1[d], kr[d], acc);
          pr[t] = acc + bias_wh[(size_t)i * N + j];
          mx = fmaxf(mx, pr[t]);
        }
      }
      mx = warp_max(mx);
      float sum = 0.f;
#pragma unroll
      for (int t = 0; t < kLongChunks; ++t) {
        if (lane + 32 * t < N) {
          pr[t] = expf(pr[t] - mx);
          sum += pr[t];
        }
      }
      sum = warp_sum(sum);
      float dot = 0.f;
#pragma unroll
      for (int t = 0; t < kLongChunks; ++t) {
        const int j = lane + 32 * t;
        dp[t] = 0.f;
        if (j < N) {
          pr[t] = pr[t] / sum;
          const float* vr = S.opB + j * KS;
          float acc = 0.f;
#pragma unroll
          for (int d = 0; d < HD; ++d) acc = fmaf(S.vec2[d], vr[d], acc);
          dp[t] = acc;
          dot = fmaf(acc, pr[t], dot);
        }
      }
      dot = warp_sum(dot);
#pragma unroll
      for (int t = 0; t < kLongChunks; ++t) {
        const int j = lane + 32 * t;
        if (j < N) {
          const float ds = pr[t] * (dp[t] - dot);
          dB[il * ld + j] += ds;
          S.vecN[j] = ds;
        }
      }
      if (lane == 0)
        stats[((size_t)b * gridDim.y + wh) * N + i] = make_float4(mx, sum, dot, 0.f);
      __syncwarp();
      float acc[NACC];
      weighted_rows<HD>(S.vecN, S.opA, KS, N, lane, acc);   // dS . k
      store_row<HD>(gwin + (size_t)i * 3 * C, lane, acc, scale);
      __syncwarp();
    }
  }

  __syncthreads();
  float* dst = dbias_tile(dbias, partials, gridDim.z, blockIdx.z, gridDim.y, wh, N)
             + (size_t)r0 * N;
  for (int i = threadIdx.x; i < nq * N; i += blockDim.x) {
    const int r = i / N;
    dst[i] = dB[r * ld + (i - r * N)];
  }
}

template <int HD>
__global__ void __launch_bounds__(kLongWarps * 32)
window_attention_bwd_long_cols_kernel(const float* __restrict__ qkv,
                     const float* __restrict__ bias,
                     const float* __restrict__ dout, float* __restrict__ dqkv,
                     const float4* __restrict__ stats, int B, int nW, int N,
                     int h, long long bias_w_stride, float scale) {
  constexpr int KS = k_stride<float>(HD);
  constexpr int NACC = HD >= 32 ? HD / 32 : 1;
  const int wh = blockIdx.y;
  const int w = wh / h;
  const int head = wh - w * h;
  const int C = h * HD;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ld = tile_ld(N);
  const int c0 = blockIdx.x * kLongRows;
  const int nk = min(kLongRows, N - c0);
  int b_begin, b_end;
  split_range(B, gridDim.z, blockIdx.z, &b_begin, &b_end);

  extern __shared__ __align__(16) unsigned char smem[];
  const LongSmem S(smem, N, HD, KS);
  float* Bt = S.tile;              // Bt[jl * ld + i] = bias[i, c0 + jl]
  const float* bias_wh = bias + (size_t)w * bias_w_stride + (size_t)head * N * N;
  for (int idx = threadIdx.x; idx < N * nk; idx += blockDim.x) {
    const int i = idx / nk;
    const int jl = idx - i * nk;
    Bt[jl * ld + i] = bias_wh[(size_t)i * N + c0 + jl];
  }

  for (int b = b_begin; b < b_end; ++b) {
    const size_t row0 = ((size_t)b * nW + w) * N;
    const float* win = qkv + row0 * 3 * C + head * HD;
    const float* dwin = dout + row0 * C + head * HD;
    float* gwin = dqkv + row0 * 3 * C + head * HD;
    __syncthreads();               // the previous element is done with q, dO
    for (int i = threadIdx.x; i < N * HD; i += blockDim.x) {
      const int n = i / HD;
      const int d = i - n * HD;
      cp_async4(S.opA + n * KS + d, win + (size_t)n * 3 * C + d);
      cp_async4(S.opB + n * KS + d, dwin + (size_t)n * C + d);
    }
    const float4* srow = stats + ((size_t)b * gridDim.y + wh) * N;
    for (int i = threadIdx.x; i < N; i += blockDim.x) S.stats[i] = srow[i];
    cp_async_wait_all();
    __syncthreads();
    for (int jl = warp; jl < nk; jl += kLongWarps) {
      const int j = c0 + jl;
      for (int d = lane; d < HD; d += 32) {
        S.vec1[d] = win[(size_t)j * 3 * C + C + d];
        S.vec2[d] = win[(size_t)j * 3 * C + 2 * C + d];
      }
      __syncwarp();
      float ds[kLongChunks];
#pragma unroll
      for (int t = 0; t < kLongChunks; ++t) {
        const int i = lane + 32 * t;
        ds[t] = 0.f;
        if (i < N) {
          const float* qr = S.opA + i * KS;
          const float* orow = S.opB + i * KS;
          const float4 st = S.stats[i];
          float acc = 0.f;
#pragma unroll
          for (int d = 0; d < HD; ++d) acc = fmaf(qr[d] * scale, S.vec1[d], acc);
          const float pij = expf(acc + Bt[jl * ld + i] - st.x) / st.y;
          float dpij = 0.f;
#pragma unroll
          for (int d = 0; d < HD; ++d) dpij = fmaf(orow[d], S.vec2[d], dpij);
          ds[t] = pij * (dpij - st.z);
          S.vecN[i] = pij;
        }
      }
      __syncwarp();
      float acc[NACC];
      weighted_rows<HD>(S.vecN, S.opB, KS, N, lane, acc);   // P^T . dO
      store_row<HD>(gwin + (size_t)j * 3 * C + 2 * C, lane, acc, 1.f);
      __syncwarp();
#pragma unroll
      for (int t = 0; t < kLongChunks; ++t) {
        const int i = lane + 32 * t;
        if (i < N) S.vecN[i] = ds[t];
      }
      __syncwarp();
      weighted_rows<HD>(S.vecN, S.opA, KS, N, lane, acc);   // dS^T . q
      store_row<HD>(gwin + (size_t)j * 3 * C + C, lane, acc, scale);
      __syncwarp();
    }
  }
}

template <int HD>
cudaError_t launch_long(const float* qkv, const float* bias, const float* dout,
                        float* dqkv, float* dbias, float* partials,
                        float4* stats, int B, int nW, int N, int h,
                        long long bias_w_stride, float scale, int splits,
                        int col_splits, cudaStream_t stream) {
  auto rk = window_attention_bwd_long_rows_kernel<HD>;
  auto ck = window_attention_bwd_long_cols_kernel<HD>;
  const size_t smem = bwd_long_smem_bytes(N, HD);
  cudaError_t e = allow_smem(rk, smem);
  if (e == cudaSuccess) e = allow_smem(ck, smem);
  if (e != cudaSuccess) return e;
  const int blocks = (N + kLongRows - 1) / kLongRows;
  rk<<<dim3(blocks, nW * h, splits), kLongWarps * 32, smem, stream>>>(
      qkv, bias, dout, dqkv, dbias, partials, stats, B, nW, N, h,
      bias_w_stride, scale);
  if ((e = cudaGetLastError()) != cudaSuccess) return e;
  if (splits > 1 &&
      (e = sum_splits(partials, dbias, splits, (long long)nW * h * N * N,
                      stream)) != cudaSuccess)
    return e;
  ck<<<dim3(blocks, nW * h, col_splits), kLongWarps * 32, smem, stream>>>(
      qkv, bias, dout, dqkv, stats, B, nW, N, h, bias_w_stride, scale);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Shared memory of a block of either long-window kernel.
long long fiber_window_attention_bwd_long_smem_bytes(int N, int hd) {
  return (long long)bwd_long_smem_bytes(N, hd);
}

// Resident blocks per SM of the long-window row kernel (the column
// kernel's are the same: same threads and shared memory); -1 on error.
int fiber_window_attention_bwd_long_blocks_per_sm(int N, int hd) {
  const size_t smem = bwd_long_smem_bytes(N, hd);
  switch (hd) {
    case 8: return blocks_per_sm(window_attention_bwd_long_rows_kernel<8>, kLongWarps * 32, smem);
    case 16: return blocks_per_sm(window_attention_bwd_long_rows_kernel<16>, kLongWarps * 32, smem);
    case 32: return blocks_per_sm(window_attention_bwd_long_rows_kernel<32>, kLongWarps * 32, smem);
    case 64: return blocks_per_sm(window_attention_bwd_long_rows_kernel<64>, kLongWarps * 32, smem);
    case 128: return blocks_per_sm(window_attention_bwd_long_rows_kernel<128>, kLongWarps * 32, smem);
    default: return -1;
  }
}

// Launches the long-window row kernel (`splits` of the batch), the
// fixed-order sum of its dbias partials when splits > 1, then the column
// kernel (`col_splits`), on `stream`; returns the first CUDA error.  The
// tensors as for fiber_window_attention_bwd, and stats (B, nW h, N, 4)
// fp32 scratch, 16-byte aligned.
int fiber_window_attention_bwd_long(const void* qkv, const void* bias,
                                    const void* dout, void* dqkv, void* dbias,
                                    void* partials, void* stats, int B, int nW,
                                    int N, int h, int hd,
                                    long long bias_w_stride, float scale,
                                    int splits, int col_splits, void* stream) {
  if (N < 1 || N > 32 * kLongChunks || splits < 1 || splits > B
      || col_splits < 1 || col_splits > B)
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
    case 8: return (int)launch_long<8>(q, bi, o, dq, db, pa, st, B, nW, N, h, bias_w_stride, scale, splits, col_splits, s);
    case 16: return (int)launch_long<16>(q, bi, o, dq, db, pa, st, B, nW, N, h, bias_w_stride, scale, splits, col_splits, s);
    case 32: return (int)launch_long<32>(q, bi, o, dq, db, pa, st, B, nW, N, h, bias_w_stride, scale, splits, col_splits, s);
    case 64: return (int)launch_long<64>(q, bi, o, dq, db, pa, st, B, nW, N, h, bias_w_stride, scale, splits, col_splits, s);
    case 128: return (int)launch_long<128>(q, bi, o, dq, db, pa, st, B, nW, N, h, bias_w_stride, scale, splits, col_splits, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Shared memory one block needs.
long long fiber_window_attention_bwd_smem_bytes(int N, int hd) {
  return (long long)bwd_smem_bytes(N, hd);
}

// Resident blocks per SM at that shared memory; -1 on error.
int fiber_window_attention_bwd_blocks_per_sm(int N, int hd) {
  const size_t smem = bwd_smem_bytes(N, hd);
  switch (hd) {
    case 8: return blocks_per_sm(window_attention_bwd_kernel<8>, kWarps * 32, smem);
    case 16: return blocks_per_sm(window_attention_bwd_kernel<16>, kWarps * 32, smem);
    case 32: return blocks_per_sm(window_attention_bwd_kernel<32>, kWarps * 32, smem);
    case 64: return blocks_per_sm(window_attention_bwd_kernel<64>, kWarps * 32, smem);
    case 128: return blocks_per_sm(window_attention_bwd_kernel<128>, kWarps * 32, smem);
    default: return -1;
  }
}

// Launches on `stream` and returns the first CUDA error (0 on success).
// qkv, dqkv (B, nW, N, 3 h hd) and dout (B, nW, N, h hd) contiguous fp32;
// bias fp32, element (w, head, i, j) at w * bias_w_stride + (head * N + i)
// * N + j; dbias (nW, h, N, N) fp32 contiguous, written whole; partials
// (splits, nW, h, N, N) fp32 scratch, read only when splits > 1.
int fiber_window_attention_bwd(const void* qkv, const void* bias,
                               const void* dout, void* dqkv, void* dbias,
                               void* partials, int B, int nW, int N, int h,
                               int hd, long long bias_w_stride, float scale,
                               int splits, void* stream) {
  if (N < 1 || N > 32 * kMaxChunks || splits < 1 || splits > B)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto q = static_cast<const float*>(qkv);
  auto bi = static_cast<const float*>(bias);
  auto o = static_cast<const float*>(dout);
  auto dq = static_cast<float*>(dqkv);
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
