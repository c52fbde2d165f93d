// Windowed multi-head attention backward for Hopper (sm_90a).
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
// where round() is a rounding to the input dtype and every product
// accumulates in fp32, the steps of the plain version
// window_attention_bwd_reference (fiber_torch/ops/window_attention.py).
// dq, dk, dv are written into dqkv (B, nW, N, 3C) at the channel offsets
// the forward reads q, k, v from; dbias is (nW, h, N, N) fp32.
//
// What bounds it on the card: at the FIBER-Base 384^2 shapes (N = 144,
// hd = 32) one (b, w, head) does 5 products of 2 N^2 hd = 1.3 MFLOP on
// 4 N hd input and 3 N hd output elements, so bytes bound the work (the
// bias and dbias tiles, 83 KB each per (w, head), are most of them).
// This first design reads each input once per block and writes each
// output once, and runs its products on the CUDA cores in fp32; its time
// is set by those FMAs and by the parallelism below, not by bytes.
//
// The choices, point by point:
// * The dbias sum over the batch (the TPU kernel keeps one dbias block
//   resident across a sequential batch axis): one block per (window,
//   head) loops over b, keeps the fp32 dbias tile in shared memory across
//   the loop and writes it once.  Each element is owned by one thread per
//   batch, so the sum is deterministic and needs no atomics.  Its
//   parallelism is nW * h blocks (256, 128, 64, 32 at stages 1-4).
// * dk and dv sum over query rows, dq over keys: two passes per batch.
//   Pass A gives a warp one query row (lanes own keys): logits, softmax,
//   dP, dS, the dbias update, dq, and the row's max, sum and
//   rowsum(dP * P).  Pass B gives a warp one key (lanes own query rows):
//   it recomputes P and dS for that key's column with the same operations
//   in the same order (so bit for bit the values of pass A) from the
//   stored row statistics, then dv and dk.  Recomputing costs two of the
//   seven products but keeps no (N, N) probabilities in shared memory.
// * Shared memory: the bias tile (staged once per block, since it is the
//   same for every b) and the dbias tile, (N, N|1) fp32 each, plus two
//   staged (N, hd) operands in the input dtype: K and V in pass A, Q and
//   dO in pass B.  At N = 144, hd = 32 that is 215 KB in fp32; the
//   wrapper raises where a shape does not fit (N = 256, or hd = 64 in
//   fp32 at N = 144).
// * The broadcast bias: a window stride of 0 reads one (h, N, N) bias
//   for every window; dbias is always written per window, and autograd's
//   expand backward sums it.
// * N = 144 is not a power of two: lanes own the keys (or rows)
//   j = lane + 32 t, t < 8, with a masked tail, as in K1.
// * Rounding in bf16: P and dS are rounded to the input type before
//   their products, q is scaled and rounded before q.k^T, as in K1 and the
//   plain version.
// * Launch checks: the C function returns cudaGetLastError() after the
//   launch and sets the dynamic shared-memory limit first.
// Tensor cores (wgmma), TMA and more parallelism than nW * h blocks are
// left for a later version.

#include <stdint.h>

#include "window_attention_common.cuh"

namespace {

using namespace fiber;

constexpr int kWarps = 16;
constexpr int kMaxChunks = 8;  // N <= 32 * 8 = 256

// Leading dimension of the (N, N) fp32 tiles: odd, so that a column read
// by 32 lanes hits 32 banks.
__host__ __device__ inline int tile_ld(int N) { return N | 1; }

template <typename T>
__host__ __device__ inline size_t bwd_smem_bytes(int N, int hd) {
  return 2 * align16(sizeof(float) * (size_t)N * tile_ld(N))  // bias, dbias
       + 2 * align16(sizeof(T) * (size_t)N * k_stride<T>(hd))  // two operands
       + align16(sizeof(float) * 3 * (size_t)N)                // row stats
       + align16(sizeof(float) * kWarps * (size_t)(2 * hd + N));  // per warp
}

// acc[c] = sum_j w[j] * M[j, d] for the lane's channels d (lane + 32 c for
// HD >= 32; for HD < 32 the lanes split the rows into 32 / HD groups and
// reduce, and lane d < HD holds the result).
template <typename T, int HD>
__device__ __forceinline__ void weighted_rows(
    const float* __restrict__ w, const T* __restrict__ M, int ld, int N,
    int lane, float (&acc)[HD >= 32 ? HD / 32 : 1]) {
  if constexpr (HD >= 32) {
#pragma unroll
    for (int c = 0; c < HD / 32; ++c) acc[c] = 0.f;
    for (int j = 0; j < N; ++j) {
      const float wj = w[j];
      const T* row = M + (size_t)j * ld + lane;
#pragma unroll
      for (int c = 0; c < HD / 32; ++c) acc[c] = fmaf(wj, to_float(row[32 * c]), acc[c]);
    }
  } else {
    constexpr int G = 32 / HD;
    const int d = lane % HD;
    float a = 0.f;
    for (int j = lane / HD; j < N; j += G) a = fmaf(w[j], to_float(M[(size_t)j * ld + d]), a);
#pragma unroll
    for (int off = HD; off < 32; off <<= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
    acc[0] = a;
  }
}

// dst[d] = round(scale * acc) for the lane's channels
template <typename T, int HD>
__device__ __forceinline__ void store_row(T* __restrict__ dst, int lane,
                                          const float (&acc)[HD >= 32 ? HD / 32 : 1],
                                          float scale) {
  if constexpr (HD >= 32) {
#pragma unroll
    for (int c = 0; c < HD / 32; ++c) dst[lane + 32 * c] = from_float<T>(acc[c] * scale);
  } else {
    if (lane < HD) dst[lane] = from_float<T>(acc[0] * scale);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kWarps * 32)
window_attention_bwd_kernel(const T* __restrict__ qkv,
                            const float* __restrict__ bias,
                            const T* __restrict__ dout,
                            T* __restrict__ dqkv,
                            float* __restrict__ dbias,
                            int B, int nW, int N, int h,
                            long long bias_w_stride, float scale) {
  constexpr int KS = k_stride<T>(HD);
  constexpr int NACC = HD >= 32 ? HD / 32 : 1;
  const int w = blockIdx.x / h;
  const int head = blockIdx.x - w * h;
  const int C = h * HD;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ld = tile_ld(N);

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* p = smem;
  float* bias_s = reinterpret_cast<float*>(p);
  p += align16(sizeof(float) * (size_t)N * ld);
  float* dbias_s = reinterpret_cast<float*>(p);
  p += align16(sizeof(float) * (size_t)N * ld);
  T* opA = reinterpret_cast<T*>(p);                 // K (pass A), Q (pass B)
  p += align16(sizeof(T) * (size_t)N * KS);
  T* opB = reinterpret_cast<T*>(p);                 // V (pass A), dO (pass B)
  p += align16(sizeof(T) * (size_t)N * KS);
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
    bias_s[r * ld + c] = bias_wh[i];
    dbias_s[r * ld + c] = 0.f;
  }

  for (int b = 0; b < B; ++b) {
    const size_t row0 = ((size_t)b * nW + w) * N;  // first token of the window
    const T* win = qkv + row0 * 3 * C + head * HD;
    const T* dwin = dout + row0 * C + head * HD;
    T* gwin = dqkv + row0 * 3 * C + head * HD;

    // ---- pass A: one query row per warp --------------------------------
    __syncthreads();                                // previous pass B is done
    for (int i = threadIdx.x; i < N * HD; i += blockDim.x) {
      const int n = i / HD;
      const int d = i - n * HD;
      opA[n * KS + d] = win[(size_t)n * 3 * C + C + d];
      opB[n * KS + d] = win[(size_t)n * 3 * C + 2 * C + d];
    }
    __syncthreads();
    for (int i = warp; i < N; i += kWarps) {
      for (int d = lane; d < HD; d += 32) {
        vec1[d] = round_to<T>(to_float(win[(size_t)i * 3 * C + d]) * scale);
        vec2[d] = to_float(dwin[(size_t)i * C + d]);
      }
      __syncwarp();
      float pr[kMaxChunks], dp[kMaxChunks];
      float mx = -INFINITY;
#pragma unroll
      for (int t = 0; t < kMaxChunks; ++t) {
        const int j = lane + 32 * t;
        pr[t] = -INFINITY;
        if (j < N) {
          const T* kr = opA + j * KS;
          float acc = 0.f;
#pragma unroll
          for (int d = 0; d < HD; ++d) acc = fmaf(vec1[d], to_float(kr[d]), acc);
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
          const T* vr = opB + j * KS;
          float acc = 0.f;
#pragma unroll
          for (int d = 0; d < HD; ++d) acc = fmaf(vec2[d], to_float(vr[d]), acc);
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
          vecN[j] = round_to<T>(ds);
        }
      }
      if (lane == 0) {
        row_max[i] = mx;
        row_sum[i] = sum;
        row_dot[i] = dot;
      }
      __syncwarp();
      float acc[NACC];
      weighted_rows<T, HD>(vecN, opA, KS, N, lane, acc);   // dS~ . k
      store_row<T, HD>(gwin + (size_t)i * 3 * C, lane, acc, scale);
      __syncwarp();
    }

    // ---- pass B: one key per warp --------------------------------------
    __syncthreads();
    for (int i = threadIdx.x; i < N * HD; i += blockDim.x) {
      const int n = i / HD;
      const int d = i - n * HD;
      opA[n * KS + d] = win[(size_t)n * 3 * C + d];
      opB[n * KS + d] = dwin[(size_t)n * C + d];
    }
    __syncthreads();
    for (int j = warp; j < N; j += kWarps) {
      for (int d = lane; d < HD; d += 32) {
        vec1[d] = to_float(win[(size_t)j * 3 * C + C + d]);
        vec2[d] = to_float(win[(size_t)j * 3 * C + 2 * C + d]);
      }
      __syncwarp();
      float ds[kMaxChunks];
#pragma unroll
      for (int t = 0; t < kMaxChunks; ++t) {
        const int i = lane + 32 * t;
        ds[t] = 0.f;
        if (i < N) {
          const T* qr = opA + i * KS;
          const T* orow = opB + i * KS;
          float acc = 0.f;
#pragma unroll
          for (int d = 0; d < HD; ++d)
            acc = fmaf(round_to<T>(to_float(qr[d]) * scale), vec1[d], acc);
          const float pij = expf(acc + bias_s[i * ld + j] - row_max[i]) / row_sum[i];
          float dpij = 0.f;
#pragma unroll
          for (int d = 0; d < HD; ++d) dpij = fmaf(to_float(orow[d]), vec2[d], dpij);
          ds[t] = pij * (dpij - row_dot[i]);
          vecN[i] = round_to<T>(pij);
        }
      }
      __syncwarp();
      float acc[NACC];
      weighted_rows<T, HD>(vecN, opB, KS, N, lane, acc);   // P~^T . dO
      store_row<T, HD>(gwin + (size_t)j * 3 * C + 2 * C, lane, acc, 1.f);
      __syncwarp();
#pragma unroll
      for (int t = 0; t < kMaxChunks; ++t) {
        const int i = lane + 32 * t;
        if (i < N) vecN[i] = round_to<T>(ds[t]);
      }
      __syncwarp();
      weighted_rows<T, HD>(vecN, opA, KS, N, lane, acc);   // dS~^T . q
      store_row<T, HD>(gwin + (size_t)j * 3 * C + C, lane, acc, scale);
      __syncwarp();
    }
  }

  __syncthreads();
  float* dbias_wh = dbias + ((size_t)w * h + head) * N * N;
  for (int i = threadIdx.x; i < N * N; i += blockDim.x) {
    const int r = i / N;
    dbias_wh[i] = dbias_s[r * ld + (i - r * N)];
  }
}

template <typename T, int HD>
cudaError_t launch(const void* qkv, const void* bias, const void* dout,
                   void* dqkv, void* dbias, int B, int nW, int N, int h,
                   long long bias_w_stride, float scale, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes<T>(N, HD);
  auto kernel = window_attention_bwd_kernel<T, HD>;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  kernel<<<nW * h, kWarps * 32, smem, stream>>>(
      static_cast<const T*>(qkv), static_cast<const float*>(bias),
      static_cast<const T*>(dout), static_cast<T*>(dqkv),
      static_cast<float*>(dbias), B, nW, N, h, bias_w_stride, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_hd(const void* qkv, const void* bias, const void* dout,
                        void* dqkv, void* dbias, int B, int nW, int N, int h,
                        int hd, long long bias_w_stride, float scale,
                        cudaStream_t s) {
  switch (hd) {
    case 8: return launch<T, 8>(qkv, bias, dout, dqkv, dbias, B, nW, N, h, bias_w_stride, scale, s);
    case 16: return launch<T, 16>(qkv, bias, dout, dqkv, dbias, B, nW, N, h, bias_w_stride, scale, s);
    case 32: return launch<T, 32>(qkv, bias, dout, dqkv, dbias, B, nW, N, h, bias_w_stride, scale, s);
    case 64: return launch<T, 64>(qkv, bias, dout, dqkv, dbias, B, nW, N, h, bias_w_stride, scale, s);
    case 128: return launch<T, 128>(qkv, bias, dout, dqkv, dbias, B, nW, N, h, bias_w_stride, scale, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Shared memory one block needs; dtype 0 = fp32, 1 = bf16.
long long fiber_window_attention_bwd_smem_bytes(int N, int hd, int dtype) {
  return (long long)(dtype == 0 ? bwd_smem_bytes<float>(N, hd)
                                : bwd_smem_bytes<__nv_bfloat16>(N, hd));
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// qkv, dqkv (B, nW, N, 3 h hd) and dout (B, nW, N, h hd) contiguous in
// `dtype`; bias fp32, element (w, head, i, j) at
// w * bias_w_stride + (head * N + i) * N + j; dbias (nW, h, N, N) fp32
// contiguous, written whole.
int fiber_window_attention_bwd(const void* qkv, const void* bias,
                               const void* dout, void* dqkv, void* dbias,
                               int B, int nW, int N, int h, int hd,
                               long long bias_w_stride, float scale, int dtype,
                               void* stream) {
  if (N < 1 || N > 32 * kMaxChunks) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e = dtype == 0
      ? dispatch_hd<float>(qkv, bias, dout, dqkv, dbias, B, nW, N, h, hd, bias_w_stride, scale, s)
      : dispatch_hd<__nv_bfloat16>(qkv, bias, dout, dqkv, dbias, B, nW, N, h, hd, bias_w_stride, scale, s);
  return (int)e;
}

}  // extern "C"
