// Device helpers shared by the window-attention kernels (K1 forward, K2
// backward, K4 per-head forward) and the fused Swin blocks (K3): dtype
// conversion, warp reductions, the staged-row layout, and the attention of
// one (batch, window, head) that K1, K3 and K4 run.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stddef.h>

namespace fiber {

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) {
  return x;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(
    float x) {
  return __float2bfloat16_rn(x);
}
// x rounded to T and back: the rounding steps of the plain version
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_float(from_float<T>(x));
}

// Row stride of a staged (N, hd) operand, in elements: an odd number of
// 32-bit words, so that 32 lanes reading 32 different rows hit 32
// different banks.
template <typename T> __host__ __device__ constexpr int k_stride(int hd) {
  return sizeof(T) == 4 ? hd + 1 : hd + 2;
}

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~size_t(15);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// ---------------------------------------------------------------------------
// Attention of one (batch, window, head), forward only.
//
//     out = softmax(logits + bias (+ mask)) . v
//
// SCALE_AFTER = false (K1, K4): q is scaled by hd^-1/2 and rounded to T
// before the product, logits = q.k^T in fp32.  SCALE_AFTER = true (K3):
// logits = (q.k^T in fp32) * hd^-1/2.  Then the fp32 bias (and, with MASK,
// the fp32 mask) is added, the softmax is fp32, the probabilities are
// rounded to T before P.V, and P.V accumulates in fp32.
//
// Row n of q, k and v is at q + n * in_rs (likewise k, v), row n of the
// output at out + n * out_rs; bias and mask are (N, N) fp32 row-major.
// The caller's block has `warps` warps (warps * 32 threads) and gives
// attend_smem_bytes<T>(N, HD, warps) bytes of shared memory at `smem`.
// Work: K and V are staged in shared memory; one warp owns one query row at
// a time; the lanes split the N <= 32 KC keys (j = lane + 32 t, masked at
// the tail), reduce max and sum with warp shuffles, and for P.V each lane owns
// hd / 32 output channels (for hd < 32 the lanes split the keys into 32 / hd
// groups and reduce).  No __syncthreads() after the last row: a caller that
// stages again must synchronise first.
// ---------------------------------------------------------------------------
// KC key chunks a lane: N <= 32 KC.  K1, K3 and K4 up to N = 256 take
// kMaxKeyChunks; beyond that (FIBER's N = 324 windows at 576^2) each takes a
// second instance, kLongKeyChunks, so that the first keeps its registers.
constexpr int kMaxKeyChunks = 8;    // N <= 32 * 8 = 256
constexpr int kLongKeyChunks = 11;  // N <= 32 * 11 = 352

template <typename T>
__host__ __device__ inline size_t attend_smem_bytes(int N, int hd, int warps) {
  return align16(sizeof(T) * (size_t)N * k_stride<T>(hd))   // K
       + align16(sizeof(T) * (size_t)N * hd)                // V
       + align16(sizeof(float) * (size_t)warps * hd)        // one q row per warp
       + align16(sizeof(float) * (size_t)warps * N);        // one p row per warp
}

template <typename T, int HD, bool SCALE_AFTER, bool MASK, int KC = kMaxKeyChunks>
__device__ __forceinline__ void attend_head(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    long long in_rs, T* __restrict__ out, long long out_rs,
    const float* __restrict__ bias, const float* __restrict__ mask, int N,
    float scale, unsigned char* smem, int warps) {
  constexpr int KS = k_stride<T>(HD);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  T* Ks = reinterpret_cast<T*>(smem);
  T* Vs = reinterpret_cast<T*>(smem + align16(sizeof(T) * (size_t)N * KS));
  float* Qs = reinterpret_cast<float*>(
      reinterpret_cast<unsigned char*>(Vs) + align16(sizeof(T) * (size_t)N * HD));
  float* Ps = Qs + align16(sizeof(float) * (size_t)warps * HD) / sizeof(float);
  float* q_row = Qs + warp * HD;
  float* p_row = Ps + warp * N;

  // Stage this head's K and V (N x hd each) in shared memory.
  for (int i = threadIdx.x; i < N * HD; i += warps * 32) {
    const int n = i / HD;
    const int d = i - n * HD;
    Ks[n * KS + d] = k[(size_t)n * in_rs + d];
    Vs[n * HD + d] = v[(size_t)n * in_rs + d];
  }
  __syncthreads();

  for (int n = warp; n < N; n += warps) {
    const T* q_src = q + (size_t)n * in_rs;
    for (int d = lane; d < HD; d += 32)
      q_row[d] = SCALE_AFTER ? to_float(q_src[d])
                             : to_float(from_float<T>(to_float(q_src[d]) * scale));
    __syncwarp();

    // Logits: lane owns keys j = lane + 32 t.
    const float* bias_row = bias + (size_t)n * N;
    const float* mask_row = MASK ? mask + (size_t)n * N : nullptr;
    float logit[KC];
    float mx = -INFINITY;
#pragma unroll
    for (int t = 0; t < KC; ++t) {
      const int j = lane + 32 * t;
      logit[t] = -INFINITY;
      if (j < N) {
        const T* kr = Ks + j * KS;
        float acc = 0.f;
#pragma unroll
        for (int d = 0; d < HD; ++d) acc = fmaf(q_row[d], to_float(kr[d]), acc);
        if (SCALE_AFTER) acc = acc * scale;
        logit[t] = acc + bias_row[j];
        if (MASK) logit[t] = logit[t] + mask_row[j];
        mx = fmaxf(mx, logit[t]);
      }
    }
    mx = warp_max(mx);
    float sum = 0.f;
#pragma unroll
    for (int t = 0; t < KC; ++t) {
      const int j = lane + 32 * t;
      if (j < N) {
        logit[t] = expf(logit[t] - mx);
        sum += logit[t];
      }
    }
    sum = warp_sum(sum);
#pragma unroll
    for (int t = 0; t < KC; ++t) {
      const int j = lane + 32 * t;
      if (j < N) p_row[j] = to_float(from_float<T>(logit[t] / sum));
    }
    __syncwarp();

    // P.V in fp32.
    T* o = out + (size_t)n * out_rs;
    if constexpr (HD >= 32) {
#pragma unroll
      for (int c = 0; c < HD / 32; ++c) {
        const int d = lane + 32 * c;
        float acc = 0.f;
        for (int j = 0; j < N; ++j) acc = fmaf(p_row[j], to_float(Vs[j * HD + d]), acc);
        o[d] = from_float<T>(acc);
      }
    } else {
      constexpr int G = 32 / HD;  // key groups
      const int d = lane % HD;
      const int g = lane / HD;
      float acc = 0.f;
      for (int j = g; j < N; j += G) acc = fmaf(p_row[j], to_float(Vs[j * HD + d]), acc);
#pragma unroll
      for (int off = HD; off < 32; off <<= 1)
        acc += __shfl_xor_sync(0xffffffffu, acc, off);
      if (g == 0) o[d] = from_float<T>(acc);
    }
    __syncwarp();
  }
}

}  // namespace fiber
